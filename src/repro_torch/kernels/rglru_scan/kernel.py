"""RG-LRU linear-recurrence kernel: ``h_t = a_t * h_{t-1} + x_t`` along
time, for gate and input streams precomputed by the surrounding layer
(recurrentgemma's RG-LRU after its input and recurrence gates).

Port of ``src/repro/kernels/rglru_scan/kernel.py`` (``rglru_scan_fwd``).
The CUDA kernel (``csrc/kernels/rglru_scan.cu``) gives one thread to each
(batch, channel): it walks all ``S`` steps with the carry in a register,
so the Pallas kernel's time tiles (``bs``) and channel tiles (``bd``) have
no counterpart on the card; both stay in the signature for the plain
version, which keeps the Pallas body's time tiles.
"""
from __future__ import annotations

import torch

from .. import _cuda


def rglru_scan_plain(a, x, h0, *, bs: int = 256, bd: int = 128):
    """The Pallas body in eager torch: time tiles of ``bs`` rows stepped in
    order, the f32 carry crossing tiles as the kernel's scratch does.
    Channel tiles of ``bd`` are independent and run side by side."""
    B, S, D = a.shape
    bs = min(bs, S)
    h = torch.empty_like(a)
    carry = h0.float()
    for s0 in range(0, S, bs):
        at = a[:, s0:s0 + bs].float()
        xt = x[:, s0:s0 + bs].float()
        for t in range(at.shape[1]):
            carry = at[:, t] * carry + xt[:, t]
            h[:, s0 + t] = carry.to(a.dtype)
    return h, carry


def rglru_scan_fwd(a, x, h0, *, bs: int = 256, bd: int = 128):
    """a, x: [B, S, D] (decay, gated input), f32 or bf16; h0: [B, D] f32.
    Returns (h [B,S,D] in the input type, h_final [B,D] f32)."""
    if not _cuda.on_cuda(a, x, h0):
        return rglru_scan_plain(a, x, h0, bs=bs, bd=bd)
    B, S, D = a.shape
    _cuda.require(a, "a", _cuda.FLOATS, (B, S, D))
    _cuda.require(x, "x", (a.dtype,), (B, S, D))
    _cuda.require(h0, "h0", (torch.float32,), (B, D))
    h = torch.empty_like(a)
    h_final = torch.empty((B, D), dtype=torch.float32, device=a.device)
    P, I = _cuda.P, _cuda.I
    _cuda.launch("rglru_scan", [P, P, P, P, P, I, I, I, I], a.device,
                 a.data_ptr(), x.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 h_final.data_ptr(), B, S, D, _cuda.DTYPE_CODE[a.dtype])
    rglru_scan_fwd.launches += 1
    return h, h_final


#: kernel launches (the plain version launches nothing)
rglru_scan_fwd.launches = 0
