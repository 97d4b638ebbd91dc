"""RG-LRU linear-recurrence kernel: ``h_t = a_t * h_{t-1} + x_t`` along
time, for gate and input streams precomputed by the surrounding layer
(recurrentgemma's RG-LRU after its input and recurrence gates).

Port of ``src/repro/kernels/rglru_scan/kernel.py`` (``rglru_scan_fwd``).
The CUDA kernel (``csrc/kernels/rglru_scan.cu``) gives one warp to each
(batch row, group of 16 channels): lanes 0-15 walk their channel's ``S``
steps with the carry in a register, in the plain version's rounding order,
while the whole warp streams ``a`` and ``x`` three time tiles ahead
through a four-stage ``cp.async`` ring in shared memory and stores ``h``
from shared memory in 16-byte stores.  The Pallas kernel's time tiles
(``bs``) and channel tiles (``bd``) have no counterpart on the card; both
stay in the signature for the plain version, which keeps the Pallas body's
time tiles.  Any other floating type (float16, or operands of mixed
types) computes in f32 and returns the type of ``a``
(:func:`~repro_torch.kernels._cuda.prepare`).
"""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import rglru_scan_assoc


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
    """a, x: [B, S, D] (decay, gated input), floating point; h0: [B, D].
    Returns (h [B,S,D] in the type of ``a``, h_final [B,D] f32)."""
    if not _cuda.on_cuda(a, x, h0):
        if _cuda.on_meta(a):
            return rglru_scan_assoc(a, x, h0)
        return rglru_scan_plain(a, x, h0, bs=bs, bd=bd)
    out_dtype = a.dtype
    (a, x), (h0,), _ = _cuda.prepare((a, x), f32=(h0,))
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
    return h.to(out_dtype), h_final


#: kernel launches (the plain version launches nothing)
rglru_scan_fwd.launches = 0
