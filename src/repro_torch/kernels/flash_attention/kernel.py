"""Flash attention forward kernel.

Port of ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``): causal or sliding-window softmax attention on
``q, k, v [B, H, S, d]`` (kv already repeated for GQA), online softmax with
f32 accumulator, running max and denominator, masked kv tail, cast on the
final flush.

The CUDA kernel (``csrc/kernels/flash_attention.cu``) runs one block per
(batch, head, 64-row q tile) and loops over 32-row kv tiles inside the
block, skipping the tiles past the diagonal (causal) and left of the band
(window).  It takes ``d <= 256`` in three builds — ``d <= 64``, ``<= 128``
and ``<= 256`` — each padding the head to its width with zeros; q tiles of
64 and kv tiles of 32 rows go with all three.  ``bq`` and ``bk`` are the
Pallas tiles, kept by the plain version; on the card they do not change
the result (a tile that is skipped or not gives the same sums).
"""
from __future__ import annotations

import math

import torch

from .. import _cuda

NEG_INF = -1e30
#: the largest head width the kernel takes
MAX_D = 256


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          bq: int = 128, bk: int = 128):
    """The Pallas body in eager torch, batch and heads side by side: for
    each q tile of ``bq`` rows an online softmax over the kv tiles of
    ``bk`` rows that the Pallas kernel runs, in its order and with its
    masking constants."""
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    bq, bk = min(bq, Sq), min(bk, Sk)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for q0 in range(0, Sq, bq):
        qt = q[:, :, q0:q0 + bq].float()
        n = qt.shape[2]
        acc = torch.zeros((B, H, n, d), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, n, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, n, 1), dtype=torch.float32, device=q.device)
        qpos = q0 + torch.arange(n, device=q.device)[:, None]
        for k0 in range(0, Sk, bk):
            if causal and k0 > q0 + bq - 1:
                continue
            if window is not None and k0 + bk - 1 <= q0 - window:
                continue
            kt = k[:, :, k0:k0 + bk].float()
            vt = v[:, :, k0:k0 + bk].float()
            s = (qt @ kt.transpose(-1, -2)) * scale
            kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
            mask = torch.ones_like(s[0, 0], dtype=torch.bool)
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vt
            m = m_new
        out[:, :, q0:q0 + bq] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def flash_attention_fwd(q, k, v, *, causal: bool = True, window=None,
                        bq: int = 128, bk: int = 128):
    """q,k,v: [B, H, S, d] (kv pre-repeated for GQA), f32 or bf16, one
    type, ``d <= 256``.  Returns [B,H,S,d] in the input type."""
    if not _cuda.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     bq=bq, bk=bk)
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    _cuda.require(q, "q", _cuda.FLOATS, (B, H, Sq, d))
    _cuda.require(k, "k", (q.dtype,), (B, H, Sk, d))
    _cuda.require(v, "v", (q.dtype,), (B, H, Sk, d))
    if d > MAX_D:
        raise ValueError(f"head width d={d}: the flash attention kernel "
                         f"takes d <= {MAX_D}")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: a window holds at least one key")
    out = torch.empty_like(q)
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    _cuda.launch("flash_attention", [P, P, P, P, I, I, I, I, I, I, I, F32, I],
                 q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, H, Sq, Sk, d, int(causal),
                 -1 if window is None else window, 1.0 / math.sqrt(d),
                 _cuda.DTYPE_CODE[q.dtype])
    flash_attention_fwd.launches += 1
    return out


#: kernel launches (the plain version launches nothing)
flash_attention_fwd.launches = 0
