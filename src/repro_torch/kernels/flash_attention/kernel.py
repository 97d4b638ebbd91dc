"""Flash attention forward kernel.

Port of ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``): causal or sliding-window softmax attention on
``q, k, v [B, H, S, d]`` (kv already repeated for GQA), online softmax with
f32 accumulator, running max and denominator, masked kv tail, cast on the
final flush.

Two CUDA sources, each kernel skipping the kv tiles past the diagonal
(causal) and left of the band (window), routed before the launch by
:func:`tma_loadable`:

* bf16 whose rows TMA can load (``d <= 256`` a multiple of 8, q, k, v
  16-byte aligned): ``csrc/kernels/flash_attention_sm90.cu``, one block
  per (batch, head, 128-row q tile): a producer warpgroup loads q, K and
  V tiles by TMA into a two-stage ring, two consumer warpgroups multiply
  with ``wgmma`` (f32 accumulators; P enters ``P V`` as two bf16
  operands, ``hi + lo``), in three builds (``d <= 64``, ``<= 128``,
  ``<= 256``).  Launches counted in ``flash_attention_fwd.sm90_launches``.
* everything else: ``csrc/kernels/flash_attention.cu`` on the CUDA cores
  in IEEE f32 (no TF32: f32 results are held to 2e-5), register-tiled
  over ``csrc/kernels/simt_f32.cuh``: one 256-thread block per (batch,
  head, q tile) — 128 query rows over 64-key tiles for ``d <= 64`` and
  ``<= 128``, 64 rows over 32-key tiles for ``d <= 256`` — a thread
  owning 8 (or 4) rows' scores and outputs in registers, q, K, V and P
  read from shared memory as float4, K and V tiles double-buffered by
  ``cp.async`` (one barrier per kv tile), causal q tiles heaviest first.
  f32 launches are counted in ``flash_attention_fwd.launches``; bf16 that
  TMA cannot load (``d % 8 != 0``, unaligned tensors) runs a build that
  converts each element to f32 on its way into shared memory, counted in
  ``flash_attention_fwd.simt_bf16_launches``.  Heads wider than 256 (any
  type) run the wide build, counted in ``flash_attention_fwd.wide_launches``:
  a third grid dimension cuts the output's ``d`` into slices of 256, and
  each block sums ``Q Kᵀ`` over the whole head in 256-wide chunks that it
  stages one after another.

Any other floating type (float16, or operands of mixed types) computes
in f32 and returns the type of ``q`` (:func:`~repro_torch.kernels._cuda.prepare`).

``bq`` and ``bk`` are the Pallas tiles, kept by the plain version; on the
card they do not change the result (a tile that is skipped or not gives
the same sums).
"""
from __future__ import annotations

import math

import torch

from .. import _cuda

NEG_INF = -1e30
#: the widest head of the kernels' one-chunk builds; wider heads run the
#: wide build
WIDE_D = 256


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
    """q,k,v: [B, H, S, d] (kv pre-repeated for GQA), floating point.
    Returns [B,H,S,d] in the type of ``q``."""
    if not _cuda.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     bq=bq, bk=bk)
    out_dtype = q.dtype
    (q, k, v), _, _ = _cuda.prepare((q, k, v))
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    _cuda.require(q, "q", _cuda.FLOATS, (B, H, Sq, d))
    _cuda.require(k, "k", (q.dtype,), (B, H, Sk, d))
    _cuda.require(v, "v", (q.dtype,), (B, H, Sk, d))
    if window is not None and window < 1:
        raise ValueError(f"window={window}: a window holds at least one key")
    out = torch.empty_like(q)
    P, I, F32 = _cuda.P, _cuda.I, _cuda.F32
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Sq, Sk, d, int(causal), -1 if window is None else window,
            1.0 / math.sqrt(d))
    types = [P, P, P, P, I, I, I, I, I, I, I, F32]
    if tma_loadable(q, k, v):
        _cuda.launch("flash_attention_sm90", types, q.device, *args)
        flash_attention_fwd.sm90_launches += 1
        return out.to(out_dtype)
    _cuda.launch("flash_attention", types + [I], q.device, *args,
                 _cuda.DTYPE_CODE[q.dtype])
    if d > WIDE_D:
        flash_attention_fwd.wide_launches += 1
    elif q.dtype == torch.bfloat16:
        flash_attention_fwd.simt_bf16_launches += 1
    else:
        flash_attention_fwd.launches += 1
    return out.to(out_dtype)


def tma_loadable(q, k, v) -> bool:
    """Does ``flash_attention_sm90`` take these inputs?  bf16, ``d <=
    256`` a multiple of 8 (TMA row strides are multiples of 16 bytes) and
    16-byte aligned tensors."""
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and d <= WIDE_D and d % 8 == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v))


#: launches of the f32 CUDA-core kernel, the bf16 wgmma/TMA kernel, the
#: bf16 build of the CUDA-core kernel and its wide build (the plain
#: version launches nothing)
flash_attention_fwd.launches = 0
flash_attention_fwd.sm90_launches = 0
flash_attention_fwd.simt_bf16_launches = 0
flash_attention_fwd.wide_launches = 0
