"""Chunked gated linear attention — the mLSTM matrix-memory core.

Semantics (per batch-head, unstabilized, f32):

    C_t = f_t * C_{t-1} + i_t * k_t v_t^T          (C: [dk, dv])
    y_t = q_t @ C_t

Time runs in chunks of ``bt``: within a chunk the intra-chunk term is a
decay-masked attention ``(q k^T ∘ Λ) v`` and the inter-chunk term is
``(λ_t q_t) @ C_in``, the state updated once per chunk.  Gates arrive as
per-step log-decay ``lf`` and input gate ``gi``.

Port of ``src/repro/kernels/mlstm_chunk/kernel.py`` (``mlstm_chunk_fwd``).
The CUDA source (``csrc/kernels/mlstm_chunk.cu``) splits a call into three
kernels by what depends on the state: per chunk, all in parallel, the
decays and the masked scores ``P = (q k^T) o W`` over the causal triangle;
the state walked chunk by chunk (``C = e^{L_end} C + kw^T v`` from
register tiles, 256 blocks at xlstm-125m), writing each chunk's incoming
state; and per chunk, all in parallel again, ``y = e^{L} q C_in + P v``.
The wrapper allocates their scratch (the chunks' states, ``P`` and the
decays).  Chunks run at ``min(bt, 128)`` steps: a larger ``bt`` runs as
chunks of 128, the same function in another rounding order.  Any other
floating type (float16, or operands of mixed types) computes in f32 and
returns the type of ``q`` (:func:`~repro_torch.kernels._cuda.prepare`).
"""
from __future__ import annotations

import torch

from .. import _cuda

#: the longest chunk the kernels run (their tiles' rows); longer chunks
#: run as chunks of this many steps
MAX_CHUNK = 128


def mlstm_chunk_plain(q, k, v, lf, gi, *, bt: int = 128):
    """The Pallas body in eager torch, batch-heads side by side: chunks of
    ``bt`` steps in order, the f32 state carried between them.  A partial
    last chunk computes over its own steps only."""
    BH, S, dk = q.shape
    dv = v.shape[-1]
    bt = min(bt, S)
    C = torch.zeros((BH, dk, dv), dtype=torch.float32, device=q.device)
    y = torch.empty((BH, S, dv), dtype=q.dtype, device=q.device)
    for t0 in range(0, S, bt):
        sl = slice(t0, t0 + bt)
        qt, kt, vt = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        gt = gi[:, sl].float()                         # [BH, n, 1]
        lcum = torch.cumsum(lf[:, sl].float(), dim=1)  # [BH, n, 1]
        total = lcum[:, -1:]                           # [BH, 1, 1]
        y_inter = torch.exp(lcum) * (qt @ C)
        s = qt @ kt.transpose(1, 2)
        n = qt.shape[1]
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=q.device).tril()
        w = torch.where(causal, torch.exp(lcum - lcum.transpose(1, 2))
                        * gt.transpose(1, 2), 0.0)
        y[:, sl] = (y_inter + (s * w) @ vt).to(q.dtype)
        kw = kt * (torch.exp(total - lcum) * gt)
        C = torch.exp(total) * C + kw.transpose(1, 2) @ vt
    return y, C


def mlstm_chunk_fwd(q, k, v, lf, gi, *, bt: int = 128):
    """q,k: [BH, S, dk]; v: [BH, S, dv] (floating point); lf, gi:
    [BH, S, 1].  Returns (y [BH,S,dv] in the type of ``q``, C_final
    [BH,dk,dv] f32)."""
    if not _cuda.on_cuda(q, k, v, lf, gi):
        return mlstm_chunk_plain(q, k, v, lf, gi, bt=bt)
    out_dtype = q.dtype
    (q, k, v), (lf, gi), _ = _cuda.prepare((q, k, v), f32=(lf, gi))
    BH, S, dk = q.shape
    dv = v.shape[-1]
    _cuda.require(q, "q", _cuda.FLOATS, (BH, S, dk))
    _cuda.require(k, "k", (q.dtype,), (BH, S, dk))
    _cuda.require(v, "v", (q.dtype,), (BH, S, dv))
    _cuda.require(lf, "lf", (torch.float32,), (BH, S, 1))
    _cuda.require(gi, "gi", (torch.float32,), (BH, S, 1))
    if bt < 1:
        raise ValueError(f"bt={bt}: a chunk holds at least one step")
    L = min(bt, S, MAX_CHUNK)
    nc = -(-S // L)
    dev = q.device
    y = torch.empty((BH, S, dv), dtype=q.dtype, device=dev)
    c_final = torch.empty((BH, dk, dv), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = (torch.empty((BH, nc, MAX_CHUNK, MAX_CHUNK), **f32),  # P
               torch.empty((BH, nc, dk, dv), **f32),   # each chunk's C_in
               torch.empty((BH, nc, MAX_CHUNK), **f32),   # e^{L}
               torch.empty((BH, nc, MAX_CHUNK), **f32),   # e^{L_end - L} i
               torch.empty((BH, nc), **f32))              # e^{L_end}
    P, I = _cuda.P, _cuda.I
    _cuda.launch("mlstm_chunk", [P] * 12 + [I] * 6, dev,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                 gi.data_ptr(), y.data_ptr(), c_final.data_ptr(),
                 *(t.data_ptr() for t in scratch), BH, S, dk, dv, L,
                 _cuda.DTYPE_CODE[q.dtype])
    mlstm_chunk_fwd.launches += 1
    return y.to(out_dtype), c_final


def executed_ops(BH: int, S: int, dk: int, dv: int, bt: int = 128) -> int:
    """Floating-point operations (2 a multiply-add) the three CUDA kernels
    execute, tiles and padding included: per chunk the 10 of 16 32 x 32
    score blocks on or below the diagonal over dk rounded up to the 32-wide
    slices; the state update over 384-row and 48-column tiles and 16-step
    slices; the outputs over 128-column tiles, dk rounded up to the
    64-wide slices and 3/4 of ``P v``'s 128 x 128 square (the warps whose
    rows all lie above a 64-step slice skip it)."""
    L = min(bt, S, MAX_CHUNK)
    nc = -(-S // L)
    up = lambda x, m: -(-x // m) * m   # noqa: E731
    ch = MAX_CHUNK
    scores = 10 * 32 * 32 * up(dk, 32)
    state = up(dk, 384) * up(dv, 48) * up(L, 16)
    out = ch * up(dv, 128) * (up(dk, 64) + ch * 3 // 4)
    return 2 * BH * nc * (scores + state + out)


#: kernel launches (the plain version launches nothing)
mlstm_chunk_fwd.launches = 0
