"""Chunked gated linear attention — the mLSTM matrix-memory core.

Semantics (per batch-head, unstabilized, f32):

    C_t = f_t * C_{t-1} + i_t * k_t v_t^T          (C: [dk, dv])
    y_t = q_t @ C_t

Time runs in chunks of ``bt``: within a chunk the intra-chunk term is a
decay-masked attention ``(q k^T ∘ Λ) v`` and the inter-chunk term is
``(λ_t q_t) @ C_in``, the state updated once per chunk.  Gates arrive as
per-step log-decay ``lf`` and input gate ``gi``.

Port of ``src/repro/kernels/mlstm_chunk/kernel.py`` (``mlstm_chunk_fwd``).
The state of xlstm-125m (``dk = dv = 384``, 576 KB in f32) does not fit in
one block's shared memory, so the CUDA kernel (``csrc/kernels/mlstm_chunk.cu``)
splits ``dv`` across blocks: grid ``(dv / 64, BH)``, each block carrying its
``C[:, 64-column tile]`` over the chunks and recomputing the chunk's
``[bt, bt]`` score matrix, with ``q`` and ``k`` streamed in 32-wide ``dk``
slices.  It honours ``bt`` up to 128 and takes ``dk <= 640``.
"""
from __future__ import annotations

import torch

from .. import _cuda

#: the longest chunk and the widest key the kernel takes (its shared
#: memory holds a [dk, 64] f32 state slice beside the chunk's tiles)
MAX_BT, MAX_DK = 128, 640


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
    """q,k: [BH, S, dk]; v: [BH, S, dv] (f32 or bf16, one type); lf, gi:
    [BH, S, 1] f32.  Returns (y [BH,S,dv] in the input type, C_final
    [BH,dk,dv] f32)."""
    if not _cuda.on_cuda(q, k, v, lf, gi):
        return mlstm_chunk_plain(q, k, v, lf, gi, bt=bt)
    BH, S, dk = q.shape
    dv = v.shape[-1]
    _cuda.require(q, "q", _cuda.FLOATS, (BH, S, dk))
    _cuda.require(k, "k", (q.dtype,), (BH, S, dk))
    _cuda.require(v, "v", (q.dtype,), (BH, S, dv))
    _cuda.require(lf, "lf", (torch.float32,), (BH, S, 1))
    _cuda.require(gi, "gi", (torch.float32,), (BH, S, 1))
    bt = min(bt, S)
    if not 1 <= bt <= MAX_BT:
        raise ValueError(f"bt={bt}: the mLSTM kernel takes chunks of 1 to "
                         f"{MAX_BT} steps")
    if dk > MAX_DK:
        raise ValueError(f"dk={dk}: the mLSTM kernel takes dk <= {MAX_DK}")
    y = torch.empty((BH, S, dv), dtype=q.dtype, device=q.device)
    c_final = torch.empty((BH, dk, dv), dtype=torch.float32,
                          device=q.device)
    P, I = _cuda.P, _cuda.I
    _cuda.launch("mlstm_chunk", [P, P, P, P, P, P, P, I, I, I, I, I, I],
                 q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lf.data_ptr(), gi.data_ptr(), y.data_ptr(),
                 c_final.data_ptr(), BH, S, dk, dv, bt,
                 _cuda.DTYPE_CODE[q.dtype])
    mlstm_chunk_fwd.launches += 1
    return y, c_final


#: kernel launches (the plain version launches nothing)
mlstm_chunk_fwd.launches = 0
