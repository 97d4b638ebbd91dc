"""Pure-torch oracle: per-step gated linear attention scan."""
from __future__ import annotations

import torch


def mlstm_chunk_ref(q, k, v, lf, gi):
    """q,k: [BH,S,dk]; v: [BH,S,dv]; lf,gi: [BH,S,1].
    C_t = exp(lf_t)·C_{t-1} + i_t·k_t v_t^T ;  y_t = q_t @ C_t."""
    BH, S, dk = q.shape
    dv = v.shape[-1]
    C = torch.zeros((BH, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(S):
        C = torch.exp(lf[:, t].float())[..., None] * C \
            + (gi[:, t].float() * k[:, t].float())[..., None] \
            * v[:, t].float()[:, None, :]
        ys.append(torch.einsum("bk,bkv->bv", q[:, t].float(), C))
    return torch.stack(ys, 1).to(q.dtype), C
