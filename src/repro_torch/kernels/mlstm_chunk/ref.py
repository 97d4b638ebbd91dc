"""Pure-torch oracles: per-step gated linear attention scan, and the same
function in chunks (the one the op's backward differentiates)."""
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


def mlstm_chunk_chunked_ref(q, k, v, lf, gi, bt: int = 128):
    """:func:`mlstm_chunk_ref`'s function in chunks of ``bt`` steps,
    after the JAX model's ``chunk_step`` (``mlstm_chunked`` in
    ``src/repro/models/layers.py``): per chunk, with ``L`` the cumulative
    log-forget from its start,

        y = e^{L_t} q_t C_in + Σ_{u≤t} (q_t·k_u) e^{L_t - L_u} i_u v_u
        C_out = e^{L_end} C_in + Σ_u e^{L_end - L_u} i_u k_u v_uᵀ,

    the inter-chunk term from the carried state, the intra-chunk term under
    the causal decay mask, the state updated once.  Autograd through it
    keeps a chunk's tensors where the per-step oracle keeps a step's (the
    state ``[BH, dk, dv]`` once per chunk instead of once per step).  The
    decay's exponent is masked above the diagonal before ``exp``, so that
    no infinity there meets a zero gradient.  In f32, or f64 where ``q`` is
    f64; a partial last chunk runs over its own steps."""
    BH, S, dk = q.shape
    dv = v.shape[-1]
    bt = min(bt, S)
    wt = torch.float64 if q.dtype == torch.float64 else torch.float32
    C = torch.zeros((BH, dk, dv), dtype=wt, device=q.device)
    ys = []
    for t0 in range(0, S, bt):
        sl = slice(t0, t0 + bt)
        qc, kc, vc = (t[:, sl].to(wt) for t in (q, k, v))
        L = torch.cumsum(lf[:, sl, 0].to(wt), dim=1)         # [BH, n]
        g = gi[:, sl, 0].to(wt)                              # [BH, n]
        n = L.shape[1]
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=q.device).tril()
        decay = torch.exp(torch.where(causal, L[:, :, None] - L[:, None, :],
                                      -torch.inf))           # [BH, t, u]
        s = qc @ kc.transpose(1, 2)
        ys.append(torch.exp(L)[..., None] * (qc @ C)
                  + (s * decay * g[:, None, :]) @ vc)
        w_end = torch.exp(L[:, -1:] - L) * g                 # [BH, n]
        C = torch.exp(L[:, -1])[:, None, None] * C \
            + (kc * w_end[..., None]).transpose(1, 2) @ vc
    return torch.cat(ys, 1).to(q.dtype), C
