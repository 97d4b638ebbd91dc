"""AdamW with dtype-configurable moment states and global-norm clipping.

Port of ``src/repro/optim/adamw.py``.  The parameters, gradients and
moments are mappings keyed alike (a model's ``named_parameters()``
names); the moments are f32 unless ``state_dtype`` says otherwise.  The
update is the reference's, in f32 per leaf, applied in place: the
parameters and the moments are overwritten by ``copy_`` under
``torch.no_grad()``, so that a model on the card needs no second copy of
its state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]
#: the moments' decay rates and the denominator's guard (the reference's)
B1, B2, EPS = 0.9, 0.95, 1e-8


def adamw_init(params: Tensors, state_dtype: str = "float32"
               ) -> Dict[str, object]:
    """Zero moments ``m`` and ``v`` beside each parameter, and the step
    ``count`` (int32, 0) on the parameters' device."""
    dt = getattr(torch, state_dtype)
    device = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def adamw_update(grads: Tensors, opt_state: Dict[str, object],
                 params: Tensors, *, lr, weight_decay: float = 0.1,
                 clip_norm: float = 1.0, gnorm=None
                 ) -> Tuple[Tensors, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step with the gradients clipped to ``clip_norm`` in
    global norm.  ``params`` and ``opt_state``'s moments are updated in
    place; returns (params, the new opt_state, ``{"grad_norm"}``).  The
    bias corrections ``1 - b**count`` are f32 tensors, as the reference's
    (Python floats would be doubles).  ``gnorm``: the global norm where
    ``grads`` are shards of the gradients (the mesh executor's), else
    :func:`global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = opt_state["count"] + 1
    cf = count.float()
    f32 = dict(dtype=torch.float32, device=cf.device)
    c1 = 1.0 - torch.tensor(B1, **f32) ** cf
    c2 = 1.0 - torch.tensor(B2, **f32) ** cf
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = m_all[name], v_all[name]
        m_new = B1 * m.float() + (1 - B1) * g
        v_new = B2 * v.float() + (1 - B2) * torch.square(g)
        mhat = m_new / c1
        vhat = v_new / c2
        p32 = p.float()
        step = mhat / (torch.sqrt(vhat) + EPS) + weight_decay * p32
        p.copy_(p32 - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, {"m": m_all, "v": v_all, "count": count}, \
        {"grad_norm": gnorm}
