"""The JAX package's parameter tree as the port's ``state_dict``.

``params_from_jax(tree, cfg)`` takes the tree that the JAX
``init_params(key, cfg)`` returns, with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``): each layer group's leaves carry a
leading repeat axis for ``lax.scan``, and each group's body holds its blocks
as ``slot0``, ``slot1``, ...  The port holds one block per layer, in the
order of ``cfg.blocks()``, so layer ``l`` of group ``g`` at repeat ``r`` and
slot ``i`` reads ``tree["groups"][g][f"slot{i}"]`` at index ``r`` (a
decoder block with cross-attention carries its ``norm_cross`` and
``cross`` there too).  An encoder–decoder model's encoder is one group of
one slot: encoder layer ``r`` reads ``tree["enc"]["groups"][0]["slot0"]``
at index ``r``, and ``enc.final_norm`` reads ``tree["enc"]["final_norm"]``.
The tests load the result into :class:`~repro_torch.models.model.Model`
to run both packages on the same weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig


def _flat(tree: Mapping, prefix: str, index=None) -> Dict[str, np.ndarray]:
    out = {}
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            out.update(_flat(leaf, key + ".", index))
        else:
            out[key] = np.asarray(leaf if index is None else leaf[index])
    return out


def params_from_jax(tree: Mapping, cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``Model(cfg)`` holding the JAX tree's values."""
    flat = {"embed": np.asarray(tree["embed"])}
    flat.update(_flat(tree["final_norm"], "final_norm."))
    if "lm_head" in tree:
        flat["lm_head"] = np.asarray(tree["lm_head"])
    if "frontend" in tree:
        flat.update(_flat(tree["frontend"], "frontend."))
    layer = 0
    for (repeat, body), group in zip(cfg.layer_groups, tree["groups"]):
        for r in range(repeat):
            for i in range(len(body)):
                flat.update(_flat(group[f"slot{i}"], f"blocks.{layer}.", r))
                layer += 1
    if "enc" in tree:
        (slots,) = tree["enc"]["groups"]
        for r in range(cfg.enc_layers):
            flat.update(_flat(slots["slot0"], f"enc.blocks.{r}.", r))
        flat.update(_flat(tree["enc"]["final_norm"], "enc.final_norm."))
    # np.array copies: a view of a read-only JAX buffer is not writable
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
