"""The JAX package's parameter tree as the port's ``state_dict``, and back.

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
to run both packages on the same weights.  The tree's leaves may also be
torch tensors (a checkpoint read by :mod:`repro_torch.checkpoint`); a
layer's tensor is then a view of the stacked leaf.

``params_to_jax(state_dict, cfg)`` is the inverse: the tree of the JAX
package's layout, each group's leaves stacked over its repeat axis, from
any mapping keyed like the ``state_dict`` (the parameters, their
gradients, AdamW's moments), with torch tensors as leaves.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig


def _flat(tree: Mapping, prefix: str, index=None) -> Dict[str, object]:
    out = {}
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            out.update(_flat(leaf, key + ".", index))
        else:
            leaf = leaf if isinstance(leaf, torch.Tensor) \
                else np.asarray(leaf)
            out[key] = leaf if index is None else leaf[index]
    return out


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    # np.array copies: a view of a read-only JAX buffer is not writable
    return torch.from_numpy(np.array(leaf))


def params_from_jax(tree: Mapping, cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``Model(cfg)`` holding the JAX tree's values."""
    flat = {"embed": tree["embed"]}
    flat.update(_flat(tree["final_norm"], "final_norm."))
    if "lm_head" in tree:
        flat["lm_head"] = tree["lm_head"]
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
    return {k: _tensor(v) for k, v in flat.items()}


def _layer_keys(cfg: ModelConfig) -> List[List[List[str]]]:
    """``[group][slot]`` -> the ``state_dict`` prefixes of the slot's
    layers, one per repeat."""
    out, layer = [], 0
    for repeat, body in cfg.layer_groups:
        slots = [[] for _ in body]
        for _ in range(repeat):
            for i in range(len(body)):
                slots[i].append(f"blocks.{layer}.")
                layer += 1
        out.append(slots)
    return out


def _nest(flat: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    """The entries of ``flat`` under ``prefix`` as nested dicts, split at
    the dots."""
    out: Dict = {}
    for key, t in flat.items():
        if not key.startswith(prefix):
            continue
        *path, name = key[len(prefix):].split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[name] = t
    return out


def _stacked(flat: Mapping[str, torch.Tensor], prefixes: List[str],
             device) -> Dict:
    """The nested leaves of one slot, each stacked over ``prefixes`` (the
    slot's layers) into a new tensor on ``device`` (the layers' own when
    None), one layer copied in at a time."""
    layers = [_nest(flat, p) for p in prefixes]

    def stack(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: stack([n[k] for n in nodes]) for k in first}
        out = torch.empty((len(nodes),) + tuple(first.shape),
                          dtype=first.dtype,
                          device=first.device if device is None else device)
        for r, t in enumerate(nodes):
            out[r].copy_(t.detach())
        return out
    return stack(layers)


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  device: Optional[torch.device] = None) -> Dict:
    """The JAX package's tree of ``state_dict`` (``Model.state_dict()``
    keys; any mapping of them, such as gradients or optimizer moments):
    ``embed``, ``final_norm``, ``lm_head``, ``frontend``, ``groups[g]
    ["slot{i}"]`` with each leaf stacked over the group's repeats, and an
    encoder–decoder model's ``enc``.  Every leaf is a new tensor on
    ``device`` (the inputs' own when None): ``device="cpu"`` copies a
    model on the card to the host one stacked leaf at a time."""
    def copy(t):
        t = t.detach()
        return t.to(device, copy=True) if device is not None else t.clone()

    flat = dict(state_dict)
    tree: Dict = {name: copy(flat[name]) for name in ("embed", "lm_head")
                  if name in flat}
    tree["final_norm"] = {k: copy(t) for k, t in
                          _nest(flat, "final_norm.").items()}
    if "frontend.proj" in flat:
        tree["frontend"] = {"proj": copy(flat["frontend.proj"])}
    tree["groups"] = [{f"slot{i}": _stacked(flat, prefixes, device)
                       for i, prefixes in enumerate(slots)}
                      for slots in _layer_keys(cfg)]
    if cfg.encoder_decoder:
        tree["enc"] = {
            "groups": [{"slot0": _stacked(
                flat, [f"enc.blocks.{r}." for r in range(cfg.enc_layers)],
                device)}],
            "final_norm": {k: copy(t) for k, t in
                           _nest(flat, "enc.final_norm.").items()}}
    return tree
