"""A configuration's weights, drawn from the seed on the device.

The configuration's reference family lists its groups of like weights
(``groups(c)``: one matrix kind over every layer, the embedding, the
head; :mod:`portbench.reference.layout`).  Each group is one
``torch.randn`` call of a ``torch.Generator`` seeded from the run's seed
and the group's index, scaled, and cast to the type the model is served
in, so a group can be drawn again alone, with the same bits
(:func:`draw_group`).  The names are the keys of the port's
``state_dict``; the benchmark hands the same tensors to the port and to
the reference.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from .reference import family


def _seed(seed: int, index: int) -> int:
    return (int(seed) * 64 + index) % (2 ** 63)


def draw_group(c, seed: int, index: int, device
               ) -> Dict[str, torch.Tensor]:
    """Group ``index`` of the family's groups, by parameter name (views of
    one stacked ``[layers, ...]`` tensor for a group of layers), in the
    configuration's ``torch_dtype``."""
    name, layers, shape, scale = family(c).groups(c)[index]
    dtype = getattr(torch, c["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(_seed(seed, index))
    full = shape if layers is None else (layers, *shape)
    t = torch.randn(full, generator=gen, device=device,
                    dtype=torch.float32).mul_(scale).to(dtype)
    if layers is None:
        return {name: t}
    return {name.format(i): t[i] for i in range(layers)}


def iter_groups(c, seed: int, device) -> Iterator[Dict[str, torch.Tensor]]:
    for i in range(len(family(c).groups(c))):
        yield draw_group(c, seed, i, device)


def draw(c, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration, by parameter name."""
    out: Dict[str, torch.Tensor] = {}
    for g in iter_groups(c, seed, device):
        out.update(g)
    return out
