"""GPipe-style pipeline parallelism over a mesh axis.

Port of ``src/repro/parallel/pipeline.py``.  The layer stack is split
into ``S`` contiguous stages, one per rank along ``axis``; microbatches
stream through, each stage's output sent to the next stage by
``dist.batch_isend_irecv`` on the axis's process group (where the
reference's ``ppermute`` rotates it).  Schedule: plain GPipe, ``M + S -
1`` ticks for ``M`` microbatches: at tick ``t`` stage 0 takes microbatch
``t`` and the last stage emits microbatch ``t - S + 1``; the bubble is
``(S - 1) / (M + S - 1)``.  Every stage computes at every tick, as the
reference's does.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _stage_params(tree, sid: int):
    """Stage ``sid``'s parameters of a tree whose leaves lead with the
    stage axis: a ``DTensor`` split over it holds only this stage's."""
    if isinstance(tree, dict):
        return {k: _stage_params(v, sid) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_params(v, sid) for v in tree)
    if isinstance(tree, DTensor):
        return tree.to_local()[0]
    return tree[sid]


def pipeline_apply(stage_fn: Callable, mesh, axis: str, params_stacked,
                   microbatches: torch.Tensor) -> torch.Tensor:
    """Run ``y_mb = stage_S(...stage_1(x_mb))`` for every microbatch.

    stage_fn(stage_params, x) -> y : one stage's computation (y has x's
    shape and type).
    params_stacked: tree whose leaves lead with ``S`` (stage i's params),
    whole on every rank or ``DTensor``s split over ``axis``.
    microbatches:   [M, ...] stacked microbatch inputs, the same on every
    rank.
    Returns [M, ...] outputs of the last stage, on every rank.
    """
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    sid = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (sid + 1) % S)
    prv = dist.get_global_rank(group, (sid - 1) % S)
    M = microbatches.shape[0]
    params = _stage_params(params_stacked, sid)
    h = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (the last one again past the end)
        inp = microbatches[min(t, M - 1)] if sid == 0 else h
        out = stage_fn(params, inp)
        # the last stage emits microbatch t - S + 1
        if sid == S - 1 and 0 <= t - (S - 1) < M:
            outs[t - (S - 1)] = out
        # rotate the activations to the next stage
        h = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, h, prv, group)])
        for r in reqs:
            r.wait()
    # only the last stage holds real outputs; the sum broadcasts them
    # (every other stage contributes zeros)
    outs = outs * float(sid == S - 1)
    dist.all_reduce(outs, group=group)
    return outs
