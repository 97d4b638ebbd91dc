"""The numbers that decide ``correct``: each is a gap between what the
port's timed path produced and what the reference computes from the same
inputs, and each has a limit in the cell's file."""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

#: a leaf whose first gradient in the reference is under this share of the
#: median leaf's has nought to move it but round-off; its change is left
#: out of ``change_gap``
STILL_LEAF = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               names: Sequence[str]) -> Tuple[float, str]:
    """The largest gap between the port's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger; and that leaf."""
    med = statistics.median(ref[n] for n in names)
    gaps = [(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n)
            for n in names]
    return max(gaps)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: :func:`worst_leaf` of the first moment after the first
    step (the clipped first gradient, as the optimizer got it);
    ``change_gap``: :func:`worst_leaf` of each leaf's change after the
    steps, over the leaves that the reference's gradient moves
    (:data:`STILL_LEAF`).  ``prog`` and ``ref`` hold ``losses``, ``m1``
    and ``change``."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    names = sorted(ref["m1"])
    grad, grad_leaf = worst_leaf(prog["m1"], ref["m1"], names)
    med = statistics.median(ref["m1"][n] for n in names)
    moved = [n for n in names if ref["m1"][n] >= STILL_LEAF * med]
    change, change_leaf = worst_leaf(prog["change"], ref["change"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "still_leaves": len(names) - len(moved)}


def request_numbers(prog, ref, served) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per request (rows of ``prog``/``ref [n, vocab]`` and the served
    tokens ``[n]``): the RMS gap of the logits over the standard deviation
    of the reference's, and how far the served token's reference logit
    lies below the reference's best, in the same unit."""
    prog, ref = prog.float(), ref.float()
    sd = ref.std(dim=-1)
    err = (prog - ref).square().mean(-1).sqrt() / sd
    mine = ref.gather(-1, served.long().to(ref.device)[:, None])[:, 0]
    return err, (ref.max(dim=-1).values - mine) / sd


def logit_numbers(parts) -> Dict[str, float]:
    """Over every request of ``parts`` (``(prog, ref, served)`` blocks):
    ``logit_err`` and ``top_gap``, the largest of :func:`request_numbers`'
    two; ``logit_err_med``, the median logit gap; ``top_gap_mean``, the
    mean served-token gap."""
    errs, gaps = zip(*(request_numbers(*p) for p in parts))
    err, gap = torch.cat(errs), torch.cat(gaps)
    return {"logit_err": float(err.max()), "top_gap": float(gap.max()),
            "logit_err_med": float(err.median()),
            "top_gap_mean": float(gap.mean())}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].float().norm() for n in names]).tolist()
    return dict(zip(names, vals))
