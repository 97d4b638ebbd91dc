"""The one traffic generator: a cell file's parameters and the seed give
the inputs.  The seed orders and fills a fixed set of sizes, so that
every seed asks for the same work in another order."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch


def deck_lengths(p) -> List[int]:
    """The cell's prompt lengths, one per deck entry: the quantiles ``(i +
    0.5) / deck`` of a lognormal of median ``median`` and shape ``sigma``,
    clipped to ``[min, max]`` and rounded to a whole token."""
    if p["dist"] != "lognormal":
        raise ValueError(f"length distribution {p['dist']!r}: only "
                         "'lognormal' is known")
    n = p["deck"]
    unit = statistics.NormalDist()
    out = []
    for i in range(n):
        x = p["median"] * math.exp(p["sigma"] * unit.inv_cdf((i + 0.5) / n))
        out.append(round(min(max(x, p["min"]), p["max"])))
    return out


def tokens(rng: np.random.Generator, kind: str, vocab: int,
           shape: Tuple[int, ...]) -> np.ndarray:
    if kind != "uniform":
        raise ValueError(f"token distribution {kind!r}: only 'uniform' is "
                         "known")
    return rng.integers(0, vocab, shape, dtype=np.int64)


def deck_order(n: int, rounds: int, rng: np.random.Generator
               ) -> List[int]:
    """An order of the ``n`` ascending deck lengths in ``rounds`` rounds:
    round ``r`` holds lengths ``r, r + rounds, ...``, so each spans the
    whole distribution; the rounds, and the calls within each, in an
    order drawn from ``rng``.  A window that ends inside the deck has then
    asked for nearly the deck's mix."""
    out = []
    for r in rng.permutation(rounds):
        members = list(range(int(r), n, rounds))
        out += [members[i] for i in rng.permutation(len(members))]
    return out


def prefill_deck(t, seed: int, vocab: int) -> List[np.ndarray]:
    """The calls a prefill cell cycles through: ``deck`` token arrays
    ``[batch, length]``, the lengths of :func:`deck_lengths` in the order
    of :func:`deck_order` (``rounds`` of the lengths' parameters), each
    call's tokens drawn from ``seed`` too."""
    rng = np.random.default_rng(seed)
    lengths = deck_lengths(t["lengths"])
    order = deck_order(len(lengths), t["lengths"].get("rounds", 1), rng)
    return [tokens(rng, t["tokens"], vocab, (t["batch"], lengths[i]))
            for i in order]


def prefill_round(t, seed: int, r: int) -> List[int]:
    """The positions in ``seed``'s deck (:func:`prefill_deck`) of round
    ``r``'s calls: one call at each of that round's lengths, so every
    seed's round ``r`` asks for the same work."""
    p = t["lengths"]
    rounds = p.get("rounds", 1)
    order = deck_order(p["deck"], rounds, np.random.default_rng(seed))
    return [pos for pos, i in enumerate(order) if i % rounds == r]


class TrainFeed:
    """A training cell's batches: ``batch_at(step)`` gives ``{"tokens":
    [batch, seq_len]}`` on ``device``, a pure function of (seed, step), so
    the reference can take the same rows again."""

    def __init__(self, t, seed: int, vocab: int, device):
        self.t, self.seed, self.vocab, self.device = t, seed, vocab, device

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng([int(self.seed), int(step)])
        rows = tokens(rng, self.t["tokens"], self.vocab,
                      (self.t["batch"], self.t["seq_len"]))
        return {"tokens": torch.from_numpy(rows).to(self.device)}
