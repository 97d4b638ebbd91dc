"""Every rank of a mesh, run in one process: the layers' own mesh code on
simulated ranks, whose collectives exchange tensors in memory.

On a mesh the MoE and the recurrent mixers split by share functions of a
rank's index and the split's size
(:func:`~repro_torch.models.layers.moe_capacity_share`,
:func:`~repro_torch.models.layers.moe_grouped_share`,
:func:`~repro_torch.models.layers.mlstm_scan_share`,
:func:`~repro_torch.models.layers.mlstm_chunked_share`,
:func:`~repro_torch.models.layers.slstm_share`), which the layers
(:func:`~repro_torch.models.layers.moe_ffn_global`,
:func:`~repro_torch.models.layers.moe_ffn_grouped`, the mixers'
``_split_mixer``) call with this rank's index and put together with
collectives.  The functions here run those layers once for every rank of
a ``("data", "model")`` mesh of the given sizes, each on its rows and on
the blocks of the parameters that :class:`MeshRules` gives it, in threads
of this process that take turns: a thread runs until it waits in a
collective, and a collective is the concatenation, the rank-order sum or
the elementwise max of the members' tensors.  So one device, a card or
the CPU, runs what a mesh runs, kernels included, and holds it against
the one-device layer.
"""
from __future__ import annotations

import functools
import threading
import types
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..configs.base import MLSTM, SLSTM, ModelConfig, ParallelCfg
from ..models import layers as L
from ..models.model import head_logits, token_nll
from .sharding import MeshRules
from .split import Group, ModelSplit, MoERows, assemble, block, greedy


def rules_for(cfg: ModelConfig, data: int, model: int) -> MeshRules:
    """The rules of a ``(data, model)`` mesh (no process group)."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(data, model))
    return MeshRules(cfg, ParallelCfg(), mesh)


def model_blocks(p: Mapping[str, torch.Tensor], rules: MeshRules,
                 index: int, whole=frozenset()) -> Dict[str, torch.Tensor]:
    """Rank ``index`` of ``model``'s blocks of one layer's whole parameters
    ``p``: each cut along the dim that its rule splits over ``model``
    (whole where none does, and for the names in ``whole``)."""
    n = rules.axis_size[rules.tp]
    out = {}
    for name, t in p.items():
        spec = rules._core_rule(name, tuple(t.shape))
        d = next((i for i, e in enumerate(spec) if e == rules.tp), None)
        out[name] = t if d is None or name in whole else \
            t.chunk(n, dim=d)[index]
    return out


class _Ranks:
    """Simulated ranks: one thread each, one running at a time (the one
    that holds the lock; waiting in a collective lets the others run), so
    their launches go out one after another on the same stream."""

    def __init__(self):
        self.cond = threading.Condition()
        self.rounds: Dict[tuple, list] = {}
        self.calls: Dict[tuple, int] = {}
        self.done: set = set()
        self.error: Optional[BaseException] = None

    def exchange(self, key, n: int, index: int, t) -> list:
        """Every member's ``t`` in this call of group ``key`` (the members
        call a group's collectives in the same order), by index."""
        c = self.calls.get((key, index), 0)
        self.calls[key, index] = c + 1
        slot = self.rounds.setdefault((key, c), [[None] * n, n])
        slot[0][index] = t
        self.cond.notify_all()

        def gone():  # members that ended without this call
            return [i for i, s in enumerate(slot[0])
                    if s is None and (key, i) in self.done]
        self.cond.wait_for(lambda: self.error is not None or gone()
                           or all(s is not None for s in slot[0]))
        if self.error is not None:
            raise RuntimeError("another simulated rank failed")
        if gone():
            raise RuntimeError(f"ranks {gone()} of {key} ended before "
                               "the collective")
        parts = list(slot[0])
        slot[1] -= 1
        if not slot[1]:
            del self.rounds[key, c]
        return parts

    def run(self, fns: Sequence[Callable], keys: Sequence[Sequence[tuple]]
            ) -> list:
        """``fns[i]()`` of every rank; ``keys[i]``: the ``(group key,
        index)`` memberships of rank ``i``."""
        out = [None] * len(fns)
        grad = torch.is_grad_enabled()

        def body(i):
            with self.cond:
                try:
                    with torch.set_grad_enabled(grad):
                        out[i] = fns[i]()
                except BaseException as e:  # handed to the caller
                    self.error = self.error or e
                finally:
                    self.done.update(keys[i])
                    self.cond.notify_all()
        threads = [threading.Thread(target=body, args=(i,))
                   for i in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.error is not None:
            raise self.error
        return out


class _Local:
    """A :class:`Group`'s collectives among simulated ranks (``group``:
    ``(ranks, key)``), in rank order."""

    def gather(self, t, dim: int):
        ranks, key = self.group
        return torch.cat(ranks.exchange(key, self.n, self.index, t), dim)

    def sum(self, t):
        ranks, key = self.group
        parts = ranks.exchange(key, self.n, self.index, t)
        out = parts[0]
        for s in parts[1:]:
            out = out + s
        return out

    def max(self, t):
        ranks, key = self.group
        parts = ranks.exchange(key, self.n, self.index, t.detach())
        return torch.stack(parts).amax(0)


class _LocalGroup(_Local, Group):
    pass


class _LocalSplit(_Local, ModelSplit):
    pass


def _mesh(rules: MeshRules, fn) -> list:
    """``fn(d, m, rows, ac)`` of every rank ``(d, m)`` of ``rules``' mesh,
    data-major: ``rows`` its data group (None for one data rank), ``ac``
    its ``model`` split (None for one ``model`` rank), as the executor
    hands them to the layers."""
    n_d, n_m = rules.axis_size["data"], rules.axis_size["model"]
    ranks = _Ranks()
    fns, keys = [], []
    for d in range(n_d):
        for m in range(n_m):
            rows = _LocalGroup((ranks, ("data", m)), n_d, d) \
                if n_d > 1 else None
            ac = _LocalSplit((ranks, ("model", d)), n_m, m, False) \
                if n_m > 1 else None
            fns.append(functools.partial(fn, d, m, rows, ac))
            keys.append(((("data", m), d), (("model", d), m)))
    return ranks.run(fns, keys)


def _rows_of(outs: list, n_m: int) -> torch.Tensor:
    """The whole batch from each data rank's output (every ``model`` rank
    of a data rank computes the same bits)."""
    for i, y in enumerate(outs):
        if not torch.equal(y, outs[i - i % n_m]):
            raise RuntimeError(f"model rank {i % n_m} differs from rank 0")
    return torch.cat(outs[::n_m])


def moe_global(x, p: Mapping[str, torch.Tensor], cfg: ModelConfig,
               rules: MeshRules) -> Tuple[torch.Tensor, dict]:
    """The global MoE (:func:`~repro_torch.models.layers.moe_ffn_global`)
    over the whole batch ``x [B, S, D]`` as the ranks of ``rules``' mesh
    run it: each data rank on its rows, each ``model`` rank on its
    experts or block of ``d_ff``, the capacity split over the data ranks
    where the ``moe_buf`` rule splits it.  Returns the output and
    ``{"n_capacity", "n_model", "ep"}``."""
    E, D = cfg.moe.n_experts, cfg.d_model
    n_d, n_m = rules.axis_size["data"], rules.axis_size["model"]

    def capacity(rows):
        def group(E, C):
            entry = rules.moe_spec("moe_buf", (E, C, D))[1]
            if entry not in (None, "data", ("data",)):
                raise ValueError(f"capacity over {entry}")
            return None if entry is None else rows
        return group

    def rank(d, m, rows, ac):
        return L.moe_ffn_global(x.chunk(n_d)[d], model_blocks(p, rules, m),
                                cfg, ac, MoERows(rows, capacity(rows)))
    y = _rows_of(_mesh(rules, rank), n_m)
    ep, cap, _ = rules.moe_spec(
        "moe_buf", (E, L.global_capacity(x.shape[0] * x.shape[1], cfg), D))
    return y, dict(n_capacity=rules._size(cap), n_model=n_m, ep=bool(ep))


def moe_grouped(x, p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                rules: MeshRules) -> torch.Tensor:
    """The grouped MoE (:func:`~repro_torch.models.layers.moe_ffn_grouped`)
    as the ranks of ``rules``' mesh run it: each data rank on its own
    rows, each ``model`` rank on its experts or block of ``d_ff``."""
    n_d, n_m = rules.axis_size["data"], rules.axis_size["model"]

    def rank(d, m, rows, ac):
        return L.moe_ffn_grouped(x.chunk(n_d)[d], model_blocks(p, rules, m),
                                 cfg, ac)
    return _rows_of(_mesh(rules, rank), n_m)


def lm_head(x, w, labels, cfg: ModelConfig, n: int, shard_logits: bool
            ) -> list:
    """The head over ``x [B, S, D]`` with ``w [D, V]`` as ``n`` ``model``
    ranks run it, ``w``'s vocab columns split over them: for each rank,
    its logits (:func:`~repro_torch.models.model.head_logits`: its vocab
    slice, or whole when ``shard_logits`` is false), each position's loss
    of ``labels`` (:func:`~repro_torch.models.model.token_nll`) and the
    greedy pick of each row's last position
    (:func:`~repro_torch.parallel.split.greedy`)."""
    V = cfg.padded_vocab

    def rank(d, m, rows, ac):
        logits = head_logits(x, w.chunk(n, dim=1)[m], ac, V, shard_logits)
        return (logits, token_nll(logits, labels, ac, V),
                greedy(logits[:, -1], ac, V))
    return _mesh(rules_for(cfg, 1, n), rank)


#: each recurrent mixer's layer, by form
_LAYERS = {(MLSTM, "scan"): L._mlstm_scan,
           (MLSTM, "chunked"): L.mlstm_chunked,
           (SLSTM, "scan"): L.slstm}


def mixer(kind: str, x, p: Mapping[str, torch.Tensor], cfg: ModelConfig,
          n: int, state: Optional[dict] = None, form: str = "scan",
          **kw) -> Tuple[torch.Tensor, dict]:
    """An mLSTM or sLSTM (``kind``; ``form`` ``"scan"`` or the mLSTM's
    ``"chunked"``, ``kw`` its ``chunk``) over ``x`` as ``n`` ``model``
    ranks run it: each rank's heads, or its block of one head, on its
    parameter blocks, from its block of ``state`` (whole, as one device
    holds it); the output (the same on every rank) and the states
    assembled from their layouts
    (:func:`~repro_torch.models.layers.state_layouts`)."""
    if L._head_split(kind, cfg, n) is None:
        raise ValueError(f"{n} ranks do not split {kind}'s "
                         f"{cfg.n_heads} heads")
    rules = rules_for(cfg, 1, n)
    whole = L.whole_params(kind, cfg, n)
    layouts = L.state_layouts(kind, cfg, n)
    layer = _LAYERS[kind, form]

    def rank(d, m, rows, ac):
        st = None if state is None else {
            k: block(t, layouts[k], n, m) for k, t in state.items()}
        return layer(x, model_blocks(p, rules, m, whole), cfg, st, ac=ac,
                     **kw)
    outs = _mesh(rules, rank)
    return _rows_of([y for y, _ in outs], n), {
        k: assemble([st[k] for _, st in outs], layouts[k], n)
        for k in layouts}
