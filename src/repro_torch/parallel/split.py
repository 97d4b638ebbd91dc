"""The compute split over the mesh's ``model`` dim: Megatron tensor
parallelism (TP), a sequence-parallel residual (SP) and expert
parallelism (EP), the port's counterpart of the reference's ``ac(...)``
constraints, from which GSPMD derives the same split.

A :class:`ModelSplit` is the ``ac`` hook that the mesh executor hands to
the model's layers when ``model`` has more than one rank (on one device,
and on a mesh whose ``model`` size is 1, the layers get None and run the
one-device path).  The layers' parameters are then this rank's blocks of
their ``model`` split (columns of ``wq``/``wk``/``wv``/``wg``/``wu``/
``w1``/``w_in_*``, rows of ``wo``/``wd``/``w2``/``w_out``, experts or
``d_ff`` of the MoE, ``conv_w``/``lam``/``w_r``/``w_i`` columns, vocab
rows of ``embed`` and columns of ``lm_head``), and the layers call:

* ``ac(x, "mm_input")``: under SP the residual holds this rank's slice of
  the sequence; it is gathered whole before a product;
* :meth:`gather`: a split activation made whole (a projection whose
  columns do not line up with heads, expert outputs, logits);
* :meth:`sum_seq`: a row-parallel product's partial sums added over
  ``model`` (the reference's ``attn_mix`` / ``ffn_hidden`` points): an
  all-reduce, or under SP a reduce-scatter over the sequence;
* :meth:`sum` / :meth:`max`: the vocab-parallel embedding, cross-entropy
  and greedy pick, and the log-sum-exp of a cache split by slots.

The logits stay split over the vocab where ``pcfg.shard_logits`` holds
(the reference's default); with it false they are gathered whole over
``model`` (:func:`~repro_torch.models.model.head_logits`), and the loss
and the greedy pick (:func:`greedy`) then take the whole vocab.

A tensor that the ``model`` ranks hold in blocks has a *layout*
(:meth:`ModelSplit.relayout`): None (whole), a dim ``d`` (``n`` blocks
along ``d``, block ``index`` on this rank), or a tuple of ``(dim,
ways)`` levels, major first, whose blocks the ranks take in order, each
block on ``n / prod(ways)`` neighbouring ranks (the mLSTM's heads and
value columns, the sLSTM's heads repeated where ``n`` exceeds them).

:class:`MoERows` is the MoE's view of the mesh's fsdp axes: the ranks
whose rows make up the batch (the global dispatch ranks the whole batch),
and the ranks over which the reference's ``moe_buf`` rule splits the
capacity of an ``[E, C, D]`` buffer.

Gradients.  Each rank's loss share is its rows' loss over the number of
ranks holding those rows (the executor's convention), so the shares of
all ranks add up to the loss; a collective's backward is then its adjoint
under that sum: an all-reduce's is an all-reduce, an all-gather's a
reduce-scatter, a reduce-scatter's an all-gather, and a replicated
activation's gradient stays each rank's partial one (summed later by an
all-reduce's backward, or by the parameters' reduction, which sums over
every mesh dim a parameter is replicated on).  So no parameter needs a
rule of its own: a ``model``-split parameter's gradient is reduced over
its fsdp dims only, and every other over ``model`` too.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    """Sum over the group; backward: the same sum of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """The blocks of every rank concatenated along ``dim``, in rank order;
    backward: the gradient summed over the ranks, this rank's block of
    it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    """The sum over the ranks, this rank's block of it along ``dim``;
    backward: the blocks' gradients gathered (an all-gather)."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None


def _all_gather(x, dim, group, n):
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x0.shape[0],) + tuple(x0.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim, group, n):
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((x0.shape[0] // n,) + tuple(x0.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


class Group:
    """A process group of ``n`` ranks and this rank's ``index`` in it,
    with the collectives the layers take over it."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index

    def gather(self, t, dim: int):
        """``t``'s blocks of every rank, concatenated along ``dim``."""
        return _AllGather.apply(t, dim % t.dim(), self.group, self.n)

    def own(self, t, dim: int):
        """This rank's block of a whole ``t`` along ``dim`` (a view)."""
        return t.chunk(self.n, dim=dim)[self.index]

    def sum(self, t):
        """The sum of ``t`` over the ranks, on every rank."""
        return _AllReduce.apply(t, self.group)


#: a layout of a tensor over the ``model`` ranks (see the module's text)
Layout = Union[None, int, Tuple[Tuple[int, int], ...]]


class ModelSplit(Group):
    """The ``model`` dim's process group, its size ``n`` and this rank's
    ``index`` on it, and whether the residual is split over the sequence
    (``seq``: ``pcfg.seq_shard`` and a length that ``n`` divides, set by
    :meth:`at` once the length is known)."""

    def __init__(self, group, n: int, index: int, seq_shard: bool,
                 seq: bool = False):
        super().__init__(group, n, index)
        self.seq_shard, self.seq = seq_shard, seq

    def at(self, seq_len: int) -> "ModelSplit":
        """This split for a residual of ``seq_len`` positions."""
        return ModelSplit(self.group, self.n, self.index, self.seq_shard,
                          self.seq_shard and seq_len % self.n == 0)

    # -- the reference's constraint point -------------------------------
    def __call__(self, x, kind: str):
        if kind != "mm_input":
            raise ValueError(f"unknown constraint {kind!r}")
        return self.gather(x, 1) if self.seq else x

    # -- collectives -----------------------------------------------------
    def sum_seq(self, t):
        """A row-parallel product's partial sums ``[B, S, D]`` added over
        the ranks: whole, or this rank's slice of the sequence under
        SP."""
        if self.seq:
            return _ReduceScatter.apply(t, 1, self.group, self.n)
        return self.sum(t)

    def max(self, t):
        """The elementwise max of ``t`` over the ranks (no gradient)."""
        t = t.detach().contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def relayout(self, t, have: Layout, want: Layout):
        """``t`` held under layout ``have`` -> under ``want``: gathered
        whole over ``model`` (unless it is whole), then this rank's
        block."""
        if levels(have, self.n) == levels(want, self.n):
            return t
        if levels(have, self.n):
            t = assemble(list(self.gather(t.unsqueeze(0), 0).unbind(0)),
                         have, self.n)
        return block(t, want, self.n, self.index)

    def argmax(self, logits):
        """The greedy pick over a vocab split over the ranks: each rank's
        largest logit and its index, then the largest of those (the lowest
        index among ties, as ``argmax`` picks).  ``logits [..., V/n]`` ->
        indices ``[...]`` into the whole vocab."""
        val, idx = logits.max(dim=-1, keepdim=True)
        idx = idx + self.index * logits.shape[-1]
        vals = self.gather(val.contiguous(), -1)              # [..., n]
        idxs = self.gather(idx.contiguous(), -1)
        best = vals.argmax(dim=-1, keepdim=True)              # first max
        return idxs.gather(-1, best)[..., 0]


def greedy(logits, ac: Optional[ModelSplit], vocab: int):
    """The greedy pick ``[...]`` over the last dim of ``logits``: the
    whole vocab of ``vocab`` entries, or this rank's slice of it, whose
    pick is taken across the ranks (:meth:`ModelSplit.argmax`)."""
    if ac is None or logits.shape[-1] == vocab:
        return logits.argmax(-1)
    return ac.argmax(logits)


def levels(layout: Layout, n: int) -> Tuple[Tuple[int, int], ...]:
    """``layout``'s ``(dim, ways)`` levels over ``n`` ranks (none:
    whole)."""
    if layout is None:
        return ()
    return ((layout, n),) if isinstance(layout, int) else tuple(layout)


def block(t, layout: Layout, n: int, index: int):
    """The block of a whole ``t`` that rank ``index`` of ``n`` holds under
    ``layout`` (a view)."""
    lv = levels(layout, n)
    i = index // (n // math.prod(w for _, w in lv))
    for j, (dim, ways) in enumerate(lv):
        t = t.chunk(ways, dim=dim)[
            i // math.prod(w for _, w in lv[j + 1:]) % ways]
    return t


def assemble(blocks: Sequence[torch.Tensor], layout: Layout, n: int):
    """The whole tensor from the ``n`` ranks' blocks under ``layout``, in
    rank order (a block that several ranks hold is taken once)."""
    lv = levels(layout, n)
    if not lv:
        return blocks[0]
    return _assemble(blocks[::n // math.prod(w for _, w in lv)], lv)


def _assemble(pieces: Sequence[torch.Tensor], lv) -> torch.Tensor:
    if not lv:
        return pieces[0]
    (dim, ways), rest = lv[0], lv[1:]
    m = len(pieces) // ways
    return torch.cat([_assemble(pieces[j * m:(j + 1) * m], rest)
                      for j in range(ways)], dim=dim)


class MoERows:
    """The MoE's view of the fsdp axes: ``rows``, the :class:`Group` of the
    ranks whose rows make up the batch, in order (None: every rank holds
    every row), and :meth:`capacity`, the :class:`Group` over which the
    reference's ``moe_buf`` rule splits the capacity of a buffer ``[E, C,
    D]`` (None: whole on every rank).  The executor makes one per batch
    (:meth:`~repro_torch.parallel.executor.MeshExecutor.moe_rows`)."""

    def __init__(self, rows: Optional[Group],
                 capacity: Callable[[int, int], Optional[Group]]):
        self.rows, self._capacity = rows, capacity

    def capacity(self, E: int, C: int) -> Optional[Group]:
        return self._capacity(E, C)
