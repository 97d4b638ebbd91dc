"""The mesh executor: a model whose state lives sharded on a mesh of
several ranks, computing on plain tensors.

The state (the parameters, AdamW's ``m`` and ``v``) is ``DTensor``s
placed by :class:`~repro_torch.parallel.sharding.MeshRules`, so each
rank holds the bytes the reference's specs give it (ZeRO-3 over the fsdp
axes, and over ``model`` where a rule names it).  Each rank computes on
its rows of the batch (rows split over the fsdp axes, as ``batch_specs``
splits them; a sequence split over ``model`` is gathered first, and cut
again by the model under SP).  Where ``model`` has more than one rank,
the compute is split over it as the reference's ``ac`` constraints make
GSPMD split it (:class:`~repro_torch.parallel.split.ModelSplit`: heads,
FFN hidden, experts, RG-LRU channels, vocab and, under ``seq_shard``,
the sequence); with ``split=False``, or a ``model`` of one rank, each
rank runs whole layers.  The model asks this executor, through its hooks
(:class:`~repro_torch.models.model.Model`), for:

* **parameters**: each block, the embedding, the head and the norms
  gather theirs right before use (an all-gather over their sharded mesh
  dims, ``model`` excepted where the compute is split, unless the layer
  needs the parameter whole: the mLSTM's fused ``w_qkv`` and the sLSTM's
  gate-major ``w_x``, whose column blocks do not line up with heads and
  whose columns each rank regroups by its heads, and every parameter of
  a mixer whose heads the split cannot divide; a mixer's ``whole`` names
  them) and drop them after; under remat the recompute gathers
  again.  In the backward pass each gathered tensor's gradient, a partial
  sum on every rank, is reduced into its parameter's placements: a
  reduce-scatter over each gathered sharded mesh dim, then one all-reduce
  over all the replicated dims together (one flattened group), so that
  every replica of a shard receives the same bits.  That is the
  reference's ``pin_grads``.
* **MoE rows** (:meth:`MeshExecutor.moe_rows`): the reference routes all
  tokens of the batch at once in its global dispatch (expert capacity is
  ranked over all of them, and the load-balancing loss takes its
  statistics over all of them), and pins the capacity buffer split over
  the fsdp axes where the experts do not divide ``model``.  So the global
  MoE gathers every rank's router logits and rows, routes the whole
  batch alike on every rank, computes only this rank's slice of the
  capacity (of its experts, or of its block of ``d_ff``), gathers the
  slices' outputs and combines its own rows (with ``split=False`` it
  computes the whole capacity).  The grouped dispatch routes
  each row on its own, so it never gathers rows; its load-balancing
  loss adds its statistics over the ranks of the rows.
* **the loss**: ranks along a replicated mesh dim (``model``, unless the
  batch cannot be split) hold the same rows, so each rank's share of the
  loss is its rows' summed log-likelihood over the label count of the
  whole batch, divided by the number of ranks that hold those rows; the
  MoE terms, computed alike on every rank, by the number of ranks.  The
  shares add up to the one-device loss, and so do their gradients.

The kernels see plain local tensors, as on one device.  A mesh of one
rank needs no executor: the model keeps plain tensors.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import types
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .sharding import MeshRules, distribute, placements
from .split import Group, ModelSplit, MoERows, levels


class _Gather(torch.autograd.Function):
    """A parameter's local shard -> the whole tensor; backward: the whole
    tensor's gradient (each rank's partial sum) reduced into the shard's
    placements."""

    @staticmethod
    def forward(ctx, local, ex, pl, keep):
        ctx.ex, ctx.pl, ctx.keep = ex, pl, keep
        dt = DTensor.from_local(local, ex.mesh, pl, run_check=False)
        if keep is None:
            full = dt.full_tensor()
        else:  # whole but for mesh dim ``keep``'s split
            full = dt.redistribute(ex.mesh, [
                p if i == keep else Replicate()
                for i, p in enumerate(pl)]).to_local()
        # a replicated shard comes back as itself: a new tensor for
        # autograd
        return full.clone() if full.data_ptr() == local.data_ptr() \
            else full

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.reduce(g, ctx.pl, ctx.keep), None, None, None


class MeshExecutor:
    """Runs models on ``rules.mesh`` (a ``DeviceMesh`` of several ranks)."""

    def __init__(self, rules: MeshRules, split: bool = True):
        if not rules.sharded:
            raise ValueError("a mesh executor needs a mesh of several ranks")
        self.rules = rules
        self.split = split
        self.mesh = mesh = rules.mesh
        self.names = list(mesh.mesh_dim_names)
        self.size = mesh.size()
        self.coord = mesh.get_coordinate()
        self.specs = rules.named_param_specs()
        # the compute split over ``model`` (None: whole layers)
        self.tp_dim = self.names.index(rules.tp) if rules.tp else None
        n_tp = mesh.size(self.tp_dim) if self.tp_dim is not None else 1
        self._split = ModelSplit(
            mesh.get_group(self.tp_dim), n_tp, self.coord[self.tp_dim],
            rules.pcfg.seq_shard) \
            if split and n_tp > 1 else None
        # one group for each set of two or more mesh dims: the ranks that
        # differ only in those dims (every rank creates every group, in
        # the same order)
        nd = mesh.ndim
        self._groups: Dict[Tuple[int, ...], object] = {}
        for k in range(2, nd + 1):
            for dims in itertools.combinations(range(nd), k):
                rest = [d for d in range(nd) if d not in dims]
                n = math.prod(mesh.size(d) for d in dims)
                ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, n)
                self._groups[dims], _ = dist.new_subgroups_by_enumeration(
                    ranks.tolist())
        self.set_rows(1)

    # -- process groups --------------------------------------------------
    def group(self, dims: Sequence[int]):
        """The group of the ranks that differ from this one only in the
        mesh dims ``dims`` (None: no dims)."""
        dims = tuple(sorted(dims))
        if not dims:
            return None
        if len(dims) == 1:
            return self.mesh.get_group(dims[0])
        return self._groups[dims]

    def model_split(self):
        """The :class:`ModelSplit` the layers compute by, or None where
        each rank computes whole layers."""
        return self._split

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank of the mesh, in one reduction
        (the same bits on every rank)."""
        t = t.clone()
        dist.all_reduce(t, group=self.group(range(self.mesh.ndim)))
        return t

    # -- batch rows ------------------------------------------------------
    def set_rows(self, batch: int) -> None:
        """Split the rows of a batch of ``batch`` rows as ``batch_specs``
        does: over the fsdp axes that divide it, in mesh order."""
        entry = self.rules._fit(batch, self.rules.fsdp)
        axes = () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))
        self.row_dims = tuple(self.names.index(a) for a in axes)
        self.row_group = self.group(self.row_dims)
        self.n_row_shards = math.prod(self.mesh.size(d)
                                      for d in self.row_dims)
        self.row_index = dist.get_rank(self.row_group) \
            if self.row_group is not None else 0
        #: ranks that hold each row
        self.rep = self.size // self.n_row_shards

    def moe_rows(self):
        """The MoE's :class:`~repro_torch.parallel.split.MoERows` for the
        current rows: the row group, and the capacity split of the rules'
        ``moe_buf`` placement (none with ``split=False``: every rank then
        computes the whole capacity)."""
        rows = Group(self.row_group, self.n_row_shards, self.row_index) \
            if self.row_group is not None else None
        return MoERows(rows, self._capacity_group if self.split
                       else lambda E, C: None)

    def _capacity_group(self, E: int, C: int):
        """The :class:`~repro_torch.parallel.split.Group` over which the
        reference's ``moe_buf`` rule splits a capacity of ``C`` rows of
        ``E`` experts (None: whole)."""
        entry = self.rules.moe_spec("moe_buf", (E, C, 1))[1]
        if entry is None:
            return None
        dims = tuple(self.names.index(a) for a in
                     ((entry,) if isinstance(entry, str) else entry))
        group = self.group(dims)
        return Group(group, math.prod(self.mesh.size(d) for d in dims),
                     dist.get_rank(group))

    def row_placements(self):
        return [Shard(0) if i in self.row_dims else Replicate()
                for i in range(self.mesh.ndim)]

    def local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of every leaf of ``batch`` (``DTensor``s, or
        full tensors alike on every rank), whole along every other
        dimension: a sequence split over ``model`` is gathered here,
        before attention.  Sets the row split from the batch's rows."""
        self.set_rows(next(iter(batch.values())).shape[0])
        return {k: self.rows_of(v) if isinstance(v, DTensor) else
                v.chunk(self.n_row_shards, dim=0)[self.row_index]
                for k, v in batch.items()}

    def own_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor."""
        return y.chunk(self.n_row_shards, dim=0)[self.row_index]

    def place_rows(self, t: torch.Tensor, spec) -> DTensor:
        """A ``DTensor`` placed by ``spec`` from this rank's rows ``t``
        (whole along every other dimension): the block of each dimension
        split over other mesh dims is cut locally."""
        dt = DTensor.from_local(t.contiguous(), self.mesh,
                                self.row_placements(), run_check=False)
        return dt.redistribute(self.mesh, placements(self.mesh, spec))

    def model_dim(self, dt: DTensor):
        """The tensor dim that ``dt`` splits over ``model`` (None)."""
        p = dt.placements[self.tp_dim] if self.tp_dim is not None else None
        return p.dim if isinstance(p, Shard) else None

    def place_logits(self, logits: torch.Tensor) -> DTensor:
        """This rank's logits ``[B_rows, S, V or V/n]`` as a ``DTensor``
        split by rows (and by vocab over ``model`` where it is split)."""
        pl = self.row_placements()
        if self._split is not None and \
                logits.shape[-1] < self.rules.cfg.padded_vocab:
            pl[self.tp_dim] = Shard(logits.dim() - 1)
        return DTensor.from_local(logits, self.mesh, pl, run_check=False)

    def place_caches(self, caches, dims):
        """Caches of this rank's rows, each tensor held over ``model`` as
        its layout in ``dims`` says (None: whole;
        :meth:`~repro_torch.parallel.split.ModelSplit.relayout`), as
        ``DTensor``s placed by the rules' cache specs: each is cut or
        gathered over ``model`` to its spec's split."""
        ac = self._split

        def whole(t, d):  # the whole tensor's shape, for its spec
            shape = list(t.shape)
            shape[0] *= self.n_row_shards
            for dim, ways in levels(d, ac.n):
                shape[dim] *= ways
            return types.SimpleNamespace(shape=tuple(shape), ndim=t.ndim)
        specs = self.rules.cache_specs([
            {n: whole(t, d[n]) for n, t in c.items()}
            for c, d in zip(caches, dims)])
        out = []
        for c, d, s in zip(caches, dims, specs):
            placed = {}
            for n, t in c.items():
                pl = placements(self.mesh, s[n])
                want = pl[self.tp_dim].dim \
                    if isinstance(pl[self.tp_dim], Shard) else None
                placed[n] = DTensor.from_local(
                    ac.relayout(t, d[n], want).contiguous(), self.mesh, pl,
                    run_check=False)
            out.append(placed)
        return out

    def greedy(self, logits: DTensor) -> torch.Tensor:
        """The greedy tokens ``[B_rows, 1]`` of this rank's rows from the
        logits of a step (:meth:`place_logits`): the argmax of each row's
        last position, taken across the vocab split where there is one."""
        local = logits.to_local()[:, -1]
        if self.model_dim(logits) is None:
            return local.argmax(-1)[:, None]
        return self._split.argmax(local)[:, None]

    def rows_of(self, dt: DTensor) -> torch.Tensor:
        """This rank's rows of ``dt``, whole along every other dimension."""
        return dt.redistribute(self.mesh, self.row_placements()).to_local()

    # -- parameters ------------------------------------------------------
    def shard(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, DTensor]:
        """Whole tensors by parameter name (the same on every rank; the
        parameters, or a moment) -> ``DTensor``s placed like the
        parameters."""
        return {n: distribute(t.detach(), self.mesh, self.specs[n])
                for n, t in tensors.items()}

    def adopt(self, model: nn.Module, params: Dict[str, DTensor]
              ) -> nn.Module:
        """Make ``params`` (``DTensor``s by name) the model's parameters
        and bind the model to this executor."""
        for name, dt in params.items():
            owner, attr = _owner(model, name)
            owner._parameters[attr] = nn.Parameter(dt)
        return self.bind(model)

    def shard_model(self, model: nn.Module) -> nn.Module:
        """Replace every parameter of ``model`` (whole, the same on every
        rank) by its ``DTensor`` placed by the rules, and bind the model
        to this executor."""
        return self.adopt(model, self.shard(dict(model.named_parameters())))

    def bind(self, model: nn.Module) -> nn.Module:
        """Point the model's hooks (the model, its blocks, its encoder) at
        this executor."""
        model.executor = self
        for blk in model.blocks:
            blk.executor = self
        if model.enc is not None:
            model.enc.executor = self
        return model

    def zeros_like(self, p: DTensor, dtype: torch.dtype) -> DTensor:
        return DTensor.from_local(
            torch.zeros(p.to_local().shape, dtype=dtype,
                        device=p.to_local().device),
            self.mesh, p.placements, run_check=False)

    @contextlib.contextmanager
    def gathered(self, module: nn.Module, names=None):
        """Within the context, ``module``'s parameters (only its own ones
        in ``names``, where given) are gathered from their shards with the
        gradient's reduction attached: whole, or this rank's block of
        their ``model`` split where the compute is split (unless their
        module's ``whole(n)`` names them: the parameters its layer needs
        whole on a split of ``n`` ranks)."""
        items = [(module, n) for n in names] if names is not None else \
            [(m, n) for m in module.modules() for n in m._parameters]
        saved = []
        try:
            for m, n in items:
                p = m._parameters[n]
                if isinstance(p, DTensor):
                    saved.append((m, n, p))
                    pl = tuple(p.placements)
                    whole = getattr(m, "whole", None)
                    keep = self.tp_dim if (
                        self._split is not None
                        and not (whole and n in whole(self._split.n))
                        and isinstance(pl[self.tp_dim], Shard)) else None
                    m._parameters[n] = _Gather.apply(p.to_local(), self, pl,
                                                     keep)
            yield
        finally:
            for m, n, p in saved:
                m._parameters[n] = p

    def reduce(self, g: torch.Tensor, pl, keep=None) -> torch.Tensor:
        """Each rank's partial gradient of a gathered tensor (whole, or
        this rank's block of mesh dim ``keep``'s split), summed over the
        mesh into this rank's block under placements ``pl``: a
        reduce-scatter over each other sharded mesh dim, then one
        all-reduce over the replicated ones together."""
        nd = self.mesh.ndim
        dt = DTensor.from_local(g.contiguous(), self.mesh,
                                [pl[i] if i == keep else Partial()
                                 for i in range(nd)], run_check=False)
        local = dt.redistribute(self.mesh, [
            p if isinstance(p, Shard) else Partial() for p in pl]).to_local()
        rest = [i for i, p in enumerate(pl) if not isinstance(p, Shard)]
        if rest:
            if local.data_ptr() == g.data_ptr():
                local = local.clone()
            dist.all_reduce(local, group=self.group(rest))
        return local

    # -- the train step's pieces -----------------------------------------
    def loss_share(self, model, batch, remat: bool) -> torch.Tensor:
        """This rank's share of the loss on its rows ``batch`` (with its
        graph); the shares of all ranks add up to the loss of the whole
        batch."""
        nll, count, per_group = model.train_terms(batch, remat=remat)
        count = count.detach().clone()
        if self.row_group is not None:
            dist.all_reduce(count, group=self.row_group)
        loss = nll / torch.clamp(count, min=1.0) / self.rep
        if per_group:
            loss = loss + 0.01 * sum(per_group) / len(per_group) / self.size
        return loss

    def global_norm(self, grads: Dict[str, DTensor]) -> torch.Tensor:
        """The gradients' global L2 norm, in f32, the same bits on every
        rank: each parameter's sum of squares counted once per shard (by
        the replica at coordinate 0 of its replicated dims), all of them
        summed over the mesh in one reduction."""
        sq = []
        for g in grads.values():
            owner = all(self.coord[i] == 0
                        for i, p in enumerate(g.placements)
                        if not isinstance(p, Shard))
            loc = g.to_local()
            sq.append(torch.sum(torch.square(loc.float())) if owner
                      else torch.zeros((), device=loc.device))
        return torch.sqrt(sum(self.all_reduce(torch.stack(sq)).unbind()))


def _owner(model: nn.Module, name: str):
    """(the module holding parameter ``name``, its attribute name)."""
    *path, attr = name.split(".")
    mod = model
    for part in path:
        mod = getattr(mod, part)
    return mod, attr
