"""Sharding rules: logical parallelism axes -> the mesh's named dims.

Port of ``src/repro/parallel/sharding.py``: the same rules, with the same
divisibility fallbacks and the same expert-parallel axis.  Logical axes:

  fsdp  -> ("pod", "data") ∩ mesh : ZeRO-3 parameter/optimizer sharding + DP
  tp    -> "model"                : Megatron column/row sharding
  sp    -> "model"                : sequence-parallel activations / caches
  ep    -> "model" when n_experts divides it, else expert-TP fallback

A spec is a tuple with one entry per tensor dimension: a mesh axis name,
a tuple of names (a dimension split over several axes, major first), or
None; a one-name tuple is written as the name, as ``PartitionSpec``
normalizes it, so a spec equals the reference's ``tuple(P(...))`` and
checkpoints carry the same JSON.  :meth:`MeshRules.placements` turns a
spec into ``DTensor`` placements, one per mesh dim.

The rules read only a mesh's axis names and sizes (:func:`mesh_axes`): a
``DeviceMesh``, anything with its ``mesh_dim_names`` and ``shape``, or a
single device (``torch.device`` or its name), which is the ``(1, 1)``
mesh ``("data", "model")``.  So they need no process group.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig, ParallelCfg
from ..models import registry as R

Spec = Tuple[Any, ...]

#: the mesh a single device is
ONE_DEVICE_AXES = {"data": 1, "model": 1}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of ``mesh`` (a device: the ``(1, 1)`` mesh)."""
    if isinstance(mesh, (torch.device, str)):
        return dict(ONE_DEVICE_AXES)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` spans more than one rank: the state then lives as
    ``DTensor`` shards; else as plain tensors on one device."""
    return not isinstance(mesh, (torch.device, str)) and mesh.size() > 1


def placements(mesh, spec: Spec) -> List:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named in entry ``d``, ``Replicate()`` on the others.  A
    dimension split over several axes must name them in mesh order
    (``DTensor`` splits by mesh dim, outermost first), as the production
    meshes' ``("pod", "data")`` does."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: entry {entry} is not in the "
                             f"mesh's order {names}")
        for i in dims:
            out[i] = Shard(d)
    return out


def local_chunk(t: torch.Tensor, mesh, pl, coord=None) -> torch.Tensor:
    """This rank's block (or that of the rank at mesh coordinate
    ``coord``) of the full tensor ``t`` under placements ``pl`` (a view;
    mesh dims in order, each splitting the block before)."""
    coord = mesh.get_coordinate() if coord is None else coord
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t


def _coordinates(mesh) -> List[List[int]]:
    """The mesh coordinate of each global rank, by rank (a mesh over
    every rank of the default group)."""
    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{world}")
    coords = [None] * world
    for idx in itertools.product(*(range(n) for n in mesh.shape)):
        coords[int(mesh.mesh[idx])] = list(idx)
    return coords


def gather_to(dt: DTensor, dst: int) -> Optional[torch.Tensor]:
    """The whole tensor of ``dt`` on global rank ``dst``, None on every
    other rank: each rank sends its block to ``dst`` alone (one
    ``gather``), which puts the blocks in place; no other rank holds more
    than its block."""
    mesh, pl = dt.device_mesh, dt.placements
    local = dt.to_local().contiguous()
    if dist.get_rank() != dst:
        dist.gather(local, None, dst=dst)
        return None
    blocks = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.gather(local, blocks, dst=dst)
    whole = torch.empty(dt.shape, dtype=local.dtype, device=local.device)
    for coord, blk in zip(_coordinates(mesh), blocks):
        local_chunk(whole, mesh, pl, coord).copy_(blk)
    return whole


def scatter_from(t: Optional[torch.Tensor], src: int, mesh, spec, shape,
                 dtype: torch.dtype, device) -> DTensor:
    """A ``DTensor`` placed by ``spec`` on ``mesh`` from the whole tensor
    ``t`` that global rank ``src`` holds (None on the other ranks): ``src``
    sends each rank its block alone (one ``scatter``)."""
    pl = placements(mesh, spec)
    block = local_chunk(torch.empty(shape, device="meta"), mesh, pl).shape
    out = torch.empty(block, dtype=dtype, device=device)
    parts = None
    if dist.get_rank() == src:
        parts = [local_chunk(t, mesh, pl, c).to(device, dtype).contiguous()
                 for c in _coordinates(mesh)]
    dist.scatter(out, parts, src=src)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def distribute(t: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """A ``DTensor`` of the full tensor ``t`` (the same on every rank)
    placed by ``spec``: each rank keeps a copy of its block, which holds
    none of the rest of ``t``; nothing is communicated."""
    pl = placements(mesh, spec)
    return DTensor.from_local(
        local_chunk(t, mesh, pl).clone(memory_format=torch.contiguous_format),
        mesh, pl, run_check=False)


class MeshRules:
    def __init__(self, cfg: ModelConfig, pcfg: ParallelCfg, mesh):
        self.cfg = cfg
        self.pcfg = pcfg
        self.mesh = mesh
        self.axis_size = mesh_axes(mesh)
        self.fsdp: Tuple[str, ...] = tuple(
            a for a in pcfg.fsdp_axes if a in self.axis_size)
        self.tp = pcfg.tp_axis if pcfg.tp_axis in self.axis_size else None

    @property
    def sharded(self) -> bool:
        return is_sharded(self.mesh)

    # -- helpers ---------------------------------------------------------
    def _size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self.axis_size[a]
        return n

    def _fit(self, dim: int, axes) -> Optional[Any]:
        """axes if dim divides their product, else None (replicate); a
        one-name tuple comes back as the name."""
        if axes is None:
            return None
        if dim % self._size(axes) == 0:
            return axes[0] if isinstance(axes, tuple) and len(axes) == 1 \
                else axes
        # try a single-axis subset (e.g. drop "pod" from ("pod","data"))
        if isinstance(axes, tuple) and len(axes) > 1:
            for a in axes[::-1]:
                if dim % self._size(a) == 0:
                    return a
        return None

    def spec(self, shape: Tuple[int, ...], *axes) -> Spec:
        assert len(axes) == len(shape), (shape, axes)
        return tuple(self._fit(d, a) for d, a in zip(shape, axes))

    def placements(self, spec: Spec) -> List:
        return placements(self.mesh, spec)

    # -- parameter specs ---------------------------------------------------
    def param_specs(self):
        """Spec tree keyed like the JAX package's parameter tree
        (``registry.abstract_params``: each group's leaves stacked over its
        repeats, their spec led by None)."""
        def leaf_rule(path, leaf) -> Spec:
            stacked = "groups" in path  # scan-stacked leaves: [repeat, ...]
            core = tuple(leaf.shape[1:] if stacked else leaf.shape)
            s = self._core_rule(path[-1], core)
            return (None,) + s if stacked else s

        return _tree_map_with_path(leaf_rule, R.abstract_params(self.cfg))

    def named_param_specs(self) -> Dict[str, Spec]:
        """Spec of each of the port's parameters, by ``state_dict`` name: a
        layer's tensor takes its stacked leaf's spec without the leading
        None."""
        from ..models import Model
        model = Model(self.cfg, device="meta")
        return {n: self._core_rule(n.rsplit(".", 1)[-1], tuple(p.shape))
                for n, p in model.named_parameters()}

    def _core_rule(self, name: str, shape) -> Spec:
        fsdp, tp = self.fsdp, self.tp
        f = lambda d, a: self._fit(d, a)  # noqa: E731
        if name in ("embed",):
            return (f(shape[0], tp), f(shape[1], fsdp))
        if name == "lm_head":
            return (f(shape[0], fsdp), f(shape[1], tp))
        if name in ("wq", "wk", "wv", "wg", "wu", "w1", "w_in_rec",
                    "w_in_gate", "w_qkv", "w_skip", "w_x", "w_r", "w_i",
                    "proj"):
            if len(shape) == 3:  # stacked MoE experts [E, D, F]
                ep = self._ep_axis(shape[0])
                return (ep, f(shape[1], fsdp if ep is None else None),
                        None if ep == tp else f(shape[2], tp))
            return (f(shape[0], fsdp), f(shape[1], tp))
        if name in ("wo", "wd", "w2", "w_out", "w_o"):
            if len(shape) == 3:  # [E, F, D]
                ep = self._ep_axis(shape[0])
                return (ep, None if ep == tp else f(shape[1], tp),
                        f(shape[2], fsdp if ep is None else None))
            return (f(shape[0], tp), f(shape[1], fsdp))
        if name == "router":
            return (f(shape[0], fsdp), None)
        if name == "w_if":
            return (f(shape[0], fsdp), None)
        if name == "conv_w":
            return (None, f(shape[1], tp))
        if name == "lam":
            return (f(shape[0], tp),)
        if name == "r":  # sLSTM block-diag recurrence [H, dh, 4dh]
            return (f(shape[0], tp), None, None)
        # norms' scale and bias, and the default: replicate
        return (None,) * len(shape)

    def _ep_axis(self, n_experts: int) -> Optional[str]:
        """True expert-parallel axis when expert count divides `model`;
        otherwise None -> expert-TP fallback shards d_ff instead."""
        if self.tp and n_experts % self.axis_size[self.tp] == 0:
            return self.tp
        return None

    def moe_spec(self, kind: str, shape: Tuple[int, ...]) -> Spec:
        """How the reference's ``ac`` constraint ``kind`` places a MoE
        buffer of ``shape`` (``src/repro/parallel/sharding.py``, the
        ``moe_*`` kinds): the global dispatch's ``moe_buf`` / ``moe_hidden``
        ``[E, C, D or F]`` put the experts over ``ep`` and, where ``ep`` is
        None (expert-TP), the capacity over the fsdp axes that divide it
        (``F`` over ``tp``); the grouped dispatch's ``moe_buf4`` /
        ``moe_hidden4`` ``[B, E, C, D or F]`` keep each row's buffer on the
        ranks of its rows.  Where ``ep`` is ``model`` the capacity stays
        whole, a ``model`` of one rank included."""
        ep = self._ep_axis(shape[-3])
        f = None if ep == self.tp else self._fit(shape[-1], self.tp)
        if kind in ("moe_buf", "moe_hidden"):
            c = self._fit(shape[1], self.fsdp) if ep is None else None
            return (ep, c, f if kind == "moe_hidden" else None)
        if kind in ("moe_buf4", "moe_hidden4"):
            return (self._fit(shape[0], self.fsdp), ep, None,
                    f if kind == "moe_hidden4" else None)
        raise ValueError(f"not a MoE constraint: {kind!r}")

    def opt_specs(self, param_specs):
        return {"m": param_specs, "v": param_specs, "count": ()}

    # -- batch / cache specs -------------------------------------------------
    def batch_specs(self, batch_tree):
        """Batch leaves (anything with ``ndim`` and ``shape``): rows over
        the fsdp axes, and with ``seq_shard`` the sequence over ``model``."""
        def rule(path, leaf):
            if leaf.ndim == 0:
                return ()
            b_axes = self._fit(leaf.shape[0], self.fsdp)
            if leaf.ndim >= 2 and self.pcfg.seq_shard:
                s_axes = self._fit(leaf.shape[1], self.tp)
                return (b_axes, s_axes) + (None,) * (leaf.ndim - 2)
            return (b_axes,) + (None,) * (leaf.ndim - 1)

        return _tree_map_with_path(rule, batch_tree)

    def cache_specs(self, cache_tree):
        """Specs of the port's caches: a list with one dict per layer
        (``Model.init_caches``), where the reference stacks each group's
        caches over a leading layer axis.  A leaf's spec is the reference
        rule's for its stacked leaf without that axis's None: k/v
        ``[B, S, Hkv, hd]`` (and the mLSTM's ``C``) split their rows over
        the fsdp axes and their heads (``kv_shard="heads"``) or slots
        (``"seq"``) over ``model``; other states split their rows, and
        their second dimension over ``model``.  Whisper's cross cache is
        head-major, ``[B, Hkv, S_enc, hd]`` where the reference keeps
        ``[B, S_enc, Hkv, hd]``: its spec is the reference's for the
        transposed shape, with the same two entries swapped back."""
        def rule(path, leaf):
            shape = tuple(leaf.shape)
            cross = path[-1] in ("cross_k", "cross_v")
            if cross:
                shape = (shape[0], shape[2], shape[1], shape[3])
            b_axes = self._fit(shape[0], self.fsdp)
            if len(shape) == 4:  # [B, S, Hkv, hd]
                if self.pcfg.kv_shard == "seq":
                    s = (b_axes, self._fit(shape[1], self.tp), None, None)
                else:
                    s = (b_axes, None, self._fit(shape[2], self.tp), None)
                return (s[0], s[2], s[1], s[3]) if cross else s
            if len(shape) >= 2:
                return (b_axes, self._fit(shape[1], self.tp)) \
                    + (None,) * (len(shape) - 2)
            return (b_axes,)

        return _tree_map_with_path(rule, cache_tree)

    def constrain_batch(self, batch_tree):
        """Pin a (micro)batch to its specs: on a mesh of several ranks each
        leaf becomes a ``DTensor`` placed by :meth:`batch_specs` (a full
        tensor is cut locally, a ``DTensor`` redistributed); on one device
        the batch is returned as it is."""
        if not self.sharded:
            return batch_tree
        specs = self.batch_specs(batch_tree)

        def pin(x, s):
            if isinstance(x, DTensor):
                return x.redistribute(self.mesh, self.placements(s))
            return distribute(x, self.mesh, s)
        return {k: pin(v, specs[k]) for k, v in batch_tree.items()}

    # -- activation constraint hook (the reference threads it as `ac`) -------
    def ac(self, x, kind: str):
        """The identity.  The reference's constraints pin activations for
        GSPMD to split the compute over ``model`` (heads, FFN hidden,
        vocab, experts, sequence).  The port splits the compute with
        collectives at the same points instead
        (:class:`~repro_torch.parallel.split.ModelSplit`, the hook the
        mesh executor hands to the layers), so a constraint by itself has
        nothing to pin."""
        return x


def _tree_map_with_path(fn, tree):
    """tree_map passing a tuple of dict-keys/list-indices as path."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(t) if not isinstance(node, tuple) \
                else tuple(t)
        return fn(path, node)

    return walk(tree, ())
