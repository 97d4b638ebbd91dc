"""Fault-tolerant, elastic training runtime, on one device or a mesh.

Port of ``src/repro/runtime/train_loop.py``.  A trainer runs on a mesh
(a ``DeviceMesh`` of several ranks, its state ``DTensor`` shards placed
by :class:`~repro_torch.parallel.MeshRules` and its steps run by a
:class:`~repro_torch.parallel.MeshExecutor`) or on one device (the
``(1, 1)`` mesh: plain tensors):

* **cooperative checkpointing** — a ``preempt_flag`` callable is checked
  at every step boundary; when raised, the loop checkpoints and stops;
* **checkpoint/restart** — topology-neutral checkpoints in the JAX
  package's format (:mod:`repro_torch.checkpoint`: the parameters and
  AdamW's moments in the JAX tree's layout with their specs,
  ``opt/count`` and ``extra.next_step``) and seekable data, so a restart
  resumes exactly, on this mesh or another, and from a checkpoint of
  either package;
* **elastic resize / live migration** — :meth:`Trainer.resize` moves the
  live state through the host onto another mesh or device (a ``(2, 2)``
  mesh to ``(4, 1)``, the card to the host and back) without a restart;
* **one writer** — on a mesh, the host copy, the checkpoint and the
  resize gather each tensor to one writing rank (the mesh's first), one
  tensor at a time; every other rank holds only its own blocks, on the
  device and on the host;
* **failure injection** — ``failure_at`` raises :class:`SimulatedFailure`
  at that step, for the fault-tolerance tests;
* **straggler monitoring** — per-step wall-time EMA; steps slower than
  ``STRAGGLER_FACTOR`` times the EMA are counted.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs.base import ModelConfig, ParallelCfg, ShapeCfg
from ..core.backends.base import resolve_device
from ..data import SyntheticLMData
from ..models import Model, params_from_jax, params_to_jax
from ..models import registry as R
from ..optim import adamw_init
from ..parallel import MeshExecutor, MeshRules, make_train_step
from ..parallel.sharding import gather_to, scatter_from


#: a step slower than this many times the wall-time EMA is a straggler
STRAGGLER_FACTOR = 3.0


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainReport:
    steps_run: int = 0
    losses: List[float] = field(default_factory=list)
    straggler_events: int = 0
    checkpoints: List[int] = field(default_factory=list)
    preempted: bool = False


class Trainer:
    """Trains ``cfg`` on ``shape``'s batches (``SyntheticLMData`` of
    ``seed``) on ``mesh``: a ``DeviceMesh`` or a device (``cuda:0`` unless
    the caller names another).  The weights are drawn from ``seed`` by a
    ``torch.Generator`` on the compute device (whole on every rank of a
    mesh, which keeps its shards), AdamW's state is
    ``cfg.opt_state_dtype``, and the learning rate warms up over the
    reference's default 100 steps to ``peak_lr``.  ``model`` and ``opt``
    hold the state once :meth:`init_state` or :meth:`maybe_restore` has
    made it; ``step`` is the next step.  On a mesh of several ranks every
    rank makes the same calls."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, mesh=None,
                 pcfg: Optional[ParallelCfg] = None, ckpt_dir=None,
                 seed: int = 0, peak_lr: float = 1e-3):
        self.cfg = cfg
        self.shape = shape
        self.pcfg = pcfg or ParallelCfg(grad_accum=1, remat=True,
                                        seq_shard=False)
        self.seed = seed
        self.peak_lr = peak_lr
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_dir = ckpt_dir
        self._bind_mesh(mesh)
        self.step = 0
        self.model: Optional[Model] = None
        self.opt: Optional[dict] = None

    # -- mesh binding (initial and elastic) ------------------------------
    def _bind_mesh(self, mesh) -> None:
        """The rules, specs, data placement, executor and step of
        ``mesh``."""
        if isinstance(mesh, DeviceMesh):
            self.device = torch.device(mesh.device_type) \
                if mesh.device_type == "cpu" else \
                torch.device(mesh.device_type, torch.cuda.current_device())
        else:
            mesh = self.device = resolve_device(mesh)
        self.mesh = mesh
        self.rules = MeshRules(self.cfg, self.pcfg, mesh)
        self.executor = MeshExecutor(self.rules) if self.rules.sharded \
            else None
        #: the rank that holds the whole state on the host, and writes it
        self.writer = int(mesh.mesh.min()) if self.executor is not None \
            else None
        self.pspecs = self.rules.param_specs()
        self.ospecs = self.rules.opt_specs(self.pspecs)
        self.bspecs = self.rules.batch_specs(
            R.train_input_specs(self.cfg, self.shape))
        self.data = SyntheticLMData(self.cfg, self.shape, self.seed,
                                    device=self.device, mesh=mesh,
                                    specs=self.bspecs)
        self.step_fn = make_train_step(self.cfg, self.pcfg, self.rules,
                                       peak_lr=self.peak_lr)

    # -- state ------------------------------------------------------------
    def init_state(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        model = Model(self.cfg, generator=gen, device=self.device)
        if self.executor is None:
            self.model = model
            self.opt = adamw_init(dict(model.named_parameters()),
                                  self.cfg.opt_state_dtype)
        else:
            self.model = self.executor.shard_model(model)
            dt = getattr(torch, self.cfg.opt_state_dtype)
            params = dict(self.model.named_parameters())
            self.opt = {k: {n: self.executor.zeros_like(p, dt)
                            for n, p in params.items()} for k in ("m", "v")}
            self.opt["count"] = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
        self.step = 0

    def _place(self, params, m, v, count, src: Optional[int] = None
               ) -> None:
        """Make the state from whole tensors by parameter name, on the
        bound device, or sharded on the bound mesh.  The dicts are emptied
        as their tensors are placed, so each source can be freed at once.
        With ``src``, only global rank ``src`` holds the whole tensors (the
        other ranks' dicts are ignored): it sends each rank its blocks, or
        every rank the whole tensor where the bound mesh is one device."""
        pdt = getattr(torch, self.cfg.param_dtype)
        odt = getattr(torch, self.cfg.opt_state_dtype)
        model = Model(self.cfg, device="meta")
        if src is not None:
            shapes = dict(model.named_parameters())
            params, m, v = (self._from_rank(src, d, shapes, dt)
                            for d, dt in ((params, pdt), (m, odt),
                                          (v, odt)))
            if self.executor is not None:
                self.executor.adopt(model, params)
                self.opt = {"m": m, "v": v,
                            "count": count.to(self.device, torch.int32)}
                self.model = model
                return

        def on(tensors, dtype):
            # a view (a layer of a stacked leaf) becomes a tensor of its
            # own: CPU matmuls round by the operands' alignment
            out = {}
            for n in list(tensors):
                t = tensors.pop(n)
                out[n] = t.to(self.device, dtype, copy=t._base is not None)
            return out
        if self.executor is None:
            model.load_state_dict(on(params, pdt), assign=True)
            self.opt = {"m": on(m, odt), "v": on(v, odt)}
        else:
            self.executor.adopt(model, self.executor.shard(on(params, pdt)))
            self.opt = {"m": self.executor.shard(on(m, odt)),
                        "v": self.executor.shard(on(v, odt))}
        self.opt["count"] = count.to(self.device, torch.int32)
        self.model = model

    def _from_rank(self, src: int, tensors, shapes, dtype) -> dict:
        """Tensors by parameter name that global rank ``src`` holds whole:
        ``DTensor``s placed by the rules (each rank receiving its blocks)
        on a mesh, whole on every rank on a device."""
        ex, me = self.executor, dist.get_rank()
        out = {}
        for n, shape in shapes.items():
            t = tensors.pop(n) if me == src else None
            if ex is not None:
                out[n] = scatter_from(t, src, self.mesh, ex.specs[n],
                                      shape.shape, dtype, self.device)
                continue
            whole = t.to(self.device, dtype).contiguous() if me == src \
                else torch.empty(shape.shape, dtype=dtype,
                                 device=self.device)
            dist.broadcast(whole, src=src)
            out[n] = whole
        return out

    @property
    def is_writer(self) -> bool:
        """Whether this rank holds the whole state on the host (one
        device: always)."""
        return self.writer is None or dist.get_rank() == self.writer

    def host_state(self) -> dict:
        """The state on the host, topology-neutral: ``params``, ``m`` and
        ``v`` by parameter name and ``count``.  On a mesh the writing rank
        holds each tensor whole (its blocks gathered there, one tensor at
        a time) and every other rank only its own blocks."""
        def host(tensors):
            out = {}
            for n, t in tensors.items():
                if isinstance(t, DTensor):
                    whole = gather_to(t, self.writer)
                    t = t.to_local() if whole is None else whole
                out[n] = t.detach().to("cpu")
            return out
        return {"params": host(dict(self.model.named_parameters())),
                "m": host(self.opt["m"]), "v": host(self.opt["v"]),
                "count": self.opt["count"].to("cpu")}

    def state_tree(self, device=None) -> Optional[dict]:
        """The state in the JAX package's tree: ``params``, ``opt`` with
        ``m``, ``v`` (each in the parameters' layout) and ``count``; new
        tensors on ``device`` (the state's own when None), one stacked
        leaf at a time.  On a mesh, the writing rank's tree on the host
        (:meth:`host_state`), None on the other ranks."""
        if self.executor is not None:
            host = self.host_state()
            if not self.is_writer:
                return None
            tensors = {k: host[k] for k in ("params", "m", "v")}
            count = host["count"]
        else:
            tensors = {"params": dict(self.model.named_parameters()),
                       "m": self.opt["m"], "v": self.opt["v"]}
            count = self.opt["count"]

        def tree(k):
            return params_to_jax(tensors[k], self.cfg, device)
        return {"params": tree("params"),
                "opt": {"m": tree("m"), "v": tree("v"),
                        "count": count.clone() if device is None else
                        count.to(device, copy=True)}}

    def maybe_restore(self) -> bool:
        """Load the latest checkpoint of ``ckpt_dir`` (the port's or the
        JAX package's) whole on the host, then place it on the device or
        by this mesh's rules; False when there is none."""
        if self.ckpt_dir is None:
            return False
        last = latest_step(self.ckpt_dir)
        if last is None:
            return False
        state, extra = restore(self.ckpt_dir, last)
        opt = state["opt"]
        self._place(*(params_from_jax(t, self.cfg)
                      for t in (state["params"], opt["m"], opt["v"])),
                    opt["count"])
        self.step = int(extra["next_step"])
        return True

    def save_checkpoint(self) -> None:
        """Checkpoint the state with its specs; on a mesh each tensor is
        gathered to the writing rank (the mesh's first), which writes,
        then all wait."""
        if self.ckpt is None:
            return
        tree = self.state_tree(torch.device("cpu"))
        ex = self.executor
        if self.is_writer:
            self.ckpt.save(self.step, tree,
                           specs={"params": self.pspecs,
                                  "opt": self.ospecs},
                           extra={"next_step": self.step})
            self.ckpt.wait()
        if ex is not None:
            dist.barrier(group=ex.group(range(self.mesh.ndim)))

    # -- elastic resize / live migration ----------------------------------
    def resize(self, new_mesh) -> None:
        """Live-migrate the job onto another mesh or device (the cluster-
        scale analogue of the paper's cross-GPU kernel migration): the
        state goes through the host (:meth:`host_state`: whole on one
        device, or on a mesh's writing rank, which then sends each rank
        its blocks of the new placement), the old one is dropped, and the
        rules, data and step are bound to ``new_mesh`` before the state
        is placed there.  The step counter, and with it the data's
        position, carries over."""
        host = self.host_state()
        step, src = self.step, self.writer
        self.model = self.opt = None
        self._bind_mesh(new_mesh)
        self._place(host["params"], host["m"], host["v"], host["count"],
                    src=src)
        self.step = step

    # -- the loop -----------------------------------------------------------
    def run(self, num_steps: int, *, checkpoint_every: int = 0,
            preempt_flag: Optional[Callable[[], bool]] = None,
            failure_at: Optional[int] = None) -> TrainReport:
        if self.model is None:
            if not self.maybe_restore():
                self.init_state()
        report = TrainReport()
        ema = None
        target = self.step + num_steps
        while self.step < target:
            if failure_at is not None and self.step == failure_at:
                raise SimulatedFailure(f"node lost at step {self.step}")
            t0 = time.perf_counter()
            batch = self.data.batch_at(self.step)
            _, self.opt, metrics = self.step_fn(self.model, self.opt, batch,
                                                self.step)
            loss = float(metrics["loss"])
            self.step += 1
            report.steps_run += 1
            report.losses.append(loss)

            dt = time.perf_counter() - t0
            if ema is None:
                ema = dt
            elif dt > STRAGGLER_FACTOR * ema:
                report.straggler_events += 1
            ema = 0.9 * ema + 0.1 * dt if ema else dt

            if checkpoint_every and self.step % checkpoint_every == 0:
                self.save_checkpoint()
                report.checkpoints.append(self.step)
            if preempt_flag is not None and preempt_flag():
                # cooperative checkpoint at the step barrier, then stop
                self.save_checkpoint()
                report.preempted = True
                break
        return report
