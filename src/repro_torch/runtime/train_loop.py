"""Fault-tolerant training runtime on one device.

Port of ``src/repro/runtime/train_loop.py``, where a device takes the
place of the mesh:

* **cooperative checkpointing** — a ``preempt_flag`` callable is checked
  at every step boundary; when raised, the loop checkpoints and stops;
* **checkpoint/restart** — topology-neutral checkpoints in the JAX
  package's format (:mod:`repro_torch.checkpoint`: the parameters and
  AdamW's moments in the JAX tree's layout, ``opt/count`` and
  ``extra.next_step``) and seekable data, so a restart resumes exactly,
  and from a checkpoint of either package;
* **failure injection** — ``failure_at`` raises :class:`SimulatedFailure`
  at that step, for the fault-tolerance tests;
* **straggler monitoring** — per-step wall-time EMA; steps slower than
  ``STRAGGLER_FACTOR`` times the EMA are counted.

The reference's ``Trainer.resize`` (live migration from one mesh to
another) comes with the meshes, in the multi-device slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs.base import ModelConfig, ParallelCfg, ShapeCfg
from ..core.backends.base import resolve_device
from ..data import SyntheticLMData
from ..models import Model, params_from_jax, params_to_jax
from ..optim import adamw_init
from ..parallel import make_train_step


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
    ``seed``) on ``device`` (``cuda:0`` unless the caller names another):
    the weights are drawn from ``seed`` by a ``torch.Generator`` on the
    device, AdamW's state is ``cfg.opt_state_dtype``, and the learning
    rate warms up over the reference's default 100 steps to ``peak_lr``.
    ``model`` and ``opt`` hold the state once :meth:`init_state` or
    :meth:`maybe_restore` has made it; ``step`` is the next step."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, device=None,
                 pcfg: Optional[ParallelCfg] = None, ckpt_dir=None,
                 seed: int = 0, peak_lr: float = 1e-3):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.pcfg = pcfg or ParallelCfg(grad_accum=1, remat=True,
                                        seq_shard=False)
        self.seed = seed
        self.peak_lr = peak_lr
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_dir = ckpt_dir
        self.data = SyntheticLMData(cfg, shape, seed, device=self.device)
        self.step_fn = make_train_step(cfg, self.pcfg, peak_lr=peak_lr)
        self.step = 0
        self.model: Optional[Model] = None
        self.opt: Optional[dict] = None

    # -- state ------------------------------------------------------------
    def init_state(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model = Model(self.cfg, generator=gen, device=self.device)
        self.opt = adamw_init(dict(self.model.named_parameters()),
                              self.cfg.opt_state_dtype)
        self.step = 0

    def state_tree(self, device=None) -> dict:
        """The state in the JAX package's tree: ``params``, ``opt`` with
        ``m``, ``v`` (each in the parameters' layout) and ``count``; new
        tensors on ``device`` (the state's own when None), one stacked
        leaf at a time."""
        return {"params": params_to_jax(self.model.state_dict(), self.cfg,
                                        device),
                "opt": {"m": params_to_jax(self.opt["m"], self.cfg, device),
                        "v": params_to_jax(self.opt["v"], self.cfg, device),
                        "count": self.opt["count"].clone()
                        if device is None else
                        self.opt["count"].to(device, copy=True)}}

    def maybe_restore(self) -> bool:
        """Load the latest checkpoint of ``ckpt_dir`` (the port's or the
        JAX package's) onto the device; False when there is none."""
        if self.ckpt_dir is None:
            return False
        last = latest_step(self.ckpt_dir)
        if last is None:
            return False
        state, extra = restore(self.ckpt_dir, last)

        def own(tree, dtype):
            # a tensor of its own per parameter, not a view of the stacked
            # leaf: CPU matmuls round by the operands' alignment
            return {n: t.to(self.device, dtype, copy=True)
                    for n, t in params_from_jax(tree, self.cfg).items()}

        model = Model(self.cfg, device="meta")
        model.load_state_dict(own(state["params"],
                                  getattr(torch, self.cfg.param_dtype)),
                              assign=True)
        dt = getattr(torch, self.cfg.opt_state_dtype)
        self.model = model
        self.opt = {k: own(state["opt"][k], dt) for k in ("m", "v")}
        self.opt["count"] = state["opt"]["count"].to(self.device,
                                                     torch.int32)
        self.step = int(extra["next_step"])
        return True

    def save_checkpoint(self) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self.state_tree(torch.device("cpu")),
                       extra={"next_step": self.step})
        self.ckpt.wait()

    # -- elastic resize / live migration: the reference's ``resize(mesh)``
    # reshards the state onto another mesh; it comes with the meshes, in
    # the multi-device slice (one device has nothing to reshard)

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
