"""Training: the window drives the port's ``Trainer.run`` (``make_train_step``
→ ``Model.forward_train`` with remat → AdamW), one batch of
``[batch, seq_len]`` seeded token rows a step.

Set-up builds one trainer with the benchmark's weights (loaded through
``Model.load_state_dict``) and fresh AdamW moments, and runs the check's
first steps through ``Trainer.run``: they warm up every shape, and give
each step's loss, each leaf's first moment after step 1 and each leaf's
change after the last of them.  The window runs whole steps on the same
trainer until ``seconds`` have passed.  After it, the reference follows
the same first steps from the same weights and rows.
"""
from __future__ import annotations

import gc
import inspect
import sys
import time

import torch

from .. import compare, harness, traffic, weights
from ..reference import ops
from ..reference.model import RefModel


def _program_recipe(o) -> None:
    """Refuse a cell whose optimizer settings are not the ones the port's
    ``Trainer`` runs (its step's defaults, AdamW's constants)."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import steps
    step = inspect.signature(steps.make_train_step).parameters
    upd = inspect.signature(adamw.adamw_update).parameters
    runs = {"warmup_steps": step["warmup"].default,
            "total_steps": step["total_steps"].default,
            "b1": adamw.B1, "b2": adamw.B2, "eps": adamw.EPS,
            "weight_decay": upd["weight_decay"].default,
            "clip_norm": upd["clip_norm"].default}
    bad = {k: (o[k], v) for k, v in runs.items() if o[k] != v}
    if bad:
        raise ValueError(f"the port's trainer runs other optimizer settings "
                         f"than the cell states (cell, port): {bad}")


class Driver:
    def __init__(self, ctx: harness.Ctx):
        self.ctx = ctx
        self.t = ctx.t
        self.tokens_per_step = self.t["batch"] * self.t["seq_len"]

    def _change(self, params) -> dict:
        """Each leaf's change from the seed's weights (drawn again)."""
        out = {}
        for g in weights.iter_groups(self.ctx.cfg, self.ctx.seed,
                                     self.ctx.device):
            out.update(compare.leaf_norms(
                {n: params[n].float() - w.float() for n, w in g.items()}))
        return out

    def setup(self) -> None:
        from repro_torch.configs.base import ParallelCfg, ShapeCfg
        from repro_torch.models import Model
        from repro_torch.optim import adamw_init
        from repro_torch.runtime.train_loop import Trainer
        ctx, t = self.ctx, self.t
        _program_recipe(t["optimizer"])
        harness.build_kernels(ctx.device)
        pc = ctx.port_cfg
        shape = ShapeCfg(ctx.cell.name, t["seq_len"], t["batch"], "train")
        tr = Trainer(pc, shape, mesh=ctx.device,
                     pcfg=ParallelCfg(grad_accum=1, remat=True,
                                      seq_shard=False),
                     seed=ctx.seed, peak_lr=t["optimizer"]["peak_lr"])
        model = Model(pc, device="meta")
        model.load_state_dict(weights.draw(ctx.cfg, ctx.seed, ctx.device),
                              strict=True, assign=True)
        tr.model = model
        tr.opt = adamw_init(dict(model.named_parameters()),
                            pc.opt_state_dtype)
        tr.step = 0
        tr.data = traffic.TrainFeed(t, ctx.seed, pc.vocab_size, ctx.device)
        n = t["check"]["steps"]
        losses = tr.run(1).losses
        m1 = compare.leaf_norms(tr.opt["m"])
        losses += tr.run(n - 1).losses
        self.prog = {"losses": losses, "m1": m1,
                     "change": self._change(dict(model.named_parameters()))}
        self.trainer = tr

    def window(self, seconds: float) -> harness.Window:
        tr = self.trainer
        harness.sync(self.ctx.device)
        t0 = time.perf_counter()
        rep = tr.run(10 ** 9, preempt_flag=lambda:
                     time.perf_counter() - t0 >= seconds)
        t1 = time.perf_counter()
        return harness.Window(t0, t1, [{"tokens": self.tokens_per_step}
                                       for _ in range(rep.steps_run)])

    def profile(self) -> None:
        self.trainer.run(self.t["profile_steps"])

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: str = "f32", rows=None) -> dict:
        """The reference's ``losses``, ``m1`` and ``change`` over the check's
        steps, in ``prec``; ``rows(tokens)`` changes each step's rows (a
        planted fault)."""
        ctx, t = self.ctx, self.t
        ops.strict_f32()
        feed = traffic.TrainFeed(t, ctx.seed, ctx.port_cfg.vocab_size,
                                 ctx.device)
        batches = [feed.batch_at(s)["tokens"]
                   for s in range(t["check"]["steps"])]
        if rows is not None:
            batches = [rows(b) for b in batches]
        ref = RefModel(ctx.cfg, weights.draw(ctx.cfg, ctx.seed, ctx.device),
                       prec)
        out = ref.train(batches, t["optimizer"])
        del out["m"], out["v"]
        gc.collect()
        out["change"] = self._change(ref.w)
        return out

    def check(self) -> dict:
        nums = compare.train_numbers(self.prog, self.reference())
        print(f"# train check: losses {self.prog['losses']}; worst grad "
              f"leaf {nums['grad_leaf']}, worst change leaf "
              f"{nums['change_leaf']}, {nums['still_leaves']} still leaves",
              file=sys.stderr)
        return nums
