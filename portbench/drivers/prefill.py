"""Prefill: a closed loop of one caller through the port's serving entry,
``launch.serve.generate(model, batch, steps=1)`` → ``Model.prefill``: each
call sends one deck entry's ``[batch, length]`` prompts and waits for
their first tokens on the host.  The calls cycle through the deck
(:func:`portbench.traffic.prefill_deck`).

Set-up loads the benchmark's weights into ``Model`` through
``load_state_dict`` and runs one call at each length of the deck.  Each
call's last-position logits, which ``Model.prefill`` returns to
``generate``, are kept on the device; after the window the reference
recomputes them for a sample of the window's calls, drawn from the seed,
the longest call always in it.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from .. import compare, harness, traffic, weights
from ..reference import ops
from ..reference.model import RefModel


class Driver:
    def __init__(self, ctx: harness.Ctx):
        self.ctx = ctx
        self.t = ctx.t
        self.deck = [torch.from_numpy(a) for a in traffic.prefill_deck(
            self.t, ctx.seed, ctx.port_cfg.vocab_size)]
        self.next = 0
        self.last = None
        self.calls = []          # (deck index, served tokens, logits)

    def setup(self) -> None:
        from repro_torch.models import Model
        ctx = self.ctx
        harness.build_kernels(ctx.device)
        model = Model(ctx.port_cfg, device="meta")
        model.load_state_dict(weights.draw(ctx.cfg, ctx.seed, ctx.device),
                              strict=True, assign=True)
        prefill = model.prefill

        def keeping(batch, **kw):
            logits, caches = prefill(batch, **kw)
            self.last = logits
            return logits, caches
        model.prefill = keeping
        self.model = model
        by_len = {}
        for i, toks in enumerate(self.deck):
            by_len.setdefault(toks.shape[1], i)
        for L in sorted(by_len, reverse=True):
            self._call(by_len[L])

    def _call(self, i: int):
        from repro_torch.launch import serve
        out = serve.generate(self.model,
                             {"tokens": self.deck[i].to(self.ctx.device)}, 1)
        return out["tokens"]

    def _loop(self, until) -> list:
        items = []
        while True:
            i = self.next % len(self.deck)
            self.next += 1
            t0 = time.perf_counter()
            served = self._call(i)
            t1 = time.perf_counter()
            toks = self.deck[i]
            items.append({"t_sent": t0, "t_done": t1, "batch": toks.shape[0],
                          "length": toks.shape[1], "tokens": toks.numel(),
                          "deck": i})
            self.calls.append((i, served, self.last))
            if until(t1):
                return items

    def window(self, seconds: float) -> harness.Window:
        self.calls = []
        harness.sync(self.ctx.device)
        start = time.perf_counter()
        items = self._loop(lambda now: now - start >= seconds)
        # every request of a call is its own item
        reqs = [dict(it, tokens=it["length"]) for it in items
                for _ in range(it["batch"])]
        self.window_calls = self.calls
        rate = sum(it["tokens"] for it in items) / (items[-1]["t_done"]
                                                     - start)
        print(f"# prompt tokens/s {rate!r} over {len(items)} calls",
              file=sys.stderr)
        slow = sorted(items, key=lambda it: it["t_sent"] - it["t_done"])[:5]
        print("# slowest calls (ms, length, index): " + ", ".join(
            f"{(it['t_done'] - it['t_sent']) * 1e3:.1f} {it['length']} "
            f"{items.index(it)}" for it in slow), file=sys.stderr)
        return harness.Window(start, items[-1]["t_done"], reqs)

    def profile(self) -> None:
        """One whole round of the deck (``profile_round``): the same
        lengths in every traced run."""
        for i in traffic.prefill_round(self.t, self.ctx.seed,
                                       self.t["profile_round"]):
            self._call(i)

    def release(self) -> None:
        self.model = None
        self.last = None
        self.calls = []
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The window's calls the check compares: ``calls`` of them drawn
        from the seed, the longest call always among them."""
        calls = self.window_calls
        n = min(self.t["check"]["calls"], len(calls))
        longest = max(range(len(calls)),
                      key=lambda j: self.deck[calls[j][0]].shape[1])
        rest = [j for j in range(len(calls)) if j != longest]
        rng = np.random.default_rng([int(self.ctx.seed), 1])
        pick = rng.choice(len(rest), size=n - 1, replace=False)
        return [calls[longest]] + [calls[rest[j]] for j in sorted(pick)]

    def reference_logits(self, picked, prec: str = "f32") -> list:
        ctx = self.ctx
        ops.strict_f32()
        ref = RefModel(ctx.cfg, weights.draw(ctx.cfg, ctx.seed, ctx.device),
                       prec)
        return [ref.last_logits(self.deck[i].to(ctx.device))
                for i, _, _ in picked]

    def check(self) -> dict:
        picked = self.sample()
        refs = self.reference_logits(picked)
        return compare.logit_numbers(
            [(logits[:, -1], r, served[:, 0])
             for (_, served, logits), r in zip(picked, refs)])
