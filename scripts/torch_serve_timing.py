"""Time the port's serving and training of granite-moe-3b-a800m on the
card, repeated.

    python scripts/torch_serve_timing.py [--src TREE] [--repeats N]

Imports ``repro_torch`` from ``TREE/src`` (this checkout by default, or
an unpacked copy of another commit, to compare two versions in one run),
draws granite-moe-3b-a800m at full width in bf16 from seed 0 and serves
``chip_smoke.py`` phase 7's load: 4 prompts of 1024 tokens, 32 tokens
each.  After one warm-up it serves ``N`` times and reports each prefill's
and decode step's milliseconds (host clock to a synchronize), and the
device busy time of one profiled prefill and decode step.  Where the tree
has the fixed-order MoE combine (``layers._combine``), it also times, on
the first MoE layer's own inputs in a prefill and in a decode step, that
combine against the ``index_add_`` it replaced and the stable-sort
``layers.topk`` against ``torch.topk`` (CUDA events around one call: in
the decode step, where the device waits for the host, the host's time).
Then it trains ``chip_smoke.py`` phase 10's model from seed 0 (batch 4 x
1024, remat, AdamW): one warm-up step and ``N`` timed steps (host clock
to a synchronize) with their losses.  Prints the card's line from ``nvidia-smi`` and, last, one JSON object.
Needs one card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, B, S, STEPS = "granite-moe-3b-a800m", 4, 1024, 32


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_timing.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import profile_launch, smi_line, time_ms
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import serve
    from repro_torch.models import Model, layers
    from repro_torch.runtime import Trainer

    dev = torch.device("cuda", 0)
    smi = smi_line()
    cfg = configs.get_config(ARCH)
    out = {"src": args.src, "card": smi}
    with torch.no_grad():
        model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
        batch = serve.make_batch(cfg, B, S, 0, dev)
        serve.generate(model, batch, 2)
        runs = [serve.generate(model, batch, STEPS)
                for _ in range(args.repeats)]
        out["prefill_ms"] = [r["prefill_ms"] for r in runs]
        out["decode_ms_per_step"] = [r["decode_ms_per_step"] for r in runs]
        tok = runs[-1]["tokens"][:, -1:].to(dev)
        caches = runs[-1]["caches"]
        out["busy_prefill_ms"] = sum(profile_launch(
            lambda: model.prefill(batch, cache_len=S + STEPS)).values())
        out["busy_decode_step_ms"] = sum(profile_launch(
            lambda: model.decode_step(tok, caches, S + STEPS - 1)).values())
        for k in ("prefill_ms", "decode_ms_per_step"):
            out[k + "_median"] = statistics.median(out[k])
        out["busy_share_prefill"] = (out["busy_prefill_ms"]
                                     / out["prefill_ms_median"])
        out["busy_share_decode_step"] = (out["busy_decode_step_ms"]
                                         / out["decode_ms_per_step_median"])

        if hasattr(layers, "_combine"):
            seen = {}
            real_topk, real_combine = layers.topk, layers._combine
            # the combine's arguments: (contrib, tok, K) in trees before
            # the capacity split; (out_buf, routing, K, C, own) after it,
            # timed on the contributions and tokens they give
            old = len(inspect.signature(real_combine).parameters) == 3

            def topk(logits, K):
                seen.setdefault(("topk", logits.shape[0]), (logits, K))
                return real_topk(logits, K)

            def combine(*a):
                if old:
                    seen.setdefault(("combine", a[1].shape[0]), a)
                else:
                    out_buf, r, K, C = a[:4]
                    keep = r.rank < C
                    w = r.gates.reshape(-1)[r.order] * keep.to(r.gates.dtype)
                    contrib = out_buf[r.sorted_e, torch.where(keep, r.rank, 0)] \
                        * w[:, None].to(out_buf.dtype)
                    seen.setdefault(("combine", r.order.shape[0]),
                                    (contrib, r.order // K, K, a))
                return real_combine(*a)

            layers.topk, layers._combine = topk, combine
            try:
                model.prefill(batch, cache_len=S + STEPS)
                model.decode_step(tok, caches, S + STEPS - 1)
            finally:
                layers.topk, layers._combine = real_topk, real_combine
            for what, T in (("per_prefill_ms", B * S),
                            ("per_decode_step_ms", B)):
                logits, K = seen[("topk", T)]
                contrib, tok_of, _, *call = seen[("combine", T * K)]
                call = call[0] if call else (contrib, tok_of, K)

                def index_add():
                    o = torch.zeros((T, contrib.shape[-1]),
                                    dtype=contrib.dtype, device=dev)
                    return o.index_add_(0, tok_of, contrib)

                L = cfg.n_layers
                out[what] = {
                    "topk_stable_sort": L * time_ms(
                        lambda: real_topk(logits, K), 20),
                    "torch_topk": L * time_ms(
                        lambda: torch.topk(logits, K, dim=-1), 20),
                    "combine_fixed_order": L * time_ms(
                        lambda: real_combine(*call), 20),
                    "index_add": L * time_ms(index_add, 20)}
    del model, caches, runs
    torch.cuda.empty_cache()
    tr = Trainer(cfg, ShapeCfg("timing", S, B, "train"), dev, seed=0)
    tr.init_state()
    tr.run(1)
    out["train_step_ms"], out["train_loss"] = [], []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["train_loss"].append(tr.run(1).losses[0])
        torch.cuda.synchronize()
        out["train_step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["train_step_ms_median"] = statistics.median(out["train_step_ms"])
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
