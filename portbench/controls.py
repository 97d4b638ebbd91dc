"""The readings that a cell's limits are set from, at the cell's own
sizes, several seeds in one process:

* ``program``: the port's numbers, as a run computes them (the training
  cells' check steps; the prefill cells' sampled calls served one by one,
  with no timed window);
* ``fp8``: the control, the reference in the next precision below the
  configuration's (bf16): every weight product's operands rounded to
  float8 e4m3, put in the port's place;
* ``half_batch`` (training): the reference put in the port's place with
  half of each step's rows (half of the sequence where the batch is one
  row) left out of the loss.

    python3 -m portbench.controls --workload <cell> --seeds 1,2,3 \\
        [--program] [--out FILE]

Prints one JSON line per seed and reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]


def half_rows(tokens):
    """Half of a batch's rows, or of its one row's positions."""
    B, S = tokens.shape
    return tokens[:, :S // 2] if B == 1 else tokens[:B // 2]


def train_readings(drv, program: bool) -> dict:
    from . import compare
    out = {}
    prog = None
    if program:
        drv.setup()
        prog = drv.prog
        drv.release()
    ref = drv.reference("f32")
    if prog is not None:
        out["program"] = compare.train_numbers(prog, ref)
    out["fp8"] = compare.train_numbers(drv.reference("fp8"), ref)
    out["half_batch"] = compare.train_numbers(
        drv.reference("f32", rows=half_rows), ref)
    return out


def prefill_readings(drv, program: bool) -> dict:
    from . import compare
    drv.window_calls = [(i, None, None) for i in range(len(drv.deck))]
    picked = drv.sample()
    out = {}
    if program:
        drv.setup()
        served = []
        for i, _, _ in picked:
            tok = drv._call(i)
            served.append((i, tok, drv.last))
        drv.release()
    ref = drv.reference_logits(picked, "f32")
    if program:
        out["program"] = compare.logit_numbers(
            [(lg[:, -1], r, tok[:, 0])
             for (_, tok, lg), r in zip(served, ref)])
    ctl = drv.reference_logits(picked, "fp8")
    out["fp8"] = compare.logit_numbers(
        [(c, r, c.argmax(-1)) for c, r in zip(ctl, ref)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(_ROOT / "src"))
    import torch

    from . import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    pc = harness.port_config(cell.cfg)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Ctx(cell, seed, dev, pc)
        drv = harness.load_module("drivers", cell.t["driver"]).Driver(ctx)
        read = train_readings if cell.t["driver"] == "train" \
            else prefill_readings
        for kind, nums in read(drv, args.program).items():
            line = {"workload": cell.name, "seed": seed, "reading": kind,
                    "numbers": nums,
                    "seconds": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(line), flush=True)
        del drv
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
