"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (the probes and a profiled sub-window on).  Both
compare what the timed path produced with the reference; the numbers
compared, each beside its limit, close the result line (``checks``) and
standard error.  Exits non-zero, printing no result, without the cards,
or if a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_IMPORTED = time.perf_counter()
_ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from its start
    time under ``/proc``; the module's import where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return min(time.perf_counter() - age, _IMPORTED)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def forbidden_modules() -> list:
    from portbench.harness import FORBIDDEN
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start()
    if str(_ROOT / "src") not in sys.path:
        sys.path.insert(0, str(_ROOT / "src"))
    build = _ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch

    from portbench import harness
    # one host thread: the run's load is one process that launches work
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    out = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
