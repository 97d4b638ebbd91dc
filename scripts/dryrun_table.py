"""Print the production dry run's sweep as one markdown table: each arch x
shape, both meshes (``16x16 / 2x16x16``), before and after the compute
split over ``model``.

Reads the JSON cells that ``python -m repro_torch.launch.dryrun`` writes,
once with ``--no-split --tag no-split`` and once with ``--tag split``
(the same ``--out`` or two; ``--before`` and ``--after`` name other tags,
such as two trees' sweeps), and prints per cell: the state and the peak
of live bytes a rank (GB; the card has 80), the counted FLOPs a rank, the
FLOPs of all ranks over the analytic ``model_flops``, the collective
bytes a rank (ring model) and the roofline seconds (datasheet rates, not
measured).  Example::

    PYTHONPATH=src python scripts/dryrun_table.py build/dryrun
"""
import argparse
import json
from pathlib import Path

MESHES = ("16x16", "2x16x16")


def load(dirs, tag):
    out = {}
    for d in dirs:
        for f in Path(d).glob(f"*__{tag}.json"):
            arch, shape, mesh, _ = f.name.split("__")
            out[(arch, shape, mesh)] = json.loads(f.read_text())
    return out


def _g(x):
    return f"{x / 1e9:.3g}"


def _pair(fn, cells):
    """``a / b`` of ``fn`` over the two meshes' cells."""
    return " / ".join(fn(c) if c and c.get("status") == "ok" else
                      (c or {}).get("status", "—") for c in cells)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--before", default="no-split")
    ap.add_argument("--after", default="split")
    args = ap.parse_args()
    before, after = load(args.dirs, args.before), load(args.dirs, args.after)
    keys = sorted({(a, s) for a, s, _ in list(before) + list(after)})
    print("| arch | shape | state GB | peak GB before → after | FLOPs a "
          "rank after (×10¹²) | FLOPs×n / model before → after | "
          "collective GB before → after | roofline s after: compute, "
          "memory, collective |")
    print("|---|---|---|---|---|---|---|---|")
    skipped = []
    for arch, shape in keys:
        b = [before.get((arch, shape, m)) for m in MESHES]
        a = [after.get((arch, shape, m)) for m in MESHES]
        if all(c and c.get("status") == "skipped" for c in a + b):
            skipped.append(f"{arch} {shape}")
            continue

        def ratio(c):
            return f"{c['hlo_flops'] * c['n_chips'] / c['model_flops']:.3g}"

        def flops(c):
            return f"{c['hlo_flops'] / 1e12:.3g}"

        def coll(c):
            return _g(c["collective_bytes"].get("total", 0.0))

        def roof(c):
            r = c["roofline"]
            return ", ".join(f"{r[k]:.3g}" if r[k] is not None else "—"
                             for k in ("compute_s", "memory_s",
                                       "collective_s"))

        print(f"| {arch} | {shape} | "
              f"{_pair(lambda c: _g(c['state_bytes_per_device']), a)} | "
              f"{_pair(lambda c: _g(c['peak_bytes_per_device']), b)} → "
              f"{_pair(lambda c: _g(c['peak_bytes_per_device']), a)} | "
              f"{_pair(flops, a)} | "
              f"{_pair(ratio, b)} → {_pair(ratio, a)} | "
              f"{_pair(coll, b)} → {_pair(coll, a)} | "
              f"{_pair(roof, a)} |")
    if skipped:
        print(f"\nSkipped as the reference skips them (pure full "
              f"attention: no 500k decode): {', '.join(skipped)}.")


if __name__ == "__main__":
    main()
