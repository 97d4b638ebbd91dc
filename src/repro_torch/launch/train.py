"""Training launcher on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --shape train_4k --steps 1000 --ckpt /path/ck

Port of ``src/repro/launch/train.py``: a :class:`~repro_torch.runtime.
Trainer` on ``--device`` (``cuda`` unless the caller asks for ``cpu``,
where the kernels run their plain versions) restores the latest
checkpoint of ``--ckpt`` (the port's or the JAX package's) or starts
from seeded weights, runs ``--steps`` steps and checkpoints every
``--checkpoint-every``.  ``--smoke`` takes the architecture's smoke config
and the reference's smoke shape (64 tokens x 4).  The reference's
``--multi-pod`` (a production mesh) comes with the meshes.
"""
from __future__ import annotations

import argparse

from .. import configs
from ..configs.base import SHAPES, ShapeCfg, default_parallel
from ..runtime import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config and shape (CPU debugging)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = configs.get_smoke_config(args.arch)
        shape = ShapeCfg("smoke", 64, 4, "train")
    else:
        cfg = configs.get_config(args.arch)
        shape = SHAPES[args.shape]

    pcfg = default_parallel(cfg, shape)
    trainer = Trainer(cfg, shape, args.device, pcfg=pcfg,
                      ckpt_dir=args.ckpt)
    trainer.maybe_restore()
    rep = trainer.run(args.steps, checkpoint_every=args.checkpoint_every)
    print(f"ran {rep.steps_run} steps; final loss "
          f"{rep.losses[-1] if rep.losses else float('nan'):.4f}; "
          f"checkpoints at {rep.checkpoints} on {trainer.device}")
    return rep


if __name__ == "__main__":
    main()
