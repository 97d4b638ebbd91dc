"""Training launcher, on one device or a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --shape train_4k --steps 1000 --ckpt /path/ck [--multi-pod]

Port of ``src/repro/launch/train.py``: a :class:`~repro_torch.runtime.
Trainer` restores the latest checkpoint of ``--ckpt`` (the port's or the
JAX package's) or starts from seeded weights, runs ``--steps`` steps and
checkpoints every ``--checkpoint-every``.  Run alone it trains on
``--device`` (``cuda`` unless the caller asks for ``cpu``, where the
kernels run their plain versions).  Under torchrun (one process per
device, ``WORLD_SIZE`` ranks) it trains on a mesh of those ranks: the
production mesh, ``(16, 16)`` or with ``--multi-pod`` ``(2, 16, 16)``,
which needs that many ranks (``--multi-pod`` refuses any other world,
alone included).  ``--smoke`` takes the architecture's smoke config, the
reference's smoke shape (64 tokens x 4) and a ``(world, 1)`` mesh of
every rank, as the reference takes ``(n, 1)`` of all devices: one device
when run alone.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from .. import configs
from ..configs.base import SHAPES, ShapeCfg, default_parallel
from ..runtime import Trainer
from .mesh import make_production_mesh, make_test_mesh


def _mesh(args, world: int):
    """The mesh (or device) of this launch."""
    device_type = torch.device(args.device).type
    if args.multi_pod and world != 512:
        raise SystemExit(
            f"--multi-pod trains on the (2, 16, 16) mesh: run it under "
            f"torchrun with 512 processes, not {world}")
    if world == 1:
        return args.device
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if args.smoke:
        return make_test_mesh((world, 1), device_type=device_type)
    return make_production_mesh(multi_pod=args.multi_pod,
                                device_type=device_type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true")
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
    mesh = _mesh(args, int(os.environ.get("WORLD_SIZE", 1)))

    pcfg = default_parallel(cfg, shape)
    trainer = Trainer(cfg, shape, mesh, pcfg=pcfg, ckpt_dir=args.ckpt)
    trainer.maybe_restore()
    rep = trainer.run(args.steps, checkpoint_every=args.checkpoint_every)
    print(f"ran {rep.steps_run} steps; final loss "
          f"{rep.losses[-1] if rep.losses else float('nan'):.4f}; "
          f"checkpoints at {rep.checkpoints} on {trainer.mesh}")
    return rep


if __name__ == "__main__":
    main()
