"""Meshes of the port, and the card's datasheet constants.

Port of ``src/repro/launch/mesh.py``.  A mesh in the port is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, one rank
per device; a single device (a ``torch.device``) is the ``(1, 1)`` mesh
``("data", "model")`` (:mod:`repro_torch.parallel.sharding`).  A
``DeviceMesh`` needs a process group whose world is the product of its
shape: torchrun's, or one that the caller made (the tests: ``gloo`` over
a ``FileStore``, or the fake backend for the production shapes).

Both builders are functions, so that importing this module touches no
process group or device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# One NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU
# datasheet (dense rates, no sparsity), for roofline accounting: the
# TPU v5e figures of the reference do not carry over.
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12              # HBM3 bytes/s per GPU
ICI_BW = 900e9                # NVLink 4 bytes/s per GPU, both directions
HBM_BYTES = 80e9              # HBM3 bytes per GPU

#: the reference's production meshes: one pod of 16 x 16, or two
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"a mesh of shape {tuple(shape)} needs a process group of {n} "
            f"ranks (torchrun --nproc-per-node ... with {n} processes in "
            f"all); this process has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh, ``(16, 16)`` ``("data", "model")`` or, with
    ``multi_pod``, ``(2, 16, 16)`` ``("pod", "data", "model")``, over the
    ranks of the default process group; raises unless its world is the
    mesh's size."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device_type: str = "cpu") -> DeviceMesh:
    """A small mesh over the ranks of the default process group (the
    tests: ``gloo`` processes on the CPU)."""
    return _mesh(shape, axes, device_type)
