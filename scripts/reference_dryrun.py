"""Run the JAX package's dry run (``repro.launch.dryrun``) on the CPU under
the installed jax, for a one-off comparison with the port's
(``repro_torch.launch.dryrun``).

jax 0.9's ``jax.make_mesh`` makes its axes ``Explicit``, and the
reference's ``with_sharding_constraint`` refuses a ``PartitionSpec`` on
``Explicit`` axes; this script makes the production meshes with ``Auto``
axes (the behaviour the reference was written against) and then runs the
reference's ``main`` with the arguments given, unchanged.  Example::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_dryrun.py \\
        --arch llama3.2-3b --shape decode_32k --mesh single --out build/refdry
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

_make_mesh = jax.make_mesh


def _auto_mesh(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, **kw)


jax.make_mesh = _auto_mesh

from repro.launch import dryrun  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(dryrun.main())
