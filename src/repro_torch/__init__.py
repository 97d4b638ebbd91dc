"""PyTorch / CUDA port of the hetGPU reproduction.

``repro_torch.core`` is the paper's runtime — hetIR, the pass pipeline,
barrier segmentation, device-neutral snapshots, the engine, the driver-style
session — with backends ``interp`` (NumPy oracle), ``vectorized`` (eager
PyTorch) and ``cuda`` (hetIR segments translated to CUDA C++ kernels for
Hopper).  ``repro_torch.zoo`` holds the model-zoo kernels.  The package
imports torch and never the JAX package; programs and snapshots cross
between the two unchanged (``core.hetir.from_foreign``, ``core.state``).
"""
