"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell
(a model configuration under one traffic mix) runs once per process.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, one cell or one metric sits
in a file of its own, found by its name in ``BENCHMARK.json``:
``configs/<config>.json`` (the sizes as run, with the reference family),
``workloads/<cell>.json`` (the driver, the traffic's parameters and the
correctness limits), ``metrics/<metric>.py`` (a reader), ``drivers/
<driver>.py`` and ``reference/<family>.py`` (the plain PyTorch model that
decides ``correct``).  Nothing here imports JAX or the JAX package.
"""
