"""Metric readers, one file per metric of ``BENCHMARK.json``: ``value(run)``
returns the number, or None where the run holds nothing to read; see
:mod:`portbench.harness`."""
