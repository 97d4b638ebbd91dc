"""Drivers: how a cell's traffic goes through the port (``train``,
``prefill``); see :mod:`portbench.harness`."""
