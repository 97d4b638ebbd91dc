"""Topology-neutral checkpoints in the JAX package's format: the port of
``src/repro/checkpoint``."""
from .topology import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
