"""Optimizer, learning-rate schedule and gradient compression: the port of
``src/repro/optim``."""
from .adamw import adamw_init, adamw_update
from .schedule import warmup_cosine

__all__ = ["adamw_init", "adamw_update", "warmup_cosine"]
