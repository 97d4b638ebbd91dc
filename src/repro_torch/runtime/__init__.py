"""The fault-tolerant train loop on one device: the port of
``src/repro/runtime``."""
from .train_loop import SimulatedFailure, Trainer, TrainReport

__all__ = ["SimulatedFailure", "Trainer", "TrainReport"]
