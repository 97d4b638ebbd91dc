"""The fault-tolerant, elastic train loop, on one device or a mesh: the
port of ``src/repro/runtime``."""
from .train_loop import SimulatedFailure, Trainer, TrainReport

__all__ = ["SimulatedFailure", "Trainer", "TrainReport"]
