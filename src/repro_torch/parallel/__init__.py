"""The one-device train step: the port of ``src/repro/parallel/steps.py``'s
``make_train_step`` (the mesh rules, the serve and prefill steps and the
pipeline wait for the multi-device slice)."""
from .steps import make_train_step

__all__ = ["make_train_step"]
