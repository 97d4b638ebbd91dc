"""The seekable synthetic data pipeline: the port of ``src/repro/data``."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
