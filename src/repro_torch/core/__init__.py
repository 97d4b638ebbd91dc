"""The paper's primary contribution, ported to PyTorch: hetIR (portable GPU
kernel IR), the multi-backend runtime (interp / vectorized / cuda),
barrier-anchored segmentation, device-neutral snapshots, cross-backend
live migration, and the translation cache."""
from . import alias, hetir
from .backends import BACKENDS, get_backend
from .cache import TranslationCache, global_cache
from .engine import Engine
from .passes import (DEFAULT_OPT_LEVEL, OPT_MAX, PipelineStats,
                     SpecializationPolicy, get_optimized, get_specialized,
                     optimize)
from .pool import BufferPool
from .runtime import (CopyRecord, DeviceBuffer, Event, Function,
                      HetSession, LaunchRecord, Module, ParamInfo, Stream,
                      TraceRing, migrate)
from .state import Snapshot

__all__ = ["alias", "hetir", "BACKENDS", "get_backend", "Engine",
           "HetSession", "migrate", "Snapshot", "TranslationCache",
           "Module", "Function", "DeviceBuffer", "Stream", "Event",
           "LaunchRecord", "ParamInfo", "CopyRecord", "TraceRing",
           "BufferPool", "global_cache", "optimize",
           "get_optimized", "get_specialized", "SpecializationPolicy",
           "PipelineStats", "OPT_MAX", "DEFAULT_OPT_LEVEL"]
