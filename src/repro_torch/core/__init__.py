"""The paper's primary contribution, ported to PyTorch: hetIR (portable GPU
kernel IR), the multi-backend runtime (interp / vectorized / cuda),
barrier-anchored segmentation, device-neutral snapshots, cross-backend
live migration, the persistent cost-aware translation cache with its
cluster fabric, the multi-tenant serving tier and the self-healing
worker fleet."""
from . import alias, hetir
from .backends import BACKENDS, get_backend
from .cache import (DiskStore, SharedStore, TranslationCache, global_cache,
                    register_reviver)
from .engine import Engine
from .fleet import (FAULT_POINTS, FaultInjector, FleetCoordinator,
                    FleetError, FleetTicket, FleetTimeout,
                    FleetWorkerError, RetryQueue, WorkerLost)
from .passes import (DEFAULT_OPT_LEVEL, OPT_MAX, PipelineStats,
                     SpecializationPolicy, get_optimized, get_specialized,
                     optimize)
from .pool import BufferPool
from .runtime import (CopyRecord, DeviceBuffer, Event, Function,
                      HetSession, LaunchRecord, Module, ParamInfo, Stream,
                      TraceRing, migrate)
from .serving import QuotaExceeded, ServeTicket, ServingFrontEnd
from .state import Snapshot

__all__ = ["alias", "hetir", "BACKENDS", "get_backend", "Engine",
           "HetSession", "migrate", "Snapshot", "TranslationCache",
           "Module", "Function", "DeviceBuffer", "Stream", "Event",
           "LaunchRecord", "ParamInfo", "CopyRecord", "TraceRing",
           "BufferPool", "ServingFrontEnd", "ServeTicket", "QuotaExceeded",
           "FleetCoordinator", "FleetTicket", "RetryQueue", "FaultInjector",
           "FAULT_POINTS", "FleetError", "FleetTimeout", "FleetWorkerError",
           "WorkerLost",
           "DiskStore", "SharedStore", "global_cache", "register_reviver",
           "optimize",
           "get_optimized", "get_specialized", "SpecializationPolicy",
           "PipelineStats", "OPT_MAX", "DEFAULT_OPT_LEVEL"]
