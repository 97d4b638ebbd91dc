"""The multi-device layer: the sharding rules (:class:`MeshRules`), the
mesh executor that runs a model whose state is sharded on a mesh, the
train, serve and prefill steps (one device or a mesh) and GPipe over a
mesh axis.  The port of ``src/repro/parallel``."""
from .executor import MeshExecutor
from .pipeline import pipeline_apply
from .sharding import MeshRules
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["MeshExecutor", "MeshRules", "make_prefill_step",
           "make_serve_step", "make_train_step", "pipeline_apply"]
