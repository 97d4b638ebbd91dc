"""``device_idle.serve`` in the MoE cells, moving ``ttft_p95_ms.moe``."""
from portbench import harness

_base = harness.load_module("metrics", "device_idle.serve")
value = _base.value
