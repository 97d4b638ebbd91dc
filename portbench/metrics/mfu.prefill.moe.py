"""``mfu.prefill`` in the MoE cells, moving ``ttft_p95_ms.moe``."""
from portbench import harness

_base = harness.load_module("metrics", "mfu.prefill")
value = _base.value
