"""``ttft_p95_ms`` in the MoE cells, which a bound of its own holds: the host paces them more."""
from portbench import harness

_base = harness.load_module("metrics", "ttft_p95_ms")
value = _base.value
