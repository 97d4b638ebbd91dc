"""``roofline.flash_attention.serve`` in the MoE cells, moving ``ttft_p95_ms.moe``."""
from portbench import harness

_base = harness.load_module("metrics", "roofline.flash_attention.serve")
PROBE, summarize, value = _base.PROBE, _base.summarize, _base.value
