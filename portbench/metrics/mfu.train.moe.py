"""``mfu.train`` in the MoE cells, moving ``train_tokens_per_s.moe``."""
from portbench import harness

_base = harness.load_module("metrics", "mfu.train")
value = _base.value
