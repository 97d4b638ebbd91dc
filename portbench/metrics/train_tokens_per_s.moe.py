"""``train_tokens_per_s`` in the MoE cells, which a bound of its own holds: the host paces them more."""
from portbench import harness

_base = harness.load_module("metrics", "train_tokens_per_s")
value = _base.value
