"""The window's prefills' model operations over its host-clock time, as a
share of one H100's bf16 peak.  A request of ``S`` prompt tokens counts
``2 * N_blocks * S`` for the layers' weights a token passes through (the
router and ``num_experts_per_tok`` experts of a MoE layer),
``4 * pairs * head_dim * heads * layers`` for attention over causal pairs
within the window, and ``2 * hidden * vocab`` for the last position's
logits."""
from portbench import counts, peaks


def value(run):
    c = run.cell.cfg
    if not run.window.items:
        return None
    blocks = counts.block_weights_active(c)
    ops = sum(2.0 * blocks * it["length"]
              + counts.attention_flops(c, 1, it["length"], False)
              + 2.0 * counts.head_weights(c) for it in run.window.items)
    return 100.0 * ops / (run.window.seconds * peaks.BF16_FLOPS)
