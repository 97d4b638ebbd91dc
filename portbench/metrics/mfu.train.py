"""The window's training steps' model operations over its host-clock time,
as a share of one H100's bf16 peak.  A step of ``B x S`` tokens counts
``6 * N_active * B * S`` for the weights a token passes through (the
attention and FFN matrices, the router and ``num_experts_per_tok`` of
the experts, the head) and ``12 * pairs * head_dim * heads * layers * B``
for attention's scores and values, forward and backward, over causal
pairs within the window.  Recompute and the embedding gather are not
counted."""
from portbench import counts, peaks


def value(run):
    c, t = run.cell.cfg, run.cell.t
    steps = len(run.window.items)
    if not steps:
        return None
    B, S = t["batch"], t["seq_len"]
    n_active = counts.block_weights_active(c) + counts.head_weights(c)
    step = 6.0 * n_active * B * S + counts.attention_flops(c, B, S, True)
    return 100.0 * steps * step / (run.window.seconds * peaks.BF16_FLOPS)
