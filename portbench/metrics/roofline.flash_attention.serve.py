"""Flash attention's share of its roofline in the window's prefills: the
sum over its calls of the least time one H100 needs for the call's shapes
(the larger of its operations at the bf16 peak and its bytes at HBM's
rate) over the sum of the calls' times, by CUDA events around each call of
the port's ``flash_attention`` entry.  Operations: ``4 * B * H * pairs *
d`` over causal pairs within the window; bytes: q, k and v as passed read
once, the output written once."""
from portbench import counts, peaks

PROBE = "repro_torch.models.layers:flash_attention"


def summarize(args, kwargs):
    q, k = args[0], args[1]
    causal = args[3] if len(args) > 3 else kwargs.get("causal", True)
    window = args[4] if len(args) > 4 else kwargs.get("window")
    return tuple(q.shape), tuple(k.shape), q.element_size(), causal, window


def bound_s(summary) -> float:
    (B, H, Sq, d), (_, Hk, Sk, _), esize, causal, window = summary
    pairs = counts.attn_pairs(Sq, window) if causal and Sq == Sk \
        else Sq * Sk
    ops = 4.0 * B * H * pairs * d
    nbytes = esize * (2 * B * H * Sq * d + 2 * B * Hk * Sk * d)
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def value(run):
    calls = run.probes.get(PROBE) or []
    spent = sum(dt for dt, _ in calls)
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(bound_s(s) for _, s in calls) / spent
