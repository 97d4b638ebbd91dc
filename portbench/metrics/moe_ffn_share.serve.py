"""The MoE FFN's share of the window's prefill time: CUDA-event time
around each call of the port's ``moe_ffn`` (routing, dispatch, the
grouped matmuls, combine) over the window's host-clock time."""

PROBE = "repro_torch.models.layers:moe_ffn"


def summarize(args, kwargs):
    return None


def value(run):
    calls = run.probes.get(PROBE) or []
    if not calls:
        return None
    return 100.0 * sum(dt for dt, _ in calls) / run.window.seconds
