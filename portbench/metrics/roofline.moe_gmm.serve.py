"""The grouped expert matmul's share of its roofline in the window's
prefills: the sum over its calls of the least time one H100 needs for the
call (the larger of its operations at the bf16 peak and its bytes at
HBM's rate) over the sum of the calls' times, by CUDA events around each
call of the port's ``moe_gmm`` entry.  Operations: ``2 * D * F`` for each
live row (``counts``); bytes: the live rows of x, the weights of every
expert with a live row, the whole ``[E, C, F]`` output and the counts."""
from portbench import peaks

PROBE = "repro_torch.models.layers:moe_gmm"


def summarize(args, kwargs):
    x, w, cnt = args[0], args[1], args[2]
    return tuple(x.shape), tuple(w.shape), x.element_size(), \
        cnt.detach().clone()


def bound_s(E, C, D, F, esize, rows, live) -> float:
    ops = 2.0 * rows * D * F
    nbytes = esize * (rows * D + live * D * F + E * C * F) + 4 * E
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def value(run):
    calls = run.probes.get(PROBE) or []
    spent = sum(dt for dt, _ in calls)
    if not calls or spent <= 0:
        return None
    bound = 0.0
    for _, ((E, C, D), (_, _, F), esize, cnt) in calls:
        rows, live = int(cnt.sum()), int((cnt > 0).sum())
        bound += bound_s(E, C, D, F, esize, rows, live)
    return 100.0 * bound / spent
