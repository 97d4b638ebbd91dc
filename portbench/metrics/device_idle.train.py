"""Share of the profiled sub-window (a few training steps after the
window) in which no operation ran on the device, from the profiler's
device timeline."""


def value(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
