"""Share of the profiled sub-window (after the window, one call at each
length of one round of the deck, ``profile_round``: the same lengths in
every run) in which no operation ran on the device, from the profiler's
device timeline."""


def value(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
