"""The 95th percentile (linear between order statistics), over every
request of the window, of the milliseconds from its send to its first
token on the host."""
import numpy as np


def value(run):
    lat = [it["t_done"] - it["t_sent"] for it in run.window.items]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
