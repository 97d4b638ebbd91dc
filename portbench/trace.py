"""The profiled sub-window: a few more steps or calls under
``torch.profiler``, reduced to the device's busy seconds (the union of
its kernels, copies and sets), the window's length, the device
operations that took most time, and the device's idle time by what the
host was doing meanwhile (the innermost host operation running at each
gap's middle)."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

#: the host's span around the profiled sub-window
MARK = "portbench.profiled_window"
TOP = 10


def _top(totals: Dict[str, float]) -> List[list]:
    return [[n[:160], s] for n, s in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(device_spans: List[Tuple[float, float, str]],
           host_spans: List[Tuple[float, float, str]],
           w0: float, w1: float) -> dict:
    """Busy and idle time of the device within ``[w0, w1]`` (seconds), from
    its operations' spans and the host's (``(start, end, name)``)."""
    ops: Dict[str, float] = defaultdict(float)
    spans = []
    for s, e, name in device_spans:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            ops[name] += e - s
            spans.append((s, e))
    spans.sort()
    busy, gaps, cur = 0.0, [], w0
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    host = sorted(host_spans)
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid, name = (g0 + g1) / 2, "host: no operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += g1 - g0
    return {"busy_s": busy, "window_s": w1 - w0,
            "device_ops": _top(ops), "idle_gaps": _top(idle)}


def profile(fn: Callable[[], None], device) -> dict:
    """Run ``fn`` under the profiler and :func:`reduce` what it recorded
    on the device and the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(MARK):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    dev, host, mark = [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            dev.append((s, t, e.name))
        elif e.name == MARK:
            mark = (s, t)
        else:
            host.append((s, t, e.name))
    # a host span's mirror on the device timeline (a user annotation) is
    # no device operation
    names = {h[2] for h in host} | {MARK}
    dev = [d for d in dev if d[2] not in names]
    if mark is None:
        raise RuntimeError("the profiler recorded no host span of the "
                           "profiled window")
    if not dev and torch.device(device).type == "cuda":
        raise RuntimeError("the profiler recorded no device operation")
    return reduce(dev, host, *mark)
