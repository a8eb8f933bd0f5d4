"""A torch.profiler slice, reduced to what the per-layer readers take:
each device activity (name, start, end), the host's ops, the union of
device-busy time, the top device operations and the idle gaps labelled by
what the host was doing."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple


class Slice:
    """One profiled slice: ``kernels`` [(name, start_s, end_s)], ``host``
    [(name, start_s, end_s)], both in the profiler's clock, and the slice's
    length on the host clock (``window_s``, synchronised at both ends)."""

    def __init__(self, kernels, host, window_s: float):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.host = host
        self.window_s = window_s

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, a, b in self.kernels:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def time_of(self, pred) -> Tuple[float, int]:
        """(device seconds, launches) of the activities whose name ``pred`` takes."""
        sel = [b - a for name, a, b in self.kernels if pred(name)]
        return sum(sel), len(sel)

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Device-idle time between activities, summed by the innermost host
        op running at each gap's middle ("host python" where none runs)."""
        busy = self.busy_intervals()
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]
        host = sorted(self.host, key=lambda h: h[1])
        by: Dict[str, float] = {}
        active: list = []
        i = 0
        for e0, s1 in gaps:  # in time order: one sweep over the host's ops
            mid = 0.5 * (e0 + s1)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            label = max(active, key=lambda h: h[1])[0] if active else "host python"
            by[label] = by.get(label, 0.0) + (s1 - e0)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def reduce(prof, window_s: float) -> Slice:
    import torch

    kernels, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == cuda:
            kernels.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    return Slice(kernels, host, window_s)


@contextlib.contextmanager
def profiled(sync):
    """Profile the enclosed work, host and device; yields a dict that gets
    ``slice`` (a :class:`Slice`) on exit.  Both ends synchronise."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, Optional[Slice]] = {"slice": None}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        t1 = time.perf_counter()
    out["slice"] = reduce(prof, t1 - t0)
