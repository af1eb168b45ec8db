"""A traced part of a run: ``torch.profiler`` over CPU and CUDA, reduced to
device busy time, the device operations that took most time, and the
device's idle gaps by what the host was doing (the innermost host span that
covers each gap: the benchmark's own ``record_function`` spans and the
operators beneath them)."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."         # the benchmark's own record_function spans


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)      # (name, start_us, end_us) on the device
    device_ops: list = field(default_factory=list)   # [name, seconds], the 10 largest
    idle_gaps: list = field(default_factory=list)    # [host span, seconds], the 10 largest

    def seconds(self, match) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name ``match`` accepts."""
        spans = [(e - s) for n, s, e in self.kernels if match(n)]
        return sum(spans) / 1e6, len(spans)


class Tracer:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self.window = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> TraceSummary:
        """The stopped trace reduced (after the measured window: it takes seconds)."""
        return summarize(self.prof.events(), self.window)


def _union(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, window_s: float) -> TraceSummary:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # a host span's device-side copy (ours, or the optimizer's) is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
                dev.append((e.name, *rng))
        elif e.device_type == DeviceType.CPU:
            host.append((*rng, e.name))
    busy = _union([(s, e) for _, s, e in dev])
    by_name = defaultdict(float)
    for n, s, e in dev:
        by_name[n] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    idle = defaultdict(float)
    host.sort()
    active, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = active[-1][2] if active else "no host span"
        idle[label] += (g1 - g0) / 1e6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=window_s,
                        busy_s=sum(e - s for s, e in busy) / 1e6, kernels=dev,
                        device_ops=[[n[:120], v] for n, v in top],
                        idle_gaps=[[n[:120], v] for n, v in gaps_top])
