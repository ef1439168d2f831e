"""The traced window: ``torch.profiler`` over CPU and CUDA activity, and
its reduction to what the per-layer readers and the result line read.

``busy`` is the union of the intervals in which any device activity
(kernel, copy, set) ran; the idle share is what of the window it leaves.
An idle gap is labelled by the innermost host operation that was running
at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "neube_bench.window"


def union(spans: List[Tuple[float, float]]):
    """(total length, merged spans) of ``spans`` (start, end)."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class Trace:
    """What one traced window recorded, in seconds."""

    def __init__(self, window_s: float, device: List, host: List, span):
        # device / host: [(name, start_s, end_s)]; span: the window's
        # (start_s, end_s) on the profiler's clock.
        self.window_s = window_s
        self.span = span
        self.device = device
        self.host = host
        busy, merged = union([(s, e) for _, s, e in device])
        self.busy_s = busy
        self._merged = merged

    def device_seconds(self, match) -> Tuple[float, int]:
        """(summed device seconds, launches) of the device operations whose
        name ``match(name)`` accepts."""
        total, n = 0.0, 0
        for name, s, e in self.device:
            if match(name):
                total += e - s
                n += 1
        return total, n

    def top_device_ops(self, k: int = 10):
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name[:200]] += e - s
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The idle time between device activity within the window, summed
        by the innermost host operation running at each gap's middle."""
        t0, t1 = self.span
        edges = [t0] + [x for s, e in self._merged for x in (s, e)] + [t1]
        host = sorted(self.host, key=lambda r: r[1])
        starts = [s for _, s, _ in host]
        by = defaultdict(float)
        for i in range(0, len(edges) - 1, 2):
            a, b = max(edges[i], t0), min(edges[i + 1], t1)
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            label = "host (no operation)"
            j = bisect.bisect_right(starts, mid) - 1
            for _ in range(4000):
                if j < 0:
                    break
                name, s, e = host[j]
                if e >= mid:
                    label = name
                    break
                j -= 1
            by[label[:200]] += b - a
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]


@contextlib.contextmanager
def traced(device_type: str, out: Dict):
    """Profile the body; ``out['trace']`` gets the :class:`Trace`.  On the
    CPU (tests) only host activity is recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            yield
            if device_type == "cuda":
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    dev, host = [], []
    span = None
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == DeviceType.CUDA:
            # A host span (record_function) shows on the device's timeline
            # too; it is no device activity.
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("neube_bench.")):
                dev.append((ev.name, s, e))
        elif ev.name == WINDOW:
            span = (s, e)
        else:
            host.append((ev.name, s, e))
    if span is not None:
        window = span[1] - span[0]
    else:
        span = (min(s for _, s, _ in host), max(e for _, _, e in host))
    out["trace"] = Trace(window, dev, host, span)
