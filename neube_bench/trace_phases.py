"""What a traced window holds inside the program's own spans: the host
intervals of a span, the device-idle time inside them, and the device time
of the kernels launched inside them.

A phase's backward kernels are launched by autograd's thread, not by the
thread that opened the span, so a kernel belongs to a span by the time of
its launch on the host, whatever the thread: the window's kernel launches
(the runtime's and the driver's launch calls) are matched in order to its
device kernels, which one stream runs in the order they were launched.
"""

from __future__ import annotations

import bisect

from neube_bench.trace import union

LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"})
NOT_KERNELS = ("Memcpy", "Memset")


def intervals(tr, name: str):
    """The merged host intervals of span ``name`` within the window."""
    t0, t1 = tr.span
    return [(max(s, t0), min(e, t1))
            for s, e in union([(s, e) for n, s, e in tr.host
                               if n == name])[1] if e > t0 and s < t1]


def count(tr, name: str) -> int:
    return sum(1 for n, _, _ in tr.host if n == name)


def idle_ms(tr, spans) -> float:
    """Milliseconds inside ``spans`` (merged) in which no device activity
    ran."""
    busy = union([(s, e) for _, s, e in tr.device])[1]
    total, j = 0.0, 0
    for s, e in spans:
        total += e - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total -= min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return 1e3 * total


def launched_seconds(tr, spans):
    """Device seconds of the kernels launched inside ``spans``; None when
    the window's launches and kernels do not pair up one to one."""
    launches = sorted(s for n, s, _ in tr.host if n in LAUNCHES)
    kernels = sorted((s, e) for n, s, e in tr.device
                     if not n.startswith(NOT_KERNELS))
    if not kernels or len(launches) != len(kernels):
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for t, (s, e) in zip(launches, kernels):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            total += e - s
    return total
