"""``syncs_per_pass.stylize``: the host's CUDA runtime calls that wait for
the device and start inside the program's ``bse.stylize`` spans, per
``bse.render.pass`` span.  Nothing when the trace holds no device activity
or no ``bse.render.pass`` span."""

import bisect

from neube_bench.trace import union

# The runtime calls that block the host until the device has caught up, by
# the names the profiler gives them.
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy"}


def read(ctx):
    tr = ctx["trace"]
    n = sum(1 for name, _, _ in tr.host if name == "bse.render.pass")
    if not tr.device or not n:
        return None
    calls = union([(s, e) for name, s, e in tr.host
                   if name == "bse.stylize"])[1]
    starts = [s for s, _ in calls]
    syncs = 0
    for name, s, _ in tr.host:
        if name in SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            syncs += i >= 0 and s <= calls[i][1]
    return syncs / n
