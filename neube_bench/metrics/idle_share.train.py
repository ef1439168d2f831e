"""``idle_share.train``: the share of the host's time per batch in which no
device activity ran: 1 - the traced period's device busy time per batch
(the union of the profiler's CUDA intervals) over the seconds per batch of
the untraced periods before it.  Not over the traced period itself: the
profiler stretches the host's time between launches and leaves the
device's as it is."""


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    if not tr.device or not c["trace_batches"] or not c["host_batches"]:
        return None
    busy = tr.busy_s / c["trace_batches"]
    return 100.0 * (1.0 - busy / (c["host_seconds"] / c["host_batches"]))
