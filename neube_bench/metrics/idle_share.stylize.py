"""``idle_share.stylize``: the share of the host's time per tile in which
no device activity ran: 1 - the device's busy time per tile of the traced
drawings (the union of the profiler's CUDA intervals) over the seconds per
tile of the untraced drawings that follow them.  Not over the traced
window itself: the profiler stretches the host's time between launches
and leaves the device's as it is, so the traced window reads more idle
than an untraced run is."""


def read(ctx):
    tr = ctx["trace"]
    c = ctx["counters"]
    if not tr.device or not c["trace_tiles"] or not c["host_tiles"]:
        return None
    busy = tr.busy_s / c["trace_tiles"]
    return 100.0 * (1.0 - busy / (c["host_seconds"] / c["host_tiles"]))
