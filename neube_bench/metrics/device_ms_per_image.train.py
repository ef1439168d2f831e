"""``device_ms_per_image.train``: milliseconds in which the device was busy
(the union of the profiler's CUDA intervals) per image of the traced
period's batches.  The device's own cost of an image trained, steadier
than the host clock's rate."""


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    if not tr.device or not c["trace_batches"]:
        return None
    return 1e3 * tr.busy_s / (c["trace_batches"] * c["batch"])
