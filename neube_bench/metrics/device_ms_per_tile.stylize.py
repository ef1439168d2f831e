"""``device_ms_per_tile.stylize``: milliseconds in which the device was
busy (the union of the profiler's CUDA intervals) per tile of the traced
window's drawings.  The device's own cost of a tile, steadier than the
host clock's rate, which the shared host's load moves."""


def read(ctx):
    tr = ctx["trace"]
    tiles = ctx["counters"]["trace_tiles"]
    if not tr.device or not tiles:
        return None
    return 1e3 * tr.busy_s / tiles
