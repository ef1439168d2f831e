"""``mfu.stylize``: the whole pass's share of the card's peak: the least
time the tiles of the untraced drawings need, each layer's convolutions and
matrix products at the published peak of the dtype the configuration runs
it in (``workcount``), over those drawings' seconds on the host clock.  It
counts the tiles, not the rows rendered: a row that pads a wave's last
chunk is no work the drawing needs."""

from neube_bench.workcount import flops, peaks


def read(ctx):
    c = ctx["counters"]
    if not c["host_tiles"] or c["host_seconds"] <= 0:
        return None
    least = c["host_tiles"] * flops.least_seconds(ctx["cfg"], 1,
                                                 peaks.FLOPS_PER_S)
    return 100.0 * least / c["host_seconds"]
