"""``mfu.configf``: the whole training step's share of the card's peak in
the config-f cell: the least time of the untraced periods' products (every
convolution and matrix product of the 'skip' G and the 'resnet' D in the
four phases, forward, backward and second backward, each at the peak of
the dtype it runs in; ``workcount/configf.py``) over those periods'
seconds on the host clock."""

from neube_bench.workcount import peaks
from neube_bench.workcount.configf import period_least_seconds


def read(ctx):
    c = ctx["counters"]
    if not c["host_batches"] or c["host_seconds"] <= 0:
        return None
    p = c["period_batches"]
    least = period_least_seconds(ctx["cfg"], p, peaks.FLOPS_PER_S) \
        * c["host_batches"] / p
    return 100.0 * least / c["host_seconds"]
