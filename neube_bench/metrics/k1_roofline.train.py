"""``k1_roofline.train``: the fused FIR-epilogue kernel's share of its
roofline in the traced period: the least time of its launches (per launch
the larger of its bytes over the memory rate and its operations over the
float32 rate; ``workcount/train.py:period_k1``: Dmain's, Gmain's and Gpl's
generator passes) over the kernel's device time summed from the profiler.
Its backward runs as torch operations and is not counted.  Nothing when
the trace holds no such kernel, or not one launch per up-sampling layer of
each generator pass of the period."""

from neube_bench.workcount import peaks
from neube_bench.workcount.train import period_k1

KERNEL = "fir4_epilogue"


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    if not c["trace_batches"]:
        return None
    launches = period_k1(ctx["cfg"], c["trace_batches"])
    dev_s, n = tr.device_seconds(lambda name: KERNEL in name)
    if n != len(launches) or dev_s <= 0:
        return None
    bound = sum(max(b / peaks.HBM_BYTES_PER_S, f / peaks.FLOPS_PER_S["f32"])
                for _, b, f in launches)
    return 100.0 * bound / dev_s
