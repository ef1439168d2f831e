"""``k1_roofline.stylize``: the fused FIR-epilogue kernel's share of its
roofline in the traced window: the least time of its launches (per launch
the larger of bytes over the memory rate and operations over the float32
rate, ``workcount/flops.py:k1_launches``, from each pass's rows) over the
kernel's device time summed from the profiler.  Nothing when the trace
holds no such kernel, or not one launch per up-sampling layer of each
pass."""

from neube_bench.workcount import flops, peaks

KERNEL = "fir4_epilogue"


def read(ctx):
    tr = ctx["trace"]
    passes = ctx["counters"]["trace_passes"]
    dev_s, n = tr.device_seconds(lambda name: KERNEL in name)
    per_pass = len(flops.k1_launches(ctx["cfg"], 1))
    if not n or dev_s <= 0 or n != per_pass * len(passes):
        return None
    bound = sum(flops.k1_bound_seconds(ctx["cfg"], b, peaks.HBM_BYTES_PER_S,
                                       peaks.FLOPS_PER_S["f32"])
                for b in passes)
    return 100.0 * bound / dev_s
