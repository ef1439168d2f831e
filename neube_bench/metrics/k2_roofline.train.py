"""``k2_roofline.train``: the ADA warp's kernels' share of their roofline
in the traced period: the least time of the period's W and Wᵀ launches
(each a batch of images read and one written, over the memory rate;
``workcount/train.py``) over the device time of the kernels of W
(``warp_fused``) and of Wᵀ (``resample_gather_t``, two launches per Wᵀ)
summed from the profiler.  Nothing when the trace holds no such kernel, or
not as many launches as the period's phases make."""

from neube_bench.workcount import peaks
from neube_bench.workcount.train import k2_bytes, period_k2

W_KERNEL, WT_KERNEL = "warp_fused", "resample_gather_t"


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    if not c["trace_batches"]:
        return None
    n_w, n_wt = period_k2(ctx["cfg"], c["trace_batches"])
    w_s, w_n = tr.device_seconds(lambda name: W_KERNEL in name)
    t_s, t_n = tr.device_seconds(lambda name: WT_KERNEL in name)
    if w_n != n_w or t_n != 2 * n_wt or w_s + t_s <= 0:
        return None
    bound = (n_w + n_wt) * k2_bytes(ctx["cfg"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (w_s + t_s)
