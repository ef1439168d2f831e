"""``data_wait_ms.configf``: milliseconds per batch in which the device was
idle inside the program's ``bse.train.data`` spans: the trainer waiting
for the data chain's next batch (four 1024-px PNGs decoded) with nothing
queued on the device.  Nothing when the trace holds no device activity or
no such span."""

from neube_bench import trace_phases as P


def read(ctx):
    tr = ctx["trace"]
    spans = P.intervals(tr, "bse.train.data")
    n = P.count(tr, "bse.train.data")
    if not tr.device or not spans:
        return None
    return P.idle_ms(tr, spans) / n
