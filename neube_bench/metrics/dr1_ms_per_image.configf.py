"""``dr1_ms_per_image.configf``: device milliseconds of the kernels
launched inside the program's ``bse.train.Dr1`` spans (R1's forward, its
gradient and the double backward, by launch time on the host, whatever
the thread; ``trace_phases.py``) per image the traced period trains.
Nothing when the trace holds no such span or its launches and kernels do
not pair up."""

from neube_bench import trace_phases as P


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    spans = P.intervals(tr, "bse.train.Dr1")
    if not spans or not c["trace_batches"]:
        return None
    s = P.launched_seconds(tr, spans)
    return None if s is None else 1e3 * s / (c["trace_batches"] * c["batch"])
