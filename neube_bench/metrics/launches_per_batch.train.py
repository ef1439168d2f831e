"""``launches_per_batch.train``: device operations (kernels, copies, sets:
every entry of the traced period's device list) per batch."""


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    if not tr.device or not c["trace_batches"]:
        return None
    return len(tr.device) / c["trace_batches"]
