"""``idle_pass_ms.stylize``: milliseconds per render pass in which the
device was idle inside the program's ``bse.render.pass`` spans: the host
issuing the pass's launches faster or slower than the device runs them.
The profiler stretches the host's time between launches, so this reads
high against an untraced pass.  Nothing when the trace holds no device
activity or no ``bse.render.pass`` span."""

from neube_bench.trace import union


def _merged(tr, name):
    return union([(s, e) for n, s, e in tr.host if n == name])[1]


def _cut(a, b):
    """The intersection of two merged lists of spans."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _idle_ms(tr, spans):
    """Milliseconds of the traced window inside ``spans`` (merged) in which
    no device activity ran."""
    spans = _cut(spans, [tr.span])
    busy = _cut(spans, union([(s, e) for _, s, e in tr.device])[1])
    return 1e3 * (sum(e - s for s, e in spans) - sum(e - s for s, e in busy))


def read(ctx):
    tr = ctx["trace"]
    passes = _merged(tr, "bse.render.pass")
    n = sum(1 for name, _, _ in tr.host if name == "bse.render.pass")
    if not tr.device or not n:
        return None
    return _idle_ms(tr, passes) / n
