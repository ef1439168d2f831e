"""``idle_loop_ms.stylize``: milliseconds per chunk in which the device was
idle inside the program's ``bse.stylize.chunk`` spans and outside every
``bse.render.pass``: each chunk's window gathers and scatters, their index
building and the syncs it makes, per chunk span.  Nothing when the trace
holds no device activity, no ``bse.render.pass`` span or no chunk."""

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
    chunks = _merged(tr, "bse.stylize.chunk")
    n = sum(1 for name, _, _ in tr.host if name == "bse.stylize.chunk")
    passes = _merged(tr, "bse.render.pass")
    if not tr.device or not n or not passes:
        return None
    return (_idle_ms(tr, chunks) - _idle_ms(tr, _cut(chunks, passes))) / n
