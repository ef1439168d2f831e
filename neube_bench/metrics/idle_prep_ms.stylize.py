"""``idle_prep_ms.stylize``: milliseconds per drawing in which the device
was idle inside the program's ``bse.stylize`` span and outside every
``bse.stylize.chunk``: the stylize call's host stages before and after its
chunk loop (padding, the crops, the geometry's uint8 test and upload, the
canvas's copy to the host), per ``bse.stylize`` span.  Nothing when the
trace holds no device activity or no ``bse.render.pass`` span."""

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
    calls = _merged(tr, "bse.stylize")
    n = sum(1 for name, _, _ in tr.host if name == "bse.stylize")
    if not tr.device or not n or not _merged(tr, "bse.render.pass"):
        return None
    chunks = _cut(calls, _merged(tr, "bse.stylize.chunk"))
    return (_idle_ms(tr, calls) - _idle_ms(tr, chunks)) / n
