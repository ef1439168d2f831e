"""The readers of the program's spans (``idle_prep_ms``, ``idle_loop_ms``,
``idle_pass_ms``, ``launches_per_pass``, ``syncs_per_pass``, all
``.stylize``) on hand-placed traces: each against its value by hand, the
idle time they split adding up to the window's, and nothing read from a
trace without device activity or without a pass (the program before it
had spans)."""

import pytest

from small import ROOT  # noqa: F401  (puts the checkout on the path)

from neube_bench import run
from neube_bench.trace import Trace

READERS = ("idle_prep_ms.stylize", "idle_loop_ms.stylize",
           "idle_pass_ms.stylize", "launches_per_pass.stylize",
           "syncs_per_pass.stylize")

# Times in ms (seconds / 1e3), so the idle readers' ms read as written.
DEVICE = [(0, 3), (14, 20), (25, 40), (52, 58), (70, 80), (96, 101)]
SPANS = [("bse.stylize", 5, 60), ("bse.stylize", 62, 98),
         ("bse.stylize.chunk", 10, 30), ("bse.stylize.chunk", 32, 55),
         ("bse.stylize.chunk", 65, 95),
         ("bse.render.pass", 12, 28), ("bse.render.pass", 34, 50),
         ("bse.render.pass", 67, 90),
         ("bse.render.block64", 15, 20), ("aten::add", 41, 42)]
CALLS = [("cudaStreamSynchronize", 11, 11.5), ("cudaLaunchKernel", 13, 13.1),
         ("cudaMemcpy", 31, 31.5), ("cudaStreamSynchronize", 61, 61.2),
         ("cudaDeviceSynchronize", 70, 70.1),
         ("cudaEventSynchronize", 99, 99.5)]


def trace(device=DEVICE, host=SPANS + CALLS):
    ms = 1e-3
    return Trace(100 * ms, [("k", s * ms, e * ms) for s, e in device],
                 [(n, s * ms, e * ms) for n, s, e in host], (0.0, 100 * ms))


def read(tr):
    return {m: run.reader(m)({"trace": tr}) for m in READERS}


def test_each_reader_by_hand():
    got = read(trace())
    # Idle inside the passes: 16 - 9, 16 - 6, 23 - 10 ms.
    assert got["idle_pass_ms.stylize"] == pytest.approx(30 / 3)
    # Inside the chunks and outside the passes: 9 - 7, 12 - 10, 20 - 13.
    assert got["idle_loop_ms.stylize"] == pytest.approx(11 / 3)
    # Inside the stylize calls and outside the chunks: 28 - 21, 24 - 20.
    assert got["idle_prep_ms.stylize"] == pytest.approx(11 / 2)
    # Six device operations over three passes.
    assert got["launches_per_pass.stylize"] == 2.0
    # The syncs at 11, 31 and 70 start inside a stylize call; those at 61
    # and 99 do not, and a launch is no sync.
    assert got["syncs_per_pass.stylize"] == 1.0


def test_idle_parts_add_up_to_the_window():
    got = read(trace())
    idle = 100 - 44        # the device busy [0,3] ... [96,100]: 44 ms
    outside = 4            # idle in [0,5], [60,62], [98,100]
    parts = (got["idle_prep_ms.stylize"] * 2
             + got["idle_loop_ms.stylize"] * 3
             + got["idle_pass_ms.stylize"] * 3)
    assert parts + outside == pytest.approx(idle)


def test_overlapping_device_work_and_spans_count_once():
    doubled = DEVICE + [(15, 19), (26, 39)]
    spans = SPANS + [("bse.render.pass", 12, 28)]
    got = read(trace(doubled, spans + CALLS))
    base = read(trace())
    for m in ("idle_prep_ms.stylize", "idle_loop_ms.stylize"):
        assert got[m] == pytest.approx(base[m])
    # The same idle time over one pass more.
    assert got["idle_pass_ms.stylize"] == pytest.approx(30 / 4)


def test_nothing_without_device_activity_or_a_pass():
    assert all(v is None for v in read(trace(device=[])).values())
    no_pass = [s for s in SPANS if s[0] != "bse.render.pass"]
    assert all(v is None for v in read(trace(host=no_pass + CALLS)).values())
    # The program before its spans: only the benchmark's own and aten ops.
    bare = [("neube_bench.pass", 12, 28), ("aten::add", 41, 42)]
    assert all(v is None for v in read(trace(host=bare + CALLS)).values())
