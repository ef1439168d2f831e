"""The serving driver behind the gate (``neube_bench/gate.py``) on the
CPU: closed-loop painters on the pooled path get every reply, the batcher
counts its passes, and the traced phase has a window."""

import json
import os

from small import ROOT, small_cell
from neube_bench.drivers import serve


def test_pooled_painters_get_every_reply():
    import torch
    torch.set_num_threads(2)
    _, _, cfg, _ = small_cell()
    with open(os.path.join(ROOT, "neube_bench", "traffic",
                           "serve-pooled-64p.json")) as f:
        traffic = json.load(f)
    traffic.update(painters=3, canvas=96, warm_seconds=0.3,
                   trace_seconds=0.3, plan_strokes=50)
    c = serve.Cell(cfg, traffic, 2 ** 31 + 9, "cpu")
    c.setup()
    out = {}
    w = c.window(0.5, out)
    c.free_program()
    assert w["replies"] > 0 and len(w["latencies_ms"]) >= w["replies"]
    assert all(v < float("inf") for v in w["latencies_ms"])
    assert c.trace_passes and max(c.window_passes) <= 3
    assert out["trace"].window_s > 0 and c.trace_strokes > 0
    assert c.counters()["failed"] == 0
