"""The gate of a serving mix: whether the card is busy for at least half
of the host's time.

    python3 -m neube_bench.gate --traffic serve-pooled-64p [--seed N]

The painters paint a window of ``SECONDS``, then ``trace_seconds`` under
the profiler.  The busy share is the device's busy time per
stroke in the traced phase (the union of the profiler's CUDA intervals)
over the seconds per stroke of the untraced window: the profiler stretches
the host's time and not the device's, so the traced phase alone reads
more idle than the mix is.  A mix whose card is busy for less than half of
that time is paced by the host: its end-to-end numbers would measure the
host, so it becomes no cell.  Prints one ``[gate]`` JSON line: the busy
share, the traced phase's busy share of its own window beside it, rows per
pass, strokes/s, the client latency's p50 and p95, the side channel's
queue and render p50, the top device operations and the idle gaps by host
activity, and the peak device memory.  Runs the configuration
``CONFIG``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from neube_bench import run

CONFIG = "neube-flagship-256"
SECONDS = 10.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=4306)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    with open(os.path.join(run.ROOT, "neube_bench", "configs",
                           CONFIG + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(run.ROOT, "neube_bench", "traffic",
                           args.traffic + ".json")) as f:
        traffic = json.load(f)
    c = run.driver(traffic).Cell(cfg, traffic, args.seed, "cuda")
    c.setup()
    out = {}
    w = c.window(SECONDS, out)
    tr = out["trace"]
    lat = w["latencies_ms"]
    busy_per_stroke = tr.busy_s / c.trace_strokes
    busy_share = busy_per_stroke * w["replies"] / w["seconds"]
    res = {"traffic": args.traffic, "setup_phases": c.setup_phases,
           "busy_share": busy_share, "passes": bool(busy_share >= 0.5),
           "trace_window_s": tr.window_s, "trace_busy_s": tr.busy_s,
           "trace_strokes": c.trace_strokes,
           "trace_busy_share": tr.busy_s / tr.window_s,
           "trace_strokes_per_s": c.trace_strokes / tr.window_s,
           "trace_rows_per_pass": statistics.mean(c.trace_passes),
           "window_rows_per_pass": statistics.mean(c.window_passes),
           "strokes_per_s": w["replies"] / w["seconds"],
           "strokes": len(lat), "p50_ms": statistics.median(lat),
           "p95_ms": statistics.quantiles(lat, n=20)[-1],
           "queue_ms_p50": statistics.median(w["queue_ms"]),
           "render_ms_p50": statistics.median(w["render_ms"]),
           "failed": c.counters()["failed"],
           "top_ops": tr.top_device_ops(6), "idle_gaps": tr.idle_gaps(6),
           "memory_peak_bytes": torch.cuda.max_memory_allocated(),
           "card": torch.cuda.get_device_name()}
    c.free_program()
    print("[gate] " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
