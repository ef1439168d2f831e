"""Run one cell of the benchmark once and print its result line.

    python3 -m neube_bench.run --workload NAME --seed N --seconds S
        --trace 0|1

From the root of a checkout.  It reads ``BENCHMARK.json``, finds the cell,
its configuration file and its traffic file (``neube_bench/traffic/
<traffic>.json``, whose ``driver`` names the general driver under
``neube_bench/drivers/``), makes the weights and inputs from ``--seed``,
warms up, measures for ``--seconds`` and checks the outputs against the
plain reference.  With ``--trace 0`` the result holds the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, each read by its own
reader ``neube_bench/metrics/<metric>.py`` from the traced window.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the compared numbers are also the last lines of standard error.  It exits
non-zero without a result when there is no CUDA device (or fewer than the
cell asks for), or when the process holds JAX or the JAX package once the
window has closed.  Kernel builds go to ``build/`` of the checkout.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started, from ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


PROCESS_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")

# Every build and kernel cache at a fixed path inside the checkout.
os.environ["BSE_XLA_CACHE_DIR"] = BUILD
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "brushstroke_engine_tpu"}


def load_manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(manifest, workload: str):
    """(cell, configuration dict, traffic dict) of ``workload``."""
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "neube_bench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, cfg, traffic


def cell_metrics(manifest, workload: str, trace: bool):
    """The metric entries the cell reports in this kind of run."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """The ``read(ctx)`` function of metric ``name``."""
    path = os.path.join(ROOT, "neube_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "neube_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(traffic):
    return importlib.import_module("neube_bench.drivers." + traffic["driver"])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def run_cell(manifest, cell, cfg, traffic, seed: int, seconds: float,
             trace: bool, device, impl: str = "program",
             cell_hook=None, info=None):
    """Set up, warm, measure and check one cell (its BENCHMARK.json entry,
    configuration and traffic); returns the result dict (``checks``
    last).  ``cell_hook(driver_cell)`` runs after set-up: tests break the
    timed path there.  ``info`` (a dict) gets the set-up's phases."""
    import torch
    workload = cell["name"]
    c = driver(traffic).Cell(cfg, traffic, seed, device, impl)
    t_cell = time.time()
    c.setup()
    if info is not None:
        info["setup_phases"] = {"before the cell": t_cell - PROCESS_START,
                                **getattr(c, "setup_phases", {})}
    if cell_hook is not None:
        cell_hook(c)
    setup_s = time.time() - PROCESS_START
    out = {} if trace else None
    win = c.window(seconds, out)
    if info is not None:
        info["window"] = win
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = {"cell": cell, "cfg": cfg, "traffic": traffic, "window": win,
           "setup_s": setup_s, "counters": c.counters(),
           "trace": out["trace"] if trace else None}
    metrics = {}
    for m in cell_metrics(manifest, workload, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    c.free_program()
    numbers = c.check()
    limits = traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    cnt = ctx["counters"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": cnt["attempted"],
              "failed": cnt["failed"], "metrics": metrics,
              "device": device_info}
    if trace:
        tr = ctx["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    cell, cfg, traffic = cell_parts(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    info = {}
    result = run_cell(manifest, cell, cfg, traffic, args.seed, args.seconds,
                      bool(args.trace), "cuda", info=info)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the port may not load JAX",
              file=sys.stderr)
        return 3
    print("setup " + ", ".join(f"{k} {v:.3f} s"
                               for k, v in info["setup_phases"].items()),
          file=sys.stderr)
    units = info["window"].get("unit_seconds")
    if units:
        print("window unit seconds " + " ".join(f"{u:.4f}" for u in units),
              file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
