"""Readings that the training cell's limits are set from, many seeds in
one process.

    python3 -m neube_bench.calibrate_train --workload train-b64
        --seeds 1,2,3 [--control_seeds 4,5,6] [--fault_seeds 7,8,9]
        [--controls a,b] [--out FILE]

For each seed it sets the cell up as a run does, runs its checked
batches on the warm loop (with no window before them) and prints the compared numbers of the program (``[program]`` lines); on
each control seed, the same set-up also gives the numbers of each control
of the reference put in the program's place (``[control]`` lines,
``drivers/train.py:CONTROLS``); on each fault seed the program runs once
more for each fault planted underneath (``[fault]`` lines).  The limits in
the traffic file sit between the largest program reading and the smallest
control or fault reading (``PERF.md`` gives both).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from neube_bench import run

FAULTS = ("unchanged", "half_batch", "altered")


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(cfg, traffic, seed, impl, controls=()):
    """[(impl, numbers)] of one set-up: ``impl`` and then each control."""
    import torch
    c = run.driver(traffic).Cell(cfg, traffic, seed, "cuda", impl)
    c.setup()
    c.run_checked()
    peak = torch.cuda.max_memory_allocated()
    c.free_program()
    out = []
    for kind in (impl,) + tuple("control:" + k for k in controls):
        c.impl = kind
        t = time.perf_counter()
        c.check()
        out.append((kind, {**c.diagnostics,
                           "check_s": time.perf_counter() - t,
                           "setup_peak_bytes": peak}))
    del c
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--fault_seeds", default="")
    ap.add_argument("--controls", default="",
                    help="the controls of the control seeds (default all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from neube_bench.drivers.train import CONTROLS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    manifest = run.load_manifest()
    _, cfg, traffic = run.cell_parts(manifest, args.workload)
    jobs = [(s, "program", ()) for s in _seeds(args.seeds)]
    controls = tuple(c for c in args.controls.split(",") if c) \
        or tuple(CONTROLS)
    jobs += [(s, "program", controls) for s in _seeds(args.control_seeds)]
    jobs += [(s, "fault:" + f, ()) for s in _seeds(args.fault_seeds)
             for f in FAULTS]
    lines = []
    for seed, impl, controls in jobs:
        for kind, numbers in readings(cfg, traffic, seed, impl, controls):
            tag = kind.split(":")[0]
            line = f"[{tag}] " + json.dumps({"seed": seed, "impl": kind,
                                             **numbers})
            print(line, flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
