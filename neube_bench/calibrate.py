"""Readings that a cell's limits are set from, many seeds in one process.

    python3 -m neube_bench.calibrate --workload NAME --seeds 1,2,3
        [--control_seeds 4,5,6] [--out FILE]

For each seed it builds the cell as a run does, drives its timed path
through the traffic's entry for ``check_images`` units (one of each
drawing), and prints the compared numbers (``[program]`` lines); then, for
each control seed, the same with the plain reference in the program's
place in bfloat16, the nearest precision below the configuration's TF32
(``[control]`` lines).  The limits in the
traffic file sit between the largest program reading and the smallest
control reading (``PERF.md`` gives both).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

from neube_bench import run

CONTROL = "bfloat16"


def readings(manifest, cell, cfg, traffic, seed, impl):
    import torch
    c = run.driver(traffic).Cell(cfg, traffic, seed, "cuda", impl)
    c.setup()
    for _ in range(traffic["check_images"]):
        c.run_unit()
    c.free_program()
    numbers = c.check()
    numbers = {**getattr(c, "diagnostics", {}), **numbers}
    del c
    torch.cuda.empty_cache()
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    manifest = run.load_manifest()
    cell, cfg, traffic = run.cell_parts(manifest, args.workload)
    lines = []
    jobs = [("program", int(s)) for s in args.seeds.split(",") if s]
    jobs += [(CONTROL, int(s)) for s in args.control_seeds.split(",")
             if s]
    for impl, seed in jobs:
        tag = "program" if impl == "program" else "control"
        numbers = readings(manifest, cell, cfg, traffic, seed, impl)
        line = f"[{tag}] " + json.dumps({"seed": seed, "impl": impl,
                                         **numbers})
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
