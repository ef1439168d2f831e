"""A configuration and a traffic cut small enough for the CPU, for the
host-only tests: the flagship's structure (sauto encoder, geometry at
(0, 1), triad head) at 32 px with narrow layers, and the stylize mix on a
100-px drawing."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from neube_bench import run  # noqa: E402

STYLIZE = "stylize-4096-b32"


def small_cell(workload: str = STYLIZE):
    manifest = run.load_manifest()
    cell, cfg, traffic = run.cell_parts(manifest, workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(img_resolution=32, channel_max=32, channel_base=512)
    cfg["encoder"].update(pre_filters=8, down_filters=[16, 16, 16],
                          post_filters=[8, 4], up_filters=[16, 8, 8])
    traffic.update(image_size=100, overlap_margin=8, crop_margin=4,
                   batch_size=4, trace_images=1, host_images=1)
    return manifest, cell, cfg, traffic


def run_small(seconds: float = 0.5, trace: bool = False, impl="program",
              hook=None, seed: int = 2 ** 31 + 5):
    import torch
    torch.set_num_threads(2)
    manifest, cell, cfg, traffic = small_cell()
    return run.run_cell(manifest, cell, cfg, traffic, seed, seconds, trace,
                        "cpu", impl, cell_hook=hook)
