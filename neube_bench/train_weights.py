"""Seeded weights of a training configuration: the generator and the
geometry encoder as ``neube_bench/weights.py`` makes them, and the
discriminator, made on the device in one draw.

The discriminator's layout is the program's parameter tree for the 'orig'
architecture (conv weights OIHW, FC weights ``[out, in]``; the epilogue's
``fc`` reads the 4x4 features flattened in (h, w, c) order), written down
here from the configuration's widths; the tests hold it against the
program's own initialiser on the CPU.  Conv and FC weights are N(0, 1)
(equalised learning rate), biases ``0.1 * N(0, 1)``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from neube_bench import weights as W

MBSTD_CHANNELS = 1


def d_block_resolutions(cfg: Dict) -> List[int]:
    """The discriminator's blocks, from the image resolution down to 8."""
    n = int(math.log2(cfg["img_resolution"]))
    return [2 ** i for i in range(n, 2, -1)]


def d_channels(cfg: Dict, res: int) -> int:
    return min(cfg["channel_base"] // res, cfg["channel_max"])


def _d_spec(cfg: Dict):
    """[(path, shape, scale)] of the discriminator's leaves, in draw
    order."""
    leaves = []

    def conv(path, cin, cout, k):
        leaves.append((path + ("weight",), (cout, cin, k, k), 1.0))
        leaves.append((path + ("bias",), (cout,), 0.1))

    def fc(path, cin, cout):
        leaves.append((path + ("weight",), (cout, cin), 1.0))
        leaves.append((path + ("bias",), (cout,), 0.1))

    for res in d_block_resolutions(cfg):
        tmp, out = d_channels(cfg, res), d_channels(cfg, res // 2)
        if res == cfg["img_resolution"]:
            conv((f"b{res}", "fromrgb"), 3, tmp, 1)
        conv((f"b{res}", "conv0"), tmp, tmp, 3)
        conv((f"b{res}", "conv1"), tmp, out, 3)
    ch4 = d_channels(cfg, 4)
    conv(("b4", "conv"), ch4 + MBSTD_CHANNELS, ch4, 3)
    fc(("b4", "fc"), ch4 * 16, ch4)
    fc(("b4", "out"), ch4, 1)
    return leaves


def make_d_params(cfg: Dict, seed: int, device) -> Dict:
    """The discriminator's params, float32 on ``device``, from ``seed``."""
    spec = _d_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 2 ** 40)
    flat = torch.randn(total, generator=gen, device=device)
    tree, at = {}, 0
    for path, shape, scale in spec:
        n = math.prod(shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[at:at + n].view(shape) * scale
        at += n
    return tree


def make_training_trees(cfg: Dict, seed: int, device) -> Dict:
    """``{"gen_params", "gen_state", "enc_params", "enc_state",
    "disc_params"}`` for ``cfg`` from ``seed``."""
    trees = W.make_trees(cfg, seed, device)
    trees["disc_params"] = make_d_params(cfg, seed, device)
    return trees
