"""Seeded weights of a plain StyleGAN2 training configuration (no geometry
encoder): the 'skip' generator with StyleGAN2's RGB head and the 'resnet'
discriminator, made on the device in one draw each.

The layout is the program's parameter tree for these architectures (conv
weights OIHW, FC weights ``[out, in]``, the synthesis constant ``[C, 4,
4]``; a toRGB layer at every block; D's ``skip`` a 1x1 conv without bias;
the epilogue's ``fc`` reads the 4x4 features flattened in (h, w, c)
order), written down here from the configuration's widths; the tests hold
it against the program's own initialiser on the CPU.  Equalised-lr
weights are N(0, 1) (the mapping's divided by its lr multiplier 0.01),
biases ``0.1 * N(0, 1)``, affine biases ``1 + 0.1 * N(0, 1)``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from neube_bench import train_weights as TW
from neube_bench import weights as W

LR_MULT = 0.01
MBSTD_CHANNELS = 1


def _g_spec(cfg: Dict):
    """[(path, shape, scale, shift)] of the generator's leaves and its
    constant noise planes, in draw order."""
    leaves = []

    def add(path, shape, scale=1.0, shift=0.0):
        leaves.append((path, tuple(shape), scale, shift))

    w_dim = cfg["w_dim"]
    feats = [cfg["z_dim"]] + [w_dim] * cfg["mapping_layers"]
    for i in range(cfg["mapping_layers"]):
        add(("gen_params", "mapping", f"fc{i}", "weight"),
            (feats[i + 1], feats[i]), 1.0 / LR_MULT)
        add(("gen_params", "mapping", f"fc{i}", "bias"), (feats[i + 1],),
            0.1 / LR_MULT)
    for res in W.block_resolutions(cfg):
        out = W.channels(cfg, res)
        b = ("gen_params", "synthesis", f"b{res}")
        convs = [("conv1", out)]
        if res == 4:
            add(b + ("const",), (out, 4, 4))
        else:
            convs.insert(0, ("conv0", W.channels(cfg, res // 2)))
        for name, ci in convs:
            add(b + (name, "affine", "weight"), (ci, w_dim))
            add(b + (name, "affine", "bias"), (ci,), 0.1, 1.0)
            add(b + (name, "weight"), (out, ci, 3, 3))
            add(b + (name, "bias"), (out,), 0.1)
            add(("gen_state", "noise", f"b{res}.{name}.noise_const"),
                (res, res))
        add(b + ("torgb", "affine", "weight"), (out, w_dim))
        add(b + ("torgb", "affine", "bias"), (out,), 0.1, 1.0)
        add(b + ("torgb", "weight"), (3, out, 1, 1))
        add(b + ("torgb", "bias"), (3,), 0.1)
    return leaves


def _d_spec(cfg: Dict):
    """[(path, shape, scale, shift)] of the 'resnet' discriminator's
    leaves, in draw order."""
    leaves = []

    def conv(path, cin, cout, k, bias=True):
        leaves.append((path + ("weight",), (cout, cin, k, k), 1.0, 0.0))
        if bias:
            leaves.append((path + ("bias",), (cout,), 0.1, 0.0))

    for res in TW.d_block_resolutions(cfg):
        tmp, out = TW.d_channels(cfg, res), TW.d_channels(cfg, res // 2)
        b = ("disc_params", f"b{res}")
        if res == cfg["img_resolution"]:
            conv(b + ("fromrgb",), 3, tmp, 1)
        conv(b + ("conv0",), tmp, tmp, 3)
        conv(b + ("conv1",), tmp, out, 3)
        conv(b + ("skip",), tmp, out, 1, bias=False)

    def fc(path, cin, cout):
        leaves.append((path + ("weight",), (cout, cin), 1.0, 0.0))
        leaves.append((path + ("bias",), (cout,), 0.1, 0.0))

    ch4 = TW.d_channels(cfg, 4)
    conv(("disc_params", "b4", "conv"), ch4 + MBSTD_CHANNELS, ch4, 3)
    fc(("disc_params", "b4", "fc"), ch4 * 16, ch4)
    fc(("disc_params", "b4", "out"), ch4, 1)
    return leaves


def _draw(spec, seed: int, device, trees: Dict):
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    for path, shape, scale, shift in spec:
        n = math.prod(shape)
        node = trees
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[at:at + n].view(shape) * scale + shift
        at += n


def make_training_trees(cfg: Dict, seed: int, device) -> Dict:
    """``{"gen_params", "gen_state", "enc_params", "enc_state",
    "disc_params"}`` for ``cfg`` from ``seed``, float32 on ``device``; the
    encoder's trees are empty."""
    trees = {"enc_params": {}, "enc_state": {}}
    _draw(_g_spec(cfg), seed, device, trees)
    _draw(_d_spec(cfg), int(seed) + 2 ** 40, device, trees)
    syn = trees["gen_params"]["synthesis"]
    for res in W.block_resolutions(cfg):
        for name in ("conv0", "conv1"):
            if name in syn[f"b{res}"]:
                syn[f"b{res}"][name]["noise_strength"] = torch.tensor(
                    float(cfg["assumed"]["noise_strength"]), device=device)
    trees["gen_state"]["w_avg"] = torch.zeros(cfg["w_dim"], device=device)
    return trees
