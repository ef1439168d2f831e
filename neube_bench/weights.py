"""Seeded weights of a configuration, made on the device in one draw.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference.  The layout is the program's parameter
tree (torch layout: FC weights ``[out, in]``, conv weights OIHW, the
synthesis constant ``[C, 4, 4]``), written down here from the
configuration's widths; ``tests/test_neube_bench_reference.py`` holds the
tree against the program's own initialiser on the CPU.

Every leaf comes from one ``torch.randn`` of the total size on a
``torch.Generator`` seeded with ``--seed``; each leaf is then scaled and
shifted by its kind.  The same seed gives the same tensors on every run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def channels(cfg: Dict, res: int) -> int:
    return min(cfg["channel_base"] // res, cfg["channel_max"])


def block_resolutions(cfg: Dict) -> List[int]:
    n = int(math.log2(cfg["img_resolution"]))
    return [2 ** i for i in range(2, n + 1)]


def encoder_downsamplings(cfg: Dict) -> int:
    return len(cfg["encoder"]["down_filters"])


def geom_features(cfg: Dict) -> Dict[int, int]:
    """Trunk resolution -> geometry feature channels injected after it."""
    enc = cfg["encoder"]
    base = cfg["img_resolution"] // 2 ** encoder_downsamplings(cfg)
    chans = [enc["post_filters"][-1]] + list(enc["up_filters"])
    return {base * 2 ** r: chans[r] for r in cfg["geom_inject_resolutions"]}


def block_in_channels(cfg: Dict, res: int) -> int:
    prev = res // 2
    return channels(cfg, prev) + geom_features(cfg).get(prev, 0)


def encoder_plan(cfg: Dict) -> Tuple[List, List]:
    """([(name, in, out, k)] of the encoder, [(name, in, out, k)] of the
    decoder), in the program's names."""
    enc = cfg["encoder"]
    plan, prev = [], enc["in_channels"]
    if enc["pre_filters"] > 0:
        plan.append((enc["in_channels"], enc["pre_filters"], 7))
        prev = enc["pre_filters"]
    for f in list(enc["down_filters"]) + list(enc["post_filters"]):
        plan.append((prev, f, 3))
        prev = f
    encoder = [(f"layer{i}", ci, co, k) for i, (ci, co, k) in enumerate(plan)]
    decoder = []
    for i, f in enumerate(enc["up_filters"]):
        decoder.append((f"up{i}", prev, f, 3))
        prev = f
    if enc["out_channels"] != prev:
        decoder.append(("final", prev, enc["out_channels"], 1))
    return encoder, decoder


def _spec(cfg: Dict):
    """[(path, shape, scale, shift)] of every leaf, in draw order: the leaf
    is ``scale * N(0, 1) + shift`` (a BatchNorm variance its ``exp``).
    Equalised-lr weights are stored divided by their lr multiplier."""
    leaves = []

    def add(path, shape, scale=1.0, shift=0.0):
        leaves.append((path, tuple(shape), scale, shift))

    enc_layers, dec_layers = encoder_plan(cfg)
    for part, layers in (("encoder", enc_layers), ("decoder", dec_layers)):
        for name, ci, co, k in layers:
            std = math.sqrt(2.0 / (ci * k * k + co * k * k))
            if name == "final":
                add(("enc_params", part, name, "weight"), (co, ci, k, k), std)
                add(("enc_params", part, name, "bias"), (co,), 0.1)
                continue
            add(("enc_params", part, name, "conv", "weight"),
                (co, ci, k, k), std)
            add(("enc_params", part, name, "conv", "bias"), (co,), 0.1)
            add(("enc_params", part, name, "bn", "scale"), (co,), 0.1, 1.0)
            add(("enc_params", part, name, "bn", "bias"), (co,), 0.1)
            add(("enc_state", part, name, "bn", "mean"), (co,), 0.1)
            # Made positive below (exp).
            add(("enc_state", part, name, "bn", "var"), (co,), 0.2)

    w_dim, z_dim = cfg["w_dim"], cfg["z_dim"]
    lr_mult = 0.01
    feats = [z_dim] + [w_dim] * cfg["mapping_layers"]
    for i in range(cfg["mapping_layers"]):
        add(("gen_params", "mapping", f"fc{i}", "weight"),
            (feats[i + 1], feats[i]), 1.0 / lr_mult)
        add(("gen_params", "mapping", f"fc{i}", "bias"), (feats[i + 1],),
            0.1 / lr_mult)
    last = cfg["img_resolution"]
    for res in block_resolutions(cfg):
        out = channels(cfg, res)
        b = ("gen_params", "synthesis", f"b{res}")
        convs = [("conv1", out)]
        if res == 4:
            add(b + ("const",), (out, 4, 4))
        else:
            convs.insert(0, ("conv0", block_in_channels(cfg, res)))
        for name, ci in convs:
            add(b + (name, "affine", "weight"), (ci, w_dim))
            add(b + (name, "affine", "bias"), (ci,), 0.1, 1.0)
            add(b + (name, "weight"), (out, ci, 3, 3))
            add(b + (name, "bias"), (out,), 0.1)
            add(("gen_state", "noise", f"b{res}.{name}.noise_const"),
                (res, res))
        if res == last:
            add(b + ("torgb", "affine", "weight"), (out + 9, w_dim))
            add(b + ("torgb", "affine", "bias"), (out + 9,), 0.1, 1.0)
            add(b + ("torgb", "weight"), (3, out, 1, 1))
            add(b + ("torgb", "bias"), (3,), 0.1)
            add(b + ("torgb", "color_bias"), (9,), 0.1)
    return leaves


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_trees(cfg: Dict, seed: int, device) -> Dict:
    """``{"gen_params", "gen_state", "enc_params", "enc_state"}`` in the
    program's layout, float32 on ``device``, from ``seed``."""
    spec = _spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    trees, at = {}, 0
    for path, shape, scale, shift in spec:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape) * scale + shift
        if path[-1] == "var":
            leaf = leaf.exp()
        _put(trees, path, leaf)
        at += n
    for res in block_resolutions(cfg):
        for name in ("conv0", "conv1"):
            layer = trees["gen_params"]["synthesis"][f"b{res}"].get(name)
            if layer is not None:
                layer["noise_strength"] = torch.tensor(
                    float(cfg["assumed"]["noise_strength"]), device=device)
    trees["gen_state"]["w_avg"] = torch.zeros(cfg["w_dim"], device=device)
    return trees


def style_latents(seed: int, count: int, z_dim: int):
    """``count`` style latents ``[count, 1, z_dim]`` (numpy float64, as
    the program's brush options hold a style) from ``seed``: one per
    image of a stylize window, each image a new brush."""
    import numpy as np
    rng = np.random.default_rng([int(seed), 7])
    return rng.standard_normal((count, 1, z_dim))
