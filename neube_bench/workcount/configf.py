"""Operations of a training period of a plain StyleGAN2 configuration (the
'skip' generator with StyleGAN2's RGB head, the 'resnet' discriminator, no
geometry encoder), from the configuration's shapes alone.

The counting is ``workcount/train.py``'s: a convolution counts 2 * k * k *
in * out multiply-adds per output pixel (an up=2 layer its transposed
form), a matrix product 2 * m * n * k; each phase counts the passes over
every layer that its gradients need at least, in units of the layer's
forward products (Dmain: G 1, D 2 forwards and 2 backwards of 2, the first
layer's input gradient left out; Dr1: D 4; Gmain: G 3, D 2; Gpl on
``batch / pl_batch_shrink`` rows: G 4), each layer at the peak of its
dtype.  Lower bounds, as there: elementwise work (modulation, noise, bias,
activations, the FIRs, the warp) is not counted, nor Gpl's second
backward back through the forward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from neube_bench import train_weights as TW
from neube_bench import weights as W
from neube_bench.reference.train import bf16_resolutions
from neube_bench.workcount import train as WT


def g_layers(cfg: Dict, batch: int) -> List[Tuple[str, int, float]]:
    """[(layer, block resolution or 0, forward flops)] of the 'skip'
    generator: the mapping, each block's convolutions with their affines
    and demodulation, and a toRGB at every block."""
    w = cfg["w_dim"]
    feats = [cfg["z_dim"]] + [w] * cfg["mapping_layers"]
    out = [("mapping", 0,
            sum(2.0 * a * b for a, b in zip(feats, feats[1:])) * batch)]
    for r in W.block_resolutions(cfg):
        c = W.channels(cfg, r)
        layers = [("conv1", c, 2.0 * 9 * c * c * r * r)]
        if r > 4:
            ci = W.channels(cfg, r // 2)
            layers.insert(0, ("conv0", ci, 2.0 * 9 * ci * c * (r // 2) ** 2))
        for name, ci, conv in layers:
            out.append((f"b{r}.{name}", r,
                        (conv + 2.0 * w * ci + 2.0 * ci * c) * batch))
        out.append((f"b{r}.torgb", r,
                    (2.0 * c * 3 * r * r + 2.0 * w * c) * batch))
    return out


def d_layers(cfg: Dict, batch: int) -> List[Tuple[str, int, float]]:
    """[(layer, block resolution, forward flops)] of the 'resnet'
    discriminator; the epilogue at resolution 4."""
    out = []
    top = cfg["img_resolution"]
    for r in TW.d_block_resolutions(cfg):
        c, c2 = TW.d_channels(cfg, r), TW.d_channels(cfg, r // 2)
        if r == top:
            out.append((f"b{r}.fromrgb", r, 2.0 * 3 * c * r * r * batch))
        out.append((f"b{r}.conv0", r, 2.0 * 9 * c * c * r * r * batch))
        out.append((f"b{r}.conv1", r,
                    2.0 * 9 * c * c2 * (r // 2) ** 2 * batch))
        out.append((f"b{r}.skip", r, 2.0 * c * c2 * (r // 2) ** 2 * batch))
    c = TW.d_channels(cfg, 4)
    out.append(("b4.conv", 4, 2.0 * 9 * (c + TW.MBSTD_CHANNELS) * c * 16
                * batch))
    out.append(("b4.fc", 4, 2.0 * 16 * c * c * batch))
    out.append(("b4.out", 4, 2.0 * c * batch))
    return out


def phase_flops(cfg: Dict, phase: str) -> Dict[str, float]:
    """{"bf16": flops, "f32": flops} of one call of ``phase`` ('Dmain',
    'Dr1', 'Gmain' or 'Gpl')."""
    b = cfg["batch"]
    low = set(bf16_resolutions(cfg))
    out = {"bf16": 0.0, "f32": 0.0}

    def add(layers, times):
        for name, res, f in layers:
            n = times(name) if callable(times) else times
            out["bf16" if res in low else "f32"] += f * n

    first = f"b{cfg['img_resolution']}.fromrgb"
    if phase == "Dmain":
        add(g_layers(cfg, b), 1)
        add(d_layers(cfg, b), lambda name: 4 if name == first else 6)
    elif phase == "Dr1":
        add(d_layers(cfg, b), 4)
    elif phase == "Gmain":
        add(g_layers(cfg, b), 3)
        add(d_layers(cfg, b), 2)
    elif phase == "Gpl":
        add(g_layers(cfg, b // cfg["pl_batch_shrink"]), 4)
    else:
        raise ValueError(phase)
    return out


def period_flops(cfg: Dict, period: int) -> Dict[str, float]:
    """{"bf16": flops, "f32": flops} of one period's products."""
    runs = {ph: n for ph, n in WT.period_phases(cfg, period).items()
            if ph != "encode"}
    out = {"bf16": 0.0, "f32": 0.0}
    for phase, n in runs.items():
        for k, f in phase_flops(cfg, phase).items():
            out[k] += f * n
    return out


def period_least_seconds(cfg: Dict, period: int, peaks: Dict) -> float:
    """The least time of a period's products at the peak of each dtype."""
    return sum(f / peaks[k] for k, f in period_flops(cfg, period).items())
