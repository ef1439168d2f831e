"""Operations and bytes of a training period (``period_batches`` batches of
the training CLI's phase cycle), from the configuration's shapes alone.

Products: a convolution counts 2 * k * k * in * out multiply-adds per
output pixel (an up=2 layer its transposed form), a matrix product
2 * m * n * k, as ``flops.py`` counts the generator and the encoder.  Each
phase counts the passes over every layer that its gradients need at
least, in units of the layer's forward products:

* Dmain: G forward 1 (no gradient); D forward 2 (fakes, reals), each
  backward 2 (weights and inputs; the first layer's input gradient is not
  needed).
* Dr1: D forward 1, the input gradient 1, and the second backward through
  that gradient 2 (its weights and its incoming gradient).
* Gmain: G forward 1 and backward 2; D forward 1 and its input gradient 1
  (D is not trained there).
* Gpl, on ``batch / pl_batch_shrink`` rows: G forward 1, the gradient to
  the styles 1, the second backward through it 2.
* The frozen encoder's forward, once per batch.

These are lower bounds: the second backward of Gpl also runs back through
the forward, and elementwise work (modulation, noise, bias, activations,
the FIR, the warp) is not counted.  Each layer runs at the peak of its
dtype: bf16 in the blocks at the configuration's bf16 resolutions, float32
(TF32 off) elsewhere.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from neube_bench import train_weights as TW
from neube_bench import weights as W
from neube_bench.reference.train import bf16_resolutions
from neube_bench.workcount import flops


def _res_of(layer: str) -> int:
    """The block resolution of ``b<res>.<name>`` (0 for other layers)."""
    head = layer.split(".")[0]
    return int(head[1:]) if head.startswith("b") and head[1:].isdigit() \
        else 0


def g_layers(cfg: Dict, batch: int) -> List[Tuple[str, int, float]]:
    """[(layer, block resolution or 0, forward flops)] of the generator."""
    return [(name, _res_of(name), f)
            for name, part, f in flops.forward_layers(cfg, batch)
            if part == "generator"]


def encoder_flops(cfg: Dict, batch: int) -> float:
    return sum(f for _, part, f in flops.forward_layers(cfg, batch)
               if part == "encoder")


def d_layers(cfg: Dict, batch: int) -> List[Tuple[str, int, float]]:
    """[(layer, block resolution, forward flops)] of the 'orig'
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
    c = TW.d_channels(cfg, 4)
    out.append(("b4.conv", 4, 2.0 * 9 * (c + TW.MBSTD_CHANNELS) * c * 16
                * batch))
    out.append(("b4.fc", 4, 2.0 * 16 * c * c * batch))
    out.append(("b4.out", 4, 2.0 * c * batch))
    return out


def phase_flops(cfg: Dict, phase: str) -> Dict[str, float]:
    """{"bf16": flops, "f32": flops} of one call of ``phase`` ('Dmain',
    'Dr1', 'Gmain', 'Gpl' or 'encode')."""
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
    elif phase == "encode":
        out["f32"] += encoder_flops(cfg, b)
    else:
        raise ValueError(phase)
    return out


def period_phases(cfg: Dict, period: int) -> Dict[str, int]:
    """How often each phase runs in a period."""
    return {"Dmain": period, "Gmain": period, "encode": period,
            "Dr1": period // cfg["d_reg_interval"],
            "Gpl": period // cfg["g_reg_interval"]}


def period_flops(cfg: Dict, period: int) -> Dict[str, float]:
    """{"bf16": flops, "f32": flops} of one period's products."""
    out = {"bf16": 0.0, "f32": 0.0}
    for phase, n in period_phases(cfg, period).items():
        for k, f in phase_flops(cfg, phase).items():
            out[k] += f * n
    return out


def period_least_seconds(cfg: Dict, period: int, peaks: Dict) -> float:
    """The least time of a period's products at the peak of each dtype."""
    return sum(f / peaks[k] for k, f in period_flops(cfg, period).items())


def k1_launches(cfg: Dict, batch: int) -> List[Tuple[int, float, float]]:
    """[(res, bytes, flops)] of the FIR-epilogue kernel's launches in one
    generator pass of ``batch`` rows in training: one per up=2 layer, the
    pre-FIR tensor ``[B, r+3, r+3, C]`` read and ``[B, r, r, C]`` written in
    the block's dtype (bf16 at the bf16 resolutions), the noise ``[B, r, r,
    1]``, the demodulation ``[B, C]`` and the bias ``[C]`` in float32; 16
    taps' multiply-adds and 6 more operations per output."""
    low = set(bf16_resolutions(cfg))
    rows = []
    for r in W.block_resolutions(cfg)[1:]:
        c = W.channels(cfg, r)
        e = 2 if r in low else 4
        n_out = batch * r * r * c
        nbytes = (batch * (r + 3) ** 2 * c * e + n_out * e
                  + batch * r * r * 4 + batch * c * 4 + c * 4)
        rows.append((r, float(nbytes), float(n_out * (16 * 2 + 6))))
    return rows


def period_k1(cfg: Dict, period: int) -> List[Tuple[int, float, float]]:
    """Every K1 launch of a period: the generator passes of Dmain and
    Gmain (all rows) and of Gpl (the shrunk rows)."""
    b = cfg["batch"]
    pl = b // cfg["pl_batch_shrink"]
    return (k1_launches(cfg, b) * (2 * period)
            + k1_launches(cfg, pl) * (period // cfg["g_reg_interval"]))


def period_k2(cfg: Dict, period: int) -> Tuple[int, int]:
    """(launches of the warp W, of its transpose Wᵀ) in a period: W on the
    fakes and the reals of Dmain and on Gmain's fakes, twice in Dr1 (its
    forward and its second backward); Wᵀ in Gmain's backward and in Dr1's
    first backward."""
    n_dr1 = period // cfg["d_reg_interval"]
    return 3 * period + 2 * n_dr1, period + n_dr1


def k2_bytes(cfg: Dict) -> float:
    """The least bytes of one W or Wᵀ launch on a batch of the
    configuration's images: one batch read, one written, eight float32
    scalars per image (``flops.k2_launch``)."""
    res = cfg["img_resolution"]
    return flops.k2_launch(cfg["batch"], res, 3, [(1.0, 1.0)])[0]
