"""The benchmark's weights have the program's layout, and the plain
reference renders what the program renders: bit for bit in float32 on the
CPU (both strict), for whole drawings with feature blending."""

import numpy as np
import torch

from small import small_cell
from neube_bench import weights as W
from neube_bench.reference.stylize import stylize as ref_stylize


def _flat(t, p=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, p + k + "/"))
        else:
            out[p + k] = tuple(v.shape)
    return out


def test_weights_have_the_programs_layout():
    from brushstroke_engine_torch.utils.checkpoint import (
        init_native_params, params_from_jax)
    from neube_bench.drivers.engine import program_configs
    _, _, cfg, _ = small_cell()
    gen, enc = program_configs(cfg)
    theirs = {k: params_from_jax(v)
              for k, v in init_native_params(gen, enc, seed=0).items()}
    ours = W.make_trees(cfg, 2 ** 33 + 1, "cpu")
    assert _flat(ours) == _flat(theirs)
    again = W.make_trees(cfg, 2 ** 33 + 1, "cpu")
    assert torch.equal(ours["gen_params"]["synthesis"]["b32"]["conv1"]
                       ["weight"], again["gen_params"]["synthesis"]["b32"]
                       ["conv1"]["weight"])


def test_reference_equals_the_program_in_float32():
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    from brushstroke_engine_torch.engine.stylize import \
        stylize_image_ondevice
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from neube_bench.drivers.engine import program_engine
    from neube_bench.traffic.drawings import make_drawing
    torch.set_num_threads(2)
    _, _, cfg, traffic = small_cell()
    trees = W.make_trees(cfg, 77, "cpu")
    drawing = make_drawing(90, 77, 0, traffic["drawing"], "cpu")
    z = W.style_latents(77, 1, cfg["z_dim"])[0]
    set_precision_mode("strict")
    opts = GanBrushOptions()
    opts.set_style(z, None)
    got = stylize_image_ondevice(program_engine(cfg, trees, "cpu"), drawing,
                                 opts, overlap_margin=8, crop_margin=4,
                                 batch_size=4)
    want = ref_stylize(cfg, trees, torch.from_numpy(drawing),
                       torch.from_numpy(z).float(), torch.float32,
                       overlap=8, crop=4, batch=3)
    assert got.shape == want.shape == (96, 96, 4)
    assert np.array_equal(got, want)
    assert 0 < got[..., 3].mean() < 255
