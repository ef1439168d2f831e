"""The port's spans (``utils/util.py:span``) on the CPU: the ranges that
the stylize path and the render core open under ``torch.profiler``, how
they nest, that no profiler means no ``record_function`` at all, and that
a profiled stylize returns the same canvas bit for bit."""

import collections
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from brushstroke_engine_torch.data.curves import random_spline_stroke
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine import stylize as tst
from brushstroke_engine_torch.utils import util
from tests.torch_helpers import small_model

# 32-px tiles, stride 24: a 70-px drawing pads to 3 x 3 tiles in waves of
# 4, 2, 2 and 1 tiles: five chunks of 3, four of them padded.
KW = dict(overlap_margin=4, crop_margin=4, feature_blending_level=2,
          batch_size=3)
ENTRIES = {"ondevice": tst.stylize_image_ondevice,
           "batched": tst.stylize_image_batched}


@pytest.fixture(scope="module")
def engine():
    m = small_model(seed=8)
    gen, enc = m["cfg"]
    t = m["torch"]
    return tbrush.TriadGanPaintEngine(
        gen, t["gen_params"], t["gen_state"], enc, t["enc_params"],
        t["enc_state"], geom_inject_resolutions=(0, 1), device="cpu")


def geometry():
    return random_spline_stroke(np.random.default_rng(3), 70, radius=4.0)


def stylize(engine, entry, seed=5):
    opts = tbrush.GanBrushOptions()
    opts.set_style(engine.random_style(seed), seed)
    return ENTRIES[entry](engine, geometry(), opts, **KW)


def n_chunks(engine):
    w, m = engine.patch_width, KW["overlap_margin"]
    geom, _ = tst.pad_geometry(geometry(), w, m)
    crops = tst.generate_stitching_crops(geom.shape, w, m, geom=geom)
    ys, _ = tst._prepare_wave_chunks(crops, w - 2 * m, KW["batch_size"])
    return len(ys)


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("bse."))
    return out, spans


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_stylize_spans_count_and_nest(engine, entry):
    _, spans = profiled(lambda: stylize(engine, entry))
    by = collections.defaultdict(list)
    for s in spans:
        by[s[2]].append(s)
    for name in ("bse.stylize", "bse.stylize.pad", "bse.stylize.upload",
                 "bse.stylize.download"):
        assert len(by[name]) == 1, name
    n = n_chunks(engine)
    assert n == 5
    for name in ("bse.stylize.chunk", "bse.stylize.gather",
                 "bse.stylize.scatter", "bse.render.pass",
                 "bse.render.encoder", "bse.render.mapping",
                 "bse.render.head"):
        assert len(by[name]) == n, name
    assert len(by["bse.render.inputs"]) == 2 * n
    call = by["bse.stylize"][0]
    assert all(inside(s, call) for s in spans)
    chunks, passes = by["bse.stylize.chunk"], by["bse.render.pass"]
    for chunk, pas in zip(chunks, passes):
        assert inside(pas, chunk)
    blocks = [name for name in by if name.startswith("bse.render.block")]
    assert sorted(blocks) == sorted(
        f"bse.render.block{r}"
        for r in engine.gen_cfg.synthesis.block_resolutions)
    for name in blocks:
        assert len(by[name]) == n
        for pas, block in zip(passes, by[name]):
            assert inside(block, pas)
    for chunk, pas, g, sc in zip(chunks, passes, by["bse.stylize.gather"],
                                 by["bse.stylize.scatter"]):
        assert inside(g, chunk) and inside(sc, chunk)
        assert g[1] <= pas[0] and pas[1] <= sc[0]


def test_stroke_opens_one_pass(engine):
    patch = np.zeros((32, 32, 4), np.uint8)
    patch[8:24, 8:24, 3] = 255
    opts = tbrush.GanBrushOptions()
    opts.set_style(engine.random_style(2), 2)
    _, spans = profiled(lambda: engine.render_stroke(patch, None, opts))
    names = collections.Counter(s[2] for s in spans)
    assert names["bse.render.pass"] == 1
    assert names["bse.render.inputs"] == 2
    assert names["bse.render.encoder"] == names["bse.render.head"] == 1
    assert not any(k.startswith("bse.stylize") for k in names)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_profiler_enters_no_record_function(engine, entry, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    stylize(engine, entry)
    assert entered == []
    profiled(lambda: stylize(engine, entry))
    assert "bse.render.pass" in entered


def test_span_off_is_one_shared_nullcontext():
    assert not torch.autograd._profiler_enabled()
    assert util.span("bse.a") is util.span("bse.b")
    with util.span("bse.a") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(util.span("bse.a"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_profiled_canvas_is_bit_identical(engine, entry):
    plain = stylize(engine, entry)
    traced, spans = profiled(lambda: stylize(engine, entry))
    assert spans
    assert plain.dtype == traced.dtype == np.uint8
    assert np.array_equal(plain, traced)


def test_device_activity_leaves_out_annotations():
    def ev(name, kind, ann=False):
        return types.SimpleNamespace(name=name, device_type=kind,
                                     is_user_annotation=ann)
    events = [ev("kernel", DeviceType.CUDA),
              ev("Memcpy DtoH", DeviceType.CUDA),
              ev("bse.render.pass", DeviceType.CUDA, True),
              ev("bse.render.pass", DeviceType.CPU),
              ev("aten::add", DeviceType.CPU)]
    assert [e.name for e in util.device_activity(events)] == [
        "kernel", "Memcpy DtoH"]
