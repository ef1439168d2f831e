"""The port's local meshes for serving and stylizing, and the entry points
of the mesh, on the CPU.

* ``GanPaintEngine.set_serving_mesh``: ``render_batch`` over a mesh of 8
  CPU entries at 3 rows (padded to 8) and 8 rows equals the call without a
  mesh to ``atol=2e-5``, as ``tests/test_parallel.py`` holds the JAX
  engine.
* ``stylize_image_ondevice(mesh=)`` equals the call without a mesh to the
  JAX test's bound (median byte difference <= 1, 99 % of bytes within 2);
  a batch that does not divide by the mesh raises.
* ``tools/train.py``: ``--dp`` and the multi-host flags parse and reach the
  group setup with the world and rank they name.
* ``ui/server.py --serve_devices`` parses, and the core splits over that
  many devices or raises.

32 px, the small engine of ``tests/torch_helpers.py``.
"""

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.data.curves import random_spline_stroke
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine.stylize import stylize_image_ondevice
from brushstroke_engine_torch.parallel.mesh import Mesh, make_mesh
from brushstroke_engine_torch.tools import train as ttrain
from tests.torch_helpers import small_model


@pytest.fixture(scope="module")
def engine():
    m = small_model(seed=8)
    tgen, tenc = m["cfg"]
    t = m["torch"]
    return tbrush.TriadGanPaintEngine(
        tgen, t["gen_params"], t["gen_state"], tenc, t["enc_params"],
        t["enc_state"], geom_inject_resolutions=(0, 1), device="cpu")


def _requests(eng, n, rng):
    pw = eng.patch_width
    geoms = (rng.rand(n, pw, pw, 1) > 0.5).astype(np.float32)
    opts = []
    for i in range(n):
        o = tbrush.GanBrushOptions()
        o.set_style(eng.random_style(i), i)
        o.set_position(8 * i, 4 * i)
        opts.append(o)
    return geoms, opts


@pytest.mark.parametrize("n", [3, 8])
def test_render_batch_over_a_mesh_equals_one_device(engine, n):
    geoms, opts = _requests(engine, n, np.random.RandomState(n))
    want = engine.render_batch(geoms, opts)
    engine.set_serving_mesh(make_mesh(8, device="cpu"))
    try:
        got = engine.render_batch(geoms, opts, return_features=(16,))
    finally:
        engine.set_serving_mesh(None)
    pw = engine.patch_width
    assert got["rgba"].shape == (n, pw, pw, 4)
    assert got["features16"].shape[0] == n
    np.testing.assert_allclose(got["rgba"].numpy(), want["rgba"].numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(got["uvs"].numpy(), want["uvs"].numpy(),
                               atol=2e-5)
    # A training (group) mesh does not serve.
    with pytest.raises(ValueError, match="local mesh"):
        engine.set_serving_mesh(Mesh((torch.device("cpu"),), group=object()))


def test_stylize_over_a_mesh_equals_one_device(engine):
    geom = random_spline_stroke(np.random.default_rng(11), 96, radius=4.0)
    outs = []
    for mesh in (None, make_mesh(8, device="cpu")):
        opts = tbrush.GanBrushOptions()
        opts.set_style(engine.random_style(5), 5)
        outs.append(stylize_image_ondevice(
            engine, geom, opts, overlap_margin=4, crop_margin=4,
            feature_blending_level=1, batch_size=8, mesh=mesh))
    single, sharded = outs
    assert single.shape == sharded.shape and sharded.dtype == np.uint8
    diff = np.abs(single.astype(int) - sharded.astype(int))
    assert np.median(diff) <= 1
    assert (diff <= 2).mean() > 0.99
    opts = tbrush.GanBrushOptions()
    opts.set_style(engine.random_style(5), 5)
    with pytest.raises(ValueError, match="divide"):
        stylize_image_ondevice(engine, np.zeros((96, 96), np.float32), opts,
                               overlap_margin=4, feature_blending_level=1,
                               batch_size=6, mesh=make_mesh(8, device="cpu"))


class _Reached(Exception):
    pass


@pytest.mark.parametrize("argv, want", [
    (["--dp", "1"], ("localhost", 1, 0)),
    (["--dp", "1", "--coordinator_address", "h:9", "--num_processes", "3",
      "--process_id", "2"], ("h:9", 3, 2)),
    (["--coordinator_address", "h:9", "--num_processes", "2",
      "--process_id", "1"], ("h:9", 2, 1)),
])
def test_train_cli_mesh_flags_reach_the_group_setup(tmp_path, monkeypatch,
                                                     argv, want):
    """The flags name the world (hosts x ranks per host) and this rank
    (host x ranks per host + local rank), and the CLI forms the group with
    them before it builds anything."""
    seen = {}

    def fake(coordinator=None, world=None, rank=None, device="cuda", **kw):
        seen.update(coordinator=coordinator, world=world, rank=rank,
                    device=device)
        raise _Reached

    import brushstroke_engine_torch.parallel.distributed as pdist
    monkeypatch.setattr(pdist, "maybe_initialize_distributed", fake)
    with pytest.raises(_Reached):
        ttrain.main(["--outdir", str(tmp_path), "--device", "cpu"] + argv)
    assert seen["coordinator"].startswith(want[0])
    assert (seen["world"], seen["rank"], seen["device"]) == \
        (want[1], want[2], "cpu")
    # Half the multi-host flags is an error, before any group.
    with pytest.raises(ValueError, match="go together"):
        ttrain.main(["--outdir", str(tmp_path), "--device", "cpu",
                     "--num_processes", "2"])
    # torchrun's environment: the launcher's group.
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert ttrain.group_plan(ttrain.build_parser().parse_args(
        ["--outdir", "x", "--dp", "4"])) is None


def test_server_serve_devices(engine):
    from brushstroke_engine_torch.ui import server
    from brushstroke_engine_torch.ui.core import create_core
    args = server.build_parser().parse_args(["--serve_devices", "2",
                                             "--device", "cpu"])
    assert args.serve_devices == 2
    assert server.build_parser().parse_args([]).serve_devices == 0
    core = create_core(paint_engine=engine, device="cpu", serve_devices=2)
    try:
        assert core.engine.serving_mesh.size == 2
    finally:
        engine.set_serving_mesh(None)
    with pytest.raises(ValueError, match="GAN engine"):
        create_core(paint_engine=tbrush.MockPaintEngine(32), device="cpu",
                    serve_devices=1)
