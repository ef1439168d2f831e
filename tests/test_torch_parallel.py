"""The port's mesh helpers, scalar stats and data-parallel step on the CPU.

* ``parallel/mesh.py``: a local mesh of 8 CPU entries (the counterpart of
  the conftest's 8 virtual JAX devices) -- pad, split, gather, shard,
  replicate and the tile-render wrapper -- and a group mesh over a gloo
  group of one rank.
* ``utils/stats.py`` against the JAX package's ``Collector`` on the same
  reports (``tests/test_infra.py``'s cases), and the cross-rank reduction.
* ``make_dp_train_step`` at a world of one (a gloo group) against the JAX
  ``make_dp_train_step`` on the 8-device CPU mesh, the same weights through
  the carry-across functions, 32 px, B = 8, strict f32: stats 1e-4
  relative (+1e-5 abs), the G and D updates by the phase tests' Adam rule
  over the summed learning rate of the phases that moved them, ``w_avg``
  and ``pl_mean`` 1e-4; and the same step without a group (a local mesh of
  one device) bit for bit.
* ``parallel/distributed.py``: a group that cannot form raises.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.parallel.mesh import make_dp_train_step as \
    jax_dp_step, make_mesh as jax_make_mesh
from brushstroke_engine_tpu.utils import stats as jstats
from brushstroke_engine_torch.parallel import distributed as pdist
from brushstroke_engine_torch.parallel import mesh as pmesh
from brushstroke_engine_torch.utils import stats as tstats
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, _np_tree, _train_cfgs, _jax_state, _assert_update_parity,
    STAT_TOL,
)

DP_B = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def group_of_one():
    """A gloo process group of one rank for the test, torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    yield pmesh.make_mesh(device="cpu")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def test_local_mesh_pads_splits_and_gathers():
    mesh = pmesh.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.group is None and mesh.ranks() is None
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert pmesh.make_mesh(device="cpu").size == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(2, device="cuda")

    x = np.arange(3 * 2, dtype=np.float32).reshape(3, 2)
    t = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 4)
    tree = {"x": x, "t": t, "bcast": np.ones((1, 5)), "s": 7}
    padded, n_pad = pmesh.pad_rows(tree, 3, 8)
    assert n_pad == 5
    assert padded["x"].shape == (8, 2) and padded["t"].shape == (8, 4)
    np.testing.assert_array_equal(padded["x"][3:], np.repeat(x[-1:], 5, 0))
    assert torch.equal(padded["t"][3:], t[-1:].expand(5, 4))
    assert padded["bcast"].shape == (1, 5) and padded["s"] == 7
    assert pmesh.pad_rows(tree, 3, 3) == (tree, 0)

    parts = pmesh.split_rows(padded, 8, 8)
    assert len(parts) == 8 and all(p["x"].shape == (1, 2) for p in parts)
    with pytest.raises(ValueError, match="do not split"):
        pmesh.split_rows(tree, 3, 2)
    got = pmesh.gather_rows([{"t": p["t"] * 2, "n": torch.tensor(1.0)}
                             for p in parts], "cpu", keep=3)
    assert torch.equal(got["t"], t * 2) and float(got["n"]) == 1.0

    shards = pmesh.shard_batch(mesh, {"x": np.zeros((16, 3), np.float32)})
    assert len(shards) == 8 and all(s["x"].shape == (2, 3) for s in shards)
    copies = pmesh.replicate(mesh, {"w": t})
    assert len(copies) == 8 and all(torch.equal(c["w"], t) for c in copies)


@pytest.mark.parametrize("rows", [3, 8, 11])
def test_shard_tile_render_matches_one_call(rows):
    """Rows split over 8 CPU entries, issued one chunk per device, then
    gathered without the padding: the per-row function's output."""
    mesh = pmesh.make_mesh(8, device="cpu")
    calls = []

    def render(a, b, device):
        calls.append((a.shape[0], str(device)))
        return {"y": torch.as_tensor(a) * 2 + b.sum(dim=1, keepdim=True),
                "meta": torch.tensor(5.0)}

    a = np.random.RandomState(0).randn(rows, 4).astype(np.float32)
    b = torch.randn(rows, 3)
    got = pmesh.shard_tile_render(mesh, render)(a, b)
    assert torch.allclose(got["y"], torch.from_numpy(a) * 2
                          + b.sum(dim=1, keepdim=True))
    assert got["y"].shape[0] == rows and float(got["meta"]) == 5.0
    assert len(calls) == 8 and len({c[0] for c in calls}) == 1


def test_group_mesh_of_one_rank(group_of_one):
    mesh = group_of_one
    assert mesh.size == 1 and mesh.rank == 0 and mesh.group is not None
    assert mesh.ranks() == pdist.RankGroup(mesh.group, 0, 1)
    assert pdist.host_shard_info() == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(pmesh.shard_batch(mesh, x), x)
    tree = {"a": x.clone(), "b": {"c": torch.ones(2, dtype=torch.int64)},
            "n": 3}
    out = pmesh.replicate(mesh, tree)
    assert torch.equal(out["a"], x) and out["n"] == 3
    with pytest.raises(ValueError, match="spans the group"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="local mesh"):
        pmesh.shard_tile_render(mesh, lambda *a, **k: None)
    # A group of one: the means run their collective and change no bit;
    # the draws and pooled reductions are the single process's.
    with pdist.rank_context(mesh.ranks()):
        g = [torch.randn(5), torch.randn(2, 3), torch.arange(4)]
        assert all(torch.equal(a, b)
                   for a, b in zip(pdist.mean_over_ranks_(g), g))
        assert pdist.num_ranks() == 1 and pdist.rows_of(4) == slice(None)
        assert torch.equal(pdist.all_gather_rows(x), x)
        gen = torch.Generator().manual_seed(3)
        d = pdist.draw_rows(torch.randn, (4, 2), generator=gen)
    assert torch.equal(d, torch.randn((4, 2), generator=torch.Generator()
                                      .manual_seed(3)))


def test_a_group_that_cannot_form_raises(monkeypatch):
    """No rank-0 store answers: the group does not form, and the setup
    raises instead of training alone."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="did not form"):
        pdist.maybe_initialize_distributed(
            f"127.0.0.1:{_free_port()}", 2, 1, device="cpu", timeout_s=2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        pdist.maybe_initialize_distributed("127.0.0.1:1", 2, None,
                                           device="cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete torchrun"):
        pdist.maybe_initialize_distributed(device="cpu")
    monkeypatch.delenv("RANK")
    assert pdist.maybe_initialize_distributed(device="cpu") is False


def test_mesh_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (pmesh.make_mesh, pdist.rank_device,
                 lambda: pdist.maybe_initialize_distributed("127.0.0.1:1",
                                                            1, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def test_stats_match_the_jax_collector(group_of_one):
    np.testing.assert_allclose(
        tstats.report_moments(torch.tensor([1.0, 2.0, 3.0])).numpy(),
        np.asarray(jstats.report_moments(jnp.asarray([1.0, 2.0, 3.0]))))
    reports = [("Loss/a", np.asarray([1.0, 2.0, 3.0])), ("Loss/a", 4.0),
               ("Loss/b", torch.tensor([[0.5, -1.5]])), ("Timing/x", 1.0)]
    for regex in (".*", r"Loss/.*"):
        t, j = tstats.Collector(regex), jstats.Collector(regex)
        for name, v in reports:
            t.report(name, v)
            j.report(name, np.asarray(v))
        t.report_raw_moments("m", tstats.report_moments(
            torch.tensor([2.0, 4.0])))
        j.report_raw_moments("m", np.asarray(jstats.report_moments(
            jnp.asarray([2.0, 4.0]))))
        assert t.names() == j.names()
        assert t.as_dict() == j.as_dict()
        # A group of one: the reduction changes nothing.
        t.reduce_over_ranks()
        assert t.as_dict() == j.as_dict()
        t.update()
        j.update()
        t.reset()
        j.reset()
        assert t.names() == j.names() == []


# ---------------------------------------------------------------------------
# The data-parallel step against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp():
    m, jcfg, tcfg = _train_cfgs(batch_size=DP_B, d_reg_interval=2,
                                g_reg_interval=2)
    mesh = jax_make_mesh()
    assert mesh.devices.size == 8
    return m, jcfg, tcfg, jax_dp_step(jcfg, mesh)


def _dp_batch(seed):
    rng = np.random.RandomState(seed)
    real = rng.randn(DP_B, RES, RES, 3).astype(np.float32)
    geom = (rng.rand(DP_B, RES, RES, 1) > 0.5).astype(np.float32)
    z1, z2 = (rng.randn(DP_B, 16).astype(np.float32) for _ in range(2))
    return real, geom, z1, z2


def test_dp_step_at_world_one_equals_jax(jax_dp, group_of_one):
    m, jcfg, tcfg, jstep = jax_dp
    real, geom, z1, z2 = _dp_batch(5)
    jst = _jax_state(m, jcfg)
    tst = train_state_from_jax(_np_tree(jst), device="cpu")
    before = {k: _np_tree(jst[k]) for k in ("g_params", "d_params")}
    key = jax.random.PRNGKey(8)
    # The JAX step's Gpl image noise: k4 = split(key, 4)[3], split again.
    k4 = jax.random.split(key, 4)[3]
    pl = np.array(jax.random.normal(jax.random.split(k4)[1],
                                    (DP_B // 2, RES, RES, 3)))
    jst2, js = jstep(jst, m["jax"]["enc_params"], m["jax"]["enc_state"],
                     jnp.asarray(real), jnp.asarray(geom), jnp.asarray(z1),
                     jnp.asarray(z2), key, jnp.int32(0), jnp.float32(0.5))

    args = (m["torch"]["enc_params"], m["torch"]["enc_state"],
            torch.from_numpy(real), torch.from_numpy(geom),
            torch.from_numpy(z1), torch.from_numpy(z2), None, 0, 0.5)
    draws = {"greg": {"pl_noise": torch.from_numpy(pl)}}
    tst2, ts = pmesh.make_dp_train_step(tcfg, group_of_one)(
        tst, *args, draws=draws)

    js = {k: float(v) for k, v in js.items()}
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), js[k], err_msg=k,
                                   **STAT_TOL)
    lr = 2e-4
    for k, n in (("g_params", 2), ("d_params", 2)):
        _assert_update_parity(params_from_jax(before[k]), tst2[k],
                              params_from_jax(_np_tree(jst2[k])), n * lr,
                              f"dp {k}")
    for k in ("w_avg", "pl_mean"):
        np.testing.assert_allclose(tst2[k].numpy(), np.asarray(jst2[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert {k: tst2[k]["count"] for k in ("g_opt", "d_opt")} == \
        {"g_opt": 2, "d_opt": 2}

    # Without a group (a local mesh of one device) the same step, bit for
    # bit: a group of one changes nothing.
    solo, ts1 = pmesh.make_dp_train_step(
        tcfg, pmesh.make_mesh(device="cpu", local=True))(
        train_state_from_jax(_np_tree(_jax_state(m, jcfg)), device="cpu"),
        *args, draws=draws)
    for a, b in zip(tree_leaves(solo), tree_leaves(tst2)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert all(torch.equal(ts1[k], ts[k]) for k in ts)
    with pytest.raises(ValueError, match="one card per process"):
        pmesh.make_dp_train_step(tcfg, pmesh.make_mesh(2, device="cpu",
                                                       local=True))
