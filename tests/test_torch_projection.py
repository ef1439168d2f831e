"""The port's projection (``tools/projection.py``), its helpers and the
per-row noise of synthesis against the JAX package on the CPU, small sizes
(the 32-px test generator of ``tests/torch_helpers.py``).

The same numpy-seeded targets, geometry and weights go through both; the
JAX package's w-noise normals are computed eagerly with its key schedule
(``jax_draws``) and handed to the port's ``draws``.  Every JAX optimization
runs once, in a module-scoped fixture.

Tolerances: 1e-5 (relative and absolute) for single evaluations; for the
multi-step optimizations 1e-4 relative plus Adam's lr bound -- Adam divides
each gradient entry by its own running magnitude, so an entry whose
gradient is rounding noise can take a step of up to the learning rate in
another direction; such entries may be 1% of the tensor and differ by up to
the summed learning rate, every other entry within 1e-4 relative (+1e-5
absolute; ``tests.torch_helpers.assert_optimized_close``).  Losses within
1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.metrics import geom as jgeom
from brushstroke_engine_tpu.models.generator import generator_apply as \
    jgenerator_apply
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_tpu.tools import projection as jproj
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.metrics import geom as tgeom
from brushstroke_engine_torch.models.generator import generator_apply
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.tools import projection as tproj
from tests.torch_helpers import assert_optimized_close, jax_draws, \
    small_model

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS, LOG_EVERY, W_SAMPLES = 4, 2, 64


def lr_sum(cfg, steps):
    return sum(tproj._lr_schedule(cfg, s) for s in range(steps))


@pytest.fixture(scope="module")
def model():
    return small_model(seed=3)


def _engines(model):
    jgen, jenc = model["jax_cfg"]
    tgen, tenc = model["cfg"]
    j = jbrush.TriadGanPaintEngine(
        jgen, model["jax"]["gen_params"], model["jax"]["gen_state"], jenc,
        model["jax"]["enc_params"], model["jax"]["enc_state"],
        geom_inject_resolutions=(0, 1))
    t = tbrush.TriadGanPaintEngine(
        tgen, model["torch"]["gen_params"], model["torch"]["gen_state"], tenc,
        model["torch"]["enc_params"], model["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    return j, t


def _inputs(n, b, seed=0):
    """Targets in [-1, 1] and stroke geometry (a bar, 0 = FG) per row."""
    rng = np.random.RandomState(seed)
    targets = (rng.rand(n, b, 32, 32, 3) * 2 - 1).astype(np.float32)
    geoms = np.ones((n, b, 32, 32, 1), np.float32)
    for i in range(n):
        for j in range(b):
            y = rng.randint(4, 20)
            geoms[i, j, y:y + 8, 4:28] = 0.0
    return targets, geoms


CASES = {
    # project_parallel: LPIPS + the noise regularizer, W+ and noise.
    "parallel": dict(n=2, b=2, cfg={}),
    # project: every optional term on (L1 over the FG, the BG term, the
    # composite over the estimated background color).
    "terms": dict(n=1, b=2, cfg=dict(l1_fg_weight=0.7, bg_weight=0.4,
                                     with_composite=True)),
    # project without noise, one W broadcast (w_plus off).
    "w_only": dict(n=1, b=2, cfg=dict(optimize_noise=False, w_plus=False)),
}


@pytest.fixture(scope="module")
def runs(model):
    """Each case through both packages (the JAX runs once per module), and
    the 'terms' case resumed from its own result."""
    j, t = _engines(model)
    num_ws, w_dim = model["cfg"][0].num_ws, model["cfg"][0].w_dim
    out = {}
    for name, case in CASES.items():
        cfg = tproj.ProjectionConfig(
            num_steps=STEPS, w_avg_samples=W_SAMPLES,
            min_lpips_improvement=-1.0, **case["cfg"])
        jcfg = jproj.ProjectionConfig(**cfg.__dict__)
        targets, geoms = _inputs(case["n"], case["b"])
        shape = (1, num_ws if cfg.w_plus else 1, w_dim)
        with precision_mode("strict"):
            if name == "parallel":
                draws = jax_draws(0, STEPS, LOG_EVERY, shape, n=case["n"])
                want = jproj.project_parallel(j, targets, geoms, jcfg,
                                              log_every=LOG_EVERY)
                got = tproj.project_parallel(t, targets, geoms, cfg,
                                             log_every=LOG_EVERY,
                                             draws=draws)
            else:
                draws = jax_draws(0, STEPS, LOG_EVERY, shape)
                want = [jproj.project(j, targets[0], geoms[0], jcfg,
                                      log_every=LOG_EVERY)]
                got = [tproj.project(t, targets[0], geoms[0], cfg,
                                     log_every=LOG_EVERY, draws=draws)]
        out[name] = (cfg, got, want, draws)
    cfg, got, want, draws = out["terms"]
    targets, geoms = _inputs(1, 2)
    with precision_mode("strict"):
        want_r = jproj.project(j, targets[0], geoms[0],
                               jproj.ProjectionConfig(**cfg.__dict__),
                               resume_from=want[0], log_every=LOG_EVERY)
    got_r = tproj.project(t, targets[0], geoms[0], cfg, resume_from=got[0],
                          log_every=LOG_EVERY, draws=draws)
    out["resume"] = (cfg, [got_r], [want_r], draws)
    return out


@pytest.mark.parametrize("case", [*CASES, "resume"])
def test_projection_equals_jax(runs, case):
    """Best-so-far w and noise, the best LPIPS, its step and the background
    color after STEPS steps with the JAX package's draws."""
    cfg, got, want, _ = runs[case]
    assert len(got) == len(want)
    lr_total = lr_sum(cfg, STEPS)
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["lpips"], w["lpips"], rtol=1e-4)
        np.testing.assert_allclose(g["bg"], w["bg"], **TOL)
        assert_optimized_close(g["w"], w["w"], lr_total)
        assert list(g["noise"]) == list(w["noise"])
        for k in w["noise"]:
            assert_optimized_close(g["noise"][k], w["noise"][k], lr_total)
    if case == "w_only":
        assert got[0]["w"].shape[1] == 1 and not got[0]["noise"]


def test_parallel_equals_separate_projections(model, runs):
    """One Adam over the stacked styles is N Adams: each style of the
    parallel run equals ``project`` on that style alone with its draws and
    its initial noise (port against port)."""
    from brushstroke_engine_torch.tools.latent import get_w_stats

    _, t = _engines(model)
    cfg, got, _, draws = runs["parallel"]
    targets, geoms = _inputs(2, 2)
    w_avg, w_std = get_w_stats(t.gen_cfg, t.gen_params["mapping"],
                               num_samples=cfg.w_avg_samples)
    w_start = np.tile(w_avg, (1, t.gen_cfg.num_ws, 1))[None]
    order = sorted(t.gen_state["noise"])
    rng = np.random.RandomState(0)
    noise0 = {k: rng.randn(2, *tuple(t.gen_state["noise"][k].shape))
              for k in order}
    lr_total = lr_sum(cfg, STEPS)
    for i in range(2):
        alone = tproj._optimize(
            t, targets[i:i + 1], geoms[i:i + 1], cfg, w_start, w_std,
            {k: v[i:i + 1] for k, v in noise0.items()}, 0, LOG_EVERY,
            draws[:, i:i + 1])
        assert_optimized_close(alone["w"][0], got[i]["w"], lr_total)
        for k in order:
            assert_optimized_close(alone["noise"][k][0], got[i]["noise"][k],
                                   lr_total)
        np.testing.assert_allclose(alone["lpips"][0], got[i]["lpips"],
                                   rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 3, 49, 50, 120, 780, 999])
def test_lr_schedule_equals_jax(step):
    """The port's schedule is in float64 on the host, JAX's in f32 on the
    device: 1e-6 relative, and 1e-8 absolute (1e-7 of the peak 0.1) where
    the f32 cosine near pi cancels (the last steps)."""
    cfg = tproj.ProjectionConfig()
    want = float(jproj._lr_schedule(jproj.ProjectionConfig(),
                                    jnp.float32(step)))
    np.testing.assert_allclose(tproj._lr_schedule(cfg, step), want,
                               rtol=1e-6, atol=1e-8)


def test_noise_autocorr_reg_equals_jax():
    """Buffers of 32, 16, 8 and 4 px (the multiscale loop stops at 8): the
    dict of [H, W] textures, and [N, H, W] per style."""
    rng = np.random.RandomState(5)
    bufs = {f"b{r}.conv1.noise_const": rng.randn(3, r, r).astype(np.float32)
            for r in (4, 8, 16, 32)}
    per_style = tproj._noise_autocorr_reg(
        {k: torch.from_numpy(v) for k, v in bufs.items()}).numpy()
    assert per_style.shape == (3,)
    for i in range(3):
        want = float(jproj._noise_autocorr_reg(
            {k: jnp.asarray(v[i]) for k, v in bufs.items()}))
        got = tproj._noise_autocorr_reg(
            {k: torch.from_numpy(v[i]) for k, v in bufs.items()})
        np.testing.assert_allclose(float(got), want, **TOL)
        np.testing.assert_allclose(per_style[i], want, **TOL)


def test_masked_color_composite_and_fg_bg_equal_jax():
    rng = np.random.RandomState(2)
    target = (rng.rand(3, 32, 32, 3) * 2 - 1).astype(np.float32)
    geom = np.ones((3, 32, 32, 1), np.float32)
    geom[:, 10:20, 5:27] = 0.0
    geom[1] = (rng.rand(32, 32, 1) > 0.3).astype(np.float32)
    jfg, jbg = jgeom.get_conservative_fg_bg(jnp.asarray(geom))
    tfg, tbg = tgeom.get_conservative_fg_bg(torch.from_numpy(geom))
    assert np.array_equal(tfg.numpy(), np.asarray(jfg))
    assert np.array_equal(tbg.numpy(), np.asarray(jbg))
    assert tbg.numpy().any() and tfg.numpy().any()
    want = np.asarray(jproj.compute_masked_color(jnp.asarray(target), jbg))
    got = tproj.compute_masked_color(torch.from_numpy(target), tbg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    debug = {"uvs": rng.dirichlet(np.ones(3), (3, 32, 32)).astype(np.float32),
             "colors": rng.uniform(-1, 1, (3, 3, 3)).astype(np.float32)}
    want = np.asarray(jproj.composite_with_bg_color(
        {k: jnp.asarray(v) for k, v in debug.items()}, jnp.asarray(want)))
    got = tproj.composite_with_bg_color(
        {k: torch.from_numpy(v) for k, v in debug.items()},
        torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _ws_and_feats(model, n_rows, seed=4):
    from brushstroke_engine_torch.models.geo_encoder import \
        geo_encoder_encode
    tgen, tenc = model["cfg"]
    rng = np.random.RandomState(seed)
    ws = torch.from_numpy(rng.randn(n_rows, tgen.num_ws, tgen.w_dim)
                          .astype(np.float32))
    geom = torch.from_numpy((rng.rand(n_rows, 32, 32, 1) > 0.5)
                            .astype(np.float32))
    feats = geo_encoder_encode(tenc, model["torch"]["enc_params"],
                               model["torch"]["enc_state"], geom, res=[0, 1])
    return ws, feats


def test_per_row_noise_equals_separate_runs(model):
    """Noise buffers ``[N*B, H, W]`` (one plane per row) give each group of B
    rows what N separate runs with ``[H, W]`` planes give, and the JAX
    package's render of each group; the [H, W] path equals the same plane
    repeated per row, bit for bit."""
    tgen = model["cfg"][0]
    n, b = 2, 2
    ws, feats = _ws_and_feats(model, n * b)
    rng = np.random.RandomState(9)
    planes = {k: rng.randn(n, *tuple(v.shape)).astype(np.float32)
              for k, v in model["torch"]["gen_state"]["noise"].items()}
    kw = dict(noise_mode="const", return_debug_data=True)
    params, state = model["torch"]["gen_params"], model["torch"]["gen_state"]
    rows, _ = generator_apply(
        tgen, params, state, ws=ws, geom_features=feats,
        noise_buffers={k: torch.from_numpy(np.repeat(v, b, axis=0))
                       for k, v in planes.items()}, **kw)
    for i in range(n):
        sl = slice(i * b, (i + 1) * b)
        alone, _ = generator_apply(
            tgen, params, state, ws=ws[sl],
            geom_features=[f[sl] for f in feats],
            noise_buffers={k: torch.from_numpy(v[i])
                           for k, v in planes.items()}, **kw)
        # Another batch size may pick another CPU conv algorithm: 1e-5.
        np.testing.assert_allclose(rows[sl].numpy(), alone.numpy(), **TOL)
        repeated, _ = generator_apply(
            tgen, params, state, ws=ws[sl],
            geom_features=[f[sl] for f in feats],
            noise_buffers={k: torch.from_numpy(np.repeat(v[i:i + 1], b, 0))
                           for k, v in planes.items()}, **kw)
        assert torch.equal(repeated, alone)
        with precision_mode("strict"):
            want, _, _ = jgenerator_apply(
                model["jax_cfg"][0], model["jax"]["gen_params"],
                model["jax"]["gen_state"], ws=jnp.asarray(ws[sl].numpy()),
                geom_features=[jnp.asarray(f[sl].numpy()) for f in feats],
                noise_buffers={k: jnp.asarray(v[i])
                               for k, v in planes.items()},
                noise_mode="const")
        np.testing.assert_allclose(alone.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-5)
    with pytest.raises(ValueError, match="positions"):
        generator_apply(tgen, params, state, ws=ws, geom_features=feats,
                        positions=torch.zeros((n * b, 2), dtype=torch.long),
                        noise_buffers={k: torch.from_numpy(
                            np.repeat(v, b, axis=0))
                            for k, v in planes.items()}, **kw)
