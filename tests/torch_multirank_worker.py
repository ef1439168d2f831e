"""One process of ``tests/test_torch_multirank.py``: the port's fused
training loop on device banks, 32 px, global batch 8, on the CPU, as one
rank of a gloo group (``--world 2``) or as the single process of the
reference run (``--world 1``: no group).  Imports no JAX.

The configuration turns on everything that pools over the batch or draws
per sample: Dr1, Gpl, Ggeom, ADA ('bgc' at p = 0.6, updated every batch),
random noise planes, style mixing, a ``masked_mean`` loss (``l1(uvs)`` and
``bce(uvs)`` with the triband masks) and a ``mean_rgb`` loss in the phase
losses, and the discriminator's minibatch-stddev with groups of 4 (the
local batch is 4 at two ranks, so a group spans both ranks).

Writes a JSON of the last tick's stats and digests of the trees (sums of
absolute values) after ``--batches`` batches.  Then, from that state and on
fixed global inputs (each rank its rows), one Gstitch (its discriminator
passes over ``concat(fake1, fake2)`` and the composites, minibatch-stddev
groups spanning both ranks), one Gstitch in two ``batch_gpu`` rounds of 4
and one Dmain in two rounds of 4 (2 rows per rank per round): their stats
and the digests of the updated tree.  With ``--save`` the run
then writes its state through the tensor-wise ("orbax") backend; with
``--resume DIR`` (one process) a second loop resumes DIR once it is
written and, like the
first loop, trains ``--more`` batches further, and both loops' digests are
written.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# TensorBoard's writer without TensorFlow behind it (seconds of import).
sys.modules.setdefault("tensorflow", None)

from brushstroke_engine_torch.models.discriminator import \
    DiscriminatorConfig  # noqa: E402
from brushstroke_engine_torch.models.generator import \
    make_generator_config  # noqa: E402
from brushstroke_engine_torch.models.geo_encoder import \
    GeoEncoderConfig  # noqa: E402
from brushstroke_engine_torch.ops.precision import \
    set_precision_mode  # noqa: E402
from brushstroke_engine_torch.parallel.distributed import \
    maybe_initialize_distributed  # noqa: E402
from brushstroke_engine_torch.parallel.distributed import \
    rank_context  # noqa: E402
from brushstroke_engine_torch.parallel.mesh import (  # noqa: E402
    make_mesh, mean_stats,
)
from brushstroke_engine_torch.train.augment import \
    AugmentConfig  # noqa: E402
from brushstroke_engine_torch.train.device_dataset import \
    build_device_banks  # noqa: E402
from brushstroke_engine_torch.train.loop import TrainingLoop  # noqa: E402
from brushstroke_engine_torch.train import steps as ts  # noqa: E402
from brushstroke_engine_torch.train.state import TrainConfig  # noqa: E402
from brushstroke_engine_torch.utils.checkpoint import (  # noqa: E402
    init_native_params, params_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves  # noqa: E402

RES, BATCH = 32, 8
MAIN_LOSSES = "0.1*iou_inv(uvs)+0.5*l1(uvs)+0.3*rgb(uvs,mean_rgb=1)"
GEOM_LOSSES = "1.0*iou_inv(uvs)+0.5*bce(uvs)"
STITCH_LOSSES = "1.0*gan(fake)+1.0*gan(fake_composite)+1.0*l1(patch)"
ROUND = 4          # batch_gpu of the rounds: 2 rounds of the global 8


class _DS:
    def __init__(self, a):
        self.a = a

    def __len__(self):
        return len(self.a)

    def __getitem__(self, i):
        return self.a[i]


def setup(device="cpu"):
    """(cfg, enc_params, enc_state, banks) from fixed seeds."""
    enc_cfg = GeoEncoderConfig(
        kind="sauto", in_channels=1, out_channels=1, preproc="-11inverse",
        pre_filters=8, down_filters=(16, 16), post_filters=(8,),
        up_filters=(16, 8))
    inject = (0, 1)
    gen_cfg = make_generator_config(
        z_dim=16, w_dim=16, img_resolution=RES,
        geom_feature_resolutions=tuple(
            enc_cfg.featuremap_resolution(RES, r) for r in inject),
        geom_feature_channels=tuple(enc_cfg.feature_channels(r)
                                    for r in inject),
        channel_base=2048, channel_max=32)
    disc_cfg = DiscriminatorConfig(
        c_dim=0, img_resolution=RES, img_channels=3, architecture="orig",
        channel_base=2048, channel_max=32, mbstd_group_size=4)
    trees = init_native_params(gen_cfg, enc_cfg, seed=3)
    cfg = TrainConfig(
        gen_cfg=gen_cfg, disc_cfg=disc_cfg, enc_cfg=enc_cfg, enc_res=inject,
        batch_size=BATCH, noise_mode="random", style_mixing_prob=0.9,
        r1_gamma=10.0, d_reg_interval=2, g_reg_interval=2, geom_interval=2,
        ada_interval=1, ada_kimg=0.1, geom_warmstart_kimg=0,
        main_phase_losses=MAIN_LOSSES, geom_phase_losses=GEOM_LOSSES,
        augment=AugmentConfig.from_spec("bgc"),
        kimg_per_tick=BATCH / 1000.0)
    rng = np.random.RandomState(4)
    banks = build_device_banks(
        _DS(rng.randint(0, 256, (12, RES, RES, 3)).astype(np.uint8)),
        _DS(rng.randint(0, 256, (10, RES + 24, RES + 24, 3)).astype(
            np.uint8)), device=device)
    return (cfg, params_from_jax(trees["enc_params"]),
            params_from_jax(trees["enc_state"]), banks)


def make_loop(run_dir, mesh=None, device="cpu"):
    cfg, enc_params, enc_state, banks = setup(device)
    loop = TrainingLoop(cfg, enc_params, enc_state, None, None,
                        run_dir=run_dir, seed=5, device=device,
                        use_fused=True, device_banks=banks, mesh=mesh,
                        snapshot_ticks=10 ** 9)
    loop.state["ada_p"] = torch.full((), 0.6, device=loop.device)
    return loop


def digest(loop):
    """Sum of |x| over each trained tree (float64)."""
    return {name: float(sum(t.detach().double().abs().sum().item()
                            for t in tree_leaves(loop.state[name])))
            for name in ("g_params", "d_params", "g_ema")}


def extra_steps(loop, mesh):
    """{name: {"stats", "digest"}} of one Gstitch, one Gstitch in rounds and
    one Dmain in rounds from ``loop``'s state on fixed global inputs."""
    ranks = mesh.ranks() if mesh is not None else None
    world, rank = (ranks.world, ranks.rank) if ranks else (1, 0)
    cfg = dataclasses.replace(loop.cfg, stitch_interval=4,
                              stitch_phase_losses=STITCH_LOSSES)
    rng = np.random.RandomState(7)
    dev = loop.device
    geom = torch.from_numpy(
        (rng.rand(BATCH, RES, RES, 1) > 0.5).astype(np.float32)).to(dev)
    z = torch.from_numpy(rng.randn(BATCH, cfg.gen_cfg.z_dim).astype(
        np.float32)).to(dev)
    real = torch.from_numpy(rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(
        np.float32)).to(dev)
    mine = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    feats1 = ts.encode_geometry(cfg, loop.enc_params, loop.enc_state,
                                geom[mine])
    feats2 = [torch.flip(f, dims=(2,)) for f in feats1]
    rounds = dataclasses.replace(cfg, batch_gpu=ROUND)
    out = {}
    for name, c, tree in (("stitch", cfg, "g_params"),
                          ("stitch_rounds", rounds, "g_params"),
                          ("dmain_rounds", rounds, "d_params")):
        gen = torch.Generator(device=dev).manual_seed(11)
        with rank_context(ranks):
            if tree == "g_params":
                state, stats = ts.g_stitch_step(
                    c, loop.state, feats1, feats2, z[mine],
                    (0, 0, RES, RES), (5, 6, RES, RES), gen, 0.5)
            else:
                state, stats = ts.d_main_step(c, loop.state, real[mine],
                                              feats1, z[mine], gen)
            stats = mean_stats(stats)
        out[name] = {
            "stats": {k: float(v) for k, v in stats.items()},
            "digest": float(sum(t.detach().double().abs().sum().item()
                                for t in tree_leaves(state[tree])))}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--save", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--more", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_precision_mode("strict")
    mesh = None
    if args.world > 1:
        maybe_initialize_distributed(f"localhost:{args.port}", args.world,
                                     args.rank, device=args.device,
                                     backend=args.backend, timeout_s=240)
        mesh = make_mesh(device=args.device)
    run_dir = os.path.join(os.path.dirname(args.out), f"run{args.world}")
    loop = make_loop(run_dir, mesh, args.device)
    loop.run(total_kimg=args.batches * BATCH / 1000.0)
    stats = {}
    if loop.rank == 0:
        with open(loop.stats_path) as f:
            stats = json.loads(f.readlines()[-1])
    out = {"stats": stats, "digest": digest(loop),
           "nimg": loop.cur_nimg, "rank": loop.rank,
           "world": loop.num_ranks, "extra": extra_steps(loop, mesh)}
    if args.save:
        loop.save_train_state(args.save, backend="orbax")
    if args.resume:
        # The 2-rank run writes the streams' file last.
        deadline = time.time() + 240
        while not os.path.isfile(args.resume + ".nprng.pkl"):
            assert time.time() < deadline, "no state to resume"
            time.sleep(0.2)
        total = (args.batches + args.more) * BATCH / 1000.0
        loop.run(total_kimg=total)
        out["digest_more"] = digest(loop)
        resumed = make_loop(run_dir + "_resumed", device=args.device)
        assert resumed.load_train_state(args.resume, backend="orbax")
        out["resumed_nimg"] = resumed.cur_nimg
        resumed.run(total_kimg=total)
        out["resumed_digest"] = digest(resumed)
    with open(f"{args.out}.rank{args.rank}", "w") as f:
        json.dump(out, f)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
