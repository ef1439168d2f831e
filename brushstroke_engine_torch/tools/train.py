"""GAN training CLI of the port.

Counterpart of ``scripts/train_main.py``, with the same flags, names and
defaults, plus ``--device`` (default ``cuda``; the run raises without CUDA
unless ``--device cpu``).  It assembles a ``TrainConfig``, builds the
geometry encoder from a seed, creates the numbered run directory
(``00000-<desc>``), writes ``training_options.json`` and runs the loop with
network snapshots and the resumable train state every ``--snap`` ticks and
the eval hooks of ``--metrics``.  The canonical run, as ``neube_train.sh``
assembles its flags:

    python -m brushstroke_engine_torch.tools.train --outdir runs/ \\
        $(grep -v '^#' train_flags.txt | tr '\\n' ' ')

and the clarity finetune adds ``finetune_flags.txt`` and ``--resume`` with
a snapshot.  Without ``--data`` the style images are seeded noise, without
``--geom_data`` the geometry is synthetic splines.  ``--encoder_checkpt``
takes an AE checkpoint (``tools/train_autoencoder.py``, either package's)
or else a reference encoder ``.pt``, converted on the way; without it the
flagship encoder's weights are random from the seed.

``--d_arch`` builds the discriminator it names ('orig' or 'resnet').  Flags
of parts that are not ported yet raise, naming ROADMAP.md: ``--fused``,
``--dp``, ``--device_dataset``, ``--steps_per_dispatch`` other than 1,
``--profile_dir`` and the multi-host flags.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re

import numpy as np

logger = logging.getLogger(__name__)


def next_run_dir(outdir: str, desc: str) -> str:
    os.makedirs(outdir, exist_ok=True)
    prev = [re.match(r"^(\d+)-", d) for d in os.listdir(outdir)]
    prev_ids = [int(m.group(1)) for m in prev if m]
    run_id = max(prev_ids, default=-1) + 1
    return os.path.join(outdir, f"{run_id:05d}-{desc}")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # Data.
    ap.add_argument("--data", help="Style image dataset (dir or zip).")
    ap.add_argument("--geom_data", default=None,
                    help="Triband geometry dataset (dir or zip); synthetic "
                         "splines if omitted.")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--resume", default=None,
                    help="Native snapshot to resume G from.")
    ap.add_argument("--encoder_checkpt", default=None,
                    help="Geometry encoder: an AE checkpoint, or a "
                         "reference .pt converted on the way.")
    ap.add_argument("--mirror", type=int, default=0)
    # Model (reference train_flags.txt names).
    ap.add_argument("--output_resolution", type=int, default=128)
    ap.add_argument("--zdim", type=int, default=64)
    ap.add_argument("--wdim", type=int, default=64)
    ap.add_argument("--channel_max", type=int, default=128)
    ap.add_argument("--num_bf16_res", type=int, default=4,
                    help="Run G and D at bf16 for the N highest "
                         "resolutions (0 disables).")
    ap.add_argument("--color_format", default="triad",
                    choices=["orig", "triad", "canvas"])
    ap.add_argument("--color_w_channels", type=int, default=0)
    ap.add_argument("--geom_inject_resolutions", default="0,1",
                    help="Encoder resolutions to inject (CSV).")
    ap.add_argument("--synthesis_arch", default="orig")
    ap.add_argument("--d_arch", default="orig")
    ap.add_argument("--positional_encoding", default=None)
    ap.add_argument("--posenc_inject_resolutions", default="")
    ap.add_argument("--posenc_injection_mode", default="cat")
    # Optimization.
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batch_gpu", type=int, default=None,
                    help="Microbatch size for gradient accumulation; None = "
                         "full batch.")
    ap.add_argument("--glr", type=float, default=2e-4)
    ap.add_argument("--dlr", type=float, default=2e-4)
    ap.add_argument("--geom_lr", type=float, default=2e-4)
    ap.add_argument("--gamma", type=float, default=None,
                    help="R1 weight; default 0.0002*res^2/batch.")
    ap.add_argument("--kimg", type=int, default=10000)
    ap.add_argument("--snap", type=int, default=100,
                    help="Network-snapshot + metric-suite interval in "
                         "ticks.")
    ap.add_argument("--image_snap", type=int, default=10,
                    help="Visualizer-sheet interval in ticks.")
    ap.add_argument("--aug", default="ada", choices=["ada", "noaug"])
    ap.add_argument("--augpipe", default="bgc")
    ap.add_argument("--style_mixing_prob", type=float, default=0.9)
    ap.add_argument("--ema_kimg", type=float, default=-1.0,
                    help="G_ema half-life in kimg; -1 = batch*10/32.")
    ap.add_argument("--ema_rampup", type=float, default=0.05,
                    help="EMA ramp-up ratio; <=0 disables ramp-up.")
    # NeuBE phases (train_flags.txt).
    ap.add_argument("--main_phase_losses", default="")
    ap.add_argument("--geom_phase_losses", default="1.0*iou_inv(uvs)")
    ap.add_argument("--geom_warmstart_losses",
                    default="1.0*iou_inv(uvs)+1.0*iou(u)")
    ap.add_argument("--stitch_phase_losses", default="")
    ap.add_argument("--geom_interval", type=int, default=200)
    ap.add_argument("--stitch_interval", type=int, default=0)
    ap.add_argument("--geom_phase_mode", default="last_and_rgb")
    ap.add_argument("--geom_warmstart_mode", default="last_and_rgb")
    ap.add_argument("--geom_warmstart_kimg", type=float, default=50)
    ap.add_argument("--geom_warmstart_start_kimg", type=float, default=0)
    ap.add_argument("--exit_after_warmstart", action="store_true")
    ap.add_argument("--partial_loss_with_triband_input", type=int, default=1)
    ap.add_argument("--geom_input_channel", type=int, default=1)
    ap.add_argument("--geom_truth_channel", type=int, default=2)
    # Misc (the throughput and multi-host flags are not ported yet).
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--dp", type=int, default=0)
    ap.add_argument("--device_dataset", action="store_true")
    ap.add_argument("--steps_per_dispatch", type=int, default=1)
    ap.add_argument("--coordinator_address", default="")
    ap.add_argument("--num_processes", type=int, default=0)
    ap.add_argument("--process_id", type=int, default=-1)
    ap.add_argument("--profile_dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default="fid,forger")
    ap.add_argument("--dry-run", action="store_true", dest="dry_run")
    ap.add_argument("--log_level", type=int, default=logging.INFO)
    ap.add_argument("--device", default="cuda",
                    help="Where to train: 'cuda' (needs a GPU) or 'cpu'.")
    return ap


def _reject_unported(args):
    asked = {
        "--fused": args.fused, "--dp": args.dp,
        "--device_dataset": args.device_dataset,
        "--steps_per_dispatch": args.steps_per_dispatch != 1,
        "--profile_dir": args.profile_dir,
        "--coordinator_address": args.coordinator_address,
        "--num_processes": args.num_processes,
        "--process_id": args.process_id >= 0,
    }
    for flag, on in asked.items():
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md, 'Modules to port')")


def load_encoder(path: str):
    """(GeoEncoderConfig, params, state) on the CPU from an AE checkpoint,
    or else from a reference encoder ``.pt`` (factory.py:18 layout)."""
    from brushstroke_engine_torch.train.train_autoencoder import (
        is_ae_checkpoint, load_ae_checkpoint,
    )
    from brushstroke_engine_torch.utils import torch_extract as tx
    from brushstroke_engine_torch.utils.checkpoint import (
        encoder_trees_from_checkpoint, params_from_jax,
    )
    if is_ae_checkpoint(path):
        return load_ae_checkpoint(path, device="cpu")
    enc_cfg, params, state = encoder_trees_from_checkpoint(
        tx.load_torch_file(path))
    return enc_cfg, params_from_jax(params), params_from_jax(state)


def setup_config(args):
    """argparse args -> (TrainConfig, enc_cfg, enc_params, enc_state), as
    ``scripts/train_main.py:setup_config`` builds them; without
    ``--encoder_checkpt`` the flagship encoder's weights are random from the
    numpy seed ``args.seed + 99``."""
    from brushstroke_engine_torch.flagship import flagship_encoder_config
    from brushstroke_engine_torch.models.discriminator import (
        DiscriminatorConfig,
    )
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    from brushstroke_engine_torch.train.augment import AugmentConfig
    from brushstroke_engine_torch.train.state import TrainConfig
    from brushstroke_engine_torch.utils.checkpoint import (
        init_encoder_trees, params_from_jax,
    )

    _reject_unported(args)
    inject = tuple(int(x) for x in
                   args.geom_inject_resolutions.split(",") if x != "")
    if args.encoder_checkpt:
        enc_cfg, enc_params, enc_state = load_encoder(args.encoder_checkpt)
    else:
        enc_cfg = flagship_encoder_config()
        enc_params, enc_state = map(params_from_jax, init_encoder_trees(
            enc_cfg, seed=args.seed + 99))
    res = args.output_resolution
    posenc_res = tuple(int(x) for x in
                       args.posenc_inject_resolutions.split(",") if x != "")
    gen_cfg = make_generator_config(
        z_dim=args.zdim, w_dim=args.wdim, img_resolution=res,
        geom_feature_resolutions=tuple(
            enc_cfg.featuremap_resolution(res, r) for r in inject),
        geom_feature_channels=tuple(
            enc_cfg.feature_channels(r) for r in inject),
        color_format=args.color_format,
        color_w_channels=args.color_w_channels,
        channel_base=16384, channel_max=args.channel_max,
        num_bf16_res=args.num_bf16_res,
        positional_encoding=args.positional_encoding,
        posenc_inject_resolutions=posenc_res,
        posenc_injection_mode=args.posenc_injection_mode)
    disc_cfg = DiscriminatorConfig(
        c_dim=0, img_resolution=res, img_channels=3,
        channel_base=16384, channel_max=args.channel_max,
        num_bf16_res=args.num_bf16_res, architecture=args.d_arch)

    gamma = args.gamma if args.gamma is not None else \
        0.0002 * (res ** 2) / args.batch
    cfg = TrainConfig(
        gen_cfg=gen_cfg, disc_cfg=disc_cfg, enc_cfg=enc_cfg,
        enc_res=inject, batch_size=args.batch, batch_gpu=args.batch_gpu,
        g_lr=args.glr, d_lr=args.dlr, geom_lr=args.geom_lr,
        r1_gamma=gamma,
        style_mixing_prob=args.style_mixing_prob,
        main_phase_losses=args.main_phase_losses,
        geom_phase_losses=args.geom_phase_losses,
        geom_warmstart_losses=args.geom_warmstart_losses,
        stitch_phase_losses=args.stitch_phase_losses,
        partial_loss_with_triband_input=bool(
            args.partial_loss_with_triband_input),
        geom_interval=args.geom_interval,
        stitch_interval=args.stitch_interval,
        geom_phase_mode=args.geom_phase_mode,
        geom_warmstart_mode=args.geom_warmstart_mode,
        geom_warmstart_kimg=args.geom_warmstart_kimg,
        geom_warmstart_start_kimg=args.geom_warmstart_start_kimg,
        augment=AugmentConfig.from_spec(args.augpipe)
        if args.aug == "ada" else None,
        ema_kimg=(args.ema_kimg if args.ema_kimg >= 0
                  else args.batch * 10.0 / 32.0),
        ema_rampup=(args.ema_rampup if args.ema_rampup > 0 else None),
        total_kimg=args.kimg)
    return cfg, enc_cfg, enc_params, enc_state


def build(argv=None):
    """Parse ``argv``, write the run directory's options and build the
    ``TrainingLoop`` with its data and eval hooks; returns ``(loop, args)``
    (None for ``--dry-run``).  :func:`main` runs it."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    from brushstroke_engine_torch.utils.util import resolve_device
    device = resolve_device(args.device)

    cfg, enc_cfg, enc_params, enc_state = setup_config(args)
    desc = (f"{args.color_format}-res{args.output_resolution}"
            f"-batch{args.batch}")
    run_dir = next_run_dir(args.outdir, desc)

    if args.dry_run:
        print("Resolved training options:")
        print(json.dumps({k: str(v) for k, v in vars(args).items()},
                         indent=2))
        print(f"Would create run dir: {run_dir}")
        return None

    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    from brushstroke_engine_torch.train.dataset import (
        BatchIterator, ImageFolderDataset, NoiseStyleDataset,
        SyntheticGeometryDataset,
    )
    from brushstroke_engine_torch.train.loop import TrainingLoop

    res = args.output_resolution
    if args.data:
        style_ds = ImageFolderDataset(args.data, res, xflip=bool(args.mirror))
    else:
        logger.warning("--data not given: using random noise style images "
                       "(smoke-test mode)")
        style_ds = NoiseStyleDataset(res)
    if args.geom_data:
        geom_ds = ImageFolderDataset(args.geom_data, res + 64, channels=3)
    else:
        geom_ds = SyntheticGeometryDataset(res + 64, size=10000)

    style_iter = BatchIterator(style_ds, cfg.batch_size, seed=args.seed)
    geom_iter = BatchIterator(geom_ds, cfg.batch_size, seed=args.seed + 1)

    resume_state = None
    if args.resume:
        from brushstroke_engine_torch.train.state import init_train_state
        from brushstroke_engine_torch.utils.checkpoint import load_native
        bundle = load_native(args.resume, device=device)
        # The resumed state is built before the loop, so that the clarity
        # finetune's frozen G_orig is the resumed generator.
        resume_state = init_train_state(cfg, args.seed,
                                        g_params=bundle.gen_params,
                                        g_state=bundle.gen_state,
                                        device=device)

    hooks = None
    metric_names = tuple(m for m in args.metrics.split(",") if m)
    if metric_names:
        from brushstroke_engine_torch.train.eval_hooks import make_eval_hooks
        fid_real = None
        if "fid" in metric_names and args.data:
            n = min(len(style_ds), 256)
            fid_real = [
                np.stack([style_ds[j] for j in range(i, min(i + 16, n))])
                for i in range(0, n, 16)]
        metric_geom_iter = BatchIterator(geom_ds, 4, seed=args.seed + 2)
        hooks = make_eval_hooks(
            image_snapshot_ticks=args.image_snap,
            metric_snapshot_ticks=args.snap,
            fid_real_batches=fid_real, geom_iterator=metric_geom_iter,
            metrics=metric_names)

    loop = TrainingLoop(cfg, enc_params, enc_state, style_iter, geom_iter,
                        run_dir=run_dir, seed=args.seed, hooks=hooks,
                        resume_state=resume_state, snapshot_ticks=args.snap,
                        device=device)
    return loop, args


def main(argv=None):
    """Run the CLI; returns the finished ``TrainingLoop`` (None for
    ``--dry-run``)."""
    built = build(argv)
    if built is None:
        return None
    loop, args = built
    loop.run(exit_after_warmstart=args.exit_after_warmstart)
    print(f"Training finished; run dir: {loop.run_dir}")
    return loop


if __name__ == "__main__":
    main()
