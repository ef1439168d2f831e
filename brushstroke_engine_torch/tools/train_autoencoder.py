"""Train the geometry stroke autoencoder.

The port's counterpart of ``scripts/train_stroke_autoencoder.py``, with its
flags and defaults (the 'sauto' flag family) plus ``--device``:

    python3 -m brushstroke_engine_torch.tools.train_autoencoder \\
        --run_dir runs/ae [--data triband.zip] [--num_steps 10000]

Without ``--data`` the geometry is synthetic splines.  The checkpoint
``<run_dir>/ae_latest.pkl`` is what ``tools/train.py --encoder_checkpt``
and the JAX package's ``load_ae_checkpoint`` read.  Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging


def intlist(v):
    return tuple(int(x) for x in v.split(",") if x)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None,
                    help="Triband geometry dataset; synthetic if omitted.")
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--model_name", default="sauto",
                    choices=["sauto", "conv"])
    ap.add_argument("--encoder_in_channels", type=int, default=1)
    ap.add_argument("--decoder_out_channels", type=int, default=1)
    ap.add_argument("--preproc_type", default="-11inverse")
    ap.add_argument("--encoder_pre_filters", type=int, default=64)
    ap.add_argument("--encoder_down_filters", default="128,256,256")
    ap.add_argument("--encoder_post_filters", default="32,16")
    ap.add_argument("--decoder_up_filters", default="256,128,64")
    ap.add_argument("--neg_slope", type=float, default=None)
    ap.add_argument("--widths", default="128")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--num_steps", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda",
                    help="Where to train: 'cuda' (needs a GPU) or 'cpu'.")
    return ap


def main(argv=None):
    """Run the CLI; returns ``train_autoencoder``'s (params, state,
    losses)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.train.dataset import (
        BatchIterator, ImageFolderDataset, SyntheticGeometryDataset,
    )
    from brushstroke_engine_torch.train.train_autoencoder import (
        AETrainConfig, train_autoencoder,
    )

    enc_cfg = GeoEncoderConfig(
        kind=args.model_name,
        in_channels=args.encoder_in_channels,
        out_channels=args.decoder_out_channels,
        preproc=args.preproc_type,
        pre_filters=args.encoder_pre_filters,
        down_filters=intlist(args.encoder_down_filters),
        post_filters=intlist(args.encoder_post_filters),
        up_filters=intlist(args.decoder_up_filters),
        neg_slope=args.neg_slope)
    cfg = AETrainConfig(enc_cfg=enc_cfg, batch_size=args.batch_size,
                        learning_rate=args.lr, num_steps=args.num_steps,
                        widths=intlist(args.widths))

    max_w = max(cfg.widths)
    if args.data:
        ds = ImageFolderDataset(args.data, max_w + 32, channels=3)
    else:
        ds = SyntheticGeometryDataset(max_w + 32)
    it = BatchIterator(ds, cfg.batch_size, seed=args.seed)
    out = train_autoencoder(cfg, it, args.run_dir, seed=args.seed,
                            resume=args.resume, device=args.device)
    print(f"AE training done; checkpoints in {args.run_dir}")
    return out


if __name__ == "__main__":
    main()
