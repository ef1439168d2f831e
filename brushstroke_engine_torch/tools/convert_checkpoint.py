"""Convert reference checkpoints into the formats both packages read.

The port's counterpart of ``scripts/convert_checkpoint.py``, with its four
modes:

  * ``--kind snapshot``: a reference training snapshot pkl ({G, D, G_ema,
    args, encoder}; reference training_loop_modified.py:560-578) -> a
    native engine bundle (``utils/checkpoint.py:save_native``);
  * ``--kind encoder``: an encoder ``.pt`` -> an AE checkpoint
    (``train/train_autoencoder.py:save_ae_checkpoint``);
  * ``--kind library``: a brush library pkl with torch tensors -> a
    torch-free numpy pkl;
  * ``--kind tf``: a TF-legacy StyleGAN2 pickle ((G, D, Gs) tflib tuple;
    reference legacy.py:109) -> a generator file with the 'orig' head
    (``utils/checkpoint.py:save_tf_generator``; no encoder in those).

    python3 -m brushstroke_engine_torch.tools.convert_checkpoint \\
        --kind snapshot --src network-snapshot.pkl --dst bundle.pkl

No code of the source file runs (``utils/torch_extract.py``); the
conversion works on the CPU and needs no GPU.
"""

from __future__ import annotations

import argparse
import logging
import pickle

import numpy as np


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return int(np.prod(np.shape(tree)))


def convert_snapshot(src, dst, encoder_checkpoint=None):
    from brushstroke_engine_torch.utils import checkpoint as ckpt
    bundle = ckpt.convert_reference_snapshot(
        src, encoder_checkpoint=encoder_checkpoint, device="cpu")
    ckpt.save_native(dst, bundle)
    print(f"Converted snapshot {src} -> {dst} "
          f"(G_ema: {_n_params(bundle.gen_params):,} params, "
          f"color_format={bundle.color_format}, "
          f"inject={bundle.geom_inject_resolutions})")
    return bundle


def convert_encoder(src, dst):
    from brushstroke_engine_torch.train.train_autoencoder import \
        save_ae_checkpoint
    from brushstroke_engine_torch.utils import checkpoint as ckpt
    from brushstroke_engine_torch.utils import torch_extract as tx
    cfg, params, state = ckpt.encoder_trees_from_checkpoint(
        tx.load_torch_file(src))
    save_ae_checkpoint(dst, cfg, ckpt.params_from_jax(params),
                       ckpt.params_from_jax(state))
    print(f"Converted encoder {src} -> {dst} (kind={cfg.kind})")
    return cfg


def convert_library(src, dst):
    from brushstroke_engine_torch.engine.library import (
        WBrushLibrary, _to_numpy,
    )
    lib = WBrushLibrary.from_file(src)
    out = {}
    for k, v in lib.styles.items():
        if isinstance(v, dict):
            out[k] = {kk: {k2: _to_numpy(v2) for k2, v2 in vv.items()}
                      if isinstance(vv, dict) else _to_numpy(vv)
                      for kk, vv in v.items()}
        else:
            out[k] = _to_numpy(v)
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    print(f"Converted library {src} -> {dst} ({len(out)} styles)")
    return out


def convert_tf(src, dst):
    from brushstroke_engine_torch.utils import checkpoint as ckpt
    cfg, params, state = ckpt.tf_generator_trees(src)
    ckpt.save_tf_generator(dst, cfg, params, state)
    print(f"Converted TF generator {src} -> {dst} "
          f"({_n_params(params):,} params, "
          f"{cfg.img_resolution}px {cfg.synthesis.architecture})")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True,
                    choices=["snapshot", "encoder", "library", "tf"])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--encoder_checkpoint", default=None,
                    help="For snapshots without an embedded encoder.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.kind == "snapshot":
        return convert_snapshot(args.src, args.dst, args.encoder_checkpoint)
    if args.kind == "encoder":
        return convert_encoder(args.src, args.dst)
    if args.kind == "tf":
        return convert_tf(args.src, args.dst)
    return convert_library(args.src, args.dst)


if __name__ == "__main__":
    main()
