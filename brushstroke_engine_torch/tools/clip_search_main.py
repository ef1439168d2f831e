"""Text-driven brush search and optimization.

The port's counterpart of ``scripts/clip_search_main.py``, with its flags
plus ``--device``: builds a style-thumbnail feature dictionary from a
library (or reuses ``--dictionary``), answers a text query with the top-k
styles and, with ``--optimize``, optimizes the best match's W+ toward the
text embedding and writes it as a brush library ``CLIP_<query>.pkl``.

    python3 -m brushstroke_engine_torch.tools.clip_search_main \\
        --gan_checkpoint B.pkl --library lib.pkl --query "a dark ink stroke" \\
        --output_dir OUT [--clip_weights clip.pt --clip_bpe bpe.txt.gz]

Without ``--clip_weights`` the backbone is the labelled, NOT semantic,
hashing fallback; the first line printed names the backbone's kind.  Runs on
CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--library", default="rand50")
    ap.add_argument("--query", required=True)
    ap.add_argument("--top_k", type=int, default=5)
    ap.add_argument("--optimize", action="store_true")
    ap.add_argument("--num_steps", type=int, default=300)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--dictionary", default=None,
                    help="Existing feature-dictionary pkl to reuse.")
    ap.add_argument("--clip_weights", default=None,
                    help="OpenAI CLIP checkpoint (a state-dict pickle or "
                         "the published TorchScript .pt) for the real "
                         "backbone (semantic search); omit for the labeled "
                         "non-semantic hashing fallback.")
    ap.add_argument("--clip_bpe", default=None,
                    help="CLIP BPE merges file "
                         "(bpe_simple_vocab_16e6.txt[.gz]).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from brushstroke_engine_torch.data.curves import random_spline_stroke
    from brushstroke_engine_torch.engine.brush import (
        GanBrushOptions, PaintEngineFactory,
    )
    from brushstroke_engine_torch.engine.library import BrushLibrary
    from brushstroke_engine_torch.models.mapping import mapping_apply
    from brushstroke_engine_torch.tools.clip_search import (
        CLIPBackbone, ClipOptConfig, ClipStyleOptimizer, FeatureDictionary,
        HashingBackbone,
    )

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    lib = BrushLibrary.from_arg(args.library, z_dim=engine.gen_cfg.z_dim)
    if args.clip_weights:
        backbone = CLIPBackbone(args.clip_weights, args.clip_bpe,
                                device=engine.device)
    else:
        backbone = HashingBackbone(0, device=engine.device)
    print(f"Backbone kind: {backbone.kind}" + (
        "" if backbone.kind == "clip" else
        " (NOT semantic -- pass --clip_weights for real search)"))

    os.makedirs(args.output_dir, exist_ok=True)
    dict_path = args.dictionary or os.path.join(args.output_dir,
                                                "style_dict.pkl")
    if os.path.isfile(dict_path):
        d = FeatureDictionary.load(dict_path, backbone)
    else:
        d = FeatureDictionary(backbone)
        d.build_from_library(lib, engine.uvs_mapper)
        d.save(dict_path)

    results = d.get_top_results(args.query, k=args.top_k)
    print("Top styles for query %r (backbone=%s):"
          % (args.query, backbone.kind))
    for style_id, score in results:
        print(f"  {style_id}: {score:.4f}")
    out = {"backbone": backbone.kind, "results": results}

    if args.optimize:
        best_id = results[0][0]
        opts = GanBrushOptions()
        lib.set_style(best_id, opts)
        if opts.style_ws is not None:
            w0 = opts.style_ws
        else:
            with torch.no_grad():
                w0 = mapping_apply(
                    engine.gen_cfg.mapping, engine.gen_params["mapping"],
                    torch.as_tensor(np.asarray(opts.style_z, np.float32),
                                    device=engine.device),
                    None, w_avg=engine.gen_state.get("w_avg")).cpu().numpy()

        def geom_batches():
            rng = np.random.default_rng(0)
            w = engine.patch_width
            while True:
                yield np.stack([random_spline_stroke(rng, w)[..., None]
                                for _ in range(4)])

        opt = ClipStyleOptimizer(engine, backbone,
                                 ClipOptConfig(num_steps=args.num_steps))
        res = opt.optimize(args.query, w0, geom_batches())
        key = args.query.replace(" ", "_")
        out_path = os.path.join(args.output_dir, "CLIP_" + key + ".pkl")
        with open(out_path, "wb") as f:
            pickle.dump({key: {"w": res["w"]}}, f)
        print(f"Optimized style written to {out_path}")
        out.update(optimized=res, path=out_path)
    return out


if __name__ == "__main__":
    main()
