"""Dump W vectors for style seed lists (binary float64, for PCA / analysis).

The port's counterpart of ``scripts/get_ws_main.py``, with its flags plus
``--device``:

    python3 -m brushstroke_engine_torch.tools.get_ws_main \\
        --gan_checkpoint B.pkl --seeds 0-999 --output_file ws.bin

Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging


def parse_seeds(spec: str):
    """'a-b' (inclusive) or a comma-separated list -> list of ints."""
    if "-" in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(x) for x in spec.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--seeds", default="0-999",
                    help="Seed range 'a-b' or CSV list.")
    ap.add_argument("--output_file", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.tools.latent import dump_ws

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    ws = dump_ws(engine, parse_seeds(args.seeds), args.output_file)
    print(f"Wrote {ws.shape[0]} W vectors (dim {ws.shape[1]}) to "
          f"{args.output_file}")
    return ws


if __name__ == "__main__":
    main()
