#!/bin/bash
# Stylize a line drawing with the PyTorch/CUDA port (the port's counterpart
# of neube_stylize.sh, with its defaults: feature_blending_level=2,
# color_mode=1, crop_margin=10, --on_white).
# Usage: ./neube_stylize_torch.sh <gan_checkpoint> <geo_image> <outdir> [flags]
set -e
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
CKPT="${1:?usage: neube_stylize_torch.sh <gan_checkpoint> <geo_image> <outdir> [flags]}"
GEO="${2:?need geometry image}"
OUT="${3:?need output dir}"
shift 3
PYTHONPATH="$SCRIPT_DIR${PYTHONPATH:+:$PYTHONPATH}" \
python -m brushstroke_engine_torch.tools.paint_image \
  --gan_checkpoint="$CKPT" --geo_image="$GEO" --output_dir="$OUT" \
  --feature_blending_level=2 --color_mode=1 --crop_margin=10 --on_white "$@"
