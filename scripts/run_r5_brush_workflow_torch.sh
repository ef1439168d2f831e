#!/bin/bash
# Round-5 stage 3 through the PyTorch/CUDA port (the port's counterpart of
# run_r5_brush_workflow.sh, with its steps and seeds): project novel media
# into the trained style space, clarity-optimize the projected library,
# CLIP-index it and run a text query, then serve every library together and
# paint with each over the websocket (tools/drive_brush_server.py, which
# needs tornado: where the card's machine lacks it, run this stage with
# DEVICE=cpu on a machine that has it).
#
# Usage: run_r5_brush_workflow_torch.sh SNAPSHOT OUT_DIR [N_MEDIA]
set -ex
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

SNAP="$1"
OUT="${2:-runs/r5_torch_brush_workflow}"
N="${3:-8}"
DEVICE="${DEVICE:-cuda}"
MEDIA="$OUT/media"

mkdir -p "$OUT"

# 1) N media patches from a fresh seed: novel media, not the training set.
python -m brushstroke_engine_torch.tools.make_synthetic_media \
    --output_dir "$MEDIA" --num_images "$N" --resolution 128 --seed 777

TARGETS=$(ls "$MEDIA"/*.png | head -n "$N")

python -m brushstroke_engine_torch.tools.project_main \
    --gan_checkpoint "$SNAP" \
    --target_image $TARGETS \
    --output_dir "$OUT/proj" \
    --num_steps 200 --num_patches 2 \
    --library_name ALL_projected_media.pkl --seed 0 --device "$DEVICE"

python -m brushstroke_engine_torch.tools.opt_clarity_main \
    --gan_checkpoint "$SNAP" \
    --library "$OUT/proj/ALL_projected_media.pkl" \
    --output_dir "$OUT/opt" --num_steps 120 --seed 0 --device "$DEVICE"

python -m brushstroke_engine_torch.tools.clip_search_main \
    --gan_checkpoint "$SNAP" \
    --library "$OUT/proj/ALL_projected_media.pkl" \
    --query "a dark ink brush stroke" --top_k 3 \
    --output_dir "$OUT/clip" --device "$DEVICE"

OPT_PKL=$(ls "$OUT"/opt/OPT_*.pkl | head -1)
# A seed library: one integer seed per line.
printf '3\n7\n11\n21\n42\n' > "$OUT/seeds.txt"
LIBS="Seeds:disp:$OUT/seeds.txt"
LIBS="$LIBS,Projected_Media:disp:$OUT/proj/ALL_projected_media.pkl"
LIBS="$LIBS,Opt_Clarity:disp:$OPT_PKL"

python -m brushstroke_engine_torch.tools.drive_brush_server \
    --gan_checkpoint "$SNAP" --libraries "$LIBS" \
    --out_dir "$OUT/served" --port 8741 --device "$DEVICE"

echo "brush workflow complete: $OUT"
