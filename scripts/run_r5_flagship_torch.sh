#!/bin/bash
# The round-5 flagship workflow through the PyTorch/CUDA port's CLIs (the
# port's counterpart of run_r5_flagship.sh, with its seeds and sizes): style
# media -> style zip; splines -> triband -> geometry zip; the stroke
# autoencoder; then a continuous train_flags.txt run with that encoder.
# Outputs go to _data/torch/ and runs/r5_torch.  The trainer runs the
# production path of the JAX run: --fused --device_dataset
# --steps_per_dispatch 16 (the zips as uint8 banks on the card, 16 fused
# batches per step call).
set -ex
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
D=_data/torch

mkdir -p "$D"

if [ ! -f "$D/style.zip" ]; then
  python -m brushstroke_engine_torch.tools.make_synthetic_media \
      --output_dir "$D/media" --num_images 4000 --resolution 128 --seed 0
  python -m brushstroke_engine_torch.tools.dataset_tool --source "$D/media" \
      --dest "$D/style.zip" --resolution 128
fi

if [ ! -f "$D/geom.zip" ]; then
  python -m brushstroke_engine_torch.tools.create_splines \
      --output_dir "$D/splines" --num_images 1000 --width 192 --seed 0
  python -m brushstroke_engine_torch.tools.prep_geom_data \
      --input_dir "$D/splines" --output_dir "$D/triband"
  python -m brushstroke_engine_torch.tools.dataset_tool \
      --source "$D/triband" --dest "$D/geom.zip" --resolution 192
fi

if [ ! -f "$D/ae/ae_latest.pkl" ]; then
  python -m brushstroke_engine_torch.tools.train_autoencoder \
      --data "$D/geom.zip" --run_dir "$D/ae" --num_steps 10000 --widths 128 \
      --seed 0
fi

exec python -m brushstroke_engine_torch.tools.train \
  --data "$D/style.zip" --geom_data "$D/geom.zip" \
  --encoder_checkpt "$D/ae/ae_latest.pkl" \
  --outdir runs/r5_torch \
  --output_resolution 128 --zdim 64 --wdim 64 --channel_max 128 \
  --color_format triad --batch 64 --d_arch orig --synthesis_arch orig \
  --glr 0.0002 --dlr 0.0002 \
  --geom_inject_resolutions 0,1 \
  --geom_warmstart_kimg 50 --geom_warmstart_mode last_and_rgb \
  --geom_warmstart_losses '1.0*iou_inv(uvs)+1.0*iou(u)' \
  --geom_phase_losses '1.0*iou_inv(uvs)' --geom_phase_mode last_and_rgb \
  --geom_interval 200 \
  --kimg 3000 --snap 50 --image_snap 25 \
  --fused --device_dataset --steps_per_dispatch 16 \
  --seed 0 --metrics fid,forger
