#!/bin/bash
# Round-5 stage 2 through the PyTorch/CUDA port (the port's counterpart of
# run_r5_finetune.sh, with its flags): the clarity finetune of the flagship
# snapshot, on the data that run_r5_flagship_torch.sh writes to _data/torch/.
#
# Two variants:
#   faithful - exactly finetune_flags.txt (the clarity anchors only).
#   color    - finetune_flags.txt + 1.0*iou(u), the color-control variant.
#
# Usage: run_r5_finetune_torch.sh SNAPSHOT {faithful|color} [KIMG]
set -ex
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
D=_data/torch

SNAP="$1"
VARIANT="${2:-color}"
KIMG="${3:-200}"

LOSSES='0.5*iou_inv(uvs)+0.5*lpips(fake_orig)+0.5*l1(fake_orig)'
if [ "$VARIANT" == "color" ]; then
  LOSSES="${LOSSES}+1.0*iou(u)"
fi

exec python -m brushstroke_engine_torch.tools.train \
  --data "$D/style.zip" --geom_data "$D/geom.zip" \
  --encoder_checkpt "$D/ae/ae_latest.pkl" \
  --outdir "runs/r5_torch_finetune_${VARIANT}" \
  --resume "$SNAP" \
  --output_resolution 128 --zdim 64 --wdim 64 --channel_max 128 \
  --color_format triad --batch 64 --d_arch orig --synthesis_arch orig \
  --glr 0.0002 --dlr 0.0002 \
  --geom_inject_resolutions 0,1 \
  --geom_warmstart_losses "$LOSSES" \
  --geom_warmstart_mode last_and_rgb \
  --geom_warmstart_kimg "$KIMG" --exit_after_warmstart \
  --kimg "$KIMG" --snap 10 --image_snap 10 \
  --fused --device_dataset --steps_per_dispatch 16 \
  --seed 0 --metrics fid,forger
