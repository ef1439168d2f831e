#!/bin/bash
# Train (or finetune) the brushstroke GAN with the PyTorch/CUDA port.
# Usage: ./neube_train_torch.sh <train|finetune> <style_data> <geom_data> <outdir> [extra flags...]
# The port's counterpart of neube_train.sh: the same flag bundles
# (train_flags.txt, plus finetune_flags.txt for a finetune), passed to
# brushstroke_engine_torch.tools.train.  Runs on the GPU; add --device cpu
# for a CPU run.
set -e
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

MODE="${1:?usage: neube_train_torch.sh <train|finetune> <style_data> <geom_data> <outdir> [flags]}"
STYLE_DATA="${2:?need style data path}"
GEOM_DATA="${3:?need geometry data path}"
OUTDIR="${4:?need output dir}"
shift 4

FLAGS=$(grep -v '^#' "$SCRIPT_DIR/train_flags.txt" | tr '\n' ' ')
if [ "$MODE" == "finetune" ]; then
  FLAGS="$FLAGS $(grep -v '^#' "$SCRIPT_DIR/finetune_flags.txt" | tr '\n' ' ')"
fi

mkdir -p "$OUTDIR"
LOG="$OUTDIR/train_$(date +%Y%m%d_%H%M%S).log"
PYTHONPATH="$SCRIPT_DIR${PYTHONPATH:+:$PYTHONPATH}" \
python -m brushstroke_engine_torch.tools.train \
  --data="$STYLE_DATA" --geom_data="$GEOM_DATA" --outdir="$OUTDIR" \
  $FLAGS "$@" 2>&1 | tee "$LOG"
