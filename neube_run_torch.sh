#!/bin/bash
# Serve the interactive drawing UI with the PyTorch/CUDA port.
# Usage: ./neube_run_torch.sh <gan_checkpoint> [port] [libraries-spec] [extra args...]
# The port's counterpart of neube_run.sh.  Extra args go to the server
# (e.g. --device_canvas for the feature canvas on the card,
# --batch_window_ms 4 to batch strokes across sessions, --device cpu).
set -e
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
CKPT="${1:-}"
PORT="${2:-8000}"
LIBS="${3:-Default:random:default}"
shift $(( $# > 3 ? 3 : $# ))
ARGS=(--port="$PORT" --libraries="$LIBS")
if [ -n "$CKPT" ]; then ARGS+=(--gan_checkpoint="$CKPT"); fi
PYTHONPATH="$SCRIPT_DIR${PYTHONPATH:+:$PYTHONPATH}" \
python -m brushstroke_engine_torch.ui.server "${ARGS[@]}" "$@"
