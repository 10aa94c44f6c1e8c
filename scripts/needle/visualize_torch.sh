#!/usr/bin/env bash
# Needle heatmap from a results folder (the PyTorch/CUDA port's plotter).
set -euo pipefail
RESULTS_FOLDER=${1:?folder with *_results.json}
SAVE_PATH=${2:-results_needle/img/heatmap.png}
MODEL_NAME=${3:-model}
python -m kvcache_factory_tpu_torch.evals.needle_viz \
  --results_folder "$RESULTS_FOLDER" --save_path "$SAVE_PATH" \
  --model_name "$MODEL_NAME"
