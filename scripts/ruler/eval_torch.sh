#!/usr/bin/env bash
# RULER run on the PyTorch/CUDA port (as scripts/ruler/eval.sh).
set -euo pipefail
METHOD=${1:?method}
CAPACITY=${2:?max_capacity_prompt}
MODEL=${3:?model_path}
SAVE_DIR=${4:-results/ruler}
DATA_DIR=${5:-data/RULER}
python -m kvcache_factory_tpu_torch.evals.ruler \
  --method "$METHOD" --max_capacity_prompts "$CAPACITY" \
  --model_path "$MODEL" --save_dir "$SAVE_DIR" --data_dir "$DATA_DIR"
