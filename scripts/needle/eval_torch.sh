#!/usr/bin/env bash
# Needle-in-a-haystack sweep on the PyTorch/CUDA port (as scripts/needle/eval.sh):
# Llama-3 protocol: contexts 1000..8000 step 100, capacity 96.
set -euo pipefail
METHOD=${1:?method}
MODEL=${2:?model_path}
CAPACITY=${3:-96}
RESULTS_DIR=${4:-results_needle}
mkdir -p "$RESULTS_DIR/logs"
(
python -m kvcache_factory_tpu_torch.evals.needle \
  --method "$METHOD" --max_capacity_prompts "$CAPACITY" \
  --model_path "$MODEL" --results_dir "$RESULTS_DIR" \
  --s_len 1000 --e_len 8001 --step 100
) 2>&1 | tee "$RESULTS_DIR/logs/${METHOD}_${CAPACITY}.log"
