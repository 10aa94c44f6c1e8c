#!/usr/bin/env bash
# LongBench single run on the PyTorch/CUDA port (scripts/longbench/eval.sh's
# command with kvcache_factory_tpu_torch).
# Usage: scripts/longbench/eval_torch.sh <method> <max_capacity> <model_path> [save_dir] [data_dir]
set -euo pipefail
METHOD=${1:?method (fullkv|snapkv|pyramidkv|h2o|streamingllm|l2norm|cam|adakv|headkv|think|random)}
CAPACITY=${2:?max_capacity_prompt}
MODEL=${3:?model_path (HF checkpoint dir)}
SAVE_DIR=${4:-results/longbench}
DATA_DIR=${5:-data/LongBench}

python -m kvcache_factory_tpu_torch.evals.longbench \
  --method "$METHOD" \
  --max_capacity_prompts "$CAPACITY" \
  --model_path "$MODEL" \
  --save_dir "$SAVE_DIR" \
  --data_dir "$DATA_DIR"
