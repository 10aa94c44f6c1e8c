#!/usr/bin/env bash
# Budget sweep over methods on the PyTorch/CUDA port (as eval_methods.sh):
# capacities 64..4096 x the method zoo.
set -euo pipefail
MODEL=${1:?model_path}
SAVE_DIR=${2:-results/longbench}
for capacity in 64 128 256 512 1024 2048 4096; do
  for method in fullkv snapkv pyramidkv h2o streamingllm l2norm cam think; do
    scripts/longbench/eval_torch.sh "$method" "$capacity" "$MODEL" "$SAVE_DIR"
  done
done
