#!/usr/bin/env bash
# Score a results tree with the PyTorch/CUDA port's scorer (as metrics.sh).
set -euo pipefail
RESULTS_DIR=${1:?results_dir (e.g. results/longbench/<model>_<capacity>)}
python -m kvcache_factory_tpu_torch.evals.score --results_dir "$RESULTS_DIR" --suite longbench
