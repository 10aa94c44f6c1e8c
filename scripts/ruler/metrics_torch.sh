#!/usr/bin/env bash
# Score a RULER results tree with the PyTorch/CUDA port's scorer.
set -euo pipefail
RESULTS_DIR=${1:?results_dir}
python -m kvcache_factory_tpu_torch.evals.score --results_dir "$RESULTS_DIR" --suite ruler
