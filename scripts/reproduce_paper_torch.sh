#!/usr/bin/env bash
# Weights-day runbook on the PyTorch/CUDA port (kvcache_factory_tpu_torch,
# one H100): scripts/reproduce_paper.sh's commands, which reproduce the
# reference's headline tables (BASELINE.json configs 2-4) — LongBench at
# budgets 128/2048, the Mistral needle sweep, and the quantized-cache RULER
# run — and score them into results.csv files.
#
# Reference protocol being matched:
#   run_longbench.py:266-315 (greedy, per-dataset max_new, jsonl layout)
#   scripts/scripts_longBench/eval.sh + eval_methods.sh (budget sweep)
#   run_needle_in_haystack.py:120-130 (1000->8001 step 100 / 400->32001)
#   run_ruler.py + eval_ruler.py (string_match_all)
#
# Usage:
#   LLAMA3=/path/to/Meta-Llama-3-8B-Instruct \
#   MISTRAL=/path/to/Mistral-7B-Instruct-v0.2 \
#   bash scripts/reproduce_paper_torch.sh [results_dir]
#
# Data: run `python tools/fetch_data.py --all` first (downloads LongBench/
# RULER/PG-essays from public sources; generates the HeadKV score fixture).
set -euo pipefail
cd "$(dirname "$0")/.."

RESULTS=${1:-results/paper}
LLAMA3=${LLAMA3:?set LLAMA3=/path/to/Meta-Llama-3-8B-Instruct}
MISTRAL=${MISTRAL:-}
METHODS=${METHODS:-"fullkv random snapkv streamingllm h2o pyramidkv cam l2norm think adakv headkv"}
BUDGETS=${BUDGETS:-"128 2048"}

echo "== Config 2: Llama-3-8B LongBench @ budgets ${BUDGETS} =="
for budget in $BUDGETS; do
  for method in $METHODS; do
    python -m kvcache_factory_tpu_torch.evals.longbench \
      --model_path "$LLAMA3" --method "$method" \
      --max_capacity_prompts "$budget" \
      --save_dir "$RESULTS/longbench"
  done
  python -m kvcache_factory_tpu_torch.evals.score \
    --results_dir "$RESULTS/longbench/$(basename "$LLAMA3" | tr 'A-Z' 'a-z')_${budget}" \
    --suite longbench
done

echo "== Config 4: quantized-cache RULER (int4/int8) =="
for nbits in 8 4; do
  python -m kvcache_factory_tpu_torch.evals.ruler \
    --model_path "$LLAMA3" --method snapkv --max_capacity_prompts 2048 \
    --quant_method kvquant --nbits "$nbits" \
    --save_dir "$RESULTS/ruler_int${nbits}"
  python -m kvcache_factory_tpu_torch.evals.score \
    --results_dir "$RESULTS/ruler_int${nbits}" --suite ruler
done

if [ -n "$MISTRAL" ]; then
  echo "== Config 3: Mistral needle-in-a-haystack sweep =="
  python -m kvcache_factory_tpu_torch.evals.needle \
    --model_path "$MISTRAL" --method snapkv --max_capacity_prompts 96 \
    --s_len 400 --e_len 32001 --step 400 \
    --results_dir "$RESULTS/needle_mistral"
  python -m kvcache_factory_tpu_torch.evals.needle_viz \
    --results_folder "$RESULTS/needle_mistral" \
    --save_path "$RESULTS/needle_mistral/heatmap.png"
fi

echo "Done. Compare the results.csv tables against the PyramidKV paper"
echo "(arXiv:2406.02069) tables at matching budget; target is within the"
echo "paper's stated run-to-run delta (BASELINE.md)."

# Note on serving-only flags: chunked admission / prefix caching
# (prefill_chunk_tokens, prefix_cache_bytes) belong to the continuous-
# batching SERVING engine (examples/serving_torch.py --prefill_chunk ...), not
# the eval protocol — evals prefill each batch one-shot by design, exactly
# as the reference does, so scores are knob-free comparable.
