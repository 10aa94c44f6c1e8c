"""RULER evaluation runner, protocol match to the reference run_ruler.py
(port of ``kvcache_factory_tpu/evals/ruler.py``).

    python -m kvcache_factory_tpu_torch.evals.ruler --model_path DIR --save_dir OUT

Contract (run_ruler.py): 11 synthetic tasks (:16-17) at each context length
(:13-14), the raw ``example["input"]`` is the prompt (:93), 64 new tokens per
task (:19-31), same middle-truncation as LongBench (:132-138), predictions to
``{save_dir}/{model}_{capacity}/{context_length}/{task}/{method}.json`` with
``answers`` = ``example["outputs"]`` (:204-205); scored by string_match_all.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

TASKS = [
    "niah_single_1", "niah_single_2", "niah_single_3", "niah_multikey_1",
    "niah_multikey_2", "niah_multikey_3", "niah_multiquery", "niah_multivalue",
    "cwe", "fwe", "vt",
]
CONTEXT_LENGTHS = [4096]  # reference default; 8192/16384 available in data
TASK2MAXLEN = {t: 64 for t in TASKS}  # reference :19-31 (64 for every task)


def run_task(engine, tokenizer, task: str, data_file: str, out_path: str,
             model_max: int, max_num_examples: Optional[int] = None,
             progress: bool = True) -> int:
    from .longbench import middle_truncate

    examples = []
    with open(data_file) as f:
        for line in f:
            examples.append(json.loads(line))
    if max_num_examples:
        examples = examples[:max_num_examples]

    from .cli_common import writes_results
    if writes_results():
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    eos_ids = []
    if getattr(tokenizer, "eos_token_id", None) is not None:
        eos_ids = [tokenizer.eos_token_id]

    out_max_len = TASK2MAXLEN[task]
    n = 0
    # Every rank of a parallel layout generates; rank 0 writes.
    with open(out_path if writes_results() else os.devnull, "w") as fout:
        it = examples
        if progress:
            try:
                from tqdm import tqdm
                it = tqdm(examples, desc=task)
            except ImportError:
                pass
        for ex in it:
            ids = tokenizer.encode(ex["input"])
            ids = middle_truncate(ids, model_max, tokenizer)
            out_ids = engine.generate_ids(ids, out_max_len, eos_ids)
            pred = tokenizer.decode(out_ids, skip_special_tokens=True)
            record = {
                "input": ex["input"], "answers": ex["outputs"], "pred": pred,
                "length": ex.get("length"), "dataset": task,
                "index": ex.get("index"),
            }
            fout.write(json.dumps(record) + "\n")
            fout.flush()
            n += 1
    return n


def main(argv=None):
    from .cli_common import add_engine_args, build_engine_from_args
    from .longbench import model_max_len

    ap = argparse.ArgumentParser(description="RULER runner (PyTorch/CUDA port)")
    add_engine_args(ap)
    ap.add_argument("--save_dir", type=str, required=True)
    ap.add_argument("--data_dir", type=str, default="data/RULER")
    ap.add_argument("--tasks", type=str, nargs="*", default=TASKS)
    ap.add_argument("--context_lengths", type=int, nargs="*",
                    default=CONTEXT_LENGTHS)
    ap.add_argument("--max_num_examples", type=int, default=None)
    args = ap.parse_args(argv)

    engine, tokenizer, model_name = build_engine_from_args(args)
    model_max = model_max_len(args.model_path)

    for ctx_len in args.context_lengths:
        for i, task in enumerate(args.tasks):
            print(f"Working on context {ctx_len} task {task} - "
                  f"{i}/{len(args.tasks)}")
            out_path = os.path.join(
                args.save_dir, f"{model_name}_{args.max_capacity_prompts}",
                str(ctx_len), task, f"{args.method}.json")
            run_task(engine, tokenizer, task,
                     os.path.join(args.data_dir, str(ctx_len), f"{task}.jsonl"),
                     out_path, model_max, args.max_num_examples)


if __name__ == "__main__":
    main()
