"""LongBench evaluation runner, protocol match to the reference CLI (port
of ``kvcache_factory_tpu/evals/longbench.py``; pure Python over the port's
``InferenceEngine``).

    python -m kvcache_factory_tpu_torch.evals.longbench --model_path DIR \
        --save_dir OUT [--method snapkv --max_capacity_prompts 2048] [--wq8] [--device cuda]

Behavioral contract (reference run_longbench.py):
 * 16 English datasets (:12-14), per-dataset max_new_tokens (:16-38) and
   prompt templates (:40-62) — these tables are LongBench protocol data;
 * model-family context ceilings llama2 3950 / llama3 7950 / mistral 31500
   (:75-81) with middle truncation of over-long prompts (:199-205);
 * method hyperparameters: window 8 for score methods, capacity-4 for
   streamingllm, kernel 7, maxpool (:219-237);
 * HeadKV per-head budgets derived from a head-score json (:225-234);
 * greedy decode, one JSON line per example (:266-315), output path
   ``{save_dir}/{model}_{capacity}/{dataset}/{method}.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import List, Optional

import numpy as np

DATASETS = [
    "narrativeqa", "qasper", "multifieldqa_en", "hotpotqa", "2wikimqa",
    "musique", "gov_report", "qmsum", "multi_news", "trec", "triviaqa",
    "samsum", "passage_count", "passage_retrieval_en", "lcc", "repobench-p",
]

DATASET2MAXLEN = {
    "narrativeqa": 128, "qasper": 128, "multifieldqa_en": 64,
    "multifieldqa_zh": 64, "hotpotqa": 32, "2wikimqa": 32, "musique": 32,
    "dureader": 128, "gov_report": 512, "qmsum": 512, "multi_news": 512,
    "vcsum": 512, "trec": 64, "triviaqa": 32, "samsum": 128, "lsht": 64,
    "passage_count": 32, "passage_retrieval_en": 32,
    "passage_retrieval_zh": 32, "lcc": 64, "repobench-p": 64,
}

# LongBench per-dataset prompt templates (protocol data; reference :40-62).
PROMPT_TEMPLATES = {
    "narrativeqa": "You are given a story, which can be either a novel or a movie script, and a question. Answer the question asconcisely as you can, using a single phrase if possible. Do not provide any explanation.\n\nStory: {context}\n\nNow, answer the question based on the story asconcisely as you can, using a single phrase if possible. Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:",
    "qasper": 'You are given a scientific article and a question. Answer the question as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write "unanswerable". If the question is a yes/no question, answer "yes", "no", or "unanswerable". Do not provide any explanation.\n\nArticle: {context}\n\n Answer the question based on the above article as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write "unanswerable". If the question is a yes/no question, answer "yes", "no", or "unanswerable". Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:',
    "multifieldqa_en": "Read the following text and answer briefly.\n\n{context}\n\nNow, answer the following question based on the above text, only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "hotpotqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "2wikimqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "musique": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "gov_report": "You are given a report by a government agency. Write a one-page summary of the report.\n\nReport:\n{context}\n\nNow, write a one-page summary of the report.\n\nSummary:",
    "qmsum": "You are given a meeting transcript and a query containing a question or instruction. Answer the query in one or more sentences.\n\nTranscript:\n{context}\n\nNow, answer the query based on the above meeting transcript in one or more sentences.\n\nQuery: {input}\nAnswer:",
    "multi_news": "You are given several news passages. Write a one-page summary of all news. \n\nNews:\n{context}\n\nNow, write a one-page summary of all the news.\n\nSummary:",
    "trec": "Please determine the type of the question below. Here are some examples of questions.\n\n{context}\n{input}",
    "triviaqa": "Answer the question based on the given passage. Only give me the answer and do not output any other words. The following are some examples.\n\n{context}\n\n{input}",
    "samsum": "Summarize the dialogue into a few short sentences. The following are some examples.\n\n{context}\n\n{input}",
    "passage_count": "There are some paragraphs below sourced from Wikipedia. Some of them may be duplicates. Please carefully read these paragraphs and determine how many unique paragraphs there are after removing duplicates. In other words, how many non-repeating paragraphs are there in total?\n\n{context}\n\nPlease enter the final count of unique paragraphs after removing duplicates. The output format should only contain the number, such as 1, 2, 3, and so on.\n\nThe final answer is: ",
    "passage_retrieval_en": 'Here are 30 paragraphs from Wikipedia, along with an abstract. Please determine which paragraph the abstract is from.\n\n{context}\n\nThe following is an abstract.\n\n{input}\n\nPlease enter the number of the paragraph that the abstract is from. The answer format must be like "Paragraph 1", "Paragraph 2", etc.\n\nThe answer is: ',
    "lcc": "Please complete the code given below. \n{context}Next line of code:\n",
    "repobench-p": "Please complete the code given below. \n{context}{input}Next line of code:\n",
}

MODEL2MAXLEN = {"llama2": 3950, "llama-2": 3950, "llama3": 7950,
                "llama-3": 7950, "mistral": 31500}


def model_max_len(model_name: str, default: int = 7950) -> int:
    low = model_name.lower()
    for key, v in MODEL2MAXLEN.items():
        if key in low:
            return v
    return default


def build_chat(prompt: str) -> str:
    """llama2 chat wrapper (reference :94-96)."""
    return f"[INST] {prompt} [/INST]"


def middle_truncate(ids: List[int], max_len: int, tokenizer) -> List[int]:
    """Keep first+last halves of an over-long prompt (reference :199-205,
    decode->re-encode round trip included for tokenizer-boundary parity)."""
    if len(ids) <= max_len:
        return ids
    half = int(max_len / 2)
    text = (tokenizer.decode(ids[:half], skip_special_tokens=True)
            + tokenizer.decode(ids[-half:], skip_special_tokens=True))
    return tokenizer.encode(text)


def headkv_capacities(head_path: str, num_layers: int, num_heads: int,
                      max_capacity: int, head_beta: float = 1.01) -> np.ndarray:
    """Per-(layer, head) budgets ``[L, H]`` int32 from a retrieval-reasoning
    head-score file (the first line: a JSON object of per-head score lists,
    layer-major): normalized mean scores times the pooled capacity, plus a
    floor (reference run_longbench.py:225-234)."""
    with open(head_path) as f:
        head_list = json.loads(f.readline())
    scores = np.array([np.mean(v) for v in head_list.values()], np.float64)
    scores = scores / scores.sum()
    total_attention = scores.reshape(num_layers, num_heads)
    total_pool = (max_capacity // head_beta) * num_layers * num_heads
    min_num = max_capacity - max_capacity // head_beta
    return np.round(total_attention * total_pool + min_num).astype(np.int32)


def method_hyperparams(method: str, max_capacity: int) -> dict:
    """Window/kernel/pooling policy table (reference :219-237)."""
    method = method.lower()
    if method in ("fullkv", "minference"):
        return {}
    if method == "streamingllm":
        window = max_capacity - 4
    else:
        window = 8
    return {"window_size": window, "kernel_size": 7, "pooling": "maxpool"}


def run_dataset(engine, tokenizer, dataset: str, data_file: str, out_path: str,
                model_max: int, max_num_examples: Optional[int] = None,
                sample_method: str = "topk", is_llama2_chat: bool = False,
                seed: int = 42, progress: bool = True) -> int:
    """Evaluate one dataset; returns number of examples written."""
    random.seed(seed)
    np.random.seed(seed)

    template = PROMPT_TEMPLATES[dataset]
    out_max_len = DATASET2MAXLEN[dataset]

    examples = []
    with open(data_file) as f:
        for line in f:
            ex = json.loads(line)
            prompt = template.format(**ex)
            if is_llama2_chat:
                prompt = build_chat(prompt)
            ex["prompt"] = prompt
            examples.append(ex)

    if max_num_examples and len(examples) > max_num_examples:
        if sample_method == "random":
            examples = random.sample(examples, max_num_examples)
        else:
            examples = examples[:max_num_examples]

    from .cli_common import writes_results
    if writes_results():
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    eos_ids = []
    if getattr(tokenizer, "eos_token_id", None) is not None:
        eos_ids = [tokenizer.eos_token_id]

    n = 0
    # Every rank of a parallel layout generates; rank 0 writes.
    with open(out_path if writes_results() else os.devnull, "w") as fout:
        it = examples
        if progress:
            try:
                from tqdm import tqdm
                it = tqdm(examples, desc=dataset)
            except ImportError:
                pass
        for ex in it:
            ids = tokenizer.encode(ex["prompt"])
            ids = middle_truncate(ids, model_max, tokenizer)
            out_ids = engine.generate_ids(ids, out_max_len, eos_ids)
            pred = tokenizer.decode(out_ids, skip_special_tokens=True)
            record = {
                "prompt": ex["prompt"], "input": ex.get("input"),
                "context": ex.get("context"), "answers": ex.get("answers"),
                "pred": pred, "length": ex.get("length"),
                "dataset": dataset, "language": ex.get("language"),
                "all_classes": ex.get("all_classes"), "_id": ex.get("_id"),
            }
            fout.write(json.dumps(record) + "\n")
            fout.flush()
            n += 1
    return n


def main(argv=None):
    from .cli_common import build_engine_from_args, add_engine_args

    ap = argparse.ArgumentParser(description="LongBench runner (PyTorch/CUDA port)")
    add_engine_args(ap)
    ap.add_argument("--save_dir", type=str, required=True)
    ap.add_argument("--data_dir", type=str, default="data/LongBench")
    ap.add_argument("--datasets", type=str, nargs="*", default=DATASETS)
    ap.add_argument("--max_num_examples", type=int, default=None)
    ap.add_argument("--sample_method", type=str, default="topk",
                    choices=["random", "topk"])
    args = ap.parse_args(argv)

    engine, tokenizer, model_name = build_engine_from_args(args)
    model_max = model_max_len(args.model_path)

    for i, dataset in enumerate(args.datasets):
        print(f"Working on max_capacity_prompts {args.max_capacity_prompts} "
              f"dataset {dataset} - {i}/{len(args.datasets)}")
        out_path = os.path.join(
            args.save_dir, f"{model_name}_{args.max_capacity_prompts}",
            dataset, f"{args.method}.json")
        run_dataset(engine, tokenizer, dataset,
                    os.path.join(args.data_dir, f"{dataset}.jsonl"), out_path,
                    model_max, args.max_num_examples, args.sample_method,
                    is_llama2_chat="llama2" in args.model_path.lower(),
                    seed=args.seed)


if __name__ == "__main__":
    main()
