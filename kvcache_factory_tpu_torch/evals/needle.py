"""Needle-in-a-Haystack harness, protocol match to run_needle_in_haystack.py
(port of ``kvcache_factory_tpu/evals/needle.py``).

    python -m kvcache_factory_tpu_torch.evals.needle --model_path DIR [--haystack_dir D]

Contract (reference, adapted from Long-Context-Data-Engineering):
 * haystack: Paul Graham essays concatenated until the target token length
   (:447-455), trimmed with a 200-token final buffer (:59, :404);
 * needle inserted at a depth %% on a sentence boundary found by scanning
   backwards for a period token (:398-438);
 * sweep: context lengths x ``linspace(0, 100, 10)`` depth percents
   (:125-134); per-cell greedy generate of 30 tokens, EOS = [eos, "\n"]
   (:281-289);
 * score: ROUGE-1 f-measure vs the needle x 10 (:296-299);
 * resume: skip cells whose result JSON already exists (:352-372);
 * outputs: per-cell results JSON + optional context txt (:325-350).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from datetime import datetime, timezone
from typing import List, Optional

import numpy as np

DEFAULT_NEEDLE = ("\nThe best thing to do in San Francisco is eat a sandwich "
                  "and sit in Dolores Park on a sunny day.\n")
DEFAULT_QUESTION = "The best thing to do in San Francisco is: "
FINAL_CONTEXT_LENGTH_BUFFER = 200
PROMPT_TEMPLATE = ("<|im_start|> This is a very long story book: <book> "
                   "{context} </book>.\n Based on the content of the book, "
                   "Question: {question}\nAnswer:")


def rouge1_score(needle: str, response: str) -> float:
    """ROUGE-1 f-measure of ``response`` against the needle, stemmed, from
    the ``rouge_score`` package (imported here, at the first scored cell).
    :meth:`NeedleHaystackTester.evaluate_cell` looks it up as a module
    global at each call."""
    from rouge_score import rouge_scorer

    scorer = rouge_scorer.RougeScorer(["rouge1"], use_stemmer=True)
    return scorer.score(needle, response)["rouge1"].fmeasure


class NeedleHaystackTester:
    def __init__(self, engine, tokenizer, haystack_dir: str,
                 results_dir: str = "results_needle",
                 needle: str = DEFAULT_NEEDLE,
                 retrieval_question: str = DEFAULT_QUESTION,
                 context_lengths: Optional[List[int]] = None,
                 depth_percents: Optional[List[float]] = None,
                 model_version: str = "model", save_contexts: bool = False,
                 period_tokens: Optional[List[int]] = None,
                 print_status: bool = True):
        self.engine = engine
        self.tok = tokenizer
        self.haystack_dir = haystack_dir
        self.results_dir = results_dir
        self.needle = needle
        self.question = retrieval_question
        self.model_version = model_version
        self.save_contexts = save_contexts
        self.print_status = print_status
        self.context_lengths = (context_lengths if context_lengths is not None
                                else list(range(1000, 8001, 100)))
        self.depth_percents = (depth_percents if depth_percents is not None
                               else np.round(np.linspace(0, 100, num=10,
                                                         endpoint=True)).astype(int).tolist())
        if period_tokens is None:
            # Sentence-boundary tokens; derived from the tokenizer rather than
            # the reference's hard-coded per-family ids (:421-425).
            period_tokens = list({
                ids[-1] for ids in (self.tok.encode(".", add_special_tokens=False),
                                    self.tok.encode("a.", add_special_tokens=False),
                                    self.tok.encode(".\n", add_special_tokens=False))
                if ids})
        self.period_tokens = period_tokens
        self._haystack_text = None

    # --- context construction -------------------------------------------

    def _enc(self, text):
        return self.tok.encode(text, add_special_tokens=False)

    def read_context_files(self, max_context_length: int) -> str:
        if self._haystack_text is not None:
            return self._haystack_text
        parts, total = [], 0
        files = sorted(glob.glob(os.path.join(self.haystack_dir, "*.txt")))
        if not files:
            raise FileNotFoundError(f"no essays in {self.haystack_dir}")
        while total < max_context_length:
            for path in files:
                with open(path) as f:
                    text = f.read()
                parts.append(text)
                total += len(self._enc(text))
                if total >= max_context_length:
                    break
        self._haystack_text = "".join(parts)
        return self._haystack_text

    def insert_needle(self, context: str, depth_percent: float,
                      context_length: int) -> str:
        tokens_needle = self._enc(self.needle)
        tokens_context = self._enc(context)
        context_length -= FINAL_CONTEXT_LENGTH_BUFFER
        if len(tokens_context) + len(tokens_needle) > context_length:
            tokens_context = tokens_context[:context_length - len(tokens_needle)]
        if depth_percent == 100:
            tokens_new = tokens_context + tokens_needle
        else:
            insertion_point = int(len(tokens_context) * depth_percent / 100)
            tokens_new = tokens_context[:insertion_point]
            while tokens_new and tokens_new[-1] not in self.period_tokens:
                insertion_point -= 1
                tokens_new = tokens_context[:insertion_point]
            tokens_new = (tokens_new + tokens_needle
                          + tokens_context[insertion_point:])
        return self.tok.decode(tokens_new)

    def generate_context(self, context_length: int, depth_percent: float) -> str:
        context = self.read_context_files(max(self.context_lengths))
        tokens = self._enc(context)
        if len(tokens) > context_length:
            context = self.tok.decode(tokens[:context_length])
        return self.insert_needle(context, depth_percent, context_length)

    # --- evaluation ------------------------------------------------------

    def _cell_path(self, context_length: int, depth_percent: float) -> str:
        tag = (f"{self.model_version.replace('.', '_')}_len_{context_length}"
               f"_depth_{int(depth_percent * 100)}")
        return os.path.join(self.results_dir, "results", self.model_version,
                            f"{tag}_results.json")

    def result_exists(self, context_length: int, depth_percent: float) -> bool:
        return os.path.exists(self._cell_path(context_length, depth_percent))

    def evaluate_cell(self, context_length: int, depth_percent: float) -> dict:
        context = self.generate_context(context_length, depth_percent)
        prompt = PROMPT_TEMPLATE.format(context=context, question=self.question)
        ids = self.tok.encode(prompt)

        eos_ids = []
        if getattr(self.tok, "eos_token_id", None) is not None:
            eos_ids.append(self.tok.eos_token_id)
        nl = self._enc("\n")
        if nl:
            eos_ids.append(nl[-1])

        t0 = time.time()
        out_ids = self.engine.generate_ids(ids, 30, eos_ids)
        response = self.tok.decode(out_ids, skip_special_tokens=True).strip()
        elapsed = time.time() - t0

        if response:
            score = rouge1_score(self.needle, response) * 10
        else:
            score = 0.0

        result = {
            "model": self.model_version,
            "context_length": int(context_length),
            "depth_percent": float(depth_percent),
            "needle": self.needle,
            "model_response": response,
            "score": score,
            "test_duration_seconds": elapsed,
            "test_timestamp_utc": datetime.now(timezone.utc)
                .strftime("%Y-%m-%d %H:%M:%S%z"),
        }
        from .cli_common import writes_results
        if not writes_results():  # every rank generates; rank 0 writes
            return result
        path = self._cell_path(context_length, depth_percent)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, ensure_ascii=False)
        if self.save_contexts:
            cdir = os.path.join(self.results_dir, "contexts", self.model_version)
            os.makedirs(cdir, exist_ok=True)
            tag = (f"{self.model_version.replace('.', '_')}_len_"
                   f"{context_length}_depth_{int(depth_percent*100)}")
            with open(os.path.join(cdir, f"{tag}_context.txt"), "w") as f:
                f.write(context)
        if self.print_status:
            print(f"-- len {context_length} depth {depth_percent}% "
                  f"score {score:.2f} ({elapsed:.1f}s): {response[:60]!r}")
        return result

    def run(self) -> List[dict]:
        results = []
        for cl in self.context_lengths:
            for dp in self.depth_percents:
                if self.result_exists(cl, dp):
                    continue
                results.append(self.evaluate_cell(cl, dp))
        return results


def main(argv=None):
    from .cli_common import add_engine_args, build_engine_from_args

    ap = argparse.ArgumentParser(description="Needle-in-a-haystack (PyTorch/CUDA port)")
    add_engine_args(ap)
    ap.add_argument("--haystack_dir", type=str, default="data/PaulGrahamEssays")
    ap.add_argument("--results_dir", type=str, default="results_needle")
    ap.add_argument("--s_len", type=int, default=1000)
    ap.add_argument("--e_len", type=int, default=8001)
    # 1000 matches the reference CLI default (run_needle_in_haystack.py:507);
    # the paper's fine sweep used --step 100 via scripts_needle/eval.sh.
    ap.add_argument("--step", type=int, default=1000)
    ap.add_argument("--save_contexts", action="store_true")
    args = ap.parse_args(argv)

    engine, tokenizer, model_name = build_engine_from_args(args)
    tester = NeedleHaystackTester(
        engine, tokenizer, args.haystack_dir, args.results_dir,
        context_lengths=list(range(args.s_len, args.e_len, args.step)),
        model_version=f"{model_name}_{args.method}_{args.max_capacity_prompts}",
        save_contexts=args.save_contexts)
    tester.run()


if __name__ == "__main__":
    main()
