"""Scoring CLI, behavioral match to the reference's eval.py / eval_ruler.py
(the port's own copy of ``kvcache_factory_tpu/evals/score.py``).

    python -m kvcache_factory_tpu_torch.evals.score --results_dir DIR [--suite ruler]

Reads prediction JSONL files laid out as ``{results_dir}/{dataset}/{method}.json``,
writes per-dataset ``metrics.json`` and an aggregate ``results.csv`` with the
reference's fixed method-row layout (eval.py:99-110, eval_ruler.py:21-30);
failures record -1 (eval.py:175-179).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import List

import numpy as np

from .metrics import DATASET_METRICS, string_match_all

LONGBENCH_DATASETS = [
    "narrativeqa", "qasper", "multifieldqa_en", "hotpotqa", "2wikimqa",
    "musique", "gov_report", "qmsum", "multi_news", "trec", "triviaqa",
    "samsum", "passage_count", "passage_retrieval_en", "lcc", "repobench-p",
]
LONGBENCH_METHODS = ["FullKV", "random", "SnapKV", "StreamingLLM", "H2O",
                     "PyramidKV", "L2Norm", "CAM", "ThinK"]
RULER_DATASETS = [
    "niah_single_1", "niah_single_2", "niah_single_3", "niah_multikey_1",
    "niah_multikey_2", "niah_multikey_3", "niah_multiquery", "niah_multivalue",
    "cwe", "fwe", "vt",
]
RULER_METHODS = ["FullKV", "random", "SnapKV", "StreamingLLM", "H2O",
                 "PyramidKV", "L2Norm"]

# Few-shot datasets keep only the first output line (eval.py:52-53, 70-71).
FIRST_LINE_DATASETS = ("trec", "triviaqa", "samsum", "lsht")


def scorer(dataset: str, predictions: List[str], answers: List[List[str]],
           all_classes) -> float:
    total = 0.0
    metric = DATASET_METRICS[dataset]
    for pred, gts in zip(predictions, answers):
        if dataset in FIRST_LINE_DATASETS:
            pred = pred.lstrip("\n").split("\n")[0]
        total += max((metric(pred, gt, all_classes=all_classes) for gt in gts),
                     default=0.0)
    return round(100 * total / len(predictions), 2)


def scorer_e(dataset: str, predictions, answers, lengths, all_classes) -> dict:
    """Length-bucketed LongBench-E scorer (eval.py:48-64)."""
    buckets = {"0-4k": [], "4-8k": [], "8k+": []}
    metric = DATASET_METRICS[dataset]
    for pred, gts, length in zip(predictions, answers, lengths):
        if dataset in FIRST_LINE_DATASETS:
            pred = pred.lstrip("\n").split("\n")[0]
        score = max((metric(pred, gt, all_classes=all_classes) for gt in gts),
                    default=0.0)
        if length < 4000:
            buckets["0-4k"].append(score)
        elif length < 8000:
            buckets["4-8k"].append(score)
        else:
            buckets["8k+"].append(score)
    return {k: round(100 * float(np.mean(v)), 2) if v else float("nan")
            for k, v in buckets.items()}


def _read_preds(path: str):
    predictions, answers, lengths, all_classes = [], [], [], None
    with open(path, encoding="utf-8") as f:
        for line in f:
            # Per-record robustness like the reference (eval.py:140-148 bare
            # except inside the loop): one truncated record from a killed run
            # must not nuke the file's score to -1 — skip it and keep the
            # remaining records.
            try:
                d = json.loads(line)
                pred, ans = d["pred"], d["answers"]
            except Exception:
                print("error")
                continue
            predictions.append(pred)
            answers.append(ans)
            all_classes = d.get("all_classes")
            if "length" in d:
                lengths.append(d["length"])
    return predictions, answers, lengths, all_classes


def _find_method_file(results_dir: str, dataset: str, method: str):
    """Scoreboard rows are capitalized (FullKV, SnapKV — eval.py:99-110) but
    the runners write the lowercase CLI method verbatim; match the prediction
    file case-insensitively so repo-default runs actually score."""
    d = os.path.join(results_dir, dataset)
    exact = os.path.join(d, f"{method}.json")
    if os.path.exists(exact):
        return exact
    want = f"{method.lower()}.json"
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.lower() == want:
                return os.path.join(d, name)
    return exact  # let the open() raise for the missing-file -1 path


def score_results_dir(results_dir: str, suite: str = "longbench",
                      longbench_e: bool = False) -> List[List]:
    if suite == "longbench":
        datasets, methods = LONGBENCH_DATASETS, LONGBENCH_METHODS
    else:
        datasets, methods = RULER_DATASETS, RULER_METHODS

    rows = [["dataset"]] + [[m] for m in methods]
    for dataset in datasets:
        rows[0].append(dataset)
        for idx, method in enumerate(methods):
            eval_file = _find_method_file(results_dir, dataset, method)
            try:
                preds, answers, lengths, all_classes = _read_preds(eval_file)
                if suite == "ruler":
                    score = string_match_all(preds, answers)
                elif longbench_e:
                    score = scorer_e(dataset, preds, answers, lengths, all_classes)
                else:
                    score = scorer(dataset, preds, answers, all_classes)
                rows[idx + 1].append(score)
                with open(os.path.join(os.path.dirname(eval_file),
                                       "metrics.json"), "w") as f:
                    json.dump({dataset: score}, f, ensure_ascii=False, indent=4)
                print(f"dataset {dataset} method {method} scores "
                      f"{{{dataset!r}: {score}}}")
            except Exception:
                rows[idx + 1].append(-1)
                print(f"dataset {dataset} method {method} scores None")

    with open(os.path.join(results_dir, "results.csv"), "w") as fp:
        csv.writer(fp).writerows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results_dir", type=str, required=True)
    ap.add_argument("--suite", type=str, default="longbench",
                    choices=["longbench", "ruler"])
    ap.add_argument("--longbench_e", action="store_true")
    args = ap.parse_args(argv)
    score_results_dir(args.results_dir, args.suite, args.longbench_e)


if __name__ == "__main__":
    main()
