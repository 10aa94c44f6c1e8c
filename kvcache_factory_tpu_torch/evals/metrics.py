"""Evaluation metrics, behavioral match to the reference scorers (the
port's own copy of ``kvcache_factory_tpu/evals/metrics.py``, pure Python).

Reference: metrics.py:12-153 (itself the standard LongBench/RULER metric set).
Re-implemented from the metric definitions; the only dependency difference is
``fuzz.ratio`` (fuzzywuzzy, absent here), replaced by an equivalent
SequenceMatcher-based ratio (fuzzywuzzy's default ratio is the same
Levenshtein-ratio formula).
"""

from __future__ import annotations

import re
import string
from collections import Counter
from difflib import SequenceMatcher
from typing import List

_CN_PUNCT = ("！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀"
             "｛｜｝～｟｠｢｣､、〃》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰"
             "〾〿–—‘’‛“”„‟…‧﹏.")


def normalize_answer(s: str) -> str:
    """lower -> strip punctuation -> drop articles -> squeeze whitespace
    (order matches the reference so e.g. "a" inside punctuation splits the
    same way, metrics.py:12-28)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def normalize_zh_answer(s: str) -> str:
    s = s.lower()
    punct = set(string.punctuation + _CN_PUNCT)
    s = "".join(ch for ch in s if ch not in punct)
    return "".join(s.split())


def _token_f1(pred_tokens, gt_tokens) -> float:
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kw) -> float:
    return _token_f1(normalize_answer(prediction).split(),
                     normalize_answer(ground_truth).split())


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    import jieba
    pred = [normalize_zh_answer(t) for t in jieba.cut(prediction, cut_all=False)]
    gt = [normalize_zh_answer(t) for t in jieba.cut(ground_truth, cut_all=False)]
    pred = [t for t in pred if t]
    gt = [t for t in gt if t]
    return _token_f1(pred, gt)


def rouge_score(prediction: str, ground_truth: str, **kw) -> float:
    from rouge import Rouge
    try:
        scores = Rouge().get_scores([prediction], [ground_truth], avg=True)
    except Exception:
        return 0.0
    return scores["rouge-l"]["f"]


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    import jieba
    pred = " ".join(jieba.cut(prediction, cut_all=False))
    gt = " ".join(jieba.cut(ground_truth, cut_all=False))
    return rouge_score(pred, gt)


def count_score(prediction: str, ground_truth: str, **kw) -> float:
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers)


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    gt_id = re.findall(r"Paragraph (\d+)", ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if str(n) == str(gt_id)) / len(numbers)


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    gt_id = re.findall(r"段落(\d+)", ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if str(n) == str(gt_id)) / len(numbers)


def _fuzz_ratio(a: str, b: str) -> float:
    """fuzzywuzzy.fuzz.ratio equivalent: round(100 * 2*M / (len(a)+len(b)))."""
    if not a and not b:
        return 100.0
    m = SequenceMatcher(None, a, b).ratio()
    return round(m * 100)


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    all_lines = prediction.lstrip("\n").split("\n")
    pred = ""
    for line in all_lines:
        if "`" not in line and "#" not in line and "//" not in line:
            pred = line
            break
    return _fuzz_ratio(pred, ground_truth) / 100


def classification_score(prediction: str, ground_truth: str, **kw) -> float:
    matches = [c for c in kw["all_classes"] if c in prediction]
    # Reference removes WHILE iterating (metrics.py:95-97): removing element
    # i advances the iterator past the element that slides into position i,
    # so consecutive ground-truth substrings are only removed at even runs.
    # A plain filter is NOT equivalent (it removes all of them, inflating
    # scores) — replicate the quirk exactly for score comparability.
    for m in matches:  # list mutated during iteration, as in the reference
        if m in ground_truth and m != ground_truth:
            matches.remove(m)
    if ground_truth in matches:
        return 1.0 / len(matches)
    return 0.0


def string_match_all(preds: List[str], refs: List[List[str]]) -> float:
    """RULER metric (metrics.py:146-153): per-example fraction of reference
    strings present in the prediction (case-insensitive), averaged, x100."""
    score = sum(
        sum(1.0 if r.lower() in pred.lower() else 0.0 for r in ref) / len(ref)
        for pred, ref in zip(preds, refs)
    ) / len(preds) * 100
    return round(score, 2)


DATASET_METRICS = {
    # LongBench dataset -> scorer (reference eval.py:18-40)
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "multifieldqa_zh": qa_f1_zh_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "dureader": rouge_zh_score,
    "gov_report": rouge_score,
    "qmsum": rouge_score,
    "multi_news": rouge_score,
    "vcsum": rouge_zh_score,
    "trec": classification_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_score,
    "lsht": classification_score,
    "passage_count": count_score,
    "passage_retrieval_en": retrieval_score,
    "passage_retrieval_zh": retrieval_zh_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
}
