"""LongBench task metrics: the port's own copy of the JAX package's
``eval/LongBench/metrics.py`` (pure Python).

The standard set: qa_f1, rouge-l, classification accuracy,
retrieval/count accuracy, code similarity, and the Chinese-task variants
(jieba word segmentation when available, character segmentation
otherwise) (reference metrics.py:25-153).
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import List

_CN_PUNCT = (
    "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃》「」『』"
    "【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏."
)


def _zh_cut(text: str) -> List[str]:
    try:
        import jieba

        return list(jieba.cut(text, cut_all=False))
    except ImportError:  # pragma: no cover
        return list(text)


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def normalize_zh_answer(s: str) -> str:
    """Lowercase, strip (cn + ascii) punctuation and whitespace
    (reference metrics.py:32-45)."""
    punct = set(string.punctuation + _CN_PUNCT)
    return "".join(ch for ch in s.lower() if ch not in punct and
                   not ch.isspace())


def _f1(pred_tokens: List[str], gold_tokens: List[str]) -> float:
    common = Counter(pred_tokens) & Counter(gold_tokens)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred_tokens)
    recall = overlap / len(gold_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kw) -> float:
    p = normalize_answer(prediction).split()
    g = normalize_answer(ground_truth).split()
    if not p or not g:
        return float(p == g)
    return _f1(p, g)


def _lcs(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_score(prediction: str, ground_truth: str, **kw) -> float:
    """ROUGE-L F1."""
    p = normalize_answer(prediction).split()
    g = normalize_answer(ground_truth).split()
    if not p or not g:
        return 0.0
    lcs = _lcs(p, g)
    if lcs == 0:
        return 0.0
    prec = lcs / len(p)
    rec = lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def classification_score(prediction: str, ground_truth: str,
                         all_classes=None, **kw) -> float:
    em_matches = [
        c for c in (all_classes or []) if c.lower() in prediction.lower()
    ]
    gt = ground_truth.lower()
    # classes that are substrings of the ground truth don't count as
    # competing predictions (reference metrics.py behavior: an exact
    # correct answer containing a shorter class name still scores 1.0)
    em_matches = [
        c for c in em_matches
        if c.lower() == gt or c.lower() not in gt
    ]
    if gt in prediction.lower():
        # penalize predicting several classes
        return 1.0 / max(len(em_matches), 1)
    return 0.0


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    # fraction of the prediction's numbers that match (reference
    # protocol) — binary membership would reward hedging with many
    # candidate paragraph numbers
    m = re.findall(r"Paragraph (\d+)", ground_truth)
    gt_num = m[0] if m else (
        re.findall(r"\d+", ground_truth) or [normalize_answer(ground_truth)]
    )[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == gt_num) / len(numbers)


def count_score(prediction: str, ground_truth: str, **kw) -> float:
    nums = re.findall(r"\d+", prediction)
    if not nums:
        return 0.0
    gt = str(ground_truth).strip()
    return sum(1 for n in nums if n == gt) / len(nums)


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    pred_line = ""
    for line in prediction.lstrip("\n").split("\n"):
        if line.strip():
            pred_line = line
            break
    p = pred_line.split()
    g = ground_truth.split()
    if not p or not g:
        return 0.0
    return _f1(p, g)


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    p = [normalize_zh_answer(t) for t in _zh_cut(prediction)]
    g = [normalize_zh_answer(t) for t in _zh_cut(ground_truth)]
    p = [t for t in p if t]
    g = [t for t in g if t]
    if not p or not g:
        return float(p == g)
    return _f1(p, g)


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    p = [t for t in _zh_cut(prediction) if t.strip()]
    g = [t for t in _zh_cut(ground_truth) if t.strip()]
    if not p or not g:
        return 0.0
    lcs = _lcs(p, g)
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    matches = re.findall(r"段落(\d+)", ground_truth)
    if not matches:
        return 0.0
    gt = matches[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == gt) / len(numbers)


DATASET2METRIC = {
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "gov_report": rouge_score,
    "qmsum": rouge_score,
    "multi_news": rouge_score,
    "trec": classification_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_score,
    "passage_retrieval_en": retrieval_score,
    "passage_count": count_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
    # Chinese tasks (reference metrics.py mapping)
    "multifieldqa_zh": qa_f1_zh_score,
    "dureader": rouge_zh_score,
    "vcsum": rouge_zh_score,
    "lsht": classification_score,
    "passage_retrieval_zh": retrieval_zh_score,
}
