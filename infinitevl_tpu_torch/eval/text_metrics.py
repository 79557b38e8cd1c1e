"""Generation-similarity metrics: BLEU-4 and ROUGE-1/2/L.

Self-contained re-implementation of the reference's SFT eval metrics
(src/llamafactory/train/sft/metric.py:62-88 ComputeSimilarity, and
scripts/eval_bleu_rouge.py): sentence-level BLEU-4 with add-k smoothing
(nltk SmoothingFunction method3 semantics: 1/(2^k) for zero counts) and
ROUGE F1 over unigrams, bigrams, and the longest common subsequence.

No nltk/jieba dependency: tokenization is whitespace-based with a
character fallback for scripts without spaces (the reference uses jieba for
Chinese; for parity evaluation on English data the word path is what runs).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence


def tokenize(text: str) -> List[str]:
    """Whitespace tokens; falls back to characters when a 'word' is long
    CJK-style running text (no spaces)."""
    words = text.strip().split()
    if not words:
        return []
    # character fallback: any token containing CJK codepoints is split
    out: List[str] = []
    for w in words:
        if any("一" <= ch <= "鿿" for ch in w):
            out.extend(list(w))
        else:
            out.append(w)
    return out


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def bleu4(pred: Sequence[str], ref: Sequence[str]) -> float:
    """Sentence BLEU-4, smoothing method3 (invcnt doubling for zero
    matches), with the standard brevity penalty."""
    import math

    if not pred or not ref:
        return 0.0
    log_p = 0.0
    invcnt = 1.0
    for n in range(1, 5):
        p_ngr = _ngrams(pred, n)
        r_ngr = _ngrams(ref, n)
        total = max(sum(p_ngr.values()), 0)
        if total == 0:
            # prediction shorter than n: no n-gram precision contribution
            match = 0
            total = 1
        else:
            match = sum(min(c, r_ngr[g]) for g, c in p_ngr.items())
        if match == 0:
            invcnt *= 2.0
            p_n = 1.0 / (invcnt * total)
        else:
            p_n = match / total
        log_p += math.log(p_n) / 4.0
    bp = 1.0 if len(pred) >= len(ref) else math.exp(1.0 - len(ref) / len(pred))
    return bp * math.exp(log_p)


def _f1(match: int, n_pred: int, n_ref: int) -> float:
    if match == 0:
        return 0.0
    p = match / n_pred
    r = match / n_ref
    return 2 * p * r / (p + r)


def rouge_n(pred: Sequence[str], ref: Sequence[str], n: int) -> float:
    if len(pred) < n or len(ref) < n:
        return 0.0
    p_ngr = _ngrams(pred, n)
    r_ngr = _ngrams(ref, n)
    match = sum(min(c, p_ngr[g]) for g, c in r_ngr.items())
    return _f1(match, sum(p_ngr.values()), sum(r_ngr.values()))


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    # O(len(a)*len(b)) rolling-row DP
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(pred: Sequence[str], ref: Sequence[str]) -> float:
    if not pred or not ref:
        return 0.0
    return _f1(_lcs_len(pred, ref), len(pred), len(ref))


def compute_similarity(
    preds: Sequence[str], refs: Sequence[str]
) -> Dict[str, float]:
    """Corpus-averaged metrics dict, reference key names
    (train/sft/metric.py:75-86): rouge-1/rouge-2/rouge-l/bleu-4 in [0, 100].
    """
    assert len(preds) == len(refs), (len(preds), len(refs))
    acc = {"rouge-1": 0.0, "rouge-2": 0.0, "rouge-l": 0.0, "bleu-4": 0.0}
    n = max(len(preds), 1)
    for p, r in zip(preds, refs):
        pt, rt = tokenize(p), tokenize(r)
        acc["rouge-1"] += rouge_n(pt, rt, 1)
        acc["rouge-2"] += rouge_n(pt, rt, 2)
        acc["rouge-l"] += rouge_l(pt, rt)
        acc["bleu-4"] += bleu4(pt, rt)
    return {k: round(v / n * 100, 4) for k, v in acc.items()}
