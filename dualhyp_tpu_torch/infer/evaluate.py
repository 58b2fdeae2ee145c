"""WER / exact-match evaluation.

A copy of `dualhyp_tpu/infer/evaluate.py` without its native C++ WER path:
the edit distance here is the pure-Python dynamic programme.

Implements the reference's metric protocol (ref: inference/ger.py:96-117)
with a dependency-free word-level edit distance (jiwer-compatible corpus
WER: summed S+D+I over all pairs divided by total reference words):

  * WER over (prediction, reference) pairs
  * exact-match count ("gtms")
  * post-string-normalised WER: lowercase, strip  . , - ? '

Plus the reference's generation postprocess: strip the decoded prompt
prefix, keep the first line, strip whitespace (ref: inference/ger.py:86-88).
"""

from __future__ import annotations

from typing import List, Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Word-level Levenshtein distance (unit costs)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        r = ref[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (r != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return prev[m]


def word_error_rate(predictions: List[str], references: List[str]) -> float:
    """Corpus WER: sum(edit ops) / sum(reference words), by the pure-Python
    dynamic programme above."""
    if len(predictions) != len(references):
        raise ValueError(
            f"{len(predictions)} predictions for {len(references)} references"
        )
    total_edits = 0
    total_words = 0
    for pred, ref in zip(predictions, references):
        ref_words = ref.split()
        total_edits += edit_distance(ref_words, pred.split())
        total_words += len(ref_words)
    return total_edits / max(total_words, 1)


def post_normalize(text: str) -> str:
    """(ref: inference/ger.py:108-109)"""
    out = text.lower()
    for ch in (".", ",", "-", "?", "'"):
        out = out.replace(ch, "")
    return out


def extract_response(decoded_full: str, decoded_prompt: str) -> str:
    """Strip the prompt prefix and keep the first generated line
    (ref: inference/ger.py:86)."""
    return decoded_full[len(decoded_prompt):].split("\n")[0].strip()


def evaluate_predictions(predictions: List[str], references: List[str]) -> dict:
    preds = [p.strip() for p in predictions]
    refs = [r.strip() for r in references]
    n = len(preds)
    exact = sum(p == r for p, r in zip(preds, refs))
    wer = word_error_rate(preds, refs)
    post_preds = [post_normalize(p) for p in preds]
    post_refs = [post_normalize(r) for r in refs]
    post_exact = sum(p == r for p, r in zip(post_preds, post_refs))
    post_wer = word_error_rate(post_preds, post_refs)
    return {
        "WER": wer,
        "gtms": exact / max(n, 1),
        "post_ST_wer": post_wer,
        "post_gtms": post_exact / max(n, 1),
        "n": n,
    }
