"""Word-level timestamp alignment: DTW over cross-attention patterns.

The reference aligns decoded text tokens to audio frames by running the
decoder once over the full token sequence, collecting cross-attention QK
matrices from designated alignment heads, normalising + median-filtering
them, and dynamic-time-warping through the negative attention matrix
(ref: data/whisper/timing.py:19-240). Word merging/truncation heuristics
follow (ref: timing.py:243-387).

Counterpart of `dualhyp_tpu/infer/whisper_timing.py`. The single decoder
forward (the FLOPs) runs on the card (`models/whisper.
decode_logits_with_cross_qk`), in the decoder's own dtype (a bf16 decoder,
int4 weights included, computes in bf16: kernel K8 takes bf16 only); the
JAX package computes it in fp32. The small sequential DTW and the median
filter run on the host in the C++ host library (`native.dtw`,
`native.median_filter`), as the JAX package's do. `dtw` and `median_filter`
here are their plain numpy versions, which the tests hold the library
against: the values of the Python versions in `dualhyp_tpu/native/
__init__.py`, vectorized (one anti-diagonal of the DTW at a time; every
row's windows at once).

The reference's CPU median filter uses REFLECT padding (timing.py:35);
`median_filter_reflect` reproduces that exactly by reflect-padding in
numpy and taking the interior of the edge-replicated filter (edge
handling only differs at positions the reflect pad removes).
"""

from __future__ import annotations

import string
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dualhyp_tpu_torch import native
from dualhyp_tpu_torch.models import whisper as w

HOP_LENGTH = 160
SAMPLE_RATE = 16000
TOKENS_PER_SECOND = SAMPLE_RATE // (HOP_LENGTH * 2)  # 50


def dtw(cost: np.ndarray):
    """Dynamic time warping through `cost` (n, m): (text indices, time
    indices) of the cheapest monotone path, ties to the diagonal, then up,
    then left (the reference's dtw_cpu and backtrace, and the Python
    version in `dualhyp_tpu/native`)."""
    cost = np.asarray(cost, np.float32)
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    trace = np.zeros((n + 1, m + 1), np.int8)
    acc[0, 0] = 0
    # the cells of one anti-diagonal (i + j = d) depend only on the two
    # before it: each diagonal at once, the same values and tie order
    for d in range(2, n + m + 1):
        i = np.arange(max(1, d - m), min(n, d - 1) + 1)
        j = d - i
        options = np.stack([acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]])
        t = np.argmin(options, axis=0)
        acc[i, j] = cost[i - 1, j - 1] + options[t, np.arange(len(i))]
        trace[i, j] = t
    pi, pj = [], []
    i, j = n, m
    while i > 0 and j > 0:
        pi.append(i - 1)
        pj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(pi[::-1], np.int32), np.asarray(pj[::-1], np.int32)


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Edge-replicated median filter along the last axis: the median of
    each window of `width` values (the Python version in
    `dualhyp_tpu/native/__init__.py`, over all rows at once)."""
    if width % 2 != 1:
        raise ValueError("`width` should be an odd number")
    half = width // 2
    x = np.asarray(x, np.float32)
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1).astype(np.float32)


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def median_filter_reflect(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the LAST axis with reflect padding
    (ref: timing.py:19-54, the CPU path actually used by the reference).
    Inputs shorter than width//2 + 1 pass through unchanged."""
    if width <= 0 or width % 2 != 1:
        raise ValueError("`width` should be an odd number")
    half = width // 2
    if x.shape[-1] <= half:
        return x
    flat = x.reshape(-1, x.shape[-1]).astype(np.float32)
    padded = np.pad(flat, ((0, 0), (half, half)), mode="reflect")
    out = np.stack([native.median_filter(row, width)[half:half + flat.shape[1]]
                    for row in padded]) if len(flat) else flat
    return out.reshape(x.shape)


def split_tokens_on_unicode(tokens: List[int], decode_fn: Callable):
    """(ref: data/whisper/tokenizer.py:286-309). decode_fn must render
    special/timestamp tokens as text (decode_with_timestamps semantics)."""
    decoded_full = decode_fn(tokens)
    replacement_char = "�"

    words, word_tokens, current_tokens = [], [], []
    unicode_offset = 0
    for token in tokens:
        current_tokens.append(token)
        decoded = decode_fn(current_tokens)
        if (
            replacement_char not in decoded
            or decoded_full[unicode_offset + decoded.index(replacement_char)]
            == replacement_char
        ):
            words.append(decoded)
            word_tokens.append(current_tokens)
            current_tokens = []
            unicode_offset += len(decoded)
    return words, word_tokens


def split_tokens_on_spaces(tokens: List[int], decode_fn: Callable, eot: int):
    """(ref: data/whisper/tokenizer.py:311-327)."""
    subwords, subword_tokens_list = split_tokens_on_unicode(tokens, decode_fn)
    words: List[str] = []
    word_tokens: List[List[int]] = []
    for subword, subword_tokens in zip(subwords, subword_tokens_list):
        special = subword_tokens[0] >= eot
        with_space = subword.startswith(" ")
        punctuation = subword.strip() in string.punctuation
        if special or with_space or punctuation or len(words) == 0:
            words.append(subword)
            word_tokens.append(subword_tokens)
        else:
            words[-1] = words[-1] + subword
            word_tokens[-1].extend(subword_tokens)
    return words, word_tokens


def split_to_word_tokens(tokens: List[int], decode_fn: Callable, eot: int,
                         language: str = "en"):
    """(ref: data/whisper/tokenizer.py:277-284)."""
    if language in {"zh", "ja", "th", "lo", "my", "yue"}:
        return split_tokens_on_unicode(tokens, decode_fn)
    return split_tokens_on_spaces(tokens, decode_fn, eot)


def find_alignment(
    dec_params,
    dec_cfg,
    features,
    text_tokens: List[int],
    num_frames: int,
    *,
    sot_sequence: Sequence[int],
    no_timestamps_id: int,
    eot_id: int,
    decode_fn: Callable,
    language: str = "en",
    alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[WordTiming]:
    """DTW word alignment for ONE already-encoded 30s window
    (ref: data/whisper/timing.py:163-240).

    features: (1, S, n_state) encoder output for the window, a tensor on
    the decoder's device.
    alignment_heads: (layer, head) pairs; None = the lower half of the
    decoder's heads (the openai default when a model ships no mask)."""
    if len(text_tokens) == 0:
        return []

    tokens = [*sot_sequence, no_timestamps_id, *text_tokens, eot_id]
    logits, qks = w.decode_logits_with_cross_qk(
        dec_params, dec_cfg, torch.tensor([tokens], device=features.device), features)
    logits = logits[0].cpu().numpy()
    qks = qks.cpu().numpy()  # (L, 1, H, T, S)

    sampled_logits = logits[len(sot_sequence):, :eot_id]
    e = np.exp(sampled_logits - sampled_logits.max(-1, keepdims=True))
    token_probs = e / e.sum(-1, keepdims=True)
    text_token_probs = [
        float(token_probs[i, t]) for i, t in enumerate(text_tokens)
    ]

    if alignment_heads is None:
        # lower-half heads, the openai fallback for models without a mask
        alignment_heads = [
            (l, h)
            for l in range(dec_cfg.n_layer // 2, dec_cfg.n_layer)
            for h in range(dec_cfg.n_head)
        ]
    weights = np.stack([qks[l, 0, h] for l, h in alignment_heads])
    weights = weights[:, :, : num_frames // 2].astype(np.float64)
    weights = weights * qk_scale
    e = np.exp(weights - weights.max(-1, keepdims=True))
    weights = e / e.sum(-1, keepdims=True)
    mean = weights.mean(-2, keepdims=True)
    std = weights.std(-2, keepdims=True)  # biased, like torch unbiased=False
    weights = (weights - mean) / std
    weights = median_filter_reflect(weights, medfilt_width)

    matrix = weights.mean(axis=0)
    matrix = matrix[len(sot_sequence):-1]
    text_indices, time_indices = native.dtw(-matrix)

    words, word_tokens = split_to_word_tokens(
        text_tokens + [eot_id], decode_fn, eot_id, language
    )
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(
        np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0)
    )

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        float(np.mean(text_token_probs[i:j]))
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, toks, float(start), float(end), prob)
        for word, toks, start, end, prob in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def merge_punctuations(alignment: List[WordTiming], prepended: str,
                       appended: str) -> None:
    """(ref: data/whisper/timing.py:243-274)."""
    i, j = len(alignment) - 2, len(alignment) - 1
    while i >= 0:
        previous, following = alignment[i], alignment[j]
        if previous.word.startswith(" ") and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ""
            previous.tokens = []
        else:
            j = i
        i -= 1

    i, j = 0, 1
    while j < len(alignment):
        previous, following = alignment[i], alignment[j]
        if not previous.word.endswith(" ") and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ""
            following.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    *,
    segments: List[dict],
    dec_params,
    dec_cfg,
    features,
    num_frames: int,
    sot_sequence: Sequence[int],
    no_timestamps_id: int,
    eot_id: int,
    decode_fn: Callable,
    language: str = "en",
    alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float = 0.0,
    **kwargs,
) -> float:
    """Attach per-word timings to each segment dict in place; returns the
    updated last_speech_timestamp (ref: data/whisper/timing.py:277-387)."""
    if len(segments) == 0:
        return last_speech_timestamp

    text_tokens_per_segment = [
        [token for token in segment["tokens"] if token < eot_id]
        for segment in segments
    ]
    text_tokens = [t for seg in text_tokens_per_segment for t in seg]
    alignment = find_alignment(
        dec_params, dec_cfg, features, text_tokens, num_frames,
        sot_sequence=sot_sequence, no_timestamps_id=no_timestamps_id,
        eot_id=eot_id, decode_fn=decode_fn, language=language,
        alignment_heads=alignment_heads, **kwargs,
    )
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = float(np.median(word_durations)) if len(word_durations) else 0.0
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0
    for segment, seg_tokens in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []
        while word_index < len(alignment) and saved_tokens < len(seg_tokens):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        if len(words) > 0:
            # first word after a pause must not run unreasonably long
            if words[0]["end"] - last_speech_timestamp > median_duration * 4 and (
                words[0]["end"] - words[0]["start"] > max_duration
                or (
                    len(words) > 1
                    and words[1]["end"] - words[0]["start"] > max_duration * 2
                )
            ):
                if (
                    len(words) > 1
                    and words[1]["end"] - words[1]["start"] > max_duration
                ):
                    boundary = max(
                        words[1]["end"] / 2, words[1]["end"] - max_duration
                    )
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if (
                segment["start"] < words[0]["end"]
                and segment["start"] - 0.5 > words[0]["start"]
            ):
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration, segment["start"])
                )
            else:
                segment["start"] = words[0]["start"]

            if (
                segment["end"] > words[-1]["start"]
                and segment["end"] + 0.5 < words[-1]["end"]
            ):
                words[-1]["end"] = max(
                    words[-1]["start"] + median_duration, segment["end"]
                )
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words
    return last_speech_timestamp
