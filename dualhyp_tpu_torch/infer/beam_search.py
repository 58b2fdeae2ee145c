"""Whisper-protocol beam search returning ALL final beams (n-best).

The reference's key Whisper modification is a decoder that returns every
beam hypothesis, not just the best (CustomDecodingResult.texts +
CustomReturnAllSamplesRanker, ref: data/whisper/decoding.py:81-92, 203-224,
802-821); the offline generator dedupes/normalises those into the top-5
n-best lists (ref: data/make_json_asr.py:162-210).

This module implements the full DecodingTask beam semantics:

  * logit rules applied to raw logits each step, in reference order
    (ref: decoding.py:739-741, 594-610): SuppressBlank at the first sampled
    position (:464-471), SuppressTokens incl. the non-speech list
    (:474-479, tokenizer.py:242-275), and ApplyTimestampRules (:482-547)
  * BeamSearchDecoder update/finalize with `patience`
    (max_candidates = round(beam * patience), ref: decoding.py:338-441)
  * CustomReturnAllSamplesRanker scoring: sum_logprob / n_sampled (or the
    Google-NMT penalty ((5+n)/6)**alpha), and the recorded
    avg_logprob = sum_logprob / (n_sampled + 1) (ref: decoding.py:203-224,
    812-813)

Device work per step is one batched `logits_fn` call; the rule filters and
beam bookkeeping are numpy on host (vocab-size vectorised).

Counterpart of `dualhyp_tpu/infer/beam_search.py`: the same host logic, with
the log-softmax and logsumexp in numpy (fp32) instead of JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def log_softmax(x: np.ndarray) -> np.ndarray:
    """fp32 log-softmax over the last axis (jax.nn.log_softmax's form:
    x - max - log(sum(exp(x - max))))."""
    x = np.asarray(x, np.float32)
    m = x.max(axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0).astype(np.float32)
    shifted = x - m
    with np.errstate(divide="ignore"):
        return shifted - np.log(np.exp(shifted).sum(axis=-1, keepdims=True))


def logsumexp(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    m = x.max(axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0).astype(np.float32)
    with np.errstate(divide="ignore"):
        return (np.log(np.exp(x - m).sum(axis=-1, keepdims=True)) + m)[..., 0]


@dataclass
class BeamHypothesis:
    tokens: List[int]  # full sequence incl. prefix, EXCLUDING the final eot
    score: float  # sum of log-probs
    sample_begin: int = 0  # prefix length (sot sequence)

    @property
    def n_sampled(self) -> int:
        return max(len(self.tokens) - self.sample_begin, 0)

    def ranking_score(self, length_penalty: Optional[float] = None) -> float:
        """Score used to order the returned beams
        (ref: decoding.py:203-224)."""
        n = max(self.n_sampled, 1)
        penalty = float(n) if length_penalty is None else ((5 + n) / 6) ** length_penalty
        return self.score / penalty

    @property
    def avg_logprob(self) -> float:
        """Recorded hypothesis score (ref: decoding.py:812-813)."""
        return self.score / (self.n_sampled + 1)

    # kept for non-whisper callers (ESPnet-joint paths)
    @property
    def normalized_score(self) -> float:
        return self.avg_logprob


def cons_to_list(node) -> List[int]:
    """Cons-cell chain (parent_node, tok) rooted at None -> token list.

    The device-beam host replays keep hypotheses as cons cells so a
    surviving child shares its parent's history in O(1); only finished
    or surviving hypotheses ever materialise (the per-candidate list
    copies were ~290 ms/chunk of host time at whisper beam 50)."""
    out: List[int] = []
    while node is not None:
        node, tok = node[0], node[1]
        out.append(tok)
    out.reverse()
    return out


@dataclass(frozen=True)
class TimestampRules:
    """ApplyTimestampRules parameters (ref: decoding.py:482-547)."""

    timestamp_begin: int
    eot: int
    no_timestamps: Optional[int] = None
    max_initial_timestamp_index: Optional[int] = None


def non_speech_token_ids(encode_fn: Callable[[str], List[int]]) -> List[int]:
    """Derive the '-1' suppress list: speaker tags / annotation symbols
    (ref: data/whisper/tokenizer.py:242-275). `encode_fn` maps a string to
    token ids without special tokens (tiktoken- or HF-style)."""
    symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    symbols += (
        "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
    )
    miscellaneous = set("♩♪♫♬♭♮♯")

    result = {encode_fn(" -")[0], encode_fn(" '")[0]}
    for symbol in symbols + list(miscellaneous):
        for tokens in [encode_fn(symbol), encode_fn(" " + symbol)]:
            if len(tokens) == 1 or symbol in miscellaneous:
                result.add(tokens[0])
    return sorted(result)


def _apply_timestamp_rules(
    logits: np.ndarray,
    tokens: np.ndarray,
    rules: TimestampRules,
    sample_begin: int,
) -> None:
    """In-place ApplyTimestampRules on (n_beams, V) logits
    (ref: decoding.py:493-547)."""
    tb = rules.timestamp_begin
    if rules.no_timestamps is not None:
        logits[:, rules.no_timestamps] = -np.inf

    for k in range(tokens.shape[0]):
        seq = tokens[k, sample_begin:].tolist()
        last_was_ts = len(seq) >= 1 and seq[-1] >= tb
        penultimate_was_ts = len(seq) < 2 or seq[-2] >= tb
        if last_was_ts:
            if penultimate_was_ts:  # a <ts><ts> pair closed a segment: text next
                logits[k, tb:] = -np.inf
            else:  # mid-pair: only the closing timestamp (or EOT) may follow
                logits[k, : rules.eot] = -np.inf
        timestamps = [t for t in seq if t >= tb]
        if timestamps:
            # timestamps must not decrease; force nonzero-length segments
            if last_was_ts and not penultimate_was_ts:
                timestamp_last = timestamps[-1]
            else:
                timestamp_last = timestamps[-1] + 1
            logits[k, tb:timestamp_last] = -np.inf

    if tokens.shape[1] == sample_begin:
        # the first sampled token must be a timestamp
        logits[:, :tb] = -np.inf
        if rules.max_initial_timestamp_index is not None:
            last_allowed = tb + rules.max_initial_timestamp_index
            logits[:, last_allowed + 1 :] = -np.inf

    # if the total timestamp probability beats every text token, force one
    logprobs = log_softmax(logits)
    ts_logprob = logsumexp(logprobs[:, tb:])
    max_text = logprobs[:, :tb].max(axis=-1)
    force = ts_logprob > max_text
    logits[force, :tb] = -np.inf


def beam_search_nbest(
    logits_fn: Callable,
    prefix: List[int],
    *,
    beam_size: int,
    eos_id: int,
    max_new_tokens: int,
    suppress_tokens: Optional[Sequence[int]] = None,
    suppress_blank_ids: Optional[Sequence[int]] = None,
    timestamp_rules: Optional[TimestampRules] = None,
    patience: Optional[float] = None,
    length_penalty: Optional[float] = None,
) -> List[BeamHypothesis]:
    """Returns all finished (or exhausted) beams, best first by the
    length-normalised ranking score.

    logits_fn: takes int32 tokens (n_beams, T), a numpy array, and returns
    (n_beams, V) next-token logits (the caller closes over model params / audio features
    and may cache whatever it likes).

    suppress_blank_ids: token ids blocked at the first sampled position
    (encode(" ") + [eot], ref: decoding.py:464-471). suppress_tokens:
    blocked at every step (ref: decoding.py:474-479).
    """
    sample_begin = len(prefix)
    max_candidates = int(round(beam_size * (patience or 1.0)))
    assert max_candidates > 0, f"invalid beam_size/patience: {beam_size}/{patience}"

    live: List[BeamHypothesis] = [BeamHypothesis(list(prefix), 0.0, sample_begin)]
    finished: Dict[Tuple[int, ...], float] = {}
    suppress = list(suppress_tokens) if suppress_tokens else None
    blank = list(suppress_blank_ids) if suppress_blank_ids else None

    for _ in range(max_new_tokens):
        if not live:
            break
        tokens = np.asarray([h.tokens for h in live], np.int32)
        logits = np.array(logits_fn(tokens), np.float32, copy=True)

        # logit rules in reference order (ref: decoding.py:594-610, 739-741)
        if blank is not None and tokens.shape[1] == sample_begin:
            logits[:, blank] = -np.inf
        if suppress is not None:
            logits[:, suppress] = -np.inf
        if timestamp_rules is not None:
            _apply_timestamp_rules(logits, tokens, timestamp_rules, sample_begin)

        logprobs = log_softmax(logits)

        # candidate pool: every live beam x top (beam_size+1) tokens,
        # ranked together (ref: decoding.py:368-395)
        k = min(beam_size + 1, logprobs.shape[-1])
        top_idx = np.argpartition(-logprobs, k - 1, axis=-1)[:, :k]
        # within-beam candidates ordered by logprob (stable tie order)
        order = np.argsort(-np.take_along_axis(logprobs, top_idx, axis=-1),
                           axis=-1, kind="stable")
        top_idx = np.take_along_axis(top_idx, order, axis=-1)

        candidates: List[Tuple[float, BeamHypothesis, int]] = []
        for b, hyp in enumerate(live):
            for t in top_idx[b]:
                candidates.append(
                    (hyp.score + float(logprobs[b, t]), hyp, int(t))
                )
        candidates.sort(key=lambda c: -c[0])

        new_live: List[BeamHypothesis] = []
        newly_finished: List[Tuple[Tuple[int, ...], float]] = []
        for score, hyp, tok in candidates:
            if tok == eos_id:
                newly_finished.append((tuple(hyp.tokens), score))
            else:
                new_live.append(
                    BeamHypothesis(hyp.tokens + [tok], score, sample_begin)
                )
                if len(new_live) == beam_size:
                    break
        live = new_live

        # candidate list capped at max_candidates (ref: decoding.py:413-422)
        for seq, score in newly_finished:
            if len(finished) >= max_candidates:
                break
            finished.setdefault(seq, score)
        if len(finished) >= max_candidates:
            break

    results = [
        BeamHypothesis(list(seq), score, sample_begin)
        for seq, score in finished.items()
    ]
    if len(results) < beam_size:
        # top up with unfinished beams, best first (ref: decoding.py:427-437)
        for hyp in sorted(live, key=lambda h: -h.score):
            results.append(hyp)
            if len(results) >= beam_size:
                break

    results.sort(key=lambda h: -h.ranking_score(length_penalty))
    return results


def sample_nbest(
    logits_fn: Callable,
    prefix: List[int],
    *,
    n_samples: int,
    temperature: float,
    eos_id: int,
    max_new_tokens: int,
    suppress_tokens: Optional[Sequence[int]] = None,
    suppress_blank_ids: Optional[Sequence[int]] = None,
    timestamp_rules: Optional[TimestampRules] = None,
    length_penalty: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[BeamHypothesis]:
    """GreedyDecoder-with-temperature sampling, `best_of` independent rows
    (the reference's t>0 fallback path, ref: decoding.py:276-336, 748-768).

    Same logit-rule order as the beam; logprobs accumulate from the
    UN-tempered distribution (ref: decoding.py:299-303). Returns all
    n_samples hypotheses sorted by ranking_score, like the reference's
    CustomReturnAllSamplesRanker over the sample group.
    """
    assert temperature > 0, "use beam_search_nbest at temperature 0"
    rng = rng or np.random.default_rng(0)
    sample_begin = len(prefix)
    tokens = np.tile(np.asarray(prefix, np.int32), (n_samples, 1))
    sum_logprobs = np.zeros((n_samples,), np.float64)
    suppress = list(suppress_tokens) if suppress_tokens else None
    blank = list(suppress_blank_ids) if suppress_blank_ids else None

    done = np.zeros((n_samples,), bool)
    for _ in range(max_new_tokens):
        logits = np.array(logits_fn(tokens), np.float32, copy=True)
        if blank is not None and tokens.shape[1] == sample_begin:
            logits[:, blank] = -np.inf
        if suppress is not None:
            logits[:, suppress] = -np.inf
        if timestamp_rules is not None:
            _apply_timestamp_rules(logits, tokens, timestamp_rules, sample_begin)

        logprobs = log_softmax(logits)
        # Gumbel-max == Categorical(logits / temperature)
        gumbel = rng.gumbel(size=logits.shape)
        next_tokens = np.argmax(logits / temperature + gumbel, axis=-1)
        current = logprobs[np.arange(n_samples), next_tokens]
        sum_logprobs += np.where(done, 0.0, current)
        next_tokens = np.where(done, eos_id, next_tokens)
        done = done | (next_tokens == eos_id)
        tokens = np.concatenate([tokens, next_tokens[:, None].astype(np.int32)], 1)
        if done.all():
            break

    results = []
    for k in range(n_samples):
        seq = tokens[k].tolist()
        if eos_id in seq[sample_begin:]:
            seq = seq[: sample_begin + seq[sample_begin:].index(eos_id)]
        results.append(BeamHypothesis(seq, float(sum_logprobs[k]), sample_begin))
    results.sort(key=lambda h: -h.ranking_score(length_penalty))
    return results


def nbest_texts(hypotheses: List[BeamHypothesis], detokenize: Callable,
                n: int = 5, normalizer: Optional[Callable] = None,
                prefix_len: int = 0) -> Tuple[List[str], List[float]]:
    """Dedupe + pad-by-repetition into exactly n texts
    (ref: make_json_asr.py:190-209)."""
    texts, scores = [], []
    seen = set()
    for hyp in hypotheses:
        text = detokenize(hyp.tokens[prefix_len:])
        if normalizer is not None:
            text = normalizer(text)
        text = text.strip()
        if not text:
            # the reference substitutes '<UNK>' for empty normalized texts
            # (ref: make_json_asr.py:189-191)
            text = "<UNK>"
        if text in seen:
            continue
        seen.add(text)
        texts.append(text)
        scores.append(hyp.avg_logprob)
        if len(texts) == n:
            break
    while texts and len(texts) < n:  # pad by repetition
        texts.append(texts[len(texts) % len(seen)])
        scores.append(scores[len(scores) % len(seen)])
    return texts, scores
