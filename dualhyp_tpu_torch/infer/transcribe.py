"""Long-form (>30s) Whisper transcription: sliding-window decode with
temperature fallback, n-best hypothesis streams, and optional word-level
timestamps.

Re-implements the reference fork's `transcribe()` semantics
(ref: data/whisper/transcribe.py:39-457):

  * log-mel over the WHOLE recording padded with 30s of silence; windows
    sliced from the one globally-normalised mel (ref: transcribe.py:126-127)
  * per-window temperature fallback: beam at t=0, best_of sampling at t>0,
    escalating while gzip `compression_ratio` or `avg_logprob` fail their
    thresholds; a loud `no_speech_prob` cancels the fallback
    (ref: transcribe.py:157-195)
  * no-voice-activity windows fast-forward a full window
    (ref: transcribe.py:242-253, 364-376)
  * the fork's distinctive feature: ONE seek cursor PER HYPOTHESIS —
    every beam rank j advances through the audio independently and yields
    its own long-form transcript, so the output is an n-best list of
    full-length transcripts (ref: transcribe.py:240, 346-457)
  * segments split at consecutive timestamp-token pairs; a single trailing
    timestamp seeks past the whole window, otherwise seek lands on the
    last timestamp (ref: transcribe.py:263-324)
  * deviation: the fork's empty-segment clearing loop reads a stale
    `segment` variable after the first window (transcribe.py:442-443, an
    upstream bug); here every segment of the current window is cleared.
  * `condition_on_previous_text` (default True like the fork's flag,
    transcribe.py:48): each window's decoded tokens roll into the next
    window's `<|startofprev|>` prompt PER HYPOTHESIS STREAM, with the
    prompt reset after a temperature>0.5 fallback (upstream whisper's
    `all_tokens[prompt_reset_since:]` protocol). NOTE the fork's
    per-hypothesis refactor severed its own rolling feed — its
    `all_tokens` is only ever extended with the initial prompt
    (transcribe.py:204-209) and `prompt_reset_since` is never advanced,
    so the fork's EXECUTED behavior equals `condition_on_previous_text=
    False` here (static initial_prompt replayed into every window). We
    implement the intended/upstream semantics and keep the flag.

Word timestamps (`word_timestamps=True`) run the DTW alignment of
`infer/whisper_timing.py` per decoded window — capability the fork
imports but never wires in (transcribe.py:22).

Counterpart of `dualhyp_tpu/infer/transcribe.py`: the window encode (kernel
K6) and every decode step run on the card (the batched beam of
`infer.whisper_device_beam`; under int4 weights the decoder's linears run
kernel K8); the fallback logic, seek bookkeeping, and segmentation are
host-side python, as in the reference. Sampling draws from numpy
Generators seeded as the JAX package seeds them.

Scheduling (batch_streams=True, the default): each round gathers every
active stream's (seek, rolling prompt) window, dedupes identical ones,
encodes each distinct seek once, and decodes the whole group in ONE
lockstep device beam with RAGGED per-stream prefixes
(device_beam_search_batch) — beam_size streams' t=0 beams collapse into
one batched run per round with per-stream outputs unchanged.
batch_streams=False keeps the sequential one-window-at-a-time sweep as
the differential baseline (tests/test_transcribe_longform.py).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dualhyp_tpu_torch.data.tokenizer import WHISPER_LANGUAGES
from dualhyp_tpu_torch.infer.beam_search import BeamHypothesis, sample_nbest
from dualhyp_tpu_torch.models import whisper as w

HOP_LENGTH = 160
SAMPLE_RATE = 16000
N_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def compression_ratio(text: str) -> float:
    """gzip compressibility of the decoded text — the repetition detector
    (ref: data/whisper/utils.py compression_ratio)."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def detect_language(features, decoder, tokenizer) -> Tuple[str, dict]:
    """Most probable language from the first window's encoder output:
    P(language token | sot) (ref: data/whisper/decoding.py
    detect_language). Returns (code, {code: prob}); falls back to "en"
    when the tokenizer has no language tokens."""
    from dualhyp_tpu_torch.cli.make_json_asr import _token_id

    dec_params, dec_cfg = decoder
    sot = _token_id(tokenizer, "<|startoftranscript|>")
    if sot < 0:
        return "en", {"en": 1.0}
    lang_ids = {}
    for code in WHISPER_LANGUAGES:
        tid = _token_id(tokenizer, f"<|{code}|>")
        if tid >= 0:
            lang_ids[code] = tid
    if not lang_ids:
        return "en", {"en": 1.0}
    logits = w.decode_logits(
        dec_params, dec_cfg, torch.tensor([[sot]], device=features.device), features
    )[0, 0].cpu().numpy()
    mask = np.full_like(logits, -np.inf)
    ids = np.asarray(list(lang_ids.values()))
    mask[ids] = logits[ids]
    e = np.exp(mask - mask.max())
    probs = e / e.sum()
    out = {code: float(probs[tid]) for code, tid in lang_ids.items()}
    best = max(out, key=out.get)
    return best, out


@dataclass
class WindowResult:
    """Per-window decode outcome (the DecodingResult surface transcribe
    consumes, ref: data/whisper/decoding.py:790-821)."""

    hyps: List[BeamHypothesis]  # ranked, len == beam_size
    sample_begin: int
    avg_logprob: float  # best hypothesis
    no_speech_prob: float
    compression_ratio: float
    temperature: float


def decode_windows_with_fallback(
    entries: Sequence[Tuple[object, Sequence[int], int]],
    decoder,
    tokenizer,
    *,
    beam_size: int,
    temperatures: Sequence[float],
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
    max_new_tokens: int = 224,
    language: str = "en",
    patience: Optional[float] = None,
    length_penalty: Optional[float] = None,
    enc_cfg=None,
    seed: int = 0,
    cross_kv_quant=None,
    self_kv_quant=None,
) -> List[Tuple[WindowResult, callable]]:
    """Temperature-escalating decode of a GROUP of encoded windows
    (ref: data/whisper/transcribe.py:157-195 per window). entries:
    (features (1, S, n_state), prompt_tokens, seed_salt) per window —
    the long-form n-best seek streams' windows at one scheduler round.

    The t=0 beam decodes ALL entries in ONE lockstep device beam with
    RAGGED per-entry prefixes (each stream's rolling prompt,
    device_beam_search_batch) and the silence-gate sot forwards batch
    into one right-padded decode_logits call — per-entry results equal
    the one-entry calls (the windows are independent; the ragged-beam
    parity is pinned in tests/test_whisper_decoding_rules.py). Entries
    that fail their thresholds escalate temperature INDIVIDUALLY with
    the same per-(window, temperature) rng streams the sequential
    scheduler used, so fallback outputs are unchanged."""
    from dualhyp_tpu_torch.cli.make_json_asr import (
        CachedWhisperStepper, _beam_setup, _token_id,
    )
    from dualhyp_tpu_torch.infer.whisper_device_beam import (
        device_beam_search_batch,
    )

    dec_params, dec_cfg = decoder
    base_prefix, beam_kwargs, eot, ts_rules = _beam_setup(
        tokenizer, enc_cfg, beam_size=beam_size,
        max_new_tokens=max_new_tokens, language=language,
        suppress_blank=True, suppress_tokens="-1",
        without_timestamps=False, max_initial_timestamp=1.0,
        patience=patience, length_penalty=length_penalty,
    )
    sot_prev = _token_id(tokenizer, "<|startofprev|>")
    sot = _token_id(tokenizer, "<|startoftranscript|>")
    prefixes: List[List[int]] = []
    sot_idx: List[int] = []
    for _, prompt, _ in entries:
        pre = list(base_prefix)
        if prompt:
            # [sot_prev] + prompt tail + sot sequence
            # (ref: decoding.py _get_initial_tokens)
            tail = list(prompt)[-(dec_cfg.n_ctx // 2 - 1):]
            if sot_prev >= 0:
                pre = [sot_prev] + tail + pre
        prefixes.append(pre)
        sot_idx.append(0 if not prompt else pre.index(sot))

    feats_stack = torch.cat([f for f, _, _ in entries], dim=0)

    # the silence gate's sot-position forward is one extra prefill + host
    # sync per window — only pay it when the threshold is active (with
    # no_speech_threshold=None the value is never consulted and segments
    # record 0.0; the fork always computes it, ref: decoding.py:689-694).
    # All entries batch into ONE right-padded forward: right padding sits
    # AFTER each row's sot position, which the causal mask never reads.
    no_speech_id = _token_id(tokenizer, "<|nospeech|>")
    ns_probs = [0.0] * len(entries)
    if no_speech_threshold is not None and no_speech_id is not None \
            and no_speech_id >= 0:
        t_max = max(len(p) for p in prefixes)
        mat = np.zeros((len(entries), t_max), np.int32)
        for u, p in enumerate(prefixes):
            mat[u, :len(p)] = p
        logits = w.decode_logits(
            dec_params, dec_cfg, torch.from_numpy(mat).to(feats_stack.device).long(),
            feats_stack
        ).cpu().numpy()
        for u in range(len(entries)):
            row = logits[u, sot_idx[u]]
            e = np.exp(row - row.max())
            ns_probs[u] = float((e / e.sum())[no_speech_id])

    ts_begin = ts_rules.timestamp_begin if ts_rules is not None else None

    def detok(toks):
        return tokenizer.decode(
            [t for t in toks if t != eot and (ts_begin is None or t < ts_begin)],
            skip_special_tokens=True,
        )

    # one lockstep ragged-prefix beam serves every entry's t=0 decode
    batch_hyps = None
    if any(t == 0 for t in temperatures):
        batch_hyps = device_beam_search_batch(
            dec_params, dec_cfg, feats_stack, prefixes,
            cross_kv_quant=cross_kv_quant, self_kv_quant=self_kv_quant,
            **beam_kwargs
        )

    out: List[Tuple[WindowResult, callable]] = []
    for u, (features, _, seed_salt) in enumerate(entries):
        prefix = prefixes[u]
        result = None
        for t_idx, t in enumerate(temperatures):
            if t == 0:
                hyps = batch_hyps[u][:beam_size]
            else:
                # same n_ctx length cap the beam applies (ref:
                # data/whisper/decoding.py:746): long rolling prompts
                # plus the full budget must not walk past the
                # positional-embedding table
                new_cap = min(
                    max_new_tokens, dec_cfg.n_ctx - len(prefix) + 1
                )
                stepper = CachedWhisperStepper(
                    dec_params, dec_cfg, features,
                    len(prefix) + new_cap,
                )
                hyps = sample_nbest(
                    stepper, prefix,
                    n_samples=beam_size, temperature=t, eos_id=eot,
                    max_new_tokens=new_cap,
                    suppress_tokens=beam_kwargs["suppress_tokens"],
                    suppress_blank_ids=beam_kwargs["suppress_blank_ids"],
                    timestamp_rules=ts_rules,
                    length_penalty=length_penalty,
                    # distinct stream per (window, fallback temperature)
                    # so retries are not gumbel-correlated (the fork's
                    # generator advances between decodes)
                    rng=np.random.default_rng([seed, seed_salt, t_idx]),
                )
            hyps = list(hyps)
            while len(hyps) < beam_size:  # degenerate tiny-vocab edge
                hyps.append(hyps[-1])
            best = hyps[0]
            text = detok(best.tokens[best.sample_begin:])
            result = WindowResult(
                hyps=hyps,
                sample_begin=len(prefix),
                avg_logprob=best.avg_logprob,
                no_speech_prob=ns_probs[u],
                compression_ratio=compression_ratio(text),
                temperature=t,
            )
            needs_fallback = False
            if (
                compression_ratio_threshold is not None
                and result.compression_ratio > compression_ratio_threshold
            ):
                needs_fallback = True  # too repetitive
            if (
                logprob_threshold is not None
                and result.avg_logprob < logprob_threshold
            ):
                needs_fallback = True  # low confidence
            if (
                no_speech_threshold is not None
                and result.no_speech_prob > no_speech_threshold
            ):
                needs_fallback = False  # silence
            if not needs_fallback:
                break
        out.append((result, detok))
    return out


def decode_window_with_fallback(
    features,
    decoder,
    tokenizer,
    *,
    initial_prompt_tokens: Sequence[int] = (),
    seed_salt: int = 0,
    **kwargs,
) -> Tuple[WindowResult, callable]:
    """One-window wrapper over `decode_windows_with_fallback`
    (ref: data/whisper/transcribe.py:157-195)."""
    feats = features if features.dim() == 3 else features[None]
    return decode_windows_with_fallback(
        [(feats, list(initial_prompt_tokens), seed_salt)],
        decoder, tokenizer, **kwargs,
    )[0]


def _split_segments(
    sampled: List[int],
    *,
    ts_begin: Optional[int],
    seek: int,
    time_precision: float,
    segment_size: int,
    segment_duration: float,
    input_stride: int,
    new_segment,
) -> Tuple[List[dict], int]:
    """Split one hypothesis's sampled tokens into timed segments and
    compute the seek advance (ref: data/whisper/transcribe.py:263-324)."""
    time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
    if ts_begin is None:
        return (
            [new_segment(
                start=time_offset, end=time_offset + segment_duration,
                tokens=list(sampled),
            )],
            segment_size,
        )

    is_ts = [t >= ts_begin for t in sampled]
    single_timestamp_ending = is_ts[-2:] == [False, True]
    consecutive = [
        i + 1 for i in range(len(sampled) - 1) if is_ts[i] and is_ts[i + 1]
    ]

    segments: List[dict] = []
    if consecutive:
        slices = list(consecutive)
        if single_timestamp_ending:
            slices.append(len(sampled))
        last_slice = 0
        for current_slice in slices:
            sliced = sampled[last_slice:current_slice]
            start_pos = sliced[0] - ts_begin
            end_pos = sliced[-1] - ts_begin
            segments.append(new_segment(
                start=time_offset + start_pos * time_precision,
                end=time_offset + end_pos * time_precision,
                tokens=sliced,
            ))
            last_slice = current_slice
        if single_timestamp_ending:
            seek_inc = segment_size
        else:
            last_ts_pos = sampled[last_slice - 1] - ts_begin
            seek_inc = last_ts_pos * input_stride
    else:
        duration = segment_duration
        timestamps = [t for t in sampled if t >= ts_begin]
        if timestamps and timestamps[-1] != ts_begin:
            duration = (timestamps[-1] - ts_begin) * time_precision
        segments.append(new_segment(
            start=time_offset, end=time_offset + duration,
            tokens=list(sampled),
        ))
        seek_inc = segment_size
    return segments, seek_inc


def transcribe(
    audio: np.ndarray,
    encoder,
    decoder,
    tokenizer,
    *,
    language: Optional[str] = "en",
    beam_size: int = 5,
    temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    max_new_tokens: int = 224,
    patience: Optional[float] = None,
    length_penalty: Optional[float] = None,
    word_timestamps: bool = False,
    alignment_heads=None,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    seed: int = 0,
    batch_streams: bool = True,
    cross_kv_quant=None,
    self_kv_quant=None,
) -> List[dict]:
    """audio: float32 16 kHz waveform of any length. language=None
    detects it from the first window
    (ref: data/whisper/transcribe.py:129-143). Returns one dict per
    hypothesis rank: {"text", "segments", "language"}
    (ref: data/whisper/transcribe.py:451-457)."""
    from dualhyp_tpu_torch.cli.make_json_asr import _token_id

    enc_params, enc_cfg = encoder
    dec_params, dec_cfg = decoder
    # the encode in the encoder's dtype, the features handed to the decoder
    # in its dtype (the first float leaf: a quantized decoder keeps its
    # embeddings in it)
    enc_dtype = w.params_dtype(enc_params)
    dec_dtype = w.params_dtype(dec_params)
    device = dec_params["token_embedding"].device

    def on_card(mels):
        return torch.from_numpy(np.ascontiguousarray(mels, np.float32)).to(device)

    temperatures = (
        [temperature] if isinstance(temperature, (int, float)) else list(temperature)
    )

    # mel over the whole recording + 30s silence (ref: transcribe.py:126)
    padded = np.concatenate(
        [np.asarray(audio, np.float32), np.zeros(N_SAMPLES, np.float32)]
    )
    mel = w.log_mel_spectrogram(padded, enc_cfg.n_mels)
    content_frames = mel.shape[-1] - N_FRAMES

    if language is None:
        first_mel = w.pad_or_trim(mel[:, :N_FRAMES], N_FRAMES)
        first_feats = w.encode(
            enc_params, enc_cfg, on_card(first_mel[None]),
            compute_dtype=enc_dtype,
        )
        language, _ = detect_language(
            first_feats.to(dec_dtype), decoder, tokenizer
        )

    input_stride = N_FRAMES // enc_cfg.n_ctx  # mel frames per token: 2
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s

    if initial_prompt is not None:
        try:
            initial_prompt_tokens = tokenizer.encode(
                " " + initial_prompt.strip(), add_special_tokens=False
            )
        except TypeError:
            initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
    else:
        initial_prompt_tokens = []

    eot = _token_id(tokenizer, "<|endoftext|>")
    ts_begin_id = _token_id(tokenizer, "<|0.00|>")
    ts_begin = ts_begin_id if ts_begin_id >= 0 else None
    no_ts = _token_id(tokenizer, "<|notimestamps|>")

    # the n-best seek streams sweep the SAME audio with different rolling
    # prompts: windows at equal seeks share their mel, so the encode is
    # memoized per seek (one entry — streams advance near-lockstep, and a
    # single window's features are ~15 MB at large-v3)
    feature_cache: dict = {}

    def encode_window(seek):
        if feature_cache.get("seek") != seek:
            mel_segment = w.pad_or_trim(mel[:, seek:seek + N_FRAMES], N_FRAMES)
            feature_cache["seek"] = seek
            feature_cache["features"] = w.encode(
                enc_params, enc_cfg, on_card(mel_segment[None]),
                compute_dtype=enc_dtype,
            ).to(dec_dtype)
        return feature_cache["features"]

    def encode_windows(seeks):
        """Encode a round's distinct seeks in ONE batched call (padded
        to a power of two, as the JAX package pads them, so both encode
        the same batches). The batched scheduler's rounds carry up to
        beam_size distinct seeks once the n-best streams diverge.
        Returns {seek: (1, S, d)}."""
        seeks = sorted(set(seeks))
        if len(seeks) == 1:
            return {seeks[0]: encode_window(seeks[0])}
        mels = np.stack([
            w.pad_or_trim(mel[:, s:s + N_FRAMES], N_FRAMES) for s in seeks
        ])
        n = 1
        while n < len(seeks):
            n *= 2
        if n > len(seeks):
            mels = np.concatenate(
                [mels, np.repeat(mels[-1:], n - len(seeks), axis=0)]
            )
        feats = w.encode(
            enc_params, enc_cfg, on_card(mels), compute_dtype=enc_dtype
        ).to(dec_dtype)
        return {s: feats[i:i + 1] for i, s in enumerate(seeks)}

    shared_decode_kwargs = dict(
        beam_size=beam_size, temperatures=temperatures,
        compression_ratio_threshold=compression_ratio_threshold,
        logprob_threshold=logprob_threshold,
        no_speech_threshold=no_speech_threshold,
        max_new_tokens=max_new_tokens, language=language,
        patience=patience, length_penalty=length_penalty,
        enc_cfg=enc_cfg, seed=seed,
        # int8 KV caches for the window beams (opt-in like the offline
        # CLIs: outputs may shift within quantization rounding)
        cross_kv_quant=cross_kv_quant, self_kv_quant=self_kv_quant,
    )

    def decode_window(seek, prompt_tokens):
        features = encode_window(seek)
        result, detok = decode_windows_with_fallback(
            [(features, list(prompt_tokens), seek)], decoder, tokenizer,
            **shared_decode_kwargs,
        )[0]
        return result, detok, features

    def should_skip(result):
        if no_speech_threshold is None:
            return False
        skip = result.no_speech_prob > no_speech_threshold
        if (
            logprob_threshold is not None
            and result.avg_logprob > logprob_threshold
        ):
            skip = False  # confident despite no_speech (transcribe.py:245-250)
        return skip

    def make_new_segment(seek, result, detok):
        def new_segment(*, start, end, tokens):
            text_tokens = [t for t in tokens if t < eot or (eot < 0)]
            return {
                "seek": seek,
                "start": start,
                "end": end,
                "text": detok(text_tokens),
                "tokens": list(tokens),
                "temperature": result.temperature,
                "avg_logprob": result.avg_logprob,
                "compression_ratio": result.compression_ratio,
                "no_speech_prob": result.no_speech_prob,
            }
        return new_segment

    def clear_degenerate(segments):
        """Instantaneous or text-free segments are blanked
        (ref: transcribe.py:332-338)."""
        for segment in segments:
            if segment["start"] == segment["end"] or not segment["text"].strip():
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []

    timing_kwargs = dict(
        sot_sequence=[], no_timestamps_id=no_ts, eot_id=eot,
        language=language, alignment_heads=alignment_heads,
        prepend_punctuations=prepend_punctuations,
        append_punctuations=append_punctuations,
    )

    def attach_words(segments, features, segment_size, result, detok,
                     last_ts):
        if not (word_timestamps and segments):
            return last_ts
        from dualhyp_tpu_torch.infer import whisper_timing

        kw = dict(timing_kwargs)
        # the alignment prefix is the decode prefix (the sot sequence)
        kw["sot_sequence"] = result.hyps[0].tokens[: result.sample_begin]
        if kw["no_timestamps_id"] is not None and kw["no_timestamps_id"] < 0:
            kw["no_timestamps_id"] = eot  # degrade: no marker token
        return whisper_timing.add_word_timestamps(
            segments=segments, dec_params=dec_params, dec_cfg=dec_cfg,
            features=features, num_frames=segment_size,
            decode_fn=lambda toks: tokenizer.decode(toks),
            last_speech_timestamp=last_ts, **kw,
        )

    n_hyps = beam_size
    segments_per_hyp: List[List[dict]] = [[] for _ in range(n_hyps)]
    tokens_per_hyp: List[List[int]] = [[] for _ in range(n_hyps)]
    last_ts_per_hyp = [0.0] * n_hyps
    # rolling per-hypothesis prompt conditioning (upstream whisper's
    # all_tokens[prompt_reset_since:] protocol; the fork declares it at
    # transcribe.py:48 but its refactor never extends all_tokens)
    all_tokens_per_hyp = [list(initial_prompt_tokens) for _ in range(n_hyps)]
    prompt_reset_per_hyp = [0] * n_hyps

    def window_prompt(j):
        if condition_on_previous_text:
            return all_tokens_per_hyp[j][prompt_reset_per_hyp[j]:]
        # flag off == the fork's executed behavior: the static initial
        # prompt replays into every window
        return initial_prompt_tokens

    def roll_prompt(j, segs, result):
        all_tokens_per_hyp[j].extend(
            t for seg in segs for t in seg["tokens"]
        )
        if result.temperature > 0.5:
            # unreliable window: don't condition the next one on it
            # (upstream transcribe's prompt_reset_since advance)
            prompt_reset_per_hyp[j] = len(all_tokens_per_hyp[j])

    # first window decoded once, consumed by every hypothesis stream
    # (ref: transcribe.py:230-344)
    seeks = [0] * n_hyps
    if content_frames > 0:
        first, detok, first_features = decode_window(0, initial_prompt_tokens)
        segment_size0 = min(N_FRAMES, content_frames)
        if should_skip(first):
            seeks = [segment_size0] * n_hyps
        else:
            new_seg = make_new_segment(0, first, detok)
            for j in range(n_hyps):
                hyp = first.hyps[j]
                segs, inc = _split_segments(
                    hyp.tokens[hyp.sample_begin:], ts_begin=ts_begin, seek=0,
                    time_precision=time_precision, segment_size=segment_size0,
                    segment_duration=segment_size0 * HOP_LENGTH / SAMPLE_RATE,
                    input_stride=input_stride, new_segment=new_seg,
                )
                last_ts_per_hyp[j] = attach_words(
                    segs, first_features, segment_size0, first, detok,
                    last_ts_per_hyp[j],
                )
                clear_degenerate(segs)
                segments_per_hyp[j].extend(segs)
                tokens_per_hyp[j].extend(
                    t for seg in segs for t in seg["tokens"]
                )
                roll_prompt(j, segs, first)
                seeks[j] += inc

    # per-hypothesis sliding windows (ref: transcribe.py:346-449). Each
    # stream's window sequence depends only on its own (seek, prompt), so
    # per-stream results are order-independent.

    def consume(j, seek, result, detok, features):
        """Apply one window result to stream j; returns its next seek."""
        segment_size = min(N_FRAMES, content_frames - seek)
        if should_skip(result):
            return seek + segment_size
        hyp = result.hyps[j]
        segs, inc = _split_segments(
            hyp.tokens[hyp.sample_begin:], ts_begin=ts_begin, seek=seek,
            time_precision=time_precision, segment_size=segment_size,
            segment_duration=segment_size * HOP_LENGTH / SAMPLE_RATE,
            input_stride=input_stride,
            new_segment=make_new_segment(seek, result, detok),
        )
        last_ts_per_hyp[j] = attach_words(
            segs, features, segment_size, result, detok, last_ts_per_hyp[j]
        )
        clear_degenerate(segs)
        segments_per_hyp[j].extend(segs)
        tokens_per_hyp[j].extend(t for seg in segs for t in seg["tokens"])
        roll_prompt(j, segs, result)
        return seek + max(inc, 1)  # guard: zero advance would loop forever

    if batch_streams:
        # BATCHED scheduler: each round gathers every still-active
        # stream's (seek, rolling prompt) window, dedupes identical ones
        # (streams with equal seek AND prompt decode identical windows —
        # the sequential sweep's per-stream rng ignores the stream index,
        # so its duplicate decodes were identical too), encodes each
        # distinct seek once, and decodes the whole group in ONE lockstep
        # ragged-prefix device beam. Per-stream outputs are unchanged;
        # the beam runs once a round instead of once a stream-window.
        while True:
            groups: dict = {}
            for j in range(n_hyps):
                if seeks[j] < content_frames:
                    key = (seeks[j], tuple(window_prompt(j)))
                    groups.setdefault(key, []).append(j)
            if not groups:
                break
            keys = sorted(groups)  # seek-ascending, deterministic order
            feats_by_seek = encode_windows([seek for seek, _ in keys])
            entries = [
                (feats_by_seek[seek], list(prompt), seek)
                for seek, prompt in keys
            ]
            outs = decode_windows_with_fallback(
                entries, decoder, tokenizer, **shared_decode_kwargs
            )
            for key, entry, (result, detok) in zip(keys, entries, outs):
                for j in groups[key]:
                    seeks[j] = consume(
                        j, key[0], result, detok, entry[0]
                    )
    else:
        # sequential reference scheduler: one stream-window at a time in
        # GLOBAL seek order (streams at the same seek decode
        # consecutively so the encode memo serves them); kept as the
        # differential baseline for the batched path.
        import heapq

        work = [
            (seeks[j], j) for j in range(n_hyps)
            if seeks[j] < content_frames
        ]
        heapq.heapify(work)
        while work:
            seek, j = heapq.heappop(work)
            result, detok, features = decode_window(seek, window_prompt(j))
            seek = consume(j, seek, result, detok, features)
            if seek < content_frames:
                heapq.heappush(work, (seek, j))

    detok_final = lambda toks: tokenizer.decode(
        [t for t in toks if t != eot and (ts_begin is None or t < ts_begin)],
        skip_special_tokens=True,
    )
    return [
        dict(
            text=detok_final(tokens_per_hyp[j]),
            segments=segments_per_hyp[j],
            language=language,
        )
        for j in range(n_hyps)
    ]
