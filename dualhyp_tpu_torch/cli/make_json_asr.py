"""Offline ASR n-best hypothesis generation (Whisper beam search).

Counterpart of `dualhyp_tpu/cli/make_json_asr.py` (ref: data/make_json_asr.py):
for each utterance of a manifest, mix recorded noise at a sampled SNR over a
beta(2, 2) chunk (or the whole utterance), pad or trim to 30 s, log-mel on
the host, the Whisper encoder on the card (kernel K6), then a batched beam
search on the card returning every beam (`infer.whisper_device_beam`; with
`quantize: int4` the decoder's linears run kernel K8), normalise and dedupe
into the top-5 n-best (padded by repetition), and append a JSON record
carrying the corruption metadata:

  {Uid, Caption, Clean_Wav, Noise_Wav, SNR, nhyps{hyps,scores},
   Audio_Corruption{total_len,start_fr,occ_len,snr}, WER_1st-hyp}

--shard_index/--num_shards sharding, `resume` skip-by-Uid, dumps every
`dump_every` utterances, and the per-sample skip of a data fault, as the JAX
package has them.

  python -m dualhyp_tpu_torch.cli.make_json_asr --config conf/asr_config.yaml

The checkpoint's dtype sets the compute dtype: an fp32 file computes in
fp32, an fp16 or bf16 file in bf16 (K6 and K8 take bf16 on the card).
`load_whisper` is also the RelPrompt feature loaders' encoder reader.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.ckpt.convert import decoder_from_jax, encoder_from_jax
from dualhyp_tpu_torch.ckpt.io import load_safetensors
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.infer.beam_search import (TimestampRules, beam_search_nbest,
                                                 nbest_texts, non_speech_token_ids)
from dualhyp_tpu_torch.infer.whisper_device_beam import (device_beam_search,
                                                         device_beam_search_batch)
from dualhyp_tpu_torch.models import whisper as w


def checkpoint_dtype(tensors: dict) -> torch.dtype:
    """The compute dtype of a checkpoint's tensors: fp32 when every float
    tensor is fp32, else bf16 (an fp16 or bf16 file)."""
    floats = {t.dtype for t in tensors.values() if t.is_floating_point()}
    return torch.float32 if floats <= {torch.float32} else torch.bfloat16


def load_whisper(checkpoint_dir, need_tokenizer=False, need_decoder=False, *,
                 device=None, dtype=torch.float32):
    """HF whisper directory (`config.json` + `*.safetensors`, and
    `tokenizer.json` for the tokenizer) -> ((encoder params, encoder
    config), (decoder params, decoder config) or None, tokenizer or None),
    the JAX package's return shape; the decoder and the tokenizer are read
    only when asked for. The weights are read by `ckpt.io.load_safetensors`
    (F32, F16 or BF16 on disk) and put on `device` (the card when None) in
    `dtype`; dtype None takes `checkpoint_dtype` of the file. The tokenizer
    is `data.tokenizer.WhisperTokenizer` over `tokenizer.json`."""
    from dualhyp_tpu_torch.data.tokenizer import WhisperTokenizer

    device = resolve_device(device)
    checkpoint_dir = Path(checkpoint_dir)
    tensors = {}
    for shard in sorted(checkpoint_dir.glob("*.safetensors")):
        tensors.update(load_safetensors(shard))
    if not tensors:
        raise FileNotFoundError(f"no *.safetensors under {checkpoint_dir}")
    if dtype is None:
        dtype = checkpoint_dtype(tensors)
    with open(checkpoint_dir / "config.json", encoding="utf-8") as fp:
        hf_cfg = json.load(fp)
    enc_cfg = w.WhisperEncoderConfig(
        n_mels=hf_cfg["num_mel_bins"],
        n_ctx=hf_cfg["max_source_positions"],
        n_state=hf_cfg["d_model"],
        n_head=hf_cfg["encoder_attention_heads"],
        n_layer=hf_cfg["encoder_layers"],
    )
    enc = encoder_from_jax(w.convert_hf_whisper_encoder(tensors, enc_cfg), device=device,
                           dtype=dtype)
    decoder = None
    if need_decoder:
        dec_cfg = w.WhisperDecoderConfig(
            n_vocab=hf_cfg["vocab_size"],
            n_ctx=hf_cfg["max_target_positions"],
            n_state=hf_cfg["d_model"],
            n_head=hf_cfg["decoder_attention_heads"],
            n_layer=hf_cfg["decoder_layers"],
        )
        decoder = (decoder_from_jax(w.convert_hf_whisper_decoder(tensors, dec_cfg),
                                    device=device, dtype=dtype), dec_cfg)
    tokenizer = WhisperTokenizer(checkpoint_dir) if need_tokenizer else None
    return (enc, enc_cfg), decoder, tokenizer


def _encode_features(enc_params, enc_cfg, mels):
    """The encoder forward in the parameters' dtype."""
    return w.encode(enc_params, enc_cfg, mels, compute_dtype=w.params_dtype(enc_params))


class CachedWhisperStepper:
    """KV-cached logits_fn for `beam_search_nbest` and `sample_nbest`: one
    utterance's features, rows matched to their parents by prefix each call
    (the rows are extensions of the last call's), the cache's rows gathered
    to them and one cached decoder step run. Returns the logits on the host."""

    def __init__(self, dec_params, dec_cfg, features, max_total: int):
        self.dec_params = dec_params
        self.dec_cfg = dec_cfg
        self.device = features.device
        self.cross = w.precompute_cross_kv(dec_params, dec_cfg, features)
        self.max_total = max_total
        self.cache = None
        self.prefix_to_row = {}

    def __call__(self, tokens):
        tokens = np.asarray(tokens)
        b, t = tokens.shape

        def step(col, pos):
            toks = torch.from_numpy(np.ascontiguousarray(col, np.int64)).to(self.device)
            return w.decode_step_cached(self.dec_params, self.dec_cfg, toks, pos,
                                        self.cache, self.cross)

        if self.cache is None:  # prefill: the shared prefix, token by token
            self.cache = w.init_self_cache(self.dec_cfg, b, self.max_total,
                                           dtype=self.dec_params["token_embedding"].dtype,
                                           device=self.device)
            for pos in range(t):
                logits = step(tokens[:, pos], pos)
        else:
            parents = torch.tensor([self.prefix_to_row[tuple(row[:-1])] for row in tokens],
                                   device=self.device)
            self.cache = {k: v.index_select(1, parents) for k, v in self.cache.items()}
            logits = step(tokens[:, -1], t - 1)
        self.prefix_to_row = {tuple(row): i for i, row in enumerate(tokens.tolist())}
        return logits.cpu().numpy()


def _token_id(tokenizer, token):
    t = tokenizer.convert_tokens_to_ids(token)
    if t is None:
        return -1
    unk = getattr(tokenizer, "unk_token_id", None)
    if unk is not None and t == unk and token != getattr(tokenizer, "unk_token", ""):
        return -1
    return t


def build_logit_rules(tokenizer, prefix_len, *, eot, no_ts, enc_n_ctx,
                      suppress_blank=True, suppress_tokens="-1",
                      without_timestamps=False, max_initial_timestamp=1.0):
    """DecodingTask logit rule set (ref: data/whisper/decoding.py:594-610,
    656-693). Returns (suppress_ids, blank_ids, timestamp_rules); rules
    whose token ids the tokenizer lacks degrade to None (tiny test
    tokenizers)."""
    encode_fn = None
    if hasattr(tokenizer, "encode"):
        def encode_fn(text):
            try:
                return tokenizer.encode(text, add_special_tokens=False)
            except TypeError:
                return tokenizer.encode(text)

    blank_ids = None
    if suppress_blank and encode_fn is not None:
        blank_ids = list(encode_fn(" ")) + [eot]

    suppress = None
    if suppress_tokens:
        if isinstance(suppress_tokens, str):
            suppress_tokens = [int(t) for t in suppress_tokens.split(",")]
        suppress_tokens = list(suppress_tokens)
        if -1 in suppress_tokens:
            suppress_tokens = [t for t in suppress_tokens if t >= 0]
            if encode_fn is not None:
                suppress_tokens.extend(non_speech_token_ids(encode_fn))
        for token in ("<|transcribe|>", "<|translate|>", "<|startoftranscript|>",
                      "<|startofprev|>", "<|startoflm|>", "<|nospeech|>"):
            tid = _token_id(tokenizer, token)
            if tid >= 0:
                suppress_tokens.append(tid)
        suppress = sorted(set(suppress_tokens)) or None

    ts_rules = None
    if not without_timestamps:
        ts_begin = _token_id(tokenizer, "<|0.00|>")
        if ts_begin >= 0:
            precision = 30.0 / enc_n_ctx  # CHUNK_LENGTH / n_audio_ctx
            max_idx = (round(max_initial_timestamp / precision)
                       if max_initial_timestamp is not None else None)
            ts_rules = TimestampRules(timestamp_begin=ts_begin, eot=eot,
                                      no_timestamps=no_ts if no_ts >= 0 else None,
                                      max_initial_timestamp_index=max_idx)
    return suppress, blank_ids, ts_rules


def _beam_setup(tokenizer, enc_cfg, *, beam_size, max_new_tokens, language,
                suppress_blank, suppress_tokens, without_timestamps,
                max_initial_timestamp, patience, length_penalty):
    """The sot sequence and the logit rules of the beam decoders
    (ref: data/whisper/decoding.py:556-610)."""
    sot = _token_id(tokenizer, "<|startoftranscript|>")
    lang = _token_id(tokenizer, f"<|{language}|>")
    task = _token_id(tokenizer, "<|transcribe|>")
    no_ts = _token_id(tokenizer, "<|notimestamps|>")
    eot = _token_id(tokenizer, "<|endoftext|>")
    sot_seq = (sot, lang, task, no_ts) if without_timestamps else (sot, lang, task)
    prefix = [t for t in sot_seq if t >= 0]

    suppress, blank_ids, ts_rules = build_logit_rules(
        tokenizer, len(prefix), eot=eot, no_ts=no_ts, enc_n_ctx=enc_cfg.n_ctx,
        suppress_blank=suppress_blank, suppress_tokens=suppress_tokens,
        without_timestamps=without_timestamps, max_initial_timestamp=max_initial_timestamp,
    )
    beam_kwargs = dict(beam_size=beam_size, eos_id=eot, max_new_tokens=max_new_tokens,
                       suppress_tokens=suppress, suppress_blank_ids=blank_ids,
                       timestamp_rules=ts_rules, patience=patience,
                       length_penalty=length_penalty)
    return prefix, beam_kwargs, eot, ts_rules


def _detokenizer(tokenizer, eot, ts_rules):
    ts_begin = ts_rules.timestamp_begin if ts_rules is not None else None
    return lambda toks: tokenizer.decode(
        [t for t in toks if t != eot and (ts_begin is None or t < ts_begin)],
        skip_special_tokens=True)


def decode_beams_from_mels(mels, encoder, decoder, tokenizer, *, beam_size=50,
                           max_new_tokens=224, language="en",
                           suppress_blank=True, suppress_tokens="-1",
                           without_timestamps=False, max_initial_timestamp=1.0,
                           patience=None, length_penalty=None,
                           cross_kv_quant=None, self_kv_quant=None):
    """The batched DecodingTask beam over U mels (numpy (U, n_mels, 3000))
    in lockstep, (U x beam)-row steps on the card. Returns (one hypothesis
    list an utterance, prefix, detokenize)."""
    enc_params, enc_cfg = encoder
    dec_params, dec_cfg = decoder
    device = dec_params["token_embedding"].device
    features = _encode_features(enc_params, enc_cfg,
                                torch.from_numpy(np.asarray(mels, np.float32)).to(device))
    prefix, beam_kwargs, eot, ts_rules = _beam_setup(
        tokenizer, enc_cfg, beam_size=beam_size, max_new_tokens=max_new_tokens,
        language=language, suppress_blank=suppress_blank, suppress_tokens=suppress_tokens,
        without_timestamps=without_timestamps, max_initial_timestamp=max_initial_timestamp,
        patience=patience, length_penalty=length_penalty,
    )
    all_hyps = device_beam_search_batch(
        dec_params, dec_cfg, features.to(w.params_dtype(dec_params)), prefix,
        cross_kv_quant=cross_kv_quant, self_kv_quant=self_kv_quant, **beam_kwargs)
    return all_hyps, prefix, _detokenizer(tokenizer, eot, ts_rules)


def decode_beams_from_mel(mel, encoder, decoder, tokenizer, *, beam_size=50,
                          max_new_tokens=224, language="en", use_cache=True,
                          suppress_blank=True, suppress_tokens="-1",
                          without_timestamps=False, max_initial_timestamp=1.0,
                          patience=None, length_penalty=None, stepper="device",
                          cross_kv_quant=None, self_kv_quant=None):
    """The DecodingTask beam over one mel: (hyps, prefix, detokenize), every
    beam, ranked (ref: data/whisper/decoding.py:556-821). stepper "device"
    runs the beam on the card; "cached" and "full" run `beam_search_nbest`
    on the host over a cached step or the full forward. Defaults are the
    reference's DecodingOptions (blank and non-speech suppression, timestamps,
    sample_len 224)."""
    enc_params, enc_cfg = encoder
    dec_params, dec_cfg = decoder
    device = dec_params["token_embedding"].device
    features = _encode_features(enc_params, enc_cfg,
                                torch.from_numpy(np.asarray(mel, np.float32)[None]).to(device))
    features = features.to(w.params_dtype(dec_params))
    prefix, beam_kwargs, eot, ts_rules = _beam_setup(
        tokenizer, enc_cfg, beam_size=beam_size, max_new_tokens=max_new_tokens,
        language=language, suppress_blank=suppress_blank, suppress_tokens=suppress_tokens,
        without_timestamps=without_timestamps, max_initial_timestamp=max_initial_timestamp,
        patience=patience, length_penalty=length_penalty,
    )
    if not use_cache and stepper == "device":
        stepper = "full"
    if stepper != "device" and (cross_kv_quant or self_kv_quant):
        raise ValueError("cross_kv_quant/self_kv_quant require the device stepper "
                         f"(got stepper={stepper!r})")
    if stepper == "device":
        hyps = device_beam_search(dec_params, dec_cfg, features, prefix,
                                  cross_kv_quant=cross_kv_quant,
                                  self_kv_quant=self_kv_quant, **beam_kwargs)
    else:
        if use_cache and stepper != "full":
            logits_fn = CachedWhisperStepper(dec_params, dec_cfg, features,
                                             len(prefix) + max_new_tokens)
        else:
            def logits_fn(tokens):
                toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)
                feats = features.expand(toks.shape[0], *features.shape[1:])
                return w.decode_logits(dec_params, dec_cfg, toks, feats)[:, -1].cpu().numpy()
        hyps = beam_search_nbest(logits_fn, prefix, **beam_kwargs)
    return hyps, prefix, _detokenizer(tokenizer, eot, ts_rules)


def transcribe_nbest(audio, encoder, decoder, tokenizer, *, n_best=5, normalizer=None,
                     **opts):
    """One utterance -> (texts, scores). audio: float32 16 kHz waveform."""
    mel = w.log_mel_spectrogram(w.pad_or_trim(audio), encoder[1].n_mels)
    hyps, prefix, detok = decode_beams_from_mel(mel, encoder, decoder, tokenizer, **opts)
    return nbest_texts(hyps, detok, n=n_best, normalizer=normalizer, prefix_len=len(prefix))


def transcribe_nbest_batch(audios, encoder, decoder, tokenizer, *, n_best=5,
                           normalizer=None, stepper="device", mels=None, **opts):
    """U utterances -> a list of (texts, scores), decoded in one lockstep
    batched beam; each as `transcribe_nbest` gives it. `mels`: the log-mels
    when the caller has them (make_json's producer thread)."""
    del stepper  # the batched path runs on the card only
    if mels is None:
        mels = [w.log_mel_spectrogram(w.pad_or_trim(a), encoder[1].n_mels) for a in audios]
    all_hyps, prefix, detok = decode_beams_from_mels(np.stack(list(mels)), encoder, decoder,
                                                     tokenizer, **opts)
    return [nbest_texts(hyps, detok, n=n_best, normalizer=normalizer, prefix_len=len(prefix))
            for hyps in all_hyps]


def make_json(cfg: dict, shard_index=0, num_shards=1, *, device=None):
    """The generator over cfg's manifest (lines `<uid>\\t<wav>\\t<caption>`),
    writing cfg["output_file"] and returning its records. device: where it
    runs (the card when None)."""
    from dualhyp_tpu_torch.data import corruption
    from dualhyp_tpu_torch.data.normalizer import HypothesisNormalizer
    from dualhyp_tpu_torch.infer.evaluate import word_error_rate
    from dualhyp_tpu_torch.utils.prefetch import prefetch

    # the reference normalize(): the whisper normalizer, digits -> words and
    # '%' -> ' percent' (ref: data/make_json_asr.py:244-252)
    normalizer = HypothesisNormalizer()
    encoder, decoder, tokenizer = load_whisper(cfg["model_checkpoint"], need_tokenizer=True,
                                               need_decoder=True, device=device, dtype=None)
    if cfg.get("quantize"):
        # int8/int4 decoder weights (ref: ger/utils.py:40-92); int4 runs K8
        from dualhyp_tpu_torch.ops import quant

        decoder = (quant.quantize_tree(decoder[0], cfg["quantize"]), decoder[1])

    manifest = Path(cfg["manifest"])
    out_path = Path(cfg["output_file"])
    if num_shards > 1:
        out_path = out_path.with_name(out_path.stem + f"_{shard_index:02d}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)

    records = []
    done_uids = set()
    if cfg.get("resume") and out_path.is_file():
        with open(out_path, encoding="utf-8") as fp:
            records = json.load(fp)
        done_uids = {r["Uid"] for r in records}
        print(f"resume: skipping {len(done_uids)} uids")

    with open(manifest, encoding="utf-8") as fp:
        lines = [l.strip() for l in fp if l.strip()]
    lines = lines[shard_index::num_shards]

    rng = np.random.default_rng(cfg.get("seed", 0) + shard_index)
    noise_path = cfg.get("noise_wav")
    noise = corruption.load_wav(noise_path) if noise_path else None
    dump_every = int(cfg.get("dump_every", 50))
    decode_batch = int(cfg.get("decode_batch", 8))
    beam_opts = dict(
        beam_size=int(cfg.get("beam_size", 50)),
        n_best=int(cfg.get("n_best", 5)),
        normalizer=normalizer,
        patience=cfg.get("patience"),
        length_penalty=cfg.get("length_penalty"),
        without_timestamps=bool(cfg.get("without_timestamps", False)),
        # DecodingOptions.sample_len (ref: data/whisper/decoding.py:97)
        max_new_tokens=int(cfg.get("max_new_tokens", 224)),
        cross_kv_quant=cfg.get("cross_kv_quant"),
        self_kv_quant=cfg.get("self_kv_quant"),
    )

    def emit(uid, wav_path, caption, corr, texts, scores):
        if not texts:
            return
        # the reference stores the normalized caption
        caption_norm = normalizer(caption)
        records.append({
            "Dataset": cfg.get("dataset_name", ""),
            "Uid": uid,
            "Caption": caption_norm,
            "Clean_Wav": wav_path,
            "Noise_Wav": noise_path,
            "SNR": corr["snr"],
            "nhyps": {"hyps": texts, "scores": scores},
            "Audio_Corruption": corr,
            "WER_1st-hyp": word_error_rate([texts[0]], [caption_norm]),
        })

    def flush(pending):
        """Decode a group of loaded utterances; if the batched beam fails,
        retry them one at a time, and skip one that fails alone (per-sample
        skip, ref: make_json_asr.py:112-116)."""
        if pending:
            try:
                results = transcribe_nbest_batch(
                    [p[3] for p in pending], encoder, decoder, tokenizer,
                    mels=[p[4] for p in pending], **beam_opts)
                for (uid, wav_path, caption, _, _, corr), (texts, scores) in zip(
                        pending, results):
                    emit(uid, wav_path, caption, corr, texts, scores)
                return
            except Exception as exc:
                print(f"batched decode failed ({type(exc).__name__}: {exc}); "
                      f"retrying per utterance")
        for uid, wav_path, caption, audio, _, corr in pending:
            try:
                texts, scores = transcribe_nbest(audio, encoder, decoder, tokenizer,
                                                 stepper=cfg.get("stepper", "device"),
                                                 **beam_opts)
                emit(uid, wav_path, caption, corr, texts, scores)
            except Exception as exc:  # per-sample skip (ref: :112-116)
                print(f"skip {uid}: {type(exc).__name__}: {exc}")

    enc_cfg = encoder[1]

    def batches():
        """Host-side preparation, in manifest order (the rng's order)."""
        pending = []
        for idx, line in enumerate(lines):
            uid, wav_path, caption = line.split("\t")
            if uid in done_uids:
                continue
            try:
                audio = corruption.load_wav(wav_path)
                corr = corruption.sample_audio_corruption(len(audio), rng)
                if noise is not None and cfg.get("corruption_enabled", True):
                    audio = corruption.add_audio_noise(audio, noise, corr)
                mel = w.log_mel_spectrogram(w.pad_or_trim(audio), enc_cfg.n_mels)
            except Exception as exc:  # per-sample skip (ref: :112-116)
                print(f"skip {uid}: {type(exc).__name__}: {exc}")
                continue
            pending.append((uid, wav_path, caption, audio, mel, corr))
            if len(pending) >= decode_batch:
                yield idx, pending, True
                pending = []
        if pending:  # tail batch: the final dump follows
            yield len(lines) - 1, pending, False

    # the producer thread prepares batch N+1 while the card decodes batch N
    for idx, pending, may_dump in prefetch(batches()):
        flush(pending)
        if may_dump and (idx + 1) % dump_every < decode_batch:
            with open(out_path, "w", encoding="utf-8") as fp:
                json.dump(records, fp, indent=1, ensure_ascii=False)
    with open(out_path, "w", encoding="utf-8") as fp:
        json.dump(records, fp, indent=1, ensure_ascii=False)
    print(f"wrote {len(records)} records to {out_path}")
    return records


def read_config(path: str) -> dict:
    """A JSON config, or YAML where `yaml` imports."""
    with open(path, encoding="utf-8") as fp:
        if path.endswith((".yaml", ".yml")):
            import yaml

            return yaml.safe_load(fp)
        return json.load(fp)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="YAML/JSON config")
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--decode_batch", type=int, default=None,
                        help="utterances decoded a lockstep batched beam (overrides the "
                             "config; default 8)")
    parser.add_argument("--device", default=None,
                        help="where to run: the card when omitted; 'cpu' runs the plain "
                             "PyTorch versions of the kernels")
    args = parser.parse_args(argv)
    cfg = read_config(args.config)
    if args.decode_batch is not None:
        cfg["decode_batch"] = args.decode_batch
    return make_json(cfg, args.shard_index, args.num_shards, device=args.device)


if __name__ == "__main__":
    main()
