"""Offline VSR n-best hypothesis generation (BRAVEn + joint CTC/attention).

Counterpart of `dualhyp_tpu/cli/make_json_vsr.py` (ref: data/make_json_vsr.py
+ data/raven/finetune_learner.py:50-109): per utterance, on a producer
thread, load the mouth ROI, occlude it (recording the replayable config)
and apply the eval transforms (centre crop 88 x 88, normalisation); then,
on the card, a decode batch at a time: the Conv3D + ResNet-18 frontend, the
BRAVEn conformer encoder and the CTC head (`encode_ctc_batch`, one padded
batch, exact at real frames), and the joint CTC/attention beam with the
selection on the card (`infer/joint_device_beam`) with weights {decoder:
1 - ctc_w, ctc: ctc_w, lm: lm_w, length_bonus: penalty}; the n-best
detokenised and normalised into the hypotheses JSON (`nhyps` +
Visual_Corruption metadata, WER of the first hypothesis).

Token lists use the unigram SentencePiece vocabulary; detokenisation is the
standard SPM rule (join the pieces, "▁" -> space), so `sentencepiece` is
not needed: pass --token_list with one piece a line.

  python -m dualhyp_tpu_torch.cli.make_json_vsr --config conf/vsr_config.json

The checkpoint's dtype sets the compute dtype of the encoder (bf16 for a
bf16 file, fp32 otherwise); the memory returns to fp32 at the encoder's
boundary, so the CTC head and the beam's CTC scoring are fp32. A batch whose
beam fails is retried one utterance at a time, and an utterance that fails
alone is skipped, as the JAX package does.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.ckpt.convert import raven_from_jax
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.cli.make_json_asr import read_config
from dualhyp_tpu_torch.data import corruption
from dualhyp_tpu_torch.data.normalizer import HypothesisNormalizer
from dualhyp_tpu_torch.device import exact_fp32, resolve_device, to_device
from dualhyp_tpu_torch.infer.beam_search import BeamHypothesis, nbest_texts
from dualhyp_tpu_torch.infer.ctc_prefix import CTCPrefixScorer
from dualhyp_tpu_torch.infer.evaluate import word_error_rate
from dualhyp_tpu_torch.infer.joint_beam_search import full_forward_att_fn, joint_beam_search
from dualhyp_tpu_torch.infer.joint_device_beam import joint_device_beam_batch
from dualhyp_tpu_torch.models import espnet_decoder as ed
from dualhyp_tpu_torch.models import raven
from dualhyp_tpu_torch.utils.prefetch import prefetch


def spm_detokenize(pieces) -> str:
    """SentencePiece detokenisation: concat pieces, '▁' becomes a space."""
    return "".join(pieces).replace("▁", " ").strip()


def load_token_list(path) -> list:
    with open(path, encoding="utf-8") as fp:
        return [line.rstrip("\n").split()[0] for line in fp if line.strip()]


def pad_video_batch(videos, pad_multiple=32, min_frames=0):
    """Pad U variable-length (T_i, H, W) videos into one batch: (U_pad, 1,
    T_pad, H, W) right-zero-padded frames and the true lengths. U pads to a
    power of two and T to a multiple of `pad_multiple` (the JAX package's
    buckets); `min_frames` raises T_pad when a sibling stream (AVSR audio)
    needs more frames than the longest video.

    Returns (vids, lens_pad, lengths): lens_pad (U_pad,) gives dummy rows
    length 1 (an all-masked attention row is NaN), lengths (U,) the real
    frame counts for slicing outputs back."""
    lengths = np.array([len(v) for v in videos], np.int32)
    t_pad = max(pad_multiple,
                -(-max(int(lengths.max()), int(min_frames)) // pad_multiple) * pad_multiple)
    u = len(videos)
    u_pad = 1 << max(0, u - 1).bit_length()
    h, w = np.shape(videos[0])[1:]
    vids = np.zeros((u_pad, 1, t_pad, h, w), np.float32)
    for i, v in enumerate(videos):
        vids[i, 0, : len(v)] = v
    lens_pad = np.ones((u_pad,), np.int32)
    lens_pad[:u] = lengths
    return vids, lens_pad, lengths


def _encode_padded(frontend_params, enc_params, enc_cfg, videos, pad_multiple):
    """(fp32 memory (U_pad, T_pad, adim), lengths (U,)) of one padded batch,
    computed in the encoder tree's dtype where its weights are."""
    device = enc_params["embed"]["linear"]["weight"].device
    vids, lens_pad, lengths = pad_video_batch(videos, pad_multiple)
    with torch.no_grad(), exact_fp32():
        x = to_device(vids, device).to(raven.encode_dtype(enc_params))
        feats = raven.conv3d_frontend(frontend_params, x)
        lens = to_device(lens_pad.astype(np.int64), device)
        mask = lens[:, None] > torch.arange(feats.shape[1], device=device)[None, :]
        memory = raven.encode(enc_params, enc_cfg, feats, mask).float()
    return memory, lengths


def encode_ctc_batch(frontend_params, enc_params, ctc_params, enc_cfg, videos,
                     pad_multiple=32, as_device=False):
    """U variable-length (T_i, H, W) videos -> per-utterance (memory,
    ctc_log_probs) through one padded batch. Right-zero padding is exact at
    real frames: the frontend mixes time only in its first convolution,
    whose windows over the zero tail match the unpadded conv's own zero
    padding; the conformer mixes positions only in masked attention and the
    masked conv module (`raven._conv_module`).

    as_device: the device handoff ((U, T_pad, adim) memory, lengths), ((U,
    T_pad, V) log-probs, lengths) for `joint_device_beam_batch`, which
    stays on the card; else lists of host arrays at the real lengths."""
    memory, lengths = _encode_padded(frontend_params, enc_params, enc_cfg, videos, pad_multiple)
    with torch.no_grad(), exact_fp32():
        ctc_lp = ed.ctc_log_probs(ctc_params, memory)
    u = len(videos)
    if as_device:
        return (memory[:u], lengths), (ctc_lp[:u], lengths)
    memory, ctc_lp = memory.cpu().numpy(), ctc_lp.float().cpu().numpy()
    return ([memory[i, :n] for i, n in enumerate(lengths)],
            [ctc_lp[i, :n] for i, n in enumerate(lengths)])


def encode_batch(frontend_params, enc_params, enc_cfg, videos, pad_multiple=32):
    """The memory-only twin of `encode_ctc_batch` (no CTC head): the frozen
    visual features of `cli.precompute_features`, host arrays."""
    memory, lengths = _encode_padded(frontend_params, enc_params, enc_cfg, videos, pad_multiple)
    memory = memory.cpu().numpy()
    return [memory[i, :n] for i, n in enumerate(lengths)]


def load_mouthroi(path) -> np.ndarray:
    """HDF5 'video_frames' dataset or raw npy (ref: data/utils.py:214-232)."""
    path = str(path)
    if path.endswith((".h5", ".hdf5")):
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f["video_frames"])
    return np.load(path)


def beam_weights(ctc_weight: float, lm_weight: float = 0.0, penalty: float = 0.0) -> dict:
    return {"decoder": 1.0 - ctc_weight, "ctc": ctc_weight, "lm": lm_weight,
            "length_bonus": penalty}


def nbest_from_hyps(hyps, token_list, n_best: int, normalizer=None):
    """(texts, scores) of the n best joint hypotheses, detokenised."""
    sos = eos = len(token_list) - 1
    return nbest_texts([BeamHypothesis(h.result_tokens(sos, eos), h.score) for h in hyps],
                       lambda toks: spm_detokenize([token_list[t] for t in toks]),
                       n=n_best, normalizer=normalizer)


def beam_search_one(memory, ctc_lp, dec_params, dec_cfg, token_list, *, beam_size, ctc_weight,
                    lm_weight=0.0, penalty=0.0, max_len=100, lm_logprobs_fn=None):
    """The per-utterance joint beam (host bookkeeping, the decoder's full
    forward as the scorer) over one utterance's memory (S, adim) on the
    card and its host CTC log-probs (T, V)."""
    sos = eos = len(token_list) - 1  # espnet: the last id is <sos/eos>
    scorer = CTCPrefixScorer(ctc_lp, blank=0, eos=eos) if ctc_weight > 0 else None
    return joint_beam_search(full_forward_att_fn(dec_params, dec_cfg, memory), scorer, sos=sos,
                             eos=eos, beam_size=beam_size,
                             weights=beam_weights(ctc_weight, lm_weight, penalty),
                             max_len=max_len, lm_logprobs_fn=lm_logprobs_fn, blank=0)


def transcribe_vsr_nbest(video, frontend_params, enc_params, enc_cfg, dec_params, dec_cfg,
                         ctc_params, token_list, *, beam_size=40, ctc_weight=0.1,
                         lm_weight=0.0, penalty=0.0, n_best=5, max_len=100,
                         lm_logprobs_fn=None, normalizer=None):
    """video: (T, H, W) preprocessed ROI. Returns (texts, scores) from the
    per-utterance joint beam (the retry path of `make_json`)."""
    memories, ctc_lps = encode_ctc_batch(frontend_params, enc_params, ctc_params, enc_cfg,
                                         [video])
    device = dec_params["embed"]["weight"].device
    hyps = beam_search_one(to_device(memories[0], device), ctc_lps[0], dec_params,
                           dec_cfg, token_list, beam_size=beam_size, ctc_weight=ctc_weight,
                           lm_weight=lm_weight, penalty=penalty, max_len=max_len,
                           lm_logprobs_fn=lm_logprobs_fn)
    return nbest_from_hyps(hyps, token_list, n_best, normalizer)


def transcribe_vsr_nbest_batch(videos, frontend_params, enc_params, enc_cfg, dec_params,
                               dec_cfg, ctc_params, token_list, *, beam_size=40,
                               ctc_weight=0.1, lm_weight=0.0, penalty=0.0, n_best=5,
                               max_len=100, lm=None, normalizer=None):
    """U videos -> list of (texts, scores), decoded in one lockstep joint
    beam on the card (`infer/joint_device_beam`), the encoder's output
    handed over on the card. An utterance's results are
    `transcribe_vsr_nbest`'s."""
    sos = eos = len(token_list) - 1
    memories, ctc_lps = encode_ctc_batch(frontend_params, enc_params, ctc_params, enc_cfg,
                                         videos, as_device=True)
    all_hyps = joint_device_beam_batch(
        dec_params, dec_cfg, memories, ctc_lps if ctc_weight > 0 else None, sos=sos, eos=eos,
        beam_size=beam_size, weights=beam_weights(ctc_weight, lm_weight, penalty),
        max_len=max_len, lm=lm, blank=0)
    return [nbest_from_hyps(hyps, token_list, n_best, normalizer) for hyps in all_hyps]


def beam_options(cfg: dict, normalizer) -> dict:
    return dict(beam_size=int(cfg.get("beam_size", 40)),
                ctc_weight=float(cfg.get("ctc_weight", 0.1)),
                penalty=float(cfg.get("penalty", 0.0)), n_best=int(cfg.get("n_best", 5)),
                max_len=int(cfg.get("max_len", 100)), normalizer=normalizer)


def output_path(cfg: dict, shard_index: int, num_shards: int) -> Path:
    out_path = Path(cfg["output_file"])
    if num_shards > 1:
        out_path = out_path.with_name(out_path.stem + f"_{shard_index:02d}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    return out_path


def resumed(cfg: dict, out_path: Path):
    """(records, uids done) of an earlier run's output when `resume` is set."""
    if cfg.get("resume") and out_path.is_file():
        with open(out_path, encoding="utf-8") as fp:
            records = json.load(fp)
        return records, {r["Uid"] for r in records}
    return [], set()


def write_records(out_path: Path, records: list) -> None:
    with open(out_path, "w", encoding="utf-8") as fp:
        json.dump(records, fp, indent=1, ensure_ascii=False)


def make_json(cfg: dict, shard_index=0, num_shards=1, *, device=None):
    """The generator over cfg's manifest (lines `<uid>\\t<mouthroi>\\t<caption>`),
    writing cfg["output_file"] and returning its records. device: where it
    runs (the card when None)."""
    device = resolve_device(device)
    # the same normalize() as the ASR path (ref: make_json_vsr.py:221-228)
    normalizer = HypothesisNormalizer()
    token_list = load_token_list(cfg["token_list"])
    enc_cfg = raven.RavenEncoderConfig(**cfg.get("encoder", {}))
    dec_cfg = ed.EspnetDecoderConfig(odim=len(token_list), **cfg.get("decoder", {}))
    weights = load_params(cfg["model_checkpoint"])
    frontend_params, enc_params, dec_params, ctc_params = (
        raven_from_jax(weights[k], device=device) for k in ("frontend", "encoder", "decoder",
                                                            "ctc"))

    out_path = output_path(cfg, shard_index, num_shards)
    records, done = resumed(cfg, out_path)
    with open(cfg["manifest"], encoding="utf-8") as fp:
        lines = [l.strip() for l in fp if l.strip()][shard_index::num_shards]

    rng = np.random.default_rng(cfg.get("seed", 0) + shard_index)
    occ_type = cfg.get("occ_type", "pixelate")
    dump_every = int(cfg.get("dump_every", 25))
    decode_batch = int(cfg.get("decode_batch", 16))
    beam_kwargs = beam_options(cfg, normalizer)

    def emit(uid, roi_path, caption, vcfg, texts, scores):
        if not texts:
            return
        caption_norm = normalizer(caption)
        records.append({
            "Dataset": cfg.get("dataset_name", ""),
            "Uid": uid,
            "Caption": caption_norm,
            "Mouthroi": roi_path,
            "Noise_Category": occ_type,
            "nhyps": {"hyps": texts, "scores": scores},
            "Visual_Corruption": vcfg,
            "WER_1st-hyp": word_error_rate([texts[0]], [caption_norm]),
        })

    def flush(pending):
        """Decode a group in one lockstep beam on the card; if it fails,
        retry one utterance at a time, and skip one that fails alone
        (per-sample skip, ref: data/make_json_vsr.py)."""
        if not pending:
            return
        try:
            results = transcribe_vsr_nbest_batch(
                [p[3] for p in pending], frontend_params, enc_params, enc_cfg, dec_params,
                dec_cfg, ctc_params, token_list, **beam_kwargs)
            for (uid, roi_path, caption, _, vcfg), (texts, scores) in zip(pending, results):
                emit(uid, roi_path, caption, vcfg, texts, scores)
            return
        except Exception as exc:
            print(f"batched decode failed ({type(exc).__name__}: {exc}); "
                  f"falling back to per-utterance")
        for uid, roi_path, caption, processed, vcfg in pending:
            try:
                texts, scores = transcribe_vsr_nbest(
                    processed, frontend_params, enc_params, enc_cfg, dec_params, dec_cfg,
                    ctc_params, token_list, **beam_kwargs)
                emit(uid, roi_path, caption, vcfg, texts, scores)
            except Exception as exc:
                print(f"skip {uid}: {type(exc).__name__}: {exc}")

    def batches():
        """Host-side preparation, in manifest order (the rng's order)."""
        pending = []
        for idx, line in enumerate(lines):
            uid, roi_path, caption = line.split("\t")
            if uid in done:
                continue
            try:
                video = load_mouthroi(roi_path)
                corrupted, vcfg = corruption.occlude_sequence(video, occ_type, rng=rng,
                                                              return_config=True)
                processed = corruption.eval_pipeline(corrupted.astype(np.float32))
            except Exception as exc:
                print(f"skip {uid}: {type(exc).__name__}: {exc}")
                continue
            pending.append((uid, roi_path, caption, processed, vcfg))
            if len(pending) >= decode_batch:
                yield pending, False
                pending = []
            if (idx + 1) % dump_every == 0:
                yield pending, True  # possibly partial or empty, then a dump
                pending = []
        yield pending, False

    # the producer thread prepares batch N+1 while the card decodes batch N
    for pending, dump_now in prefetch(batches()):
        flush(pending)
        if dump_now:
            write_records(out_path, records)
    write_records(out_path, records)
    print(f"wrote {len(records)} records to {out_path}")
    return records


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="YAML/JSON config")
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="where to run: the card when omitted; 'cpu' runs the plain "
                             "PyTorch ops")
    args = parser.parse_args(argv)
    return make_json(read_config(args.config), args.shard_index, args.num_shards,
                     device=args.device)


if __name__ == "__main__":
    main()
