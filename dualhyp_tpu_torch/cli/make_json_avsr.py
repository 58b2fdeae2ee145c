"""Offline joint audio-visual (AVSR) n-best hypothesis generation.

Counterpart of `dualhyp_tpu/cli/make_json_avsr.py` (ref: data/make_json_avsr.py
+ data/auto_avsr/lightning_av.py:72-95): per utterance, load the waveform
and the mouth ROI, reuse the audio corruption of an earlier ASR JSON when
one is given (ref: make_json_avsr.py:96-140, the modalities corrupted
alike), occlude the video; then on the card both frontends, the two
conformers fused by the MLP head (`models/avsr`) and the CTC head
(`encode_ctc_batch_av`, one padded batch), and the joint CTC/attention beam
shared with VSR (`infer/joint_device_beam`).

  python -m dualhyp_tpu_torch.cli.make_json_avsr --config conf/avsr_config.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dualhyp_tpu_torch.ckpt.convert import avsr_from_jax
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.cli.make_json_asr import read_config
from dualhyp_tpu_torch.cli.make_json_vsr import (beam_options, beam_search_one, beam_weights,
                                                 load_mouthroi, load_token_list, nbest_from_hyps,
                                                 output_path, pad_video_batch, resumed,
                                                 write_records)
from dualhyp_tpu_torch.data import corruption
from dualhyp_tpu_torch.data.normalizer import HypothesisNormalizer
from dualhyp_tpu_torch.device import exact_fp32, resolve_device, to_device
from dualhyp_tpu_torch.infer.evaluate import word_error_rate
from dualhyp_tpu_torch.infer.joint_device_beam import joint_device_beam_batch
from dualhyp_tpu_torch.models import avsr, raven
from dualhyp_tpu_torch.models import espnet_decoder as ed
from dualhyp_tpu_torch.utils.prefetch import prefetch


def encode_ctc_batch_av(params, ctc_params, video_cfg, audio_cfg, videos, audios,
                        pad_multiple=32, as_device=False):
    """U variable-length (video, audio) pairs -> per-utterance fused
    (memory, ctc_log_probs) through one padded batch, the AV twin of
    `make_json_vsr.encode_ctc_batch`. Right-zero padding is exact at real
    positions: both frontends mix time only in convolutions whose zero-tail
    windows match the unpadded convs' own zero padding (the audio frames
    are sliced back to the samples // 640 of each waveform), and the
    conformers mix positions only in masked attention and the masked conv
    module. An utterance keeps min(video frames, audio frames)."""
    device = params["decoder"]["embed"]["weight"].device
    alens = np.array([len(a) // 640 for a in audios], np.int32)
    vids, vlens_pad, vlens = pad_video_batch(videos, pad_multiple, min_frames=int(alens.max()))
    u, u_pad, t_pad = len(videos), vids.shape[0], vids.shape[2]
    auds = np.zeros((u_pad, t_pad * 640), np.float32)
    asamps = np.full((u_pad,), 640, np.int64)  # dummy rows: 1 frame
    for i, a in enumerate(audios):
        auds[i, : min(len(a), t_pad * 640)] = a[: t_pad * 640]
        asamps[i] = min(len(a), t_pad * 640)
    alens_pad = np.ones((u_pad,), np.int64)
    alens_pad[:u] = alens  # dummy rows length 1 (an all-masked row is NaN)
    dtype = raven.encode_dtype(params)
    with torch.no_grad(), exact_fp32():
        vfeats = raven.conv3d_frontend(params["video_frontend"], to_device(vids, device).to(dtype))
        afeats = avsr.conv1d_frontend(params["audio_frontend"], to_device(auds, device).to(dtype),
                                      lengths=to_device(asamps, device))
        vl = to_device(vlens_pad.astype(np.int64), device)
        al = to_device(alens_pad, device)
        vmask = vl[:, None] > torch.arange(vfeats.shape[1], device=device)[None, :]
        amask = al[:, None] > torch.arange(afeats.shape[1], device=device)[None, :]
        memory = avsr.avsr_encode(params, video_cfg, audio_cfg, vfeats, afeats,
                                  video_mask=vmask, audio_mask=amask).float()
        ctc_lp = ed.ctc_log_probs(ctc_params, memory)
    tlens = np.minimum(vlens, alens)
    if as_device:
        return (memory[:u], tlens), (ctc_lp[:u], tlens)
    memory, ctc_lp = memory.cpu().numpy(), ctc_lp.cpu().numpy()
    return ([memory[i, :t] for i, t in enumerate(tlens)],
            [ctc_lp[i, :t] for i, t in enumerate(tlens)])


def transcribe_avsr_nbest(video, audio, params, video_cfg, audio_cfg, dec_params, dec_cfg,
                          ctc_params, token_list, *, beam_size=40, ctc_weight=0.1, penalty=0.0,
                          n_best=5, max_len=100, normalizer=None):
    """One (video, audio) pair through the per-utterance joint beam (the
    retry path of `make_json`): (texts, scores)."""
    memories, ctc_lps = encode_ctc_batch_av(params, ctc_params, video_cfg, audio_cfg, [video],
                                            [audio])
    device = dec_params["embed"]["weight"].device
    hyps = beam_search_one(to_device(memories[0], device), ctc_lps[0], dec_params,
                           dec_cfg, token_list, beam_size=beam_size, ctc_weight=ctc_weight,
                           penalty=penalty, max_len=max_len)
    return nbest_from_hyps(hyps, token_list, n_best, normalizer)


def transcribe_avsr_nbest_batch(videos, audios, params, video_cfg, audio_cfg, dec_params,
                                dec_cfg, ctc_params, token_list, *, beam_size=40,
                                ctc_weight=0.1, penalty=0.0, n_best=5, max_len=100,
                                normalizer=None):
    """U (video, audio) pairs -> list of (texts, scores) in one lockstep
    joint beam on the card (see `make_json_vsr.transcribe_vsr_nbest_batch`)."""
    sos = eos = len(token_list) - 1
    memories, ctc_lps = encode_ctc_batch_av(params, ctc_params, video_cfg, audio_cfg, videos,
                                            audios, as_device=True)
    all_hyps = joint_device_beam_batch(
        dec_params, dec_cfg, memories, ctc_lps if ctc_weight > 0 else None, sos=sos, eos=eos,
        beam_size=beam_size, weights=beam_weights(ctc_weight, penalty=penalty),
        max_len=max_len, blank=0)
    return [nbest_from_hyps(hyps, token_list, n_best, normalizer) for hyps in all_hyps]


def make_json(cfg: dict, shard_index=0, num_shards=1, *, device=None):
    """The generator over cfg's manifest (lines `<uid>\\t<wav>\\t<roi>\\t<caption>`),
    writing cfg["output_file"] and returning its records. device: where it
    runs (the card when None)."""
    device = resolve_device(device)
    # the same normalize() as the ASR path (ref: make_json_avsr.py:304-311)
    normalizer = HypothesisNormalizer()
    token_list = load_token_list(cfg["token_list"])
    video_cfg = raven.RavenEncoderConfig(**cfg.get("video_encoder", {}))
    audio_cfg = raven.RavenEncoderConfig(**cfg.get("audio_encoder", {}))
    dec_cfg = ed.EspnetDecoderConfig(odim=len(token_list), **cfg.get("decoder", {}))
    params = avsr_from_jax(load_params(cfg["model_checkpoint"]), device=device)
    dec_params, ctc_params = params["decoder"], params["ctc"]

    # audio corruption reused from an earlier ASR JSON (ref: make_json_avsr.py:96-140)
    corr_by_uid = {}
    if cfg.get("asr_json"):
        with open(cfg["asr_json"], encoding="utf-8") as fp:
            corr_by_uid = {rec["Uid"]: rec for rec in json.load(fp)}

    out_path = output_path(cfg, shard_index, num_shards)
    records, done = resumed(cfg, out_path)
    with open(cfg["manifest"], encoding="utf-8") as fp:
        lines = [l.strip() for l in fp if l.strip()][shard_index::num_shards]

    rng = np.random.default_rng(cfg.get("seed", 0) + shard_index)
    occ_type = cfg.get("occ_type", "pixelate")
    decode_batch = int(cfg.get("decode_batch", 16))
    dump_every = int(cfg.get("dump_every", 25))
    beam_kwargs = beam_options(cfg, normalizer)

    def emit(uid, wav_path, roi_path, caption, prior, vcfg, texts, scores):
        if not texts:
            return
        caption_norm = normalizer(caption)
        records.append({
            "Dataset": cfg.get("dataset_name", ""),
            "Uid": uid,
            "Caption": caption_norm,
            "Clean_Wav": wav_path,
            "Mouthroi": roi_path,
            "nhyps": {"hyps": texts, "scores": scores},
            "Audio_Corruption": (prior or {}).get("Audio_Corruption"),
            "Visual_Corruption": vcfg,
            "WER_1st-hyp": word_error_rate([texts[0]], [caption_norm]),
        })

    def flush(pending):
        """One lockstep beam on the card a group; on failure one utterance
        at a time, and a per-sample skip."""
        if not pending:
            return
        try:
            results = transcribe_avsr_nbest_batch(
                [p[5] for p in pending], [p[4] for p in pending], params, video_cfg, audio_cfg,
                dec_params, dec_cfg, ctc_params, token_list, **beam_kwargs)
            for (uid, wav_path, roi_path, caption, _a, _v, prior, vcfg), (texts, scores) in zip(
                    pending, results):
                emit(uid, wav_path, roi_path, caption, prior, vcfg, texts, scores)
            return
        except Exception as exc:
            print(f"batched decode failed ({type(exc).__name__}: {exc}); "
                  f"falling back to per-utterance")
        for uid, wav_path, roi_path, caption, audio, processed, prior, vcfg in pending:
            try:
                texts, scores = transcribe_avsr_nbest(
                    processed, audio, params, video_cfg, audio_cfg, dec_params, dec_cfg,
                    ctc_params, token_list, **beam_kwargs)
                emit(uid, wav_path, roi_path, caption, prior, vcfg, texts, scores)
            except Exception as exc:
                print(f"skip {uid}: {type(exc).__name__}: {exc}")

    def batches():
        """Host-side preparation, in manifest order (the rng's order)."""
        pending = []
        for idx, line in enumerate(lines):
            uid, wav_path, roi_path, caption = line.split("\t")
            if uid in done:
                continue
            try:
                audio = corruption.load_wav(wav_path)
                prior = corr_by_uid.get(uid)
                if prior and prior.get("Audio_Corruption") and prior.get("Noise_Wav"):
                    noise = corruption.load_wav(prior["Noise_Wav"])
                    audio = corruption.add_audio_noise(audio, noise, prior["Audio_Corruption"])
                video = load_mouthroi(roi_path)
                corrupted, vcfg = corruption.occlude_sequence(video, occ_type, rng=rng,
                                                              return_config=True)
                processed = corruption.eval_pipeline(corrupted.astype(np.float32))
            except Exception as exc:
                print(f"skip {uid}: {type(exc).__name__}: {exc}")
                continue
            pending.append((uid, wav_path, roi_path, caption, audio, processed, prior, vcfg))
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
