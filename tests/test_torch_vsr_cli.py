"""The port's VSR/AVSR generators, visual features, video corruption and
native host ops against the JAX package's, on the CPU.

`cli.make_json_vsr.make_json` and `cli.make_json_avsr.make_json` run with
`device="cpu"` on tiny random models saved as one npz in the JAX package's
layout (the Conv3D trunk narrowed to widths 8-32, encoders of width 16,
decoders of width 16, a 12-entry token list), on seeded 96 x 96 uint8 mouth
ROIs (and WAVs), one decode batch of 3 (AVSR: a batch of 2 and a tail of
1), beam 4; the
JAX CLIs run on the same files. The records are equal, the scores within
1e-5. `cli.precompute_features.main --raven_checkpoint` writes the JAX
package's visual and audio features. The video half of `data/corruption`
is bitwise the JAX package's; `native` gives the JAX package's `native`
and the numpy versions the port keeps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dualhyp_tpu import native as jnative
from dualhyp_tpu.ckpt.io import save_params as jax_save_params
from dualhyp_tpu.cli import make_json_asr as jasr_cli
from dualhyp_tpu.cli import make_json_avsr as javsr_cli
from dualhyp_tpu.cli import make_json_vsr as jvsr_cli
from dualhyp_tpu.cli import precompute_features as jpre
from dualhyp_tpu.data import corruption as jcorr
from dualhyp_tpu.infer import evaluate as jeval
from dualhyp_tpu.infer import whisper_timing as jtiming
from dualhyp_tpu.models import raven as jraven
from dualhyp_tpu.models import whisper as jw
from dualhyp_tpu_torch import native
from dualhyp_tpu_torch.ckpt.convert import raven_from_jax
from dualhyp_tpu_torch.ckpt.io import load_safetensors
from dualhyp_tpu_torch.cli import make_json_avsr as tavsr_cli
from dualhyp_tpu_torch.cli import make_json_vsr as tvsr_cli
from dualhyp_tpu_torch.cli import precompute_features as tpre
from dualhyp_tpu_torch.data import corruption as tcorr
from dualhyp_tpu_torch.data import synthetic
from dualhyp_tpu_torch.infer import evaluate as teval
from dualhyp_tpu_torch.infer import whisper_timing as ttiming
from tests.test_torch_raven import _conv1d_params, _enc_params, _rnd_builders, decoder_tree
from tests.test_torch_raven import frontend_tree
from tests.test_torch_whisper import write_whisper_checkpoint

ATOL = 1e-5
TOKENS = ["<blank>"] + [f"▁w{i}" for i in range(10)] + ["<sos/eos>"]
ENC = dict(idim=32, attention_dim=16, attention_heads=2, linear_units=32, num_blocks=2)
CONFORMER = dict(ENC, num_blocks=1, macaron_style=True, use_cnn_module=True,
                 cnn_module_kernel=5)
DEC = dict(attention_dim=16, attention_heads=2, linear_units=32, num_blocks=2)
BEAM = dict(beam_size=4, ctc_weight=0.3, n_best=3, max_len=8, decode_batch=2, seed=3,
            dataset_name="tiny")
FRAMES = (12, 9, 14)


def vsr_tree():
    _, lin, _, _ = _rnd_builders(21)
    tree = {"frontend": frontend_tree(22), "encoder": _enc_params(
        jraven.RavenEncoderConfig(**ENC), seed=23),
        "decoder": decoder_tree(24, odim=len(TOKENS)), "ctc": {"ctc_lo": lin(len(TOKENS), 16)}}
    tree["encoder"]["embed"]["norm"] = _rnd_builders(25)[2](16)
    return tree


def avsr_tree():
    _, lin, _, bn = _rnd_builders(31)
    cfg = jraven.RavenEncoderConfig(**CONFORMER)
    return {"video_frontend": frontend_tree(32), "audio_frontend": audio_frontend(33),
            "video_encoder": _enc_params(cfg, seed=34), "audio_encoder": _enc_params(cfg, seed=35),
            "fusion": {"fc1": lin(24, 32), "norm": bn(24), "fc2": lin(16, 24)},
            "decoder": decoder_tree(36, odim=len(TOKENS)), "ctc": {"ctc_lo": lin(len(TOKENS), 16)}}


def audio_frontend(seed, widths=(8, 8, 16, 16, 32)):
    """`_conv1d_params`' layout at narrow widths."""
    rnd, _, _, bn = _rnd_builders(seed)
    tree = _conv1d_params(seed)
    tree["conv1"], tree["bn1"] = {"weight": rnd((widths[0], 1, 80))}, bn(widths[0])
    cin = widths[0]
    for li, cout in enumerate(widths[1:]):
        for bi, (i, o) in (("0", (cin, cout)), ("1", (cout, cout))):
            leaf = {"conv1": {"weight": rnd((o, i, 3))}, "bn1": bn(o),
                    "conv2": {"weight": rnd((o, o, 3))}, "bn2": bn(o)}
            if bi == "0" and li > 0:
                leaf["downsample"] = {"conv": {"weight": rnd((o, i, 1))}, "bn": bn(o)}
            tree[f"layer{li + 1}"][bi] = leaf
        cin = cout
    return tree


def write_rois(tmp_path, seed=40):
    rng = np.random.default_rng(seed)
    paths = []
    for i, t in enumerate(FRAMES):
        path = tmp_path / f"roi_{i}.npy"
        np.save(path, rng.integers(0, 256, size=(t, 96, 96), dtype=np.uint8))
        paths.append(str(path))
    return paths


def write_common(tmp_path, tree):
    (tmp_path / "tokens.txt").write_text("\n".join(f"{t} {i}" for i, t in enumerate(TOKENS)))
    jax_save_params(tmp_path / "model.npz", tree)
    return {"token_list": str(tmp_path / "tokens.txt"),
            "model_checkpoint": str(tmp_path / "model.npz"), **BEAM}


def assert_same_records(got, want):
    assert len(got) == len(want) == len(FRAMES)
    for a, b in zip(got, want):
        scores_a, scores_b = a["nhyps"].pop("scores"), b["nhyps"].pop("scores")
        assert a == b
        np.testing.assert_allclose(scores_a, scores_b, rtol=ATOL, atol=ATOL)


def test_make_json_vsr_matches_jax(tmp_path, capsys):
    cfg = write_common(tmp_path, vsr_tree())
    rois = write_rois(tmp_path)
    (tmp_path / "manifest.tsv").write_text(
        "".join(f"u{i}\t{p}\tword {i} here\n" for i, p in enumerate(rois)))
    # one batch of 3 (the AVSR test runs a batch of 2 and a tail of 1)
    cfg.update(manifest=str(tmp_path / "manifest.tsv"), encoder=ENC, decoder=DEC,
               occ_type="pixelate", decode_batch=3)
    for side in ("jax", "torch"):
        (tmp_path / f"{side}.json").write_text(json.dumps(
            {**cfg, "output_file": str(tmp_path / f"out_{side}.json")}))
    jvsr_cli.main(["--config", str(tmp_path / "jax.json")])
    records = tvsr_cli.main(["--config", str(tmp_path / "torch.json"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "falling back" not in printed and "skip " not in printed
    want = json.loads((tmp_path / "out_jax.json").read_text())
    assert json.loads((tmp_path / "out_torch.json").read_text()) == records
    assert all(len(r["nhyps"]["hyps"]) == BEAM["n_best"] for r in records)
    assert_same_records(records, want)


def test_vsr_per_utterance_path_matches_the_batch(tmp_path):
    """The retry path (`transcribe_vsr_nbest`, host beam over the full
    forward) gives the lockstep beam's texts; an .h5 ROI reads as its .npy."""
    import h5py

    tree = raven_from_jax(vsr_tree(), device="cpu")
    enc_cfg = tvsr_cli.raven.RavenEncoderConfig(**ENC)
    dec_cfg = tvsr_cli.ed.EspnetDecoderConfig(odim=len(TOKENS), **DEC)
    rois = write_rois(tmp_path)
    with h5py.File(tmp_path / "roi.h5", "w") as f:
        f["video_frames"] = np.load(rois[0])
    np.testing.assert_array_equal(tvsr_cli.load_mouthroi(tmp_path / "roi.h5"),
                                  tvsr_cli.load_mouthroi(rois[0]))
    videos = [tcorr.eval_pipeline(np.load(p).astype(np.float32)) for p in rois]
    args = (tree["frontend"], tree["encoder"], enc_cfg, tree["decoder"], dec_cfg, tree["ctc"],
            TOKENS)
    kw = dict(beam_size=4, ctc_weight=0.3, n_best=3, max_len=8)
    batch = tvsr_cli.transcribe_vsr_nbest_batch(videos, *args, **kw)
    for video, (texts, scores) in zip(videos, batch):
        one_texts, one_scores = tvsr_cli.transcribe_vsr_nbest(video, *args, **kw)
        assert one_texts == texts
        np.testing.assert_allclose(one_scores, scores, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_ctc_batch_matches_jax(dtype):
    """The padded batch encode (the beam's handoff) at fp32 to 1e-5, and a
    bf16 tree computing in bf16 with fp32 outputs, to the model tests'
    bf16 tolerance."""
    from tests.test_torch_raven import BF16_ATOL, close

    tree = vsr_tree()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    tt = raven_from_jax(tree, device="cpu", dtype=tdt)
    rng = np.random.default_rng(41)
    videos = [rng.normal(size=(t, 32, 32)).astype(np.float32) for t in FRAMES]
    jcfg, tcfg = jraven.RavenEncoderConfig(**ENC), tvsr_cli.raven.RavenEncoderConfig(**ENC)
    want_m, want_c = jvsr_cli.encode_ctc_batch(jt["frontend"], jt["encoder"], jt["ctc"], jcfg,
                                               videos, pad_multiple=8)
    got_m, got_c = tvsr_cli.encode_ctc_batch(tt["frontend"], tt["encoder"], tt["ctc"], tcfg,
                                             videos, pad_multiple=8)
    (dev_m, lens), (dev_c, _) = tvsr_cli.encode_ctc_batch(
        tt["frontend"], tt["encoder"], tt["ctc"], tcfg, videos, pad_multiple=8, as_device=True)
    assert list(lens) == list(FRAMES) and dev_m.shape == (3, 16, 16)
    tol = ATOL if dtype == "float32" else BF16_ATOL
    for i in range(3):
        assert got_m[i].dtype == np.float32 and got_c[i].dtype == np.float32
        close(got_m[i], want_m[i], tol)
        close(got_c[i], want_c[i], tol)
        close(dev_m[i, : FRAMES[i]], got_m[i], 0)
        close(dev_c[i, : FRAMES[i]], got_c[i], 0)


def test_make_json_avsr_matches_jax(tmp_path, capsys):
    cfg = write_common(tmp_path, avsr_tree())
    rois = write_rois(tmp_path)
    rng = np.random.default_rng(42)
    lines, asr = [], []
    for i, (t, roi) in enumerate(zip(FRAMES, rois)):
        wav = tmp_path / f"clean_{i}.wav"
        wavfile.write(wav, 16000, (rng.normal(size=t * 640 - 100) * 3000).astype(np.int16))
        lines.append(f"u{i}\t{wav}\t{roi}\tword {i}\n")
    noise = tmp_path / "noise.wav"
    wavfile.write(noise, 16000, (rng.normal(size=3000) * 3000).astype(np.int16))
    asr.append({"Uid": "u1", "Noise_Wav": str(noise),
                "Audio_Corruption": {"total_len": 5660, "start_fr": 100, "occ_len": 2000,
                                     "snr": 0}})
    (tmp_path / "manifest.tsv").write_text("".join(lines))
    (tmp_path / "asr.json").write_text(json.dumps(asr))
    cfg.update(manifest=str(tmp_path / "manifest.tsv"), video_encoder=CONFORMER,
               audio_encoder=CONFORMER, decoder=DEC, asr_json=str(tmp_path / "asr.json"))
    for side in ("jax", "torch"):
        (tmp_path / f"{side}.json").write_text(json.dumps(
            {**cfg, "output_file": str(tmp_path / f"out_{side}.json")}))
    javsr_cli.main(["--config", str(tmp_path / "jax.json")])
    records = tavsr_cli.main(["--config", str(tmp_path / "torch.json"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "falling back" not in printed and "skip " not in printed
    assert records[1]["Audio_Corruption"]["snr"] == 0
    assert_same_records(records, json.loads((tmp_path / "out_jax.json").read_text()))


def test_precompute_features_visual_matches_jax(tmp_path, monkeypatch):
    """--raven_checkpoint: the BRAVEn features of each record's ROI with its
    occlusion replayed, and the Whisper features, as the JAX CLI writes
    them."""
    enc_cfg = jw.WhisperEncoderConfig(n_mels=16, n_ctx=1500, n_state=32, n_head=1, n_layer=1)
    enc = jax.tree_util.tree_map(np.asarray, jw.init_encoder(enc_cfg, jax.random.key(3)))
    write_whisper_checkpoint(tmp_path / "whisper", enc, enc_cfg)

    def jax_load_whisper(path, n_mels=128, need_tokenizer=True):
        tensors = {k: v.numpy() for k, v in load_safetensors(
            tmp_path / "whisper" / "model.safetensors").items()}
        tree = jax.tree_util.tree_map(jnp.asarray, jw.convert_hf_whisper_encoder(tensors,
                                                                               enc_cfg))
        return (tree, enc_cfg), None, None

    monkeypatch.setattr(jasr_cli, "load_whisper", jax_load_whisper)
    tree = vsr_tree()
    jax_save_params(tmp_path / "braven.npz", {"frontend": tree["frontend"],
                                              "encoder": tree["encoder"]})
    records = synthetic.make_records(n_uids=1, seed=5)
    rng = np.random.default_rng(43)
    for rec in records:
        n = rec["Audio_Corruption"]["total_len"]
        rec["Clean_Wav"] = str(tmp_path / f"{rec['Uid']}_clean.wav")
        rec["Noise_Wav"] = str(tmp_path / f"{rec['Uid']}_noise.wav")
        wavfile.write(rec["Clean_Wav"], 16000, (rng.normal(size=n) * 3000).astype(np.int16))
        wavfile.write(rec["Noise_Wav"], 16000, (rng.normal(size=n // 3) * 3000).astype(np.int16))
        rec["Mouthroi"] = str(tmp_path / f"{rec['Uid']}.npy")
        np.save(rec["Mouthroi"], rng.integers(0, 256, (rec["Visual_Corruption"]["total_len"], 96,
                                                       96), dtype=np.uint8))
    synthetic.write_json(tmp_path / "data.json", records)
    args = ["--json", str(tmp_path / "data.json"), "--whisper_checkpoint",
            str(tmp_path / "whisper"), "--raven_checkpoint", str(tmp_path / "braven.npz"),
            "--raven_config", json.dumps(ENC)]
    jpre.main([*args, "--out_dir", str(tmp_path / "jax")])
    assert tpre.main([*args, "--out_dir", str(tmp_path / "torch"), "--device", "cpu"]) == 1
    for rec in records:
        with np.load(tmp_path / "jax" / f"{rec['Uid']}.npz") as want, \
                np.load(tmp_path / "torch" / f"{rec['Uid']}.npz") as got:
            assert got["visual"].shape == (rec["Visual_Corruption"]["total_len"], 16)
            assert np.abs(got["visual"]).max() > 0
            for key in ("audio", "visual"):
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL, err_msg=key)


def test_new_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "c.json").write_text(json.dumps({"token_list": "t", "model_checkpoint": "m"}))
    for cli in (tvsr_cli, tavsr_cli):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config", str(tmp_path / "c.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raven_from_jax({})


# ---------------------------------------------------------------------------
# the video half of data/corruption: bitwise the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("occ_type", ["pixelate", "blur", "coco", "hands"])
def test_occlusion_generation_and_replay_are_bitwise_jax(occ_type):
    video = np.random.default_rng(50).integers(0, 256, (20, 96, 96)).astype(np.uint8)
    want, wcfg = jcorr.occlude_sequence(video, occ_type, rng=np.random.default_rng(51),
                                        return_config=True)
    got, gcfg = tcorr.occlude_sequence(video, occ_type, rng=np.random.default_rng(51),
                                       return_config=True)
    assert gcfg == wcfg
    np.testing.assert_array_equal(got, want)
    rep_w, _ = jcorr.occlude_sequence(video, occ_type, occlude_config=wcfg)
    rep_g, _ = tcorr.occlude_sequence(video, occ_type, occlude_config=gcfg)
    np.testing.assert_array_equal(rep_g, rep_w)
    lm = np.random.default_rng(52).uniform(20, 70, (20, 68, 2))
    if occ_type == "coco":
        a, _ = jcorr.occlude_sequence(video, occ_type, occlude_config=wcfg, landmarks=lm)
        b, _ = tcorr.occlude_sequence(video, occ_type, occlude_config=wcfg, landmarks=lm)
        np.testing.assert_array_equal(b, a)


def test_video_transforms_and_images_are_bitwise_jax():
    rng = np.random.default_rng(53)
    frames = rng.integers(0, 256, (6, 96, 96)).astype(np.float32)
    np.testing.assert_array_equal(tcorr.eval_pipeline(frames), jcorr.eval_pipeline(frames))
    np.testing.assert_array_equal(tcorr.train_pipeline(frames, np.random.default_rng(1)),
                                  jcorr.train_pipeline(frames, np.random.default_rng(1)))
    np.testing.assert_array_equal(tcorr.center_crop(frames, (88, 88)),
                                  jcorr.center_crop(frames, (88, 88)))
    np.testing.assert_array_equal(tcorr.random_crop(frames, (80, 80), np.random.default_rng(2)),
                                  jcorr.random_crop(frames, (80, 80), np.random.default_rng(2)))
    np.testing.assert_array_equal(tcorr.horizontal_flip(frames, True),
                                  jcorr.horizontal_flip(frames, True))
    np.testing.assert_array_equal(tcorr.normalize(frames, 0.4, 0.2),
                                  jcorr.normalize(frames, 0.4, 0.2))
    assert sorted(tcorr.get_preprocessing_pipelines()) == sorted(
        jcorr.get_preprocessing_pipelines())
    for name in tcorr.get_preprocessing_pipelines():
        def kw():
            return {"rng": np.random.default_rng(3)} if name == "train" else {}

        np.testing.assert_array_equal(tcorr.get_preprocessing_pipelines()[name](frames, **kw()),
                                      jcorr.get_preprocessing_pipelines()[name](frames, **kw()))
    np.testing.assert_array_equal(tcorr.image_pixelate(frames[0]), jcorr.image_pixelate(frames[0]))
    np.testing.assert_array_equal(tcorr.image_blur(frames[0]), jcorr.image_blur(frames[0]))
    for span in ((50, np.random.default_rng(4), 0.0), (50, np.random.default_rng(4), 0.3)):
        assert tcorr.occlusion_span(*span[:1], np.random.default_rng(4), span[2]) == \
            jcorr.occlusion_span(*span[:1], np.random.default_rng(4), span[2])
    for occ in ("coco", "hands"):
        tb, jb = tcorr.OccluderBank(occ), jcorr.OccluderBank(occ)
        assert tb.names == jb.names
        for name in tb.names[:3]:
            for a, b in zip(tb.get(name), jb.get(name)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(tcorr.procedural_occluder(name, occ), jcorr.procedural_occluder(name, occ)):
                np.testing.assert_array_equal(a, b)
    img = rng.uniform(0, 255, (96, 96, 3)).astype(np.float32)
    over = rng.uniform(0, 255, (30, 30, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (30, 30, 3)).astype(np.float32)
    for y, x in ((10, 20), (80, 85), (-5, -7)):  # both write into their image
        np.testing.assert_array_equal(tcorr.overlay_image_alpha(img.copy(), over, y, x, alpha),
                                      jcorr.overlay_image_alpha(img.copy(), over, y, x, alpha))
    hand = rng.uniform(0, 255, (96, 96, 3)).astype(np.float32)
    hand_alpha = rng.uniform(0, 1, (96, 96, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcorr.overlay_image_hands(img.copy(), hand, hand_alpha),
                                  jcorr.overlay_image_hands(img.copy(), hand, hand_alpha))


# ---------------------------------------------------------------------------
# native: the C++ host ops
# ---------------------------------------------------------------------------

def test_native_matches_jax_native_and_the_numpy_versions():
    rng = np.random.default_rng(60)
    words = [f"w{i}" for i in range(7)]
    refs = [list(rng.choice(words, rng.integers(0, 12))) for _ in range(40)]
    hyps = [list(rng.choice(words, rng.integers(0, 12))) for _ in range(40)]
    got = native.edit_distance_batch(refs, hyps)
    np.testing.assert_array_equal(got, jnative.edit_distance_batch(refs, hyps))
    np.testing.assert_array_equal(got, [teval.edit_distance(r, h) for r, h in zip(refs, hyps)])
    preds, golds = [" ".join(h) for h in hyps], [" ".join(r) for r in refs]
    assert teval.word_error_rate(preds, golds) == jeval.word_error_rate(preds, golds) == \
        native.word_error_rate(preds, golds)
    for n, m in ((1, 1), (7, 30), (25, 200), (60, 1500)):
        cost = rng.normal(size=(n, m)).astype(np.float32)
        path = native.dtw(cost)
        for want in (jnative.dtw(cost), ttiming.dtw(cost)):
            for a, b in zip(path, want):
                np.testing.assert_array_equal(a, b)
    x = rng.normal(size=(4, 1500)).astype(np.float32)
    for width in (1, 7):
        for row in x:
            np.testing.assert_array_equal(native.median_filter(row, width),
                                          jnative.median_filter(row, width))
        np.testing.assert_array_equal(np.stack([native.median_filter(r, width) for r in x]),
                                      ttiming.median_filter(x, width))
        np.testing.assert_array_equal(ttiming.median_filter_reflect(x, width),
                                      jtiming.median_filter_reflect(x, width))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent Python fallback: a source g++ refuses raises with its
    message, and the library is never loaded from a half-written file."""
    bad = tmp_path / "hostops.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g.. failed to build hostops.cc"):
        native.build()
    assert not list((tmp_path / "build").rglob("*.so"))
    with pytest.raises(ValueError, match="odd"):
        native.median_filter(np.zeros(4), 4)
