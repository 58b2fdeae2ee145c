"""The port's RelPrompt path against the JAX package's, on the CPU.

Classifiers (eval and dropout on the same numpy mask), the ceil-mode pool,
`mask_loss` and `mask_metrics` in fp32 to 1e-5 (conv sums in another
order); the mask dataset, the masks, the audio corruption and the WAV
loader exactly (the same host code); the extended embedding and the
RelPrompt tree both ways through the npz format exactly; mask prediction,
prompt substitution and greedy decoding on a tiny fp32 model: the same
mask tokens, prompts, records and metrics. Then `inference_relprompt.main`
and `precompute_features.main` end to end with `--device cpu` on a tiny
Whisper checkpoint and WAV files written here: `--whisper_checkpoint` and
`--feature_dir` give the same masks and answers.
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ckpt.io import load_params as jax_load_params
from dualhyp_tpu.ckpt.io import save_params as jax_save_params
from dualhyp_tpu.cli import finetune_relprompt as jft
from dualhyp_tpu.cli import inference_relprompt as jinf
from dualhyp_tpu.cli.inference_ger import run_inference as jax_run_inference
from dualhyp_tpu.data import corruption as jcorr
from dualhyp_tpu.data import hypotheses as jhyp
from dualhyp_tpu.data import masks as jmasks
from dualhyp_tpu.data.prompts import MASK_TOKENS
from dualhyp_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.models import relprompt as jrp
from dualhyp_tpu.models import whisper as jw
from dualhyp_tpu_torch.ckpt.convert import load_tree, params_from_jax, tree_from_model
from dualhyp_tpu_torch.ckpt.io import load_params, save_params
from dualhyp_tpu_torch.cli import finetune_relprompt as tft
from dualhyp_tpu_torch.cli import inference_relprompt as tinf
from dualhyp_tpu_torch.cli import precompute_features
from dualhyp_tpu_torch.data import corruption as tcorr
from dualhyp_tpu_torch.data import hypotheses, synthetic
from dualhyp_tpu_torch.data import masks as tmasks
from dualhyp_tpu_torch.data.tokenizer import Tokenizer
from dualhyp_tpu_torch.models import relprompt as trp
from dualhyp_tpu_torch.models.gpt import GPT
from tests import helpers
from tests.test_torch_decode import _write_tokenizer
from tests.test_torch_gpt import LORA, _port_config
from tests.test_torch_whisper import write_whisper_checkpoint

ATOL = 1e-5
RELPROMPT = dict(use_relprompt=True, n_extra_tokens=3, whisper_dim=32, raven_dim=24,
                 classifier_hidden_dim=16, classifier_pool_size=10)


def _classifier(seed, in_dim, hid):
    params = jax.tree_util.tree_map(np.asarray, jrp.init_classifier(jax.random.key(seed),
                                                                   in_dim, hid))
    rng = np.random.default_rng(seed)
    for leaf in params.values():  # non-zero biases, so each one counts
        leaf["bias"] = rng.normal(size=leaf["bias"].shape).astype(np.float32) * 0.1
    return params, {k: {n: torch.tensor(v) for n, v in leaf.items()}
                    for k, leaf in params.items()}


@pytest.mark.parametrize("t,pool", [(23, 5), (20, 5), (1, 4), (45, 20)])
def test_classifier_forward_matches_jax(rng, t, pool):
    jparams, tparams = _classifier(0, 12, 8)
    x = rng.normal(size=(2, t, 12)).astype(np.float32)
    want = np.asarray(jrp.classifier_forward(jparams, jnp.asarray(x), pool))
    got = trp.classifier_forward(tparams, torch.from_numpy(x), pool)
    assert got.shape == want.shape == (2, -(-t // pool), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_classifier_dropout_matches_jax_on_the_same_mask(rng, monkeypatch):
    jparams, tparams = _classifier(1, 12, 8)
    x = rng.normal(size=(2, 17, 12)).astype(np.float32)
    keep = rng.random(size=(2, 8, 17)) >= 0.3
    monkeypatch.setattr(jrp.jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    monkeypatch.setattr(trp, "_dropout_keep",
                        lambda shape, rate, generator, device: torch.from_numpy(keep))
    want = np.asarray(jrp.classifier_forward(jparams, jnp.asarray(x), 4,
                                             rng=jax.random.key(0), dropout=0.3))
    got = trp.classifier_forward(tparams, torch.from_numpy(x), 4,
                                 generator=torch.Generator(), dropout=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    no_drop = trp.classifier_forward(tparams, torch.from_numpy(x), 4)
    assert not torch.allclose(got, no_drop)


@pytest.mark.parametrize("t", [1, 7, 20, 23])
def test_avg_pool_ceil_matches_jax(rng, t):
    x = rng.normal(size=(2, 3, t)).astype(np.float32)
    np.testing.assert_allclose(trp._avg_pool_ceil(torch.from_numpy(x), 5).numpy(),
                               np.asarray(jrp._avg_pool_ceil(jnp.asarray(x), 5)),
                               rtol=0, atol=1e-6)


def test_extend_embeddings_appends_rows_like_jax():
    wte = np.random.default_rng(0).normal(size=(40, 16)).astype(np.float32) * 0.3
    want = jrp.extend_embeddings({"wte": {"weight": jnp.asarray(wte)}}, jax.random.key(0))
    got = trp.extend_embeddings({"wte": {"weight": wte}, "ln_f": {"scale": np.ones(16)}},
                                torch.Generator().manual_seed(0))
    assert got["wte"]["weight"].shape == want["wte"]["weight"].shape == (43, 16)
    np.testing.assert_array_equal(got["wte"]["weight"][:40].numpy(), wte)
    assert got["ln_f"]["scale"] is not None
    extra = got["wte"]["weight"][40:].numpy()
    assert 0.5 * wte.std() < extra.std() < 2.0 * wte.std()


def test_mask_loss_and_metrics_match_jax(rng):
    logits = rng.normal(size=(3, 9, 3)).astype(np.float32)
    targets = rng.integers(0, 3, size=(3, 7)).astype(np.int32)
    np.testing.assert_allclose(
        float(trp.mask_loss(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(jrp.mask_loss(jnp.asarray(logits), jnp.asarray(targets))), rtol=0, atol=ATOL)
    for preds, targs in ((rng.integers(0, 3, 50), rng.integers(0, 3, 50)),
                         (np.zeros(5, int), np.zeros(5, int)), (np.array([]), np.array([]))):
        assert trp.mask_metrics(preds, targs) == jrp.mask_metrics(preds, targs)


def test_masks_and_audio_corruption_are_the_jax_host_code(tmp_path, rng):
    from scipy.io import wavfile

    for cfg, thr in (({"total_len": 50, "start_fr": 10, "occ_len": 25, "snr": 0}, None),
                     ({"total_len": 50, "start_fr": 40, "occ_len": 25, "snr": 5}, 2.0),
                     ({"total_len": 50, "start_fr": 40, "occ_len": 25, "snr": -5}, 2.0)):
        mask = tmasks.frame_noise_mask(cfg, thr)
        assert mask == jmasks.frame_noise_mask(cfg, thr)
        for size in (4, 7, 10):
            bins = tmasks.chunk_reliability(mask, size)
            assert bins == jmasks.chunk_reliability(mask, size)
            assert tmasks.bins_to_indices(bins[1]) == jmasks.bins_to_indices(bins[1])
    audio = rng.normal(size=3000).astype(np.float32)
    for noise_len in (700, 5000):
        noise = rng.normal(size=noise_len).astype(np.float32)
        cfg = {"snr": 5, "start_fr": 200, "occ_len": 1500}
        np.testing.assert_array_equal(tcorr.add_audio_noise(audio, noise, cfg),
                                      jcorr.add_audio_noise(audio, noise, cfg))
    for seed in range(4):
        assert (tcorr.sample_audio_corruption(900, np.random.default_rng(seed))
                == jcorr.sample_audio_corruption(900, np.random.default_rng(seed)))
    for name, sr, data in (("i16.wav", 16000, (audio * 8000).astype(np.int16)),
                           ("f32.wav", 16000, audio), ("i32_8k.wav", 8000,
                                                       (audio * 1e8).astype(np.int32)),
                           ("stereo.wav", 16000, np.stack([audio, audio[::-1]], axis=1))):
        wavfile.write(tmp_path / name, sr, data)
        np.testing.assert_array_equal(tcorr.load_wav(tmp_path / name),
                                      jcorr.load_wav(tmp_path / name))


def _records_json(tmp_path, n=4, seed=3):
    path = tmp_path / "test.json"
    synthetic.write_json(path, synthetic.make_records(n_uids=n, n_hyps=5, seed=seed))
    return path


@pytest.mark.parametrize("kw", [dict(leave_masks=True), dict(leave_masks=False),
                                dict(mask_threshold=2.0, time_window=0.2),
                                dict(audio_corruption_enabled=False,
                                     visual_corruption_enabled=False)])
def test_mask_dataset_items_match_jax(tmp_path, kw):
    _write_tokenizer(tmp_path)
    data = _records_json(tmp_path)
    want = jhyp.DualHypothesesMaskDataset("test", str(data), tokenizer=JaxTokenizer(tmp_path),
                                          prompts_format="RelPrompt", seed=7, **kw)
    got = hypotheses.DualHypothesesMaskDataset("test", str(data), tokenizer=Tokenizer(tmp_path),
                                               prompts_format="RelPrompt", seed=7, **kw)
    assert len(got) == len(want) == 4
    for i in range(len(got)):
        a, b = got[i], want[i]
        for field in ("uid", "ground_truth", "prompt", "prompt_no_response", "input_ids",
                      "input_ids_no_response", "labels", "audio_bin_labels",
                      "video_bin_labels", "records"):
            assert getattr(a, field) == getattr(b, field), field
        assert ("<<<ASR_MASKS>>>" in a.prompt_no_response) == kw.get("leave_masks", False)


def _tiny_relprompt(tmp_path, seed=5):
    """A tiny fp32 RelPrompt pair: the JAX tree (LoRA B and the classifiers'
    biases non-zero) and the port's model holding it, with the tokenizers
    that know the mask tokens."""
    vocab = _write_tokenizer(tmp_path)
    cfg = helpers.tiny_llama_config(block_size=640, vocab_size=vocab, padding_multiple=1,
                                    **LORA, **RELPROMPT)
    params = jax.tree_util.tree_map(np.asarray, jrp.init_relprompt_params(
        cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for leaf in (params["blocks"]["attn"]["qkv"], params["blocks"]["attn"]["proj"]):
        leaf["lora_B"] = rng.normal(size=leaf["lora_B"].shape).astype(np.float32) * 0.2
    for name in ("audio_noise_classifier", "visual_noise_classifier"):
        for leaf in params[name].values():
            leaf["bias"] = rng.normal(size=leaf["bias"].shape).astype(np.float32)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    jtok, tok = JaxTokenizer(tmp_path), Tokenizer(tmp_path)
    jtok.add_special_tokens(MASK_TOKENS)
    tinf.add_mask_tokens(tok)
    return cfg, params, model, jtok, tok


def test_relprompt_tree_loads_and_saves_both_ways(tmp_path):
    cfg, params, model, _, _ = _tiny_relprompt(tmp_path)
    assert model.wte.weight.shape[0] == cfg.padded_vocab_size + 3
    assert model.lm_head.weight.shape[0] == cfg.padded_vocab_size
    save_params(tmp_path / "port.npz", tree_from_model(model))
    back = jax_load_params(tmp_path / "port.npz")
    jax_save_params(tmp_path / "jax.npz", params)
    for tree in (back, load_params(tmp_path / "jax.npz")):
        for name in ("audio_noise_classifier", "visual_noise_classifier"):
            for layer, leaves in params[name].items():
                for kind, value in leaves.items():
                    np.testing.assert_array_equal(np.asarray(tree[name][layer][kind]), value)
        np.testing.assert_array_equal(np.asarray(tree["wte"]["weight"]),
                                      params["wte"]["weight"])
    other = GPT(_port_config(cfg), device="cpu", dtype=torch.float32)
    load_tree(other, load_params(tmp_path / "jax.npz"))
    for (name, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), name


def test_mask_tokens_are_read_and_never_emitted(tmp_path):
    """The mask tokens' ids are the extra embedding rows above lm_head's
    vocabulary: the prefill reads them (its logits move with them) and the
    logits have no column for them, as in the JAX package."""
    cfg, params, model, _, tok = _tiny_relprompt(tmp_path)
    ids = [tok.encode(t)[-1] for t in MASK_TOKENS]
    assert ids == [cfg.padded_vocab_size + i for i in range(3)]
    prompt = np.array([[5, 9, ids[0], ids[2], ids[1], 7]], np.int32)
    lengths = np.array([6], np.int32)
    jcache = jgpt.init_cache(cfg, 1, 16, dtype=jnp.float32)
    want, _ = jgpt.prefill(params, cfg, jnp.asarray(prompt), jnp.asarray(lengths), jcache,
                           compute_dtype=jnp.float32)
    got = model.prefill(torch.from_numpy(prompt).long(), torch.from_numpy(lengths).long(),
                        model.init_cache(1, 16))
    assert got.shape == (1, cfg.padded_vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    with torch.no_grad():
        model.wte.weight[ids[2]] += 1.0
    moved = model.prefill(torch.from_numpy(prompt).long(), torch.from_numpy(lengths).long(),
                          model.init_cache(1, 16))
    assert not torch.allclose(moved, got)


def _synthetic_loaders(cfg):
    args = Namespace(whisper_checkpoint=None, feature_dir=None, synthetic_features=True)
    return jft.feature_loader(args, cfg), tft.feature_loader(args, _port_config(cfg))


def test_predict_masks_and_substitution_match_jax(tmp_path):
    cfg, params, model, jtok, tok = _tiny_relprompt(tmp_path)
    data = _records_json(tmp_path)
    jds = jhyp.DualHypothesesMaskDataset("test", str(data), tokenizer=jtok,
                                         prompts_format="RelPrompt", leave_masks=True)
    ds = hypotheses.DualHypothesesMaskDataset("test", str(data), tokenizer=tok,
                                              prompts_format="RelPrompt", leave_masks=True)
    jload, load = _synthetic_loaders(cfg)
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    seen = set()
    for i in range(len(ds)):
        ja, jv, jai, jvi = jinf.predict_masks(params, cfg, jds[i], jload, jrng)
        a, v, ai, vi = tinf.predict_masks(model, model.cfg, ds[i], load, rng)
        assert (a, v) == (ja, jv)
        np.testing.assert_array_equal(ai, jai)
        np.testing.assert_array_equal(vi, jvi)
        assert tinf.substitute_and_encode(tok, ds[i], a, v) == \
            jinf.substitute_and_encode(jtok, jds[i], ja, jv)
        seen.update(a + v)
    assert len(seen) > 1  # the classifiers' biases make the classes differ


@pytest.mark.parametrize("decode_batch", [2, 3])
def test_relprompt_decoding_matches_jax(tmp_path, decode_batch):
    """Masks predicted, substituted and re-encoded, then greedy decoding:
    the port's `run_relprompt` against the JAX package's steps of `main`."""
    cfg, params, model, jtok, tok = _tiny_relprompt(tmp_path)
    data = _records_json(tmp_path, n=5)
    jds = jhyp.DualHypothesesMaskDataset("test", str(data), tokenizer=jtok,
                                         prompts_format="RelPrompt", leave_masks=True)
    jload, load = _synthetic_loaders(cfg)
    jrng = np.random.default_rng(1337)
    examples, preds, targs = [], [], []
    for i in range(len(jds)):
        ex = jds[i]
        a, v, ai, vi = jinf.predict_masks(params, cfg, ex, jload, jrng)
        ex.prompt_no_response, ex.input_ids_no_response = jinf.substitute_and_encode(
            jtok, ex, a, v)
        gt_a, gt_v = (jmasks.bins_to_indices(b) for b in (ex.audio_bin_labels,
                                                          ex.video_bin_labels))
        ta, tv = min(len(ai), len(gt_a)), min(len(vi), len(gt_v))
        preds.extend(list(ai[:ta]) + list(vi[:tv]))
        targs.extend(gt_a[:ta] + gt_v[:tv])
        examples.append(ex)
    kw = dict(decode_batch=decode_batch, max_new_tokens=6, temperature=0.2, top_k=1)
    want_records, want_metrics = jax_run_inference(params, cfg, jtok, examples,
                                                   compute_dtype=jnp.float32, **kw)
    want_metrics.update({f"mask_{k}": v for k, v in jrp.mask_metrics(
        np.asarray(preds), np.asarray(targs)).items()})
    ds = hypotheses.DualHypothesesMaskDataset("test", str(data), tokenizer=tok,
                                              prompts_format="RelPrompt", leave_masks=True)
    records, metrics, masks = tinf.run_relprompt(model, tok, ds, load, seed=1337, **kw)
    assert records == want_records and len(records) == 5
    assert {k: metrics[k] for k in want_metrics} == want_metrics
    assert sorted(masks) == sorted(r["uid"] for r in records)


def _write_wavs(tmp_path, records, seed=0):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    for rec in records:
        n = rec["Audio_Corruption"]["total_len"]
        rec["Clean_Wav"] = str(tmp_path / f"{rec['Uid']}_clean.wav")
        rec["Noise_Wav"] = str(tmp_path / f"{rec['Uid']}_noise.wav")
        wavfile.write(rec["Clean_Wav"], 16000, (rng.normal(size=n) * 3000).astype(np.int16))
        wavfile.write(rec["Noise_Wav"], 16000,
                      (rng.normal(size=n // 3) * 3000).astype(np.int16))
    return records


def test_relprompt_clis_run_on_cpu(tmp_path):
    """`precompute_features.main` and `inference_relprompt.main` with
    `--device cpu`: a tiny Whisper checkpoint (HF layout), base weights saved
    by the JAX package without the mask rows, a finetuned npz of LoRA and
    classifier leaves; `--whisper_checkpoint` and `--feature_dir` give the
    same masks and answers, and the features are the encoder's."""
    from dualhyp_tpu_torch.models import whisper as tw

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    enc_cfg = jw.WhisperEncoderConfig(n_mels=16, n_ctx=1500, n_state=32, n_head=1,
                                      n_layer=2)
    enc_params = jax.tree_util.tree_map(np.asarray, jw.init_encoder(enc_cfg, jax.random.key(3)))
    write_whisper_checkpoint(tmp_path / "whisper", enc_params, enc_cfg)
    base = helpers.tiny_llama_config(block_size=640, vocab_size=vocab, padding_multiple=1,
                                     **{**RELPROMPT, "use_relprompt": False,
                                        "n_extra_tokens": 0})
    (ckpt / "dualhyp_config.json").write_text(base.to_json())
    jax_save_params(ckpt / "dualhyp_model.npz", jax.tree_util.tree_map(
        np.asarray, jgpt.init(base, jax.random.key(4))))
    rp_cfg = base.replace(use_relprompt=True, n_extra_tokens=3, **LORA)
    tuned = jax.tree_util.tree_map(np.asarray, jrp.init_relprompt_params(rp_cfg,
                                                                       jax.random.key(6)))
    attn = tuned["blocks"]["attn"]
    jax_save_params(tmp_path / "run" / "best_model.npz", {
        "blocks": {"attn": {m: {k: attn[m][k] for k in ("lora_A", "lora_B")}
                            for m in ("qkv", "proj")}},
        "audio_noise_classifier": tuned["audio_noise_classifier"],
        "visual_noise_classifier": tuned["visual_noise_classifier"]})
    records = _write_wavs(tmp_path, synthetic.make_records(n_uids=3, seed=4))
    data = tmp_path / "test.json"
    synthetic.write_json(data, records)

    assert precompute_features.main(["--json", str(data), "--out_dir", str(tmp_path / "feats"),
                                     "--whisper_checkpoint", str(tmp_path / "whisper"),
                                     "--raven_dim", str(RELPROMPT["raven_dim"]),
                                     "--device", "cpu"]) == 3
    rec = records[0]
    with np.load(tmp_path / "feats" / f"{rec['Uid']}.npz") as z:
        audio, visual = z["audio"], z["visual"]
    mel = tw.log_mel_spectrogram(tft.replayed_waveform(rec), 16)
    want = np.asarray(jw.encode(enc_params, enc_cfg, jnp.asarray(mel[None])))[0]
    np.testing.assert_allclose(audio, want, rtol=0, atol=ATOL)
    assert visual.shape == (rec["Visual_Corruption"]["total_len"], rp_cfg.raven_dim)

    common = ["--test_path", str(data), "--llm_checkpoint", str(ckpt), "--dual_hypotheses",
              "--prompts_format", "RelPrompt", "--decode_batch", "2", "--max_new_tokens", "3",
              "--device", "cpu", "--lora_r", "4", "--lora_alpha", "8"]
    outs = {}
    for label, flags in (("whisper", ["--whisper_checkpoint", str(tmp_path / "whisper")]),
                         ("features", ["--feature_dir", str(tmp_path / "feats")])):
        model_path = tmp_path / "run" / "best_model.npz"
        tinf.main([*common, "--model_path", str(model_path), *flags])
        out = tmp_path / "run" / "predictions" / "best_model_relprompt.json"
        outs[label] = json.loads(out.read_text())
        out.unlink()
    def timeless(rows):  # the answers and metrics, without the wall-clock ones
        return [{k: v for k, v in row.items() if "latency" not in k and k != "tokens_per_s"}
                for row in rows]

    assert timeless(outs["whisper"]) == timeless(outs["features"])
    assert len(outs["whisper"]) == 4 and "mask_acc" in outs["whisper"][-1]
    assert outs["whisper"][-1]["generated_tokens"] > 0
