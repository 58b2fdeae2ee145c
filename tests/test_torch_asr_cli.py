"""The port's offline ASR generator and long-form transcription against the
JAX package's, on the CPU.

`cli.make_json_asr.main` reads a tiny HF-layout Whisper checkpoint written
here (`config.json`, an F32 `model.safetensors`, and the synthetic
large-v3-shaped `tokenizer.json` of `data.synthetic`, vocabulary 51866) and
decodes a manifest of seeded WAVs with noise mixed in (beam 5, decode batch
2, so a batch of 2 and a tail of 1); the JAX package's `make_json` runs on
the same tensors and the same tokenizer (its `load_whisper` patched, as its
own CLI tests patch it). The records are equal, the scores within 1e-5 (1e-3 with int8 self K/V,
whose codes may differ by one at a rounding tie).
`cli.transcribe.main` on a 35-s WAV (two windows, word timestamps, the
temperature fallback through `sample_nbest`) writes the JAX package's
segments and word timings, times within 1e-5 and probabilities within
1e-5. The normalizer and `merge` are held equal to the JAX package's on the
cases of its tests, the normalizer also without the `regex` package.
"""

import json
import sys
import wave

import jax
import numpy as np
import pytest
import torch

from dualhyp_tpu.cli import make_json_asr as jcli
from dualhyp_tpu.cli import transcribe as jtr_cli
from dualhyp_tpu.data import merge as jmerge
from dualhyp_tpu.data import normalizer as jnorm
from dualhyp_tpu.models import whisper as jw
from dualhyp_tpu_torch.ckpt.io import load_safetensors
from dualhyp_tpu_torch.cli import make_json_asr as tcli
from dualhyp_tpu_torch.cli import transcribe as ttr_cli
from dualhyp_tpu_torch.data import merge as tmerge
from dualhyp_tpu_torch.data import normalizer as tnorm
from dualhyp_tpu_torch.data.synthetic import whisper_tokenizer_json
from dualhyp_tpu_torch.data.tokenizer import WhisperTokenizer

ATOL = 1e-5
# int8 self K/V: a code at a rounding tie may differ by one between the
# packages (their fp32 inputs agree to ~1e-7), moving a score by ~1e-4
INT8_KV_ATOL = 1e-3
SR = 16000


def hf_tensors(enc, dec, n_layer_enc, n_layer_dec):
    """The JAX package's encoder and decoder trees under the HF names that
    `convert_hf_whisper_*` read."""
    out = {"model.encoder.conv1.weight": enc["conv1"]["weight"],
           "model.encoder.conv1.bias": enc["conv1"]["bias"],
           "model.encoder.conv2.weight": enc["conv2"]["weight"],
           "model.encoder.conv2.bias": enc["conv2"]["bias"],
           "model.encoder.layer_norm.weight": enc["ln_post"]["scale"],
           "model.encoder.layer_norm.bias": enc["ln_post"]["bias"],
           "model.decoder.embed_tokens.weight": dec["token_embedding"],
           "model.decoder.embed_positions.weight": dec["positional_embedding"],
           "model.decoder.layer_norm.weight": dec["ln"]["scale"],
           "model.decoder.layer_norm.bias": dec["ln"]["bias"]}
    projs = (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"), ("out", "out_proj"))
    for side, tree, n, attns, norms in (
            ("encoder", enc, n_layer_enc, (("attn", "self_attn"),),
             (("attn_ln", "self_attn_layer_norm"), ("mlp_ln", "final_layer_norm"))),
            ("decoder", dec, n_layer_dec, (("attn", "self_attn"), ("cross", "encoder_attn")),
             (("attn_ln", "self_attn_layer_norm"), ("cross_ln", "encoder_attn_layer_norm"),
              ("mlp_ln", "final_layer_norm")))):
        b = tree["blocks"]
        for i in range(n):
            pre = f"model.{side}.layers.{i}."
            for ours, theirs in attns:
                for proj, hname in projs:
                    for leaf, arr in b[ours][proj].items():
                        out[f"{pre}{theirs}.{hname}.{leaf}"] = arr[i]
            for ours, theirs in norms:
                out[f"{pre}{theirs}.weight"] = b[ours]["scale"][i]
                out[f"{pre}{theirs}.bias"] = b[ours]["bias"][i]
            for fc in ("fc1", "fc2"):
                for leaf, arr in b["mlp"][fc].items():
                    out[f"{pre}{fc}.{leaf}"] = arr[i]
    return out


def write_safetensors(path, tensors):
    header, offset, blobs = {}, 0, []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, np.float32)
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        blobs.append(arr.tobytes())
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fp:
        fp.write(len(raw).to_bytes(8, "little"))
        fp.write(raw)
        for blob in blobs:
            fp.write(blob)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny Whisper (width 32, one encoder and two decoder layers, a 30-s
    window of 1500 frames, large-v3's vocabulary) as a HF directory."""
    path = tmp_path_factory.mktemp("whisper_tiny")
    enc_cfg = jw.WhisperEncoderConfig(n_mels=80, n_ctx=1500, n_state=32, n_head=4, n_layer=1)
    dec_cfg = jw.WhisperDecoderConfig(n_vocab=51866, n_ctx=64, n_state=32, n_head=4,
                                      n_layer=2)
    enc = jax.tree_util.tree_map(np.array, jw.init_encoder(enc_cfg, jax.random.key(0)))
    dec = jax.tree_util.tree_map(np.array, jw.init_decoder(dec_cfg, jax.random.key(1)))
    write_safetensors(path / "model.safetensors", hf_tensors(enc, dec, 1, 2))
    (path / "config.json").write_text(json.dumps({
        "num_mel_bins": 80, "max_source_positions": 1500, "d_model": 32,
        "encoder_attention_heads": 4, "encoder_layers": 1, "vocab_size": 51866,
        "max_target_positions": 64, "decoder_attention_heads": 4, "decoder_layers": 2}))
    (path / "tokenizer.json").write_text(json.dumps(whisper_tokenizer_json(),
                                                    ensure_ascii=False))
    return path


def jax_load_whisper(checkpoint_dir, n_mels=128, need_tokenizer=True):
    """The JAX package's `load_whisper` on the port's safetensors reader and
    tokenizer (it reads with `safetensors` and `transformers`)."""
    import jax.numpy as jnp
    from pathlib import Path

    path = Path(checkpoint_dir)
    tensors = {k: v.numpy() for k, v in load_safetensors(path / "model.safetensors").items()}
    hf = json.loads((path / "config.json").read_text())
    enc_cfg = jw.WhisperEncoderConfig(n_mels=hf["num_mel_bins"], n_ctx=hf["max_source_positions"],
                                      n_state=hf["d_model"], n_head=hf["encoder_attention_heads"],
                                      n_layer=hf["encoder_layers"])
    dec_cfg = jw.WhisperDecoderConfig(n_vocab=hf["vocab_size"], n_ctx=hf["max_target_positions"],
                                      n_state=hf["d_model"], n_head=hf["decoder_attention_heads"],
                                      n_layer=hf["decoder_layers"])
    enc = jax.tree_util.tree_map(jnp.asarray, jw.convert_hf_whisper_encoder(tensors, enc_cfg))
    dec = jax.tree_util.tree_map(jnp.asarray, jw.convert_hf_whisper_decoder(tensors, dec_cfg))
    return (enc, enc_cfg), (dec, dec_cfg), WhisperTokenizer(path)


def write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    pcm = (np.clip(rng.normal(scale=0.05, size=int(seconds * SR)), -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as fp:
        fp.setnchannels(1)
        fp.setsampwidth(2)
        fp.setframerate(SR)
        fp.writeframes(pcm.tobytes())


def assert_records_equal(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["nhyps"]["scores"], w["nhyps"]["scores"], atol=atol, rtol=0)
        assert {**g, "nhyps": g["nhyps"]["hyps"]} == {**w, "nhyps": w["nhyps"]["hyps"]}


def test_load_whisper_reads_the_decoder_and_tokenizer(checkpoint, monkeypatch):
    enc, dec, tok = tcli.load_whisper(checkpoint, need_tokenizer=True, need_decoder=True,
                                      device="cpu", dtype=None)
    assert dec[1].n_vocab == 51866 and dec[1].n_layer == 2
    assert dec[0]["token_embedding"].dtype == torch.float32  # an F32 file computes in fp32
    assert tok.convert_tokens_to_ids("<|0.00|>") == 50365
    (jenc, jenc_cfg), (jdec, jdec_cfg), _ = jax_load_whisper(checkpoint)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b.numpy()),
                           jdec, dec[0])
    assert tcli.load_whisper(checkpoint, device="cpu")[1:] == (None, None)
    assert tcli.checkpoint_dtype({"a": torch.zeros(1, dtype=torch.float16)}) == torch.bfloat16
    assert tcli.checkpoint_dtype({"a": torch.zeros(1)}) == torch.float32


@pytest.mark.parametrize("variant", ["fp32", "int8_kv"])
def test_make_json_matches_jax(checkpoint, tmp_path, monkeypatch, variant):
    manifest = tmp_path / "manifest.tsv"
    lines = []
    for i, seconds in enumerate((2.0, 3.5, 2.5)):
        wav = tmp_path / f"u{i}.wav"
        write_wav(wav, seconds, seed=10 + i)
        lines.append(f"u{i}\t{wav}\tThe {i + 2} cats sat on Mr. Smith's mat.")
    manifest.write_text("\n".join(lines) + "\n")
    noise = tmp_path / "noise.wav"
    write_wav(noise, 6.0, seed=99)
    cfg = {"model_checkpoint": str(checkpoint), "manifest": str(manifest),
           "noise_wav": str(noise), "beam_size": 5, "n_best": 5, "max_new_tokens": 8,
           "decode_batch": 2, "seed": 3, "dataset_name": "synthetic"}
    if variant == "int8_kv":
        cfg.update(cross_kv_quant="int8", self_kv_quant="int8")
    (tmp_path / "port.json").write_text(json.dumps({**cfg, "output_file": str(tmp_path / "p.json")}))
    (tmp_path / "jax.json").write_text(json.dumps({**cfg, "output_file": str(tmp_path / "j.json")}))
    tcli.main(["--config", str(tmp_path / "port.json"), "--device", "cpu"])
    monkeypatch.setattr(jcli, "load_whisper", jax_load_whisper)
    jcli.main(["--config", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert len(got) == 3 and all(len(r["nhyps"]["hyps"]) == 5 for r in got)
    assert_records_equal(got, want, INT8_KV_ATOL if variant == "int8_kv" else ATOL)


def test_make_json_yaml_config_and_shards(checkpoint, tmp_path):
    yaml = pytest.importorskip("yaml")
    manifest = tmp_path / "manifest.tsv"
    lines = []
    for i in range(3):
        wav = tmp_path / f"u{i}.wav"
        write_wav(wav, 1.5, seed=i)
        lines.append(f"u{i}\t{wav}\thello {i}")
    manifest.write_text("\n".join(lines) + "\n")
    cfg = {"model_checkpoint": str(checkpoint), "manifest": str(manifest),
           "output_file": str(tmp_path / "out" / "asr.json"), "beam_size": 2,
           "max_new_tokens": 4, "without_timestamps": True}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    records = tcli.main(["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu",
                         "--num_shards", "2", "--shard_index", "1", "--decode_batch", "4"])
    written = json.loads((tmp_path / "out" / "asr_01.json").read_text())
    assert [r["Uid"] for r in written] == ["u1"] and written == records


@pytest.mark.parametrize("extra", [(), ("--cross_kv_quant", "int8", "--self_kv_quant", "int8")],
                         ids=["fp32", "int8_kv"])
def test_transcribe_cli_matches_jax(checkpoint, tmp_path, monkeypatch, extra):
    """Two 30-s windows, beam 2, word timestamps, and the fallback to
    temperature 1.0 through `sample_nbest` (a random model's windows fail
    the log-probability threshold)."""
    wav = tmp_path / "long.wav"
    write_wav(wav, 35.0, seed=5)
    args = [str(wav), "--whisper_checkpoint", str(checkpoint), "--language", "en",
            "--beam_size", "2", "--max_new_tokens", "6", "--word_timestamps",
            "--temperature_increment_on_fallback", "1.0", *extra]
    ttr_cli.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(jcli, "load_whisper", jax_load_whisper)
    jtr_cli.main([*args, "--output_dir", str(tmp_path / "jax")])
    got = json.loads((tmp_path / "port" / "long.json").read_text())
    want = json.loads((tmp_path / "jax" / "long.json").read_text())
    assert len(got) == 2
    assert sum(len(h["segments"]) for h in got) >= 2
    assert any(seg.get("words") for h in got for seg in h["segments"])
    assert any(seg["temperature"] > 0 for h in got for seg in h["segments"])

    def split(obj):
        """(the structure with every float replaced, the floats in order)"""
        floats = []

        def walk(x):
            if isinstance(x, float):
                floats.append(x)
                return "<float>"
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, list):
                return [walk(v) for v in x]
            return x
        return walk(obj), floats

    (gs, gf), (ws, wf) = split(got), split(want)
    assert gs == ws
    np.testing.assert_allclose(gf, wf, atol=INT8_KV_ATOL if extra else ATOL, rtol=0)


def test_dtw_and_median_filter_match_native(rng):
    """Word timing's host ops: the JAX package's `native` DTW (C++ and its
    Python version) and median filters, equal on random and tied costs."""
    from dualhyp_tpu import native
    from dualhyp_tpu.infer import whisper_timing as jtiming
    from dualhyp_tpu_torch.infer import whisper_timing as ttiming

    for trial in range(20):
        n, m = int(rng.integers(1, 15)), int(rng.integers(1, 60))
        cost = rng.normal(size=(n, m)).astype(np.float32)
        if trial % 3 == 0:
            cost = np.round(cost)  # ties
        got = ttiming.dtw(cost)
        for want in (native.dtw(cost), native._dtw_python(cost)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    for shape in ((3, 50), (2, 4, 33), (5, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(ttiming.median_filter_reflect(x, 7),
                                      jtiming.median_filter_reflect(x, 7))
        rows = x.reshape(-1, shape[-1])
        np.testing.assert_array_equal(ttiming.median_filter(rows, 7),
                                      np.stack([native.median_filter(r, 7) for r in rows]))


def adversarial_cases():
    from tests.test_normalizer_full import ADVERSARIAL

    return ADVERSARIAL + [
        "I paid $20,000,000 for it in 1984!", "Fifty percent done.", "it rose 3.5% today",
        "Mr. Smith has two cats", "one hundred and twenty one", "Hello, World!",
        "I can't go", "this [noise] is (uh) fine", "we're   done"]


def test_normalizer_matches_jax(monkeypatch):
    for cls in ("EnglishTextNormalizer", "HypothesisNormalizer", "BasicTextNormalizer"):
        ours, theirs = getattr(tnorm, cls)(), getattr(jnorm, cls)()
        for text in adversarial_cases():
            assert ours(text) == theirs(text), (cls, text)
    for n in (0, 17, 42, 215, 3042, 1_000_000, 123_456_789):
        assert tnorm.number_to_words(n) == jnorm.number_to_words(n)
    text = "naïve café — 12 ÉTÉ"
    with_regex = tnorm.BasicTextNormalizer(split_letters=True)(text)
    monkeypatch.setitem(sys.modules, "regex", None)  # the ImportError branch
    assert (tnorm.BasicTextNormalizer(split_letters=True)(text)
            == jnorm.BasicTextNormalizer(split_letters=True)(text))
    assert with_regex.replace(" ", "") == tnorm.BasicTextNormalizer(
        split_letters=True)(text).replace(" ", "")


def test_merge_matches_jax(tmp_path):
    asr = [{"Uid": "u1", "Caption": "a", "Clean_Wav": "x.wav", "nhyps": {"hyps": ["a1"]},
            "Noise_Category": "babble", "WER_1st-hyp": 0.1, "Audio_Corruption": {"snr": 0}},
           {"Uid": "u2", "Caption": "b", "nhyps": None},
           {"Uid": "u3", "Caption": "c", "nhyps": {"hyps": ["c1"]}}]
    vsr = [{"Uid": "u1", "Mouthroi": "u1.h5", "nhyps": {"hyps": ["v1"]},
            "Noise_Category": "coco", "WER_1st-hyp": 0.5, "Visual_Corruption": {"occ_len": 3}},
           {"Uid": "u2", "nhyps": {"hyps": ["v2"]}}]
    assert tmerge.merge_records(asr, vsr) == jmerge.merge_records(asr, vsr)
    a, v = tmp_path / "a.json", tmp_path / "v.json"
    a.write_text(json.dumps(asr))
    v.write_text(json.dumps(vsr))
    tmerge.merge_json_files(a, v, tmp_path / "o.json")
    jmerge.merge_json_files(a, v, tmp_path / "p.json")
    assert (tmp_path / "o.json").read_text() == (tmp_path / "p.json").read_text()
    with pytest.raises(FileExistsError):
        tmerge.merge_json_files(a, v, tmp_path / "o.json")


def test_slice_modules_import_no_transformers_nor_jax():
    """The slice's modules stand alone on the card's machine: no
    `transformers`, no JAX, nothing of the JAX package."""
    import subprocess
    from pathlib import Path

    code = ("import sys, json\n"
            "import dualhyp_tpu_torch.cli.make_json_asr, dualhyp_tpu_torch.cli.transcribe\n"
            "import dualhyp_tpu_torch.infer.transcribe, dualhyp_tpu_torch.infer.whisper_timing\n"
            "import dualhyp_tpu_torch.data.normalizer, dualhyp_tpu_torch.data.merge\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'jax', 'dualhyp_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
