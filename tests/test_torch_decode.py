"""The port's decoding and correction path against the JAX package's.

fp32 on the CPU, greedy: tokens, lengths, records and metrics must be
identical (the logits agree to ~1e-6, far from any argmax tie here).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.cli.inference_ger import run_inference as jax_run_inference
from dualhyp_tpu.data import hypotheses as jhyp
from dualhyp_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu_torch.ckpt.convert import params_from_jax
from dualhyp_tpu_torch.cli.inference_ger import run_inference
from dualhyp_tpu_torch.data import hypotheses, synthetic
from dualhyp_tpu_torch.data.tokenizer import Tokenizer
from dualhyp_tpu_torch.infer.decode import generate, sample_token
from tests import helpers
from tests.test_torch_gpt import LORA, _jax_params, _port_config


def _prompts():
    rng = np.random.default_rng(11)
    ids = rng.integers(3, 90, size=(3, 10)).astype(np.int32)
    lengths = np.array([10, 4, 7], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


def test_generate_matches_jax_with_eos_stop():
    cfg = helpers.tiny_llama_config(**LORA)
    params = _jax_params(cfg, seed=2)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    ids, lengths = _prompts()
    max_new = 8

    def run_jax(eos_id):
        toks, lens = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                  max_new_tokens=max_new, top_k=1, eos_id=eos_id,
                                  compute_dtype=jnp.float32)
        return np.asarray(toks), np.asarray(lens)

    # an EOS id that some row first emits as its (s+1)-th new token, s >= 1
    toks, _ = run_jax(None)
    new = [list(toks[i, lengths[i]:lengths[i] + max_new]) for i in range(3)]
    row, s = next((r, s) for r in range(3) for s in range(1, max_new)
                  if new[r][s] not in new[r][:s])
    eos_id = int(new[row][s])

    want_toks, want_lens = run_jax(eos_id)
    got_toks, got_lens = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                                  max_new_tokens=max_new, top_k=1, eos_id=eos_id)
    np.testing.assert_array_equal(got_lens.numpy(), want_lens)
    np.testing.assert_array_equal(got_toks.numpy(), want_toks)
    assert got_lens[row] == lengths[row] + s  # stopped early, EOS not counted


def test_sample_token_top_k_draws_within_the_top_k():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0]] * 64)
    gen = torch.Generator().manual_seed(0)
    toks = sample_token(logits, temperature=1.0, top_k=2, generator=gen)
    assert set(toks.tolist()) == {1, 2}
    assert torch.equal(sample_token(logits, temperature=0.2, top_k=1),
                       torch.ones(64, dtype=torch.long))


def _write_tokenizer(ckpt_dir):
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit

    vocab = {"<unk>": 0, "</s>": 1, "<s>": 2}
    for w in synthetic.word_vocabulary():
        vocab[w] = len(vocab)
    for w in ("Below", "###", "Response:", "the", "ASR", "VSR"):
        vocab.setdefault(w, len(vocab))
    tok = HFTok(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.add_special_tokens(["</s>", "<s>"])
    tok.save(str(ckpt_dir / "tokenizer.json"))
    with open(ckpt_dir / "tokenizer_config.json", "w") as fp:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "eos_token": "</s>", "bos_token": "<s>"}, fp)
    return len(tok.get_vocab())


@pytest.mark.parametrize("decode_batch", [2, 3])
def test_run_inference_matches_jax(tmp_path, decode_batch):
    vocab_size = _write_tokenizer(tmp_path)
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=5, n_hyps=5, seed=3))
    cfg = helpers.tiny_llama_config(block_size=640, vocab_size=vocab_size,
                                    padding_multiple=8, **LORA)
    params = _jax_params(cfg, seed=5)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)

    def dataset(cls, tok):
        return cls("test", str(data), tokenizer=tok, prompts_format="DualHyp", seed=1337)

    jtok, tok = JaxTokenizer(tmp_path), Tokenizer(tmp_path)
    kw = dict(decode_batch=decode_batch, max_new_tokens=6, temperature=0.2, top_k=1)
    want_records, want_metrics = jax_run_inference(
        params, cfg, jtok, dataset(jhyp.DualHypothesesDataset, jtok),
        compute_dtype=jnp.float32, **kw)
    got_records, got_metrics = run_inference(
        model, tok, dataset(hypotheses.DualHypothesesDataset, tok), **kw)
    assert got_records == want_records
    assert got_metrics == want_metrics
    assert len(got_records) == 5


def test_inference_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    """`main` end to end on a tiny checkpoint directory: base weights saved
    by the JAX package, a LoRA-only finetuned npz over them, predictions
    JSON written next to it; and random init with a warning without base
    weights. Without `transformers` (as on the card's machine) the
    tokenizer is the package's own `tokenizers` wrapper."""
    import sys

    from dualhyp_tpu.ckpt.io import save_params
    from dualhyp_tpu_torch.cli import inference_ger

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab_size = _write_tokenizer(ckpt)
    cfg = helpers.tiny_llama_config(block_size=640, vocab_size=vocab_size,
                                    padding_multiple=8, **LORA)
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    params = _jax_params(cfg, seed=1)
    save_params(ckpt / "dualhyp_model.npz", params)
    attn = params["blocks"]["attn"]
    save_params(tmp_path / "run" / "best_model.npz",
                {"blocks": {"attn": {m: {k: attn[m][k] for k in ("lora_A", "lora_B")}
                                     for m in ("qkv", "proj")}}})
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=3, seed=4))
    args = ["--test_path", str(data), "--model_path", str(tmp_path / "run" / "best_model.npz"),
            "--llm_checkpoint", str(ckpt), "--dual_hypotheses", "--prompts_format", "DualHyp",
            "--decode_batch", "2", "--max_new_tokens", "3", "--device", "cpu",
            "--lora_r", "4", "--lora_alpha", "8"]
    monkeypatch.setitem(sys.modules, "transformers", None)
    inference_ger.main(args)
    rows = json.loads((tmp_path / "run" / "predictions" / "best_model.json").read_text())
    assert len(rows) == 4 and "WER" in rows[-1] and rows[-1]["generated_tokens"] > 0
    assert "random init" not in capsys.readouterr().out

    (ckpt / "dualhyp_model.npz").unlink()
    inference_ger.main(args)
    assert "random init" in capsys.readouterr().out
