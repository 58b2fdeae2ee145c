"""The port's speculative decoding against the JAX package's, on the CPU.

`chunk_decode_attention` (float and int8 cache) in fp32 to 1e-6 and in bf16
to 2 bf16 ulps of the largest output (the same fp32 products and softmax,
one rounding of P and of the output each, sums in another order);
`GPT.verify_step` logits against the JAX package's and against K
successive `decode_step`s (1e-4, as test_torch_gpt.py holds the prefill);
`generate_lookup` and `generate_anchored`, float and int8 KV cache, token
for token equal to the JAX package's and to the port's greedy `generate`
(tiny fp32 model: no argmax near-ties); the anchored draft's pointer; the
buffer's end, where drafts run past block_size; and the CLI's
--speculative, --scheduler continuous and --dry_run against the JAX
package's `run_inference`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.cli.inference_ger import run_inference as jax_run_inference
from dualhyp_tpu.data import hypotheses as jhyp
from dualhyp_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from dualhyp_tpu.infer import decode as jdecode
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops import attention as jattn
from dualhyp_tpu.ops.quant import q8_rows as jax_q8_rows
from dualhyp_tpu_torch.ckpt.convert import params_from_jax
from dualhyp_tpu_torch.cli import inference_ger
from dualhyp_tpu_torch.data import hypotheses, synthetic
from dualhyp_tpu_torch.data.tokenizer import Tokenizer
from dualhyp_tpu_torch.infer import decode
from dualhyp_tpu_torch.ops import attention
from tests import helpers
from tests.test_torch_decode import _write_tokenizer
from tests.test_torch_gpt import LORA, _jax_params, _port_config

BF16_ULP = 2.0 ** -7  # one bf16 ulp relative to a value in [1, 2)


def _cache_case(rng, dtype, int8, b=3, hq=8, g=2, s=24, d=16, k=5):
    q = rng.normal(size=(b, hq, k, d)).astype(np.float32)
    kc = rng.normal(size=(b, g, s, d)).astype(np.float32)
    vc = rng.normal(size=(b, g, s, d)).astype(np.float32)
    start = np.array([0, 7, s - k], np.int32)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, kc, vc))
    scales = (None, None)
    if int8:
        (jk, ks), (jv, vs) = jax_q8_rows(jk), jax_q8_rows(jv)
        scales = (ks, vs)
    return jq, jk, jv, jnp.asarray(start), scales


def _torch(x):
    if x is None:
        return None
    return torch.from_numpy(np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_decode_attention_matches_jax(dtype, int8):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, start, (ks, vs) = _cache_case(np.random.default_rng(1), jdt, int8)
    want = np.asarray(jattn.chunk_decode_attention(jq, jk, jv, start, k_scale=ks,
                                                   v_scale=vs).astype(jnp.float32))
    cast = (lambda x: _torch(x).to(tdt))
    got = attention.chunk_decode_attention(
        cast(jq), _torch(jk).to(torch.int8) if int8 else cast(jk),
        _torch(jv).to(torch.int8) if int8 else cast(jv), _torch(start).long(),
        k_scale=_torch(ks), v_scale=_torch(vs))
    assert got.dtype == tdt
    atol = 1e-6 if dtype == "float32" else 2 * BF16_ULP * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_chunk_decode_attention_at_one_token_is_decode_attention():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(3, 8, 1, 16)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.normal(size=(3, 2, 20, 16)).astype(np.float32))
              for _ in range(2))
    start = torch.tensor([0, 5, 19])
    torch.testing.assert_close(attention.chunk_decode_attention(q, kc, vc, start),
                               attention.decode_attention(q, kc, vc, start + 1),
                               rtol=0, atol=1e-7)


def _pair(seed=2, **kw):
    cfg = helpers.tiny_llama_config(**LORA, **kw)
    params = _jax_params(cfg, seed=seed)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    return cfg, params, model


def _prompts(seed=0, b=3, t=12, vocab=20):
    """Prompts drawn from a few ids, so the suffix lookup finds matches."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(b, t)).astype(np.int32)
    lengths = np.array([t, t // 2, t - 3][:b], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_verify_step_matches_jax_and_successive_decode_steps(kv_quant):
    cfg, params, model = _pair()
    ids, lengths = _prompts()
    chunk = np.random.default_rng(3).integers(3, 90, size=(3, 5)).astype(np.int32)
    s = 30
    jcache = jgpt.init_cache(cfg, 3, s, dtype=jnp.float32, quantize=kv_quant)
    _, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths), jcache,
                             compute_dtype=jnp.float32)
    want, jcache = jgpt.verify_step(params, cfg, jnp.asarray(chunk), jnp.asarray(lengths),
                                    jcache, compute_dtype=jnp.float32)
    tids, tlens = torch.from_numpy(ids).long(), torch.from_numpy(lengths).long()
    cache = model.init_cache(3, s, quantize=kv_quant)
    model.prefill(tids, tlens, cache)
    got = model.verify_step(torch.from_numpy(chunk).long(), tlens, cache)
    assert got.shape == (3, 5, cfg.padded_vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for c, jc in zip(cache[0], (jcache["k"][0], jcache["v"][0])):
        np.testing.assert_allclose(c.float().numpy(), np.asarray(jc, np.float32),
                                   rtol=0, atol=1e-4 if kv_quant is None else 1)
    # the same K tokens one decode step at a time
    cache = model.init_cache(3, s, quantize=kv_quant)
    model.prefill(tids, tlens, cache)
    steps = torch.stack([model.decode_step(torch.from_numpy(chunk[:, i]).long(), tlens + i,
                                           cache) for i in range(5)], dim=1)
    np.testing.assert_allclose(steps.numpy(), got.numpy(), rtol=0, atol=1e-4)


def _greedy(model, ids, lengths, max_new, eos_id=None, kv_quant=None):
    toks, lens = decode.generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                                 max_new_tokens=max_new, top_k=1, eos_id=eos_id,
                                 kv_quant=kv_quant)
    return toks.numpy(), lens.numpy()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("mode", ["lookup", "anchored"])
def test_speculative_tokens_match_jax_and_greedy(mode, kv_quant):
    cfg, params, model = _pair()
    ids, lengths = _prompts()
    # an EOS id that a row emits after a few tokens: rows stop at different
    # steps
    want_toks, _ = _greedy(model, ids, lengths, 12, kv_quant=kv_quant)
    new = [list(want_toks[i, lengths[i]:lengths[i] + 12]) for i in range(3)]
    row, s = next((r, s) for r in range(3) for s in range(3, 12) if new[r][s] not in new[r][:s])
    eos_id = int(new[row][s])
    kw = dict(max_new_tokens=12, eos_id=eos_id, draft_len=4, return_steps=True,
              kv_quant=kv_quant)
    span_start, span_len = np.array([2, 0, 1]), np.array([5, 0, 4])
    if mode == "lookup":
        want = jdecode.generate_lookup(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                       compute_dtype=jnp.float32, **kw)
        got = decode.generate_lookup(model, ids, lengths, **kw)
    else:
        want = jdecode.generate_anchored(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                         jnp.asarray(span_start), jnp.asarray(span_len),
                                         compute_dtype=jnp.float32, **kw)
        got = decode.generate_anchored(model, ids, lengths, span_start, span_len, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2][0] == int(want[2][0])  # verify steps
    np.testing.assert_array_equal(got[2][1].numpy(), np.asarray(want[2][1]))
    greedy_toks, greedy_lens = _greedy(model, ids, lengths, 12, eos_id, kv_quant)
    np.testing.assert_array_equal(got[0].numpy(), greedy_toks)
    np.testing.assert_array_equal(got[1].numpy(), greedy_lens)
    assert got[1][row] == lengths[row] + s  # stopped at the EOS, not counted


def test_speculation_accepts_drafts_when_the_model_copies():
    """A model that repeats its prompt (lm_head = wte, so the argmax of the
    next token tends to repeat tokens) accepts drafts: fewer verify steps
    than tokens, still the greedy tokens."""
    cfg, params, model = _pair(seed=7)
    ids = np.tile(np.arange(3, 9, dtype=np.int32), 4)[None, :20]
    lengths = np.array([20], np.int32)
    toks, lens, (steps, emitted) = decode.generate_lookup(model, ids, lengths,
                                                          max_new_tokens=16, draft_len=6,
                                                          return_steps=True)
    greedy_toks, greedy_lens = _greedy(model, ids, lengths, 16)
    np.testing.assert_array_equal(toks.numpy(), greedy_toks)
    assert steps <= int(emitted[0]) - 1


def _draft_case(seed=4, b=4, s=40):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 9, size=(b, s)).astype(np.int32)
    lengths = np.array([30, 6, 2, 25], np.int32)
    ptr = np.array([0, 3, 0, 9], np.int32)
    span_start = np.array([4, 1, 0, 10], np.int32)
    span_len = np.array([12, 4, 0, 8], np.int32)
    return tokens, lengths, ptr, span_start, span_len


def test_proposals_and_anchored_pointer_match_jax():
    tokens, lengths, ptr, span_start, span_len = _draft_case()
    t = lambda x: torch.from_numpy(x).long()  # noqa: E731
    for ngram in (1, 3):
        want = jax.vmap(lambda tb, lb: jdecode._lookup_propose(
            tb, lb, draft_len=5, ngram=ngram))(jnp.asarray(tokens), jnp.asarray(lengths))
        got = decode._lookup_propose(t(tokens), t(lengths), draft_len=5, ngram=ngram)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want_d, want_pos = jax.vmap(lambda *a: jdecode._anchored_propose(
            *a, draft_len=5, ngram=ngram))(*(jnp.asarray(x) for x in
                                             (tokens, lengths, ptr, span_start, span_len)))
        got_d, got_pos = decode._anchored_propose(t(tokens), t(lengths), t(ptr),
                                                  t(span_start), t(span_len), draft_len=5,
                                                  ngram=ngram)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    assert (got_pos.numpy() == -1).any() and (got_pos.numpy() >= 0).any()


def test_find_subsequence_span_matches_jax():
    prompt = [5, 6, 7, 8, 6, 7, 9]
    for sub in ([6, 7], [7, 9], [], [1], prompt, prompt + [1]):
        assert decode.find_subsequence_span(prompt, sub) == \
            jdecode.find_subsequence_span(prompt, sub)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_buffer_end_matches_jax(kv_quant):
    """Prompt plus budget exactly block_size: the last verify windows run up
    to draft_len slots past block_size. The JAX package gathers NaN RoPE rows
    there (`jnp.take` fills), which from the second layer on reach the
    row's earlier queries through P V; the port gathers the same NaN rows
    (no index past the end) and gives exactly the JAX package's tokens,
    which then may differ from greedy's in the last tokens."""
    cfg, params, model = _pair()
    ids, lengths = _prompts(t=12)
    max_new = cfg.block_size - ids.shape[1]
    kw = dict(max_new_tokens=max_new, draft_len=4, kv_quant=kv_quant)
    want = jdecode.generate_lookup(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                   compute_dtype=jnp.float32, **kw)
    got = decode.generate_lookup(model, ids, lengths, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the NaN rows themselves
    positions = torch.tensor([[cfg.block_size - 2 + i for i in range(4)]])
    from dualhyp_tpu_torch.ops import rope

    cos, _ = rope.gather_rope_rows(model.cos, model.sin, positions)
    assert torch.isfinite(cos[0, 0, :2]).all() and torch.isnan(cos[0, 0, 2:]).all()
    with pytest.raises(ValueError, match="block_size"):
        decode.generate_lookup(model, ids, lengths, max_new_tokens=max_new + 1)


# ---- the CLI's options against the JAX package's run_inference ----

@pytest.fixture
def corpus(tmp_path):
    vocab_size = _write_tokenizer(tmp_path)
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=5, n_hyps=2, seed=3))
    cfg = helpers.tiny_llama_config(block_size=256, vocab_size=vocab_size,
                                    padding_multiple=8, **LORA)
    params = _jax_params(cfg, seed=5)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    return tmp_path, data, cfg, params, model


@pytest.mark.parametrize("options", [
    dict(speculative="lookup"), dict(speculative="anchored"),
    dict(scheduler="continuous", speculative="anchored"),
    dict(speculative="lookup", kv_quant="int8")])
def test_run_inference_options_match_jax(corpus, options):
    tmp_path, data, cfg, params, model = corpus

    def dataset(cls, tok):
        return cls("test", str(data), tokenizer=tok, prompts_format="DualHyp", seed=1337)

    jtok, tok = JaxTokenizer(tmp_path), Tokenizer(tmp_path)
    kw = dict(decode_batch=2, max_new_tokens=6, temperature=0.2, top_k=1, draft_len=3,
              **options)
    want_records, want_metrics = jax_run_inference(
        params, cfg, jtok, dataset(jhyp.DualHypothesesDataset, jtok),
        compute_dtype=jnp.float32, **kw)
    got_records, got_metrics = inference_ger.run_inference(
        model, tok, dataset(hypotheses.DualHypothesesDataset, tok), collect_latency=True,
        **kw)
    assert got_records == want_records and len(got_records) == 5
    assert {k: got_metrics[k] for k in want_metrics} == want_metrics
    assert got_metrics["generated_tokens"] > 0 and got_metrics["verify_steps"] > 0
    # the lockstep greedy path's answers
    greedy, _ = inference_ger.run_inference(
        model, tok, dataset(hypotheses.DualHypothesesDataset, tok), decode_batch=2,
        max_new_tokens=6, kv_quant=options.get("kv_quant"))
    assert got_records == greedy


def test_speculative_options_need_greedy(corpus):
    tmp_path, data, cfg, params, model = corpus
    ds = hypotheses.DualHypothesesDataset("test", str(data), tokenizer=Tokenizer(tmp_path),
                                          prompts_format="DualHyp")
    for options in (dict(speculative="lookup"), dict(scheduler="continuous")):
        with pytest.raises(ValueError, match="greedy"):
            inference_ger.run_inference(model, Tokenizer(tmp_path), ds, top_k=2, **options)


def test_dry_run_matches_jax(corpus, capsys):
    from dualhyp_tpu.cli import inference_ger as jinf

    tmp_path, data, *_ = corpus
    argv = ["--test_path", str(data), "--model_path", "m.npz", "--llm_checkpoint",
            str(tmp_path), "--dual_hypotheses", "--prompts_format", "DualHyp", "--dry_run"]
    jinf.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    inference_ger.main(argv)  # no device named: --dry_run loads no weights
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["examples"] == 5


def write_cli_checkpoint(tmp_path):
    """A checkpoint directory the CLIs read (the JAX package's base weights,
    a word tokenizer), a LoRA-only finetuned npz and a test JSON."""
    from dualhyp_tpu.ckpt.io import save_params

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab_size = _write_tokenizer(ckpt)
    cfg = helpers.tiny_llama_config(block_size=256, vocab_size=vocab_size,
                                    padding_multiple=8, **LORA)
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    params = _jax_params(cfg, seed=1)
    save_params(ckpt / "dualhyp_model.npz", params)
    attn = params["blocks"]["attn"]
    save_params(tmp_path / "run" / "best_model.npz",
                {"blocks": {"attn": {m: {k: attn[m][k] for k in ("lora_A", "lora_B")}
                                     for m in ("qkv", "proj")}}})
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=3, n_hyps=2, seed=4))
    return ckpt, data, tmp_path / "run" / "best_model.npz"


@pytest.fixture
def cli_checkpoint(tmp_path):
    return write_cli_checkpoint(tmp_path)


def test_inference_cli_options_run_on_cpu(cli_checkpoint):
    """`inference_ger.main` with --device cpu: --speculative lookup and
    anchored and --scheduler continuous write the lockstep run's answers."""
    ckpt, data, model_path = cli_checkpoint
    argv = ["--test_path", str(data), "--model_path", str(model_path), "--llm_checkpoint",
            str(ckpt), "--dual_hypotheses", "--prompts_format", "DualHyp", "--decode_batch",
            "2", "--max_new_tokens", "4", "--device", "cpu", "--lora_r", "4",
            "--lora_alpha", "8", "--draft_len", "3"]
    out = model_path.parent / "predictions" / "best_model.json"

    def answers(flags):
        inference_ger.main([*argv, *flags])
        rows = json.loads(out.read_text())
        return rows[:-1], rows[-1]

    want, _ = answers([])
    for flags in (["--speculative"], ["--speculative", "anchored"],
                  ["--scheduler", "continuous"]):
        got, metrics = answers(flags)
        assert got == want, flags
        assert metrics["verify_steps"] > 0 and metrics["generated_tokens"] > 0
