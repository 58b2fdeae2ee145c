"""The port's Whisper beam searches against the JAX package's, on the CPU.

Same decoder weights (the JAX package's `init_decoder` through
`decoder_from_jax`), same features, same tokenizer: `decode_beams_from_mel`
with the beam on the card's path (`device_beam_search`) and on the host
(`beam_search_nbest` over `CachedWhisperStepper`) over the five option sets
of the JAX package's decoding-rule tests (defaults, no timestamps, patience
2, length penalty 0.6, no suppression), at large-v3's vocabulary of 51866
(the synthetic Whisper tokenizer of `data.synthetic`) and a tiny width; then
`device_beam_search_batch` with 3 utterances of ragged prompts, with int8
cross and self K/V, with int4 weights, a starved beam and a budget that
reaches n_ctx; `sample_nbest` from the same numpy seed. Tokens are held
equal and `avg_logprob` / scores to 1e-5 (fp32 sums in another order); with
int8 self K/V, where a code at a rounding tie may differ by one, to 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.cli import make_json_asr as jcli
from dualhyp_tpu.infer import beam_search as jbs
from dualhyp_tpu.infer.whisper_device_beam import device_beam_search_batch as jbeam
from dualhyp_tpu.models import whisper as jw
from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu_torch.ckpt.convert import decoder_from_jax, encoder_from_jax
from dualhyp_tpu_torch.cli import make_json_asr as tcli
from dualhyp_tpu_torch.data.synthetic import whisper_tokenizer_json
from dualhyp_tpu_torch.data.tokenizer import WhisperTokenizer
from dualhyp_tpu_torch.infer import beam_search as tbs
from dualhyp_tpu_torch.infer.whisper_device_beam import device_beam_search_batch as tbeam
from dualhyp_tpu_torch.infer.whisper_device_beam import topk_lowest_index
from dualhyp_tpu_torch.models import whisper as tw

ATOL = 1e-5
# int8 self K/V: a code at a rounding tie may differ by one between the
# packages (their fp32 inputs agree to ~1e-7), moving a score by ~1e-4
INT8_KV_ATOL = 1e-3
OPTION_SETS = [
    dict(),  # the reference's defaults: timestamps, blank and non-speech suppression
    dict(without_timestamps=True),
    dict(patience=2.0),
    dict(length_penalty=0.6),
    dict(suppress_tokens=None, suppress_blank=False, without_timestamps=True),
]
OPTION_IDS = ["defaults", "no_timestamps", "patience2", "length_penalty", "no_suppression"]


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    path = tmp_path_factory.mktemp("whisper_tok")
    (path / "tokenizer.json").write_text(json.dumps(whisper_tokenizer_json(),
                                                    ensure_ascii=False))
    return WhisperTokenizer(path)


def cfgs(module, **dec):
    enc_cfg = module.WhisperEncoderConfig(n_mels=80, n_ctx=64, n_state=32, n_head=4, n_layer=1)
    dec_cfg = module.WhisperDecoderConfig(**{**dict(n_vocab=51866, n_ctx=48, n_state=32,
                                                    n_head=4, n_layer=1), **dec})
    return enc_cfg, dec_cfg


@pytest.fixture(scope="module")
def whisper_pair():
    """The same tiny whisper in both packages: ((JAX encoder, decoder), (the
    port's))."""
    enc_cfg, dec_cfg = cfgs(jw)
    enc = jax.tree_util.tree_map(np.array, jw.init_encoder(enc_cfg, jax.random.key(0)))
    dec = jax.tree_util.tree_map(np.array, jw.init_decoder(dec_cfg, jax.random.key(1)))
    penc, pdec = cfgs(tw)
    return (((enc, enc_cfg), (dec, dec_cfg)),
            ((encoder_from_jax(enc, device="cpu"), penc),
             (decoder_from_jax(dec, device="cpu"), pdec)))


def assert_same_hyps(want, got, atol=ATOL):
    assert [h.tokens for h in got] == [h.tokens for h in want]
    np.testing.assert_allclose([h.avg_logprob for h in got], [h.avg_logprob for h in want],
                               atol=atol, rtol=0)


def test_topk_lowest_index_matches_lax_top_k(rng):
    x = rng.normal(size=(4, 300)).astype(np.float32)
    x[:, ::3] = -np.inf  # ties, as suppression makes them
    x[1] = -np.inf
    x[2, 10:20] = 1.5
    for k in (1, 6, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = topk_lowest_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
        np.testing.assert_array_equal(np.asarray(want_v), got_v.numpy())


@pytest.mark.parametrize("stepper", ["device", "cached"])
@pytest.mark.parametrize("opts", OPTION_SETS, ids=OPTION_IDS)
def test_decode_beams_match_jax(rng, whisper_pair, tokenizer, opts, stepper):
    (jenc, jdec), (tenc, tdec) = whisper_pair
    mel = rng.normal(size=(80, 128)).astype(np.float32)
    kw = dict(beam_size=5, max_new_tokens=12, stepper=stepper, **opts)
    want, wprefix, wdetok = jcli.decode_beams_from_mel(mel, jenc, jdec, tokenizer, **kw)
    got, gprefix, gdetok = tcli.decode_beams_from_mel(mel, tenc, tdec, tokenizer, **kw)
    assert gprefix == wprefix
    assert_same_hyps(want, got)
    assert [gdetok(h.tokens[len(gprefix):]) for h in got] == [
        wdetok(h.tokens[len(wprefix):]) for h in want]


def small_decoder(**kw):
    dec_cfg = jw.WhisperDecoderConfig(**{**dict(n_vocab=96, n_ctx=64, n_state=64, n_head=4,
                                                n_layer=2), **kw})
    dec = jax.tree_util.tree_map(np.array, jw.init_decoder(dec_cfg, jax.random.key(0)))
    dec["token_embedding"][dec_cfg.n_vocab - 1] *= 3.0  # eos reachable
    return dec_cfg, dec


RAGGED = [[90, 91], [85, 86, 87, 90, 91], [88, 91]]


@pytest.mark.parametrize("case", [
    dict(prefix=RAGGED),
    dict(prefix=RAGGED, quant="int8"),
    dict(prefix=[90, 91], quant="int8", ts=True),
    dict(prefix=RAGGED, ts=True, patience=2.0),
    dict(prefix=RAGGED, int4=True),
], ids=["ragged", "ragged_int8_kv", "shared_int8_kv_ts", "ragged_ts_patience", "int4"])
def test_batched_beam_matches_jax(rng, case):
    kw = dict(n_state=256, n_head=4, n_layer=1) if case.get("int4") else {}
    dec_cfg, dec = small_decoder(**kw)
    if case.get("int4"):
        dec = jquant.quantize_tree(dec, "int4")
        dec = jax.tree_util.tree_map(np.asarray, dec)
    feats = rng.normal(size=(3, 16, dec_cfg.n_state)).astype(np.float32)
    eos = dec_cfg.n_vocab - 1
    opts = dict(beam_size=3, eos_id=eos, max_new_tokens=12, suppress_tokens=[0, 1],
                patience=case.get("patience"))
    jopts, topts = dict(opts), dict(opts)
    if case.get("ts"):
        jopts["timestamp_rules"] = jbs.TimestampRules(70, eos, 69, 3)
        topts["timestamp_rules"] = tbs.TimestampRules(70, eos, 69, 3)
        jopts["suppress_blank_ids"] = topts["suppress_blank_ids"] = [2, eos]
    q = case.get("quant")
    want = jbeam(dec, dec_cfg, jnp.asarray(feats), case["prefix"], cross_kv_quant=q,
                 self_kv_quant=q, **jopts)
    stats = {}
    got = tbeam(decoder_from_jax(dec, device="cpu"), tw.WhisperDecoderConfig(**dec_cfg.__dict__),
                torch.from_numpy(feats), case["prefix"], cross_kv_quant=q, self_kv_quant=q,
                stats=stats, **topts)
    for u in range(3):
        assert_same_hyps(want[u], got[u], INT8_KV_ATOL if q else ATOL)
    # 16 steps a chunk at U > 1: the 12-step budget is one read
    assert stats["chunks"] == 1 and stats["steps"] == 12


def test_starved_beam_returns_live_hypotheses(rng):
    """Every token suppressed: the first selection sees only -inf; the
    finalizer pads from the live beams, as in the JAX package."""
    dec_cfg, dec = small_decoder()
    feats = rng.normal(size=(2, 16, 64)).astype(np.float32)
    kw = dict(beam_size=4, eos_id=95, max_new_tokens=8, suppress_tokens=list(range(96)))
    want = jbeam(dec, dec_cfg, jnp.asarray(feats), [90, 91], **kw)
    got = tbeam(decoder_from_jax(dec, device="cpu"), tw.WhisperDecoderConfig(**dec_cfg.__dict__),
                torch.from_numpy(feats), [90, 91], **kw)
    for u in range(2):
        assert got[u] and got[u][0].tokens[:2] == [90, 91]
        assert [h.tokens for h in got[u]] == [h.tokens for h in want[u]]


def test_budget_capped_at_n_ctx(rng):
    """Prompt plus budget past n_ctx: the beam stops at total length n_ctx +
    1 with finite scores, the positions clipped to the table, as the JAX
    package does."""
    dec_cfg, dec = small_decoder()
    feats = rng.normal(size=(2, 16, 64)).astype(np.float32)
    pre = 30
    prefixes = [rng.integers(2, 90, size=pre).tolist() for _ in range(2)]
    kw = dict(beam_size=4, eos_id=95, max_new_tokens=64, suppress_tokens=[0, 1, 95])
    want = jbeam(dec, dec_cfg, jnp.asarray(feats), prefixes, **kw)
    got = tbeam(decoder_from_jax(dec, device="cpu"), tw.WhisperDecoderConfig(**dec_cfg.__dict__),
                torch.from_numpy(feats), prefixes, **kw)
    cap = dec_cfg.n_ctx - pre + 1
    for u in range(2):
        for h in got[u]:
            assert np.isfinite(h.score) and len(h.tokens) == pre + cap
        assert_same_hyps(want[u], got[u])


@pytest.mark.parametrize("temperature", [0.4, 1.0])
def test_sample_nbest_matches_jax(rng, temperature):
    """The temperature fallback's sampler over the cached stepper: the same
    Gumbel draws from the same numpy seed give the same tokens."""
    dec_cfg, dec = small_decoder()
    feats = rng.normal(size=(1, 16, 64)).astype(np.float32)
    kw = dict(n_samples=4, temperature=temperature, eos_id=95, max_new_tokens=10,
              suppress_tokens=[0, 1], suppress_blank_ids=[2, 95])
    want = jbs.sample_nbest(jcli.CachedWhisperStepper(dec, dec_cfg, jnp.asarray(feats), 12),
                            [90, 91], rng=np.random.default_rng([0, 3, 1]), **kw)
    pdec = decoder_from_jax(dec, device="cpu")
    got = tbs.sample_nbest(tcli.CachedWhisperStepper(
        pdec, tw.WhisperDecoderConfig(**dec_cfg.__dict__), torch.from_numpy(feats), 12),
        [90, 91], rng=np.random.default_rng([0, 3, 1]), **kw)
    assert_same_hyps(want, got)
