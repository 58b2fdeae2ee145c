"""The port's joint CTC/attention beams against the JAX package's, on the CPU.

A tiny ESPnet decoder (vocabulary 14, width 16, 2 blocks) and LM, built as
the JAX package's tests build them (numpy, `tests/test_torch_raven.py`),
carried across by `ckpt.convert.raven_from_jax`; seeded memories and CTC
log-probs of 3 ragged utterances. `joint_device_beam_batch` is held to the
JAX one (tokens equal, scores within 1e-5) with and without CTC, with the
LM, at U = 1 and U = 3, at chunk_steps 1, 3 and 16, under both
`DUALHYP_CTC_IMPL` values of the JAX package (the port keeps one
formulation), on a peaky CTC input that needs the +80-nat rescue, and with
the encoder's device handoff as its input. The CTC prefix scorer, the host
beam and the psi / history functions are held to the JAX package's too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.infer import ctc_prefix as jctc
from dualhyp_tpu.infer import joint_beam_search as jjbs
from dualhyp_tpu.infer import joint_device_beam as jjdb
from dualhyp_tpu.models import espnet_decoder as jed
from dualhyp_tpu.models import espnet_lm as jlm
from dualhyp_tpu_torch.ckpt.convert import raven_from_jax
from dualhyp_tpu_torch.infer import ctc_prefix as tctc
from dualhyp_tpu_torch.infer import joint_beam_search as tjbs
from dualhyp_tpu_torch.infer import joint_device_beam as tjdb
from dualhyp_tpu_torch.models import espnet_decoder as ted
from dualhyp_tpu_torch.models import espnet_lm as tlm
from tests.test_torch_raven import _enc_params, _rnd_builders, decoder_tree, jlm_encoder_config

ODIM, ADIM = 14, 16
SOS = EOS = ODIM - 1
ATOL = 1e-5
DEC = dict(odim=ODIM, attention_dim=ADIM, attention_heads=2, linear_units=32, num_blocks=2)
LM = dict(n_vocab=ODIM, embed_unit=8, att_unit=16, head=2, unit=32, layer=2)


@pytest.fixture(scope="module")
def decoder():
    tree = decoder_tree(3)
    return ((jax.tree_util.tree_map(jnp.asarray, tree), jed.EspnetDecoderConfig(**DEC)),
            (raven_from_jax(tree, device="cpu"), ted.EspnetDecoderConfig(**DEC)))


@pytest.fixture(scope="module")
def lm():
    rnd, lin, ln, _ = _rnd_builders(5)
    jcfg = jlm.EspnetLMConfig(**LM)
    enc = _enc_params(jlm_encoder_config(jcfg), seed=6)
    enc["embed"]["norm"] = ln(16)
    tree = {"embed": {"weight": rnd((ODIM, 8), scale=1.0)}, "encoder": enc,
            "decoder": lin(ODIM, 16)}
    return ((jax.tree_util.tree_map(jnp.asarray, tree), jcfg),
            (raven_from_jax(tree, device="cpu"), tlm.EspnetLMConfig(**LM)))


def utterances(seed, n=3, peaky=False):
    rng = np.random.default_rng(seed)
    mems, ctcs = [], []
    for s, t in ((7, 9), (11, 13), (9, 10))[:n]:
        mems.append(rng.normal(size=(s, ADIM)).astype(np.float32) * 0.5)
        if peaky:  # one label near probability 1 a frame, the rest ~ -110 nats
            x = (np.full((t, ODIM), -110.0) + rng.normal(0, 0.5, (t, ODIM))).astype(np.float32)
            x[np.arange(t), rng.integers(1, ODIM, t)] = -1e-4
            ctcs.append(x)
        else:
            ctcs.append(np.log(rng.dirichlet(np.ones(ODIM), size=t)).astype(np.float32))
    return mems, ctcs


def assert_same_hyps(want, got):
    for u, (a, b) in enumerate(zip(want, got)):
        assert [h.tokens for h in a] == [h.tokens for h in b], u
        np.testing.assert_allclose([h.score for h in b], [h.score for h in a], rtol=ATOL,
                                   atol=ATOL, err_msg=f"utterance {u}")
        np.testing.assert_allclose([h.ctc_score for h in b], [h.ctc_score for h in a],
                                   rtol=ATOL, atol=ATOL, err_msg=f"utterance {u}")


CASES = {
    # name: (utterances, CTC?, LM?, JAX's DUALHYP_CTC_IMPL, peaky CTC)
    "ctc": (3, True, False, "assoc", False),
    "ctc_seq": (3, True, False, "seq", False),
    "attention_only": (3, False, False, "assoc", False),
    "lm": (3, True, True, "assoc", False),
    "single": (1, True, False, "assoc", False),
    "peaky": (3, True, False, "assoc", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_beam_matches_jax(decoder, lm, monkeypatch, case):
    n_utt, use_ctc, use_lm, impl, peaky = CASES[case]
    (jdec, jcfg), (tdec, tcfg) = decoder
    mems, ctcs = utterances(7, n_utt, peaky)
    weights = {"decoder": 0.7, "ctc": 0.3 if use_ctc else 0.0,
               "lm": 0.4 if use_lm else 0.0, "length_bonus": 0.1}
    kw = dict(sos=SOS, eos=EOS, beam_size=4, max_len=10, weights=weights)
    monkeypatch.setenv("DUALHYP_CTC_IMPL", impl)
    want = jjdb.joint_device_beam_batch(jdec, jcfg, mems, ctcs if use_ctc else None,
                                        lm=lm[0] if use_lm else None, **kw)
    for chunk in (1, 3, 16):
        stats = {}
        got = tjdb.joint_device_beam_batch(tdec, tcfg, mems, ctcs if use_ctc else None,
                                           lm=lm[1] if use_lm else None, chunk_steps=chunk,
                                           stats=stats, **kw)
        assert_same_hyps(want, got)
        assert stats["host_reads"] == stats["chunks"] == -(-stats["steps_replayed"] // chunk)


def test_device_handoff_matches_lists(decoder):
    """The encoder's handoff ((U, S_pad, D) tensors and lengths, padded
    frames holding values that must not be read) gives the list form's
    hypotheses."""
    (jdec, jcfg), (tdec, tcfg) = decoder
    mems, ctcs = utterances(8)
    kw = dict(sos=SOS, eos=EOS, beam_size=4, max_len=10, weights={"decoder": 0.6, "ctc": 0.4})
    want = jjdb.joint_device_beam_batch(jdec, jcfg, mems, ctcs, **kw)
    rng = np.random.default_rng(9)
    lens = np.array([len(m) for m in mems])
    tlens = np.array([len(c) for c in ctcs])
    mem_pad = rng.normal(size=(3, 32, ADIM)).astype(np.float32)
    ctc_pad = np.log(rng.dirichlet(np.ones(ODIM), size=(3, 32))).astype(np.float32)
    for i, (m, c) in enumerate(zip(mems, ctcs)):
        mem_pad[i, : len(m)] = m
        ctc_pad[i, : len(c)] = c
    got = tjdb.joint_device_beam_batch(tdec, tcfg, (torch.from_numpy(mem_pad), lens),
                                       (torch.from_numpy(ctc_pad), tlens), **kw)
    assert_same_hyps(want, got)


def test_ctc_prefix_scorer_matches_jax():
    rng = np.random.default_rng(10)
    x = np.log(rng.dirichlet(np.ones(9), size=12)).astype(np.float32)
    js, ts = jctc.CTCPrefixScorer(x, eos=8), tctc.CTCPrefixScorer(x, eos=8)
    np.testing.assert_array_equal(ts.initial_state(), js.initial_state())
    r0 = js.initial_state()
    for y in ([8], [8, 3], [8, 3, 3]):
        cs = np.array([0, 3, 5, 8])
        want = js(y, cs, r0)
        got = ts(y, cs, r0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    ys = [[8, 2], [8, 5]]
    cs = np.array([[2, 5, 8], [1, 5, 0]])
    states = np.stack([r0, r0])
    for a, b in zip(ts.score_batch(ys, cs, states), js.score_batch(ys, cs, states)):
        np.testing.assert_array_equal(a, b)


def test_host_beam_and_full_forward_scorer_match_jax(decoder):
    """`joint_beam_search` (a copy) over the same scorer is the JAX one, and
    the port's full-forward scorer gives the JAX `static_shape_att_fn`'s
    log-probs; the per-utterance beam then gives the device beam's
    hypotheses."""
    (jdec, jcfg), (tdec, tcfg) = decoder
    mems, ctcs = utterances(11, 1)
    jatt = jjbs.static_shape_att_fn(jdec, jcfg, jnp.asarray(mems[0][None]), 4)
    tatt = tjbs.full_forward_att_fn(tdec, tcfg, torch.from_numpy(mems[0]))
    toks = np.random.default_rng(12).integers(0, ODIM, size=(4, 5))
    np.testing.assert_allclose(tatt(toks), jatt(toks), rtol=0, atol=ATOL)
    weights = {"decoder": 0.7, "ctc": 0.3}
    kw = dict(sos=SOS, eos=EOS, beam_size=4, weights=weights, max_len=10)
    want = jjbs.joint_beam_search(jatt, jctc.CTCPrefixScorer(ctcs[0], eos=EOS), **kw)
    got = tjbs.joint_beam_search(jatt, tctc.CTCPrefixScorer(ctcs[0], eos=EOS), **kw)
    assert [(h.tokens, h.score) for h in got] == [(h.tokens, h.score) for h in want]
    ported = tjbs.joint_beam_search(tatt, tctc.CTCPrefixScorer(ctcs[0], eos=EOS), **kw)
    assert_same_hyps([want], [ported])
    device = tjdb.joint_device_beam_batch(tdec, tcfg, mems, ctcs, **kw)
    n = 5
    assert [h.tokens for h in device[0][:n]] == [h.tokens for h in ported[:n]]
    np.testing.assert_allclose([h.score for h in device[0][:n]], [h.score for h in ported[:n]],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("peaky", [False, True])
def test_psi_and_selected_history_match_jax(peaky):
    """`ctc_psi_scores` and `ctc_history_selected` against the JAX
    package's, at several output lengths; on peaky emissions every non-blank
    candidate stays rankable (the +80-nat rescue)."""
    rng = np.random.default_rng(13)
    u, h, k, t, v = 2, 3, 5, 23, 9
    r = u * h
    if peaky:
        ctc_x = (np.full((u, t, v), -110.0) + rng.normal(0, 0.5, (u, t, v))).astype(np.float32)
        np.put_along_axis(ctc_x, rng.integers(1, v, (u, t))[..., None], -1e-4, axis=2)
        r_prev = rng.normal(-30, 3, (r, t, 2)).astype(np.float32)
    else:
        ctc_x = np.log(rng.dirichlet(np.ones(v), (u, t))).astype(np.float32)
        r_prev = rng.normal(-5, 2, (r, t, 2)).astype(np.float32)
    ctc_valid = np.array([t, 11], np.int32)
    last = rng.integers(1, v, (r,)).astype(np.int32)
    cand = rng.integers(0, v, (r, k)).astype(np.int32)
    cand[:, 0], cand[:, 1], cand[:, 2] = last, v - 1, 0  # repeat, eos, blank
    valid_rows = torch.from_numpy(np.repeat(ctc_valid, h).astype(np.int64))
    for out_len in (0, 4, 12):
        want = jax.jit(jjdb._ctc_psi_scores, static_argnums=(6, 7, 8))(
            jnp.asarray(ctc_x), jnp.asarray(ctc_valid), jnp.asarray(r_prev), jnp.asarray(last),
            jnp.asarray(cand), jnp.int32(out_len), 0, v - 1, h)
        got = tjdb.ctc_psi_scores(torch.from_numpy(ctc_x), valid_rows, torch.from_numpy(r_prev),
                                  torch.from_numpy(last).long(), torch.from_numpy(cand).long(),
                                  out_len, 0, v - 1, h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
        if peaky and out_len < 11:  # every row has active frames
            assert got.numpy()[cand != 0].min() > -1e4
        tok = cand[np.arange(r), rng.integers(0, k, r)]
        want_h = jax.jit(jjdb._ctc_history_selected, static_argnums=(6, 7))(
            jnp.asarray(ctc_x), jnp.asarray(ctc_valid), jnp.asarray(r_prev), jnp.asarray(last),
            jnp.asarray(tok), jnp.int32(out_len), 0, h)
        got_h = tjdb.ctc_history_selected(torch.from_numpy(ctc_x), valid_rows,
                                          torch.from_numpy(r_prev), torch.from_numpy(last).long(),
                                          torch.from_numpy(tok).long(), out_len, 0, h)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("t_len", [1, 2, 5, 16, 37])
def test_doubling_scan_is_the_sequential_recurrence(t_len):
    """`affine_scan`'s ceil(log2 T) passes give x[t] = a[t] + x[t-1] ⊕ b[t],
    resets (a = -inf) and carries (b = -inf) included."""
    rng = np.random.default_rng(t_len)
    a = rng.normal(-1, 1, (t_len, 4)).astype(np.float32)
    b = rng.normal(-3, 2, (t_len, 4)).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = -np.inf
    b[rng.random(b.shape) < 0.2] = -np.inf
    a[0] = -np.inf
    want = np.empty_like(b)
    x = np.full(4, -np.inf, np.float32)
    for t in range(t_len):
        x = np.logaddexp(b[t], a[t] + x)
        want[t] = x
    got = tjdb.affine_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
