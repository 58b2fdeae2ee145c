"""The port's continuous-batching server against the JAX package's, on the
CPU.

`ContinuousBatcher` (lookup and anchored drafts, float and int8 KV cache)
on a tiny fp32 model: exactly the JAX package's tokens and completion
order, and each request's tokens those of the port's greedy `generate` on
that request alone (refilled slots, per-request budgets); the TCP server
round trip; `cli.serve_ger`'s flags and prompt packing; and RelPrompt
correction with --speculative and --scheduler continuous against the JAX
package's steps of `inference_relprompt.main`.
"""

import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.cli import serve_ger as jserve_cli
from dualhyp_tpu.cli.inference_ger import run_inference as jax_run_inference
from dualhyp_tpu.data import hypotheses as jhyp
from dualhyp_tpu.infer.serve import ContinuousBatcher as JaxBatcher
from dualhyp_tpu_torch.ckpt.convert import params_from_jax
from dualhyp_tpu_torch.cli import inference_relprompt as tinf
from dualhyp_tpu_torch.cli import serve_ger
from dualhyp_tpu_torch.data import hypotheses
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.infer.evaluate import extract_response
from dualhyp_tpu_torch.infer.serve import ContinuousBatcher
from tests import helpers
from tests.test_data import WordTokenizer
from tests.test_torch_gpt import LORA, _jax_params, _port_config

EOS = 5


def _pair(block_size=96):
    cfg = helpers.tiny_llama_config(**LORA, block_size=block_size)
    params = _jax_params(cfg, seed=2)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    return cfg, params, model


def _requests(n=7, seed=0, block_size=96):
    """Prompts from a few ids (the drafts find matches), budgets 3-11, one
    prompt of block_size - 1 (budget cut to 1) and its hypothesis span."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = [int(x) for x in rng.integers(6, 20, size=int(rng.integers(4, 20)))]
        reqs.append((i, p, int(rng.integers(3, 12)), p[1:5]))
    long = [int(x) for x in rng.integers(6, 20, size=block_size - 1)]
    reqs.append((n, long, 8, long[:3]))
    return reqs


def _greedy(model, prompt, cap, kv_quant):
    toks, lens = generate(model, torch.tensor([prompt]), torch.tensor([len(prompt)]),
                          max_new_tokens=cap, top_k=1, eos_id=EOS, kv_quant=kv_quant)
    return toks[0, :int(lens[0])].tolist()


@pytest.mark.parametrize("draft_source, kv_quant", [("lookup", None), ("anchored", "int8")])
def test_batcher_matches_jax_and_greedy(draft_source, kv_quant):
    cfg, params, model = _pair()
    reqs = _requests()
    kw = dict(slots=3, max_new_tokens=10, draft_len=3, chunk_steps=2, eos_id=EOS,
              draft_source=draft_source, kv_quant=kv_quant)
    want = JaxBatcher(params, cfg, compute_dtype=jnp.float32, **kw).serve(reqs)
    batcher = ContinuousBatcher(model, **kw)
    got = batcher.serve(reqs)
    assert [r["id"] for r in got] == [r["id"] for r in want]  # completion order
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"] and g["prompt_len"] == w["prompt_len"]
    # each request alone, greedy, to its budget (cut to fit block_size)
    for rid, prompt, cap, _ in reqs:
        cap = max(min(cap, cfg.block_size - len(prompt)), 1)
        assert next(r for r in got if r["id"] == rid)["tokens"] == \
            _greedy(model, prompt, cap, kv_quant), rid
    # one status read a chunk, one row gather a chunk in which a slot finished
    assert batcher.chunks < batcher.host_reads <= 2 * batcher.chunks


def test_refilled_slots_keep_their_tokens_and_budgets():
    """Two slots for six requests: every slot is refilled, each request
    stops at its own budget or EOS, and a refilled slot's tokens are those
    of its request alone; records are in completion order with latencies."""
    cfg, params, model = _pair()
    reqs = [(rid, p, cap) for rid, p, cap, _ in _requests(n=6, seed=3)[:6]]
    batcher = ContinuousBatcher(model, slots=2, max_new_tokens=10, draft_len=2,
                                chunk_steps=1, eos_id=EOS)
    got = batcher.serve(reqs)
    assert sorted(r["id"] for r in got) == list(range(6)) and batcher.pending == 0
    for rec in got:
        rid, prompt, cap = reqs[rec["id"]]
        assert rec["tokens"][:len(prompt)] == prompt
        assert len(rec["tokens"]) - len(prompt) <= cap
        assert rec["tokens"] == _greedy(model, prompt, cap, None)
        assert rec["latency_s"] >= rec["decode_s"] > 0 and rec["queue_s"] >= 0
    # the default budget when a request names none
    batcher.start()
    batcher.submit("d", reqs[0][1])
    out = []
    while batcher.pending:
        out.extend(batcher.poll())
    assert out[0]["tokens"] == _greedy(model, reqs[0][1], 10, None)


def test_batcher_refuses_what_it_cannot_serve():
    cfg, _, model = _pair()
    batcher = ContinuousBatcher(model, slots=2)
    batcher.start()
    with pytest.raises(ValueError, match="block_size"):
        batcher.submit("x", [7] * cfg.block_size)
    with pytest.raises(ValueError, match="positive"):
        batcher.submit("x", [7, 8], max_new=0)
    with pytest.raises(ValueError, match="another mesh"):
        ContinuousBatcher(model, mesh=object())
    with pytest.raises(ValueError, match="draft_source"):
        ContinuousBatcher(model, draft_source="beam")


def test_request_prompts_match_jax():
    for args in ((["the cat sat", "the bat sat"],), (["dog ran"], ["fog ran", "dog van"])):
        for fmt in ("GER", "DualHyp"):
            assert serve_ger.build_request_prompt(fmt, *args) == \
                jserve_cli.build_request_prompt(fmt, *args)


def test_parser_has_the_jax_flags_but_the_mesh():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    mesh = {"--dp", "--fsdp", "--tensor", "--expert", "--seq"}
    want = flags(jserve_cli.build_parser())
    got = flags(serve_ger.build_parser())
    assert mesh <= want and want <= got and got - want == {"--device", "--seed"}
    args = serve_ger.build_parser().parse_args(["--quantize", "int4"])
    assert args.quantize == "int4" and args.draft_source == "anchored"


def test_serve_ger_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_ger.main(["--port", "0"])


def test_tcp_round_trip():
    """Three requests over a real socket on 127.0.0.1; the raw-prompt one
    answers as offline greedy decoding of its prompt does."""
    tok = WordTokenizer()
    cfg = helpers.tiny_llama_config(block_size=640, vocab_size=len(tok.vocab),
                                    padding_multiple=8, **LORA)
    model = params_from_jax(_jax_params(cfg, seed=0), _port_config(cfg), device="cpu",
                            dtype=torch.float32)
    batcher = ContinuousBatcher(model, slots=2, max_new_tokens=6, draft_len=3,
                                chunk_steps=2, eos_id=tok.eos_token_id)
    server = serve_ger.Server(batcher, tok)
    ready, holder = threading.Event(), {}

    def ready_cb(port):
        holder["port"] = port
        ready.set()

    thread = threading.Thread(target=server.run, args=("127.0.0.1", 0, ready_cb), daemon=True)
    thread.start()
    assert ready.wait(timeout=30)
    prompt = serve_ger.build_request_prompt("GER", ["many people watch", "many people talk"])
    requests = [{"id": "a", "nhyps_asr": ["the cat sat", "the bat sat", "cat sat"]},
                {"id": "b", "nhyps_asr": ["dog ran fast", "dog ran"],
                 "nhyps_vsr": ["dog van fast", "fog ran"]},
                {"id": "c", "prompt": prompt, "max_new": 4}]
    try:
        with socket.create_connection(("127.0.0.1", holder["port"]), timeout=30) as conn:
            for req in requests:
                conn.sendall((json.dumps(req) + "\n").encode())
            conn.sendall(b"not json\n")
            conn.settimeout(120)
            buf, replies, errors = b"", {}, []
            while len(replies) < len(requests) or not errors:
                data = conn.recv(1 << 16)
                assert data, "the server closed early"
                buf += data
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    rec = json.loads(line)
                    (errors.append(rec) if "error" in rec else replies.update({rec["id"]: rec}))
    finally:
        server.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    ids = tok.encode(prompt)
    want = extract_response(tok.decode(_greedy_eos(model, ids, 4, tok.eos_token_id)),
                            tok.decode(ids))
    assert replies["c"]["text"] == want
    assert all(isinstance(replies[r]["text"], str) and replies[r]["latency_s"] > 0
               for r in "ab")
    assert errors[0]["line"] == "not json"


def _greedy_eos(model, ids, cap, eos_id):
    toks, lens = generate(model, torch.tensor([ids]), torch.tensor([len(ids)]),
                          max_new_tokens=cap, top_k=1, eos_id=eos_id)
    return toks[0, :int(lens[0])].tolist()


def test_relprompt_speculative_matches_jax(tmp_path):
    """Masks predicted and substituted, then --speculative: the port's
    `run_relprompt` against the JAX package's steps of
    `inference_relprompt.main`, and the same answers as lockstep
    (--scheduler continuous: `test_relprompt_cli_options_run_on_cpu` and the
    batcher's own tests)."""
    from dualhyp_tpu.cli import inference_relprompt as jinf
    from tests.test_torch_relprompt import _records_json, _synthetic_loaders, _tiny_relprompt

    options = dict(speculative=True)

    cfg, params, model, jtok, tok = _tiny_relprompt(tmp_path)
    data = _records_json(tmp_path, n=3)
    jds = jhyp.DualHypothesesMaskDataset("test", str(data), tokenizer=jtok,
                                         prompts_format="RelPrompt", leave_masks=True)
    jload, load = _synthetic_loaders(cfg)
    jrng = np.random.default_rng(1337)
    examples = []
    for i in range(len(jds)):
        ex = jds[i]
        a, v, _, _ = jinf.predict_masks(params, cfg, ex, jload, jrng)
        ex.prompt_no_response, ex.input_ids_no_response = jinf.substitute_and_encode(
            jtok, ex, a, v)
        examples.append(ex)
    kw = dict(decode_batch=2, max_new_tokens=5, temperature=0.2, top_k=1, draft_len=3)
    want, _ = jax_run_inference(params, cfg, jtok, examples, compute_dtype=jnp.float32,
                                **kw, **options)

    def dataset():
        return hypotheses.DualHypothesesMaskDataset("test", str(data), tokenizer=tok,
                                                    prompts_format="RelPrompt",
                                                    leave_masks=True)

    got, metrics, _ = tinf.run_relprompt(model, tok, dataset(), load, seed=1337, **kw,
                                         **options)
    assert got == want and len(got) == 3 and "mask_acc" in metrics
    lockstep, _, _ = tinf.run_relprompt(model, tok, dataset(), load, seed=1337,
                                        decode_batch=2, max_new_tokens=5)
    assert got == lockstep


def test_serve_ger_main_serves_over_tcp_on_cpu(tmp_path, monkeypatch):
    """`serve_ger.main` with --device cpu: the checkpoint directory's base
    weights and a finetuned npz, 2 requests over TCP, then the loop stops."""
    from tests.test_torch_speculative import write_cli_checkpoint

    ckpt, _, model_path = write_cli_checkpoint(tmp_path)
    servers, ready, holder = [], threading.Event(), {}

    class Recording(serve_ger.Server):
        def run(self, host, port, ready_cb=None):
            servers.append(self)

            def on_ready(bound):
                holder["port"] = bound
                ready.set()

            return super().run(host, port, on_ready)

    monkeypatch.setattr(serve_ger, "Server", Recording)
    argv = ["--model_path", str(model_path), "--llm_checkpoint", str(ckpt), "--port", "0",
            "--device", "cpu", "--lora_r", "4", "--lora_alpha", "8", "--slots", "2",
            "--max_new_tokens", "4", "--draft_len", "2", "--chunk_steps", "2"]
    thread = threading.Thread(target=serve_ger.main, args=(argv,), daemon=True)
    thread.start()
    try:
        assert ready.wait(timeout=60)
        with socket.create_connection(("127.0.0.1", holder["port"]), timeout=30) as conn:
            for rid in ("x", "y"):
                conn.sendall((json.dumps({"id": rid, "nhyps_asr": ["the cat sat", "cat sat"],
                                          "max_new": 3}) + "\n").encode())
            conn.settimeout(120)
            buf, replies = b"", {}
            while len(replies) < 2:
                data = conn.recv(1 << 16)
                assert data, "the server closed early"
                buf += data
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    rec = json.loads(line)
                    replies[rec["id"]] = rec
    finally:
        if servers:
            servers[0].stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert all(isinstance(r["text"], str) for r in replies.values())
    assert servers[0].batcher.model.device == torch.device("cpu")


@pytest.mark.parametrize("entry", [
    ("inference_ger", ["--speculative", "lookup"]), ("inference_ger", ["--speculative",
                                                                      "anchored"]),
    ("inference_ger", ["--scheduler", "continuous"]),
    ("inference_relprompt", ["--speculative"]),
    ("inference_relprompt", ["--scheduler", "continuous"])])
def test_speculative_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    from dualhyp_tpu_torch.cli import inference_ger

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"inference_ger": inference_ger, "inference_relprompt": tinf}[entry[0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--test_path", str(tmp_path / "t.json"), "--model_path",
                     str(tmp_path / "m.npz"), *entry[1]])


def test_relprompt_cli_options_run_on_cpu(tmp_path):
    """`inference_relprompt.main` with --device cpu and synthetic features:
    --speculative and --scheduler continuous write the lockstep answers."""
    import jax

    from dualhyp_tpu.ckpt.io import save_params as jax_save_params
    from dualhyp_tpu.models import gpt as jgpt
    from dualhyp_tpu.models import relprompt as jrp
    from dualhyp_tpu_torch.data import synthetic
    from tests.test_torch_decode import _write_tokenizer
    from tests.test_torch_relprompt import RELPROMPT

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    base = helpers.tiny_llama_config(block_size=320, vocab_size=vocab, padding_multiple=1,
                                     **{**RELPROMPT, "use_relprompt": False,
                                        "n_extra_tokens": 0})
    (ckpt / "dualhyp_config.json").write_text(base.to_json())
    jax_save_params(ckpt / "dualhyp_model.npz", jax.tree_util.tree_map(
        np.asarray, jgpt.init(base, jax.random.key(4))))
    tuned = jax.tree_util.tree_map(np.asarray, jrp.init_relprompt_params(
        base.replace(use_relprompt=True, n_extra_tokens=3, **LORA), jax.random.key(6)))
    jax_save_params(tmp_path / "run" / "best_model.npz", {
        "audio_noise_classifier": tuned["audio_noise_classifier"],
        "visual_noise_classifier": tuned["visual_noise_classifier"]})
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=3, n_hyps=2, seed=4))
    argv = ["--test_path", str(data), "--llm_checkpoint", str(ckpt), "--dual_hypotheses",
            "--prompts_format", "RelPrompt", "--decode_batch", "2", "--max_new_tokens", "3",
            "--device", "cpu", "--lora_r", "4", "--lora_alpha", "8", "--synthetic_features",
            "--draft_len", "2", "--model_path", str(tmp_path / "run" / "best_model.npz")]
    out = tmp_path / "run" / "predictions" / "best_model_relprompt.json"
    tinf.main(argv)
    want = json.loads(out.read_text())[:-1]
    for flags in (["--speculative"], ["--scheduler", "continuous"]):
        tinf.main([*argv, *flags])
        rows = json.loads(out.read_text())
        assert rows[:-1] == want and rows[-1]["verify_steps"] > 0, flags
