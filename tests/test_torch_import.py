"""The port stands alone: no JAX, nothing of the JAX package, and no silent
CPU run when there is no card."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import dualhyp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dualhyp_tpu_torch.__path__, "dualhyp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "dualhyp_tpu"
             or m.startswith("dualhyp_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for module in ("dualhyp_tpu_torch.ops.attention", "dualhyp_tpu_torch.models.gpt",
                   "dualhyp_tpu_torch.cli.inference_ger", "dualhyp_tpu_torch.ckpt.convert",
                   "dualhyp_tpu_torch.ops.flash_fwd", "dualhyp_tpu_torch.models.whisper",
                   "dualhyp_tpu_torch.models.relprompt", "dualhyp_tpu_torch.data.masks",
                   "dualhyp_tpu_torch.data.corruption",
                   "dualhyp_tpu_torch.cli.inference_relprompt",
                   "dualhyp_tpu_torch.cli.finetune_relprompt",
                   "dualhyp_tpu_torch.cli.precompute_features",
                   "dualhyp_tpu_torch.cli.make_json_asr", "dualhyp_tpu_torch.ops.gmm",
                   "dualhyp_tpu_torch.ops.splash", "dualhyp_tpu_torch.ckpt.convert_hf",
                   "dualhyp_tpu_torch.utils.profiling"):
        assert module in result["imported"]


def test_kernel_list_names_every_wrapper():
    """`ops.KERNELS`: the fifteen hand-written kernels, each a `_lib.Kernel`
    with its own C entry point and launch count."""
    from dualhyp_tpu_torch.ops import KERNELS, TRANSPOSED, _lib

    assert sorted(KERNELS) == sorted([
        "rms_norm", "apply_rope", "flash_attention_fwd", "flash_attention_bwd", "swiglu_mlp",
        "lora_linear", "q4_matmul", "full_attention_fwd", "causal_attention_fwd",
        "grouped_matmul", "grouped_matmul_dlhs", "grouped_matmul_drhs",
        "splash_attention_fwd", "splash_attention_dq", "splash_attention_dkv"])
    kernels = [*KERNELS.values(), *TRANSPOSED.values()]
    assert all(isinstance(k, _lib.Kernel) and isinstance(k.launches, int) for k in kernels)
    assert len({id(k) for k in kernels}) == len(kernels)
    assert len({k.symbol for k in KERNELS.values()}) == len(KERNELS)


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / "dualhyp_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
              *(REPO / "scripts").glob("torch_*.py")]))
def test_no_source_file_imports_jax(path):
    roots = set(_imported_roots(REPO / path))
    assert not roots & {"jax", "jaxlib", "dualhyp_tpu"}, roots


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.ckpt.convert import params_from_jax
    from dualhyp_tpu_torch.cli import inference_ger
    from dualhyp_tpu_torch.device import resolve_device
    from dualhyp_tpu_torch.models.gpt import GPT

    cfg = config_from_name("tiny-llama-1.1b-chat", n_layer=1, lora_r=16,
                           lora_query=True, lora_key=True, lora_value=True,
                           lora_projection=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_ger.main(["--test_path", str(tmp_path / "t.json"),
                            "--model_path", str(tmp_path / "m.npz")])
    assert resolve_device("cpu") == torch.device("cpu")


def test_relprompt_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from dualhyp_tpu_torch.ckpt.convert import encoder_from_jax
    from dualhyp_tpu_torch.cli import inference_relprompt, precompute_features
    from dualhyp_tpu_torch.cli.make_json_asr import load_whisper

    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_relprompt.main(["--test_path", str(tmp_path / "t.json"),
                                  "--model_path", str(tmp_path / "m.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        precompute_features.main(["--json", str(tmp_path / "t.json"), "--out_dir",
                                  str(tmp_path / "f"), "--whisper_checkpoint", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_whisper(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder_from_jax({})


@pytest.mark.parametrize("flag", [["--speculative"], ["--scheduler", "continuous"]])
def test_unported_cli_options_raise(tmp_path, flag):
    """Speculative decoding and continuous batching are ported, greedy only,
    as in the JAX package: with sampling (top_k > 1) they raise."""
    from dualhyp_tpu_torch.cli import inference_ger

    with pytest.raises(ValueError, match="greedy"):
        inference_ger.main(["--test_path", "t.json", "--model_path", "m.npz",
                            "--device", "cpu", "--top_k", "2", *flag])


@pytest.mark.parametrize("flag", [["--speculative"], ["--scheduler", "continuous"]])
def test_unported_relprompt_options_raise(flag):
    """As `test_unported_cli_options_raise`, for RelPrompt correction."""
    from dualhyp_tpu_torch.cli import inference_relprompt

    with pytest.raises(ValueError, match="greedy"):
        inference_relprompt.main(["--test_path", "t.json", "--model_path", "m.npz",
                                  "--device", "cpu", "--top_k", "2", *flag])


def test_precompute_features_refuses_the_visual_encoder(tmp_path):
    """The BRAVEn visual encoder is ported: a --raven_checkpoint that is not
    there is refused before anything else is read."""
    from dualhyp_tpu_torch.cli import precompute_features

    with pytest.raises(FileNotFoundError, match="braven.npz"):
        precompute_features.main(["--json", "t.json", "--out_dir", str(tmp_path),
                                  "--whisper_checkpoint", str(tmp_path), "--device", "cpu",
                                  "--raven_checkpoint", "braven.npz"])


@pytest.mark.parametrize("flag", [["--quantize", "int8"], ["--quantize", "int4"],
                                  ["--kv_quant", "int8"]])
def test_quantized_cli_options_run(tmp_path, flag):
    """Each quantization flag of the correction CLI on a tiny CPU model
    (widths 256 and 512, the smallest that are quantized): the predictions
    JSON holds what `run_inference` gives on the model merged and quantized
    by hand."""
    from dualhyp_tpu_torch.ckpt.convert import tree_from_model
    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.cli import common, inference_ger
    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.data import hypotheses, synthetic
    from dualhyp_tpu_torch.models.gpt import GPT, merge_lora, quantize_model
    from dualhyp_tpu_torch.registry import config_from_checkpoint
    from tests.test_torch_decode import _write_tokenizer

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    cfg = GPTConfig(name="tiny-llama-test", block_size=640, vocab_size=vocab,
                    padding_multiple=128, n_layer=2, n_head=8, n_query_groups=2,
                    n_embd=256, rotary_percentage=1.0, parallel_residual=False, bias=False,
                    norm_class="RMSNorm", mlp_class="LLaMAMLP", intermediate_size=512)
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    lora = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
                lora_projection=True)
    cfg = config_from_checkpoint(ckpt, lora_dropout=0.05, lora_mlp=False, lora_head=False,
                                 **lora)
    finetuned = GPT(cfg, device="cpu", dtype=torch.float32)
    finetuned.init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for block in finetuned.blocks:
            for mod in (block.attn.qkv, block.attn.proj):
                mod.lora_B.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(4))
    attn = tree_from_model(finetuned)["blocks"]["attn"]
    save_params(tmp_path / "run" / "best_model.npz",
                {"blocks": {"attn": {m: {k: attn[m][k] for k in ("lora_A", "lora_B")}
                                     for m in ("qkv", "proj")}}})
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=3, seed=4))
    inference_ger.main(["--test_path", str(data),
                        "--model_path", str(tmp_path / "run" / "best_model.npz"),
                        "--llm_checkpoint", str(ckpt), "--dual_hypotheses",
                        "--prompts_format", "DualHyp", "--decode_batch", "2",
                        "--max_new_tokens", "3", "--device", "cpu", "--lora_r", "4",
                        "--lora_alpha", "8", *flag])
    rows = json.loads((tmp_path / "run" / "predictions" / "best_model.json").read_text())

    model = common.load_model(ckpt, cfg, device="cpu", seed=1337,
                              finetuned=tmp_path / "run" / "best_model.npz")
    if flag[0] == "--quantize":
        quantize_model(merge_lora(model), flag[1])
        assert model.blocks[0].attn.qkv.quant == flag[1]
    tok = common.load_tokenizer(ckpt)
    dataset = hypotheses.DualHypothesesDataset("test", str(data), tokenizer=tok,
                                               prompts_format="DualHyp", seed=1337)
    records, metrics = inference_ger.run_inference(
        model, tok, dataset, decode_batch=2, max_new_tokens=3,
        kv_quant=flag[1] if flag[0] == "--kv_quant" else None)
    assert rows[:-1] == records and len(records) == 3
    assert {k: rows[-1][k] for k in metrics} == metrics
    assert rows[-1]["generated_tokens"] > 0


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
