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
                   "dualhyp_tpu_torch.cli.inference_ger", "dualhyp_tpu_torch.ckpt.convert"):
        assert module in result["imported"]


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / "dualhyp_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
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


@pytest.mark.parametrize("flag", [["--speculative"], ["--quantize", "int8"],
                                  ["--kv_quant", "int8"], ["--scheduler", "continuous"]])
def test_unported_cli_options_raise(tmp_path, flag):
    from dualhyp_tpu_torch.cli import inference_ger

    with pytest.raises(NotImplementedError, match="not ported yet"):
        inference_ger.main(["--test_path", "t.json", "--model_path", "m.npz",
                            "--device", "cpu", *flag])


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
