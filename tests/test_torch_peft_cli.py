"""`cli.finetune_ger.main` in modes adapter_v2 and full on the CPU (the tiny
checkpoint and corpus of test_torch_train.py): the files it writes, what
they hold, and a resume;
and RelPrompt training under mode "adapter" against the JAX
RelPromptTrainer (tolerances of test_torch_peft_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualhyp_tpu.models import relprompt as jrp
from dualhyp_tpu.train.relprompt import RelPromptTrainConfig as JaxRelConfig
from dualhyp_tpu.train.relprompt import RelPromptTrainer as JaxRelTrainer
from dualhyp_tpu_torch.ckpt.convert import flat_from_named
from dualhyp_tpu_torch.ckpt.io import load_params as io_load
from dualhyp_tpu_torch.train import RelPromptTrainConfig, RelPromptTrainer
from tests.helpers import tiny_llama_config
from tests.test_torch_gpt import _port_config
from tests.test_torch_peft import _randomise
from tests.test_torch_quant import _flat
from tests.test_torch_relprompt_train import RELPROMPT
from tests.test_torch_relprompt_train import _batch as _relprompt_batch
from tests.test_torch_train import _jax_leaf, corpus, tiny_checkpoint  # noqa: F401 (fixtures)


@pytest.mark.parametrize("mode", ["adapter_v2", "full"])
def test_finetune_cli_trains_saves_and_resumes_in_mode(mode, tiny_checkpoint, corpus,
                                                       monkeypatch):
    """`cli.finetune_ger.main --mode ...` on the CPU: one epoch writes the
    CLI's files, with the mode's trainable leaves in fp32 (every weight in
    mode full, the adapter leaves and norms alone under
    --save_adapter_only in adapter_v2); a resumed run reads the moments
    back and takes the second epoch."""
    from dualhyp_tpu_torch.cli import finetune_ger

    monkeypatch.chdir(corpus)
    args = ["--train_path", str(corpus / "train.json"), "--val_path", str(corpus / "val.json"),
            "--llm_checkpoint", str(tiny_checkpoint), "--dual_hypotheses",
            "--prompts_format", "DualHyp", "--batch_size", "4", "--micro_batch_size", "2",
            "--log_interval", "2", "--device", "cpu", "--exp_name", "run", "--mode", mode,
            "--save_adapter_only"]
    finetune_ger.main(args + ["--num_epochs", "1"])
    out = corpus / "runs" / "run"
    with np.load(out / "train_state.npz") as z:
        moments = [k for k in z.files if k.startswith("optstate::exp_avg::")]
        assert moments and all(z[k].dtype == np.float32 for k in moments)
        assert int(z["meta_opt_step"]) == 2
    finetune_ger.main(args + ["--num_epochs", "2", "--resume"])
    with np.load(out / "train_state.npz") as z:
        assert int(z["extra_epoch"]) == 1 and int(z["meta_opt_step"]) == 4
    tree = dict(_flat(io_load(out / "model_lora_finetuned.npz")))
    if mode == "full":
        assert tree["blocks/mlp/fc_1/weight"].dtype == np.float32 and "wte/weight" in tree
    else:
        assert sorted(k for k in tree) == sorted(
            k for k in tree if "adapter" in k or "gating" in k or "norm" in k or "ln_f" in k)
        assert "blocks/attn/adapter_wte" in tree and "blocks/attn/qkv/adapter_scale" in tree
    assert f"mode {mode}: trainable params" in (out / "train.log").read_text()


def test_relprompt_trains_the_adapter_leaves_under_mode_adapter():
    """RelPrompt with adapter v1 (`--mode adapter`): one step against the
    JAX RelPromptTrainer, whose `select_mask` marks the adapter leaves and
    the classifiers: the losses and every trainable leaf."""
    cfg = tiny_llama_config(use_adapter=True, adapter_start_layer=1, **RELPROMPT)
    params = jax.tree_util.tree_map(np.asarray, jrp.init_relprompt_params(
        cfg, jax.random.key(3)))
    _randomise(params, np.random.default_rng(3))
    tkw = dict(learning_rate=1e-3, classifier_learning_rate=3e-3, mask_loss_weight=0.5,
               batch_size=4, micro_batch_size=4, compute_dtype="float32",
               lm_head_chunk_size=0, mode="adapter")
    jax_trainer = JaxRelTrainer(cfg, JaxRelConfig(**tkw),
                                jax.tree_util.tree_map(jnp.asarray, params))
    port = RelPromptTrainer(_port_config(cfg), RelPromptTrainConfig(**tkw), params,
                            device="cpu")
    assert any("adapter_wte" in n for n in port.trainable)
    assert not any("lora_" in n or n.startswith("wte") for n in port.trainable)
    batch = _relprompt_batch(10, cfg)
    want = jax_trainer.train_step(batch, 6, 2, jax.random.key(0))
    got = port.train_step(batch, 6, 2)
    for key in ("loss", "llm_loss", "mask_loss"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5), key
    for key, leaf in flat_from_named(port.trainable, cfg.n_layer).items():
        np.testing.assert_allclose(leaf.detach().numpy(), _jax_leaf(jax_trainer.trainable, key),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
