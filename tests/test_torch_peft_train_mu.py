"""AdamW's bf16 first moment (`mu_dtype`) in Trainer steps against the JAX
Trainer, on the CPU (the configs, batches and tolerances of
test_torch_peft_train.py)."""

import pytest

from tests.test_torch_peft_train import check_training_steps


@pytest.mark.parametrize("run", ["full", "adapter_v2"])
def test_training_steps_with_a_bf16_first_moment_match_jax(run):
    check_training_steps(run, "bfloat16")


def test_a_bf16_first_moment_saves_and_resumes_exactly(tmp_path):
    """`save_train_state` writes the bf16 moment as it is (`@bf16`) and
    `load_train_state` gives it back in bf16: a resumed trainer's next
    step equals the uninterrupted one's bit for bit."""
    import numpy as np
    import torch

    from dualhyp_tpu_torch.train import TrainConfig, Trainer
    from tests.test_torch_gpt import _port_config
    from tests.test_torch_peft_train import TRAIN, _batch, _cfg_params

    cfg, params = _cfg_params("adapter_v2")
    tcfg = TrainConfig(**{**TRAIN, "mode": "adapter_v2", "mu_dtype": "bfloat16"})
    first = Trainer(_port_config(cfg), tcfg, params, device="cpu")
    first.train_step(_batch(0), 12, 4)
    first.save_train_state(tmp_path / "state.npz")
    with np.load(tmp_path / "state.npz") as z:
        assert any(k.startswith("optstate::exp_avg::") and k.endswith("@bf16") for k in z.files)
    second = Trainer(_port_config(cfg), tcfg, params, device="cpu")
    second.load_train_state(tmp_path / "state.npz")
    for trainer in (first, second):
        trainer.train_step(_batch(1), 12, 4)
    for name, p in first.trainable.items():
        assert torch.equal(p, second.trainable[name]), name
        state = second.optimizer.state[second.trainable[name]]
        assert state["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(first.optimizer.state[p]["exp_avg"], state["exp_avg"]), name
