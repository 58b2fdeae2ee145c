"""Adapter v2 finetuning of both families in the port against the JAX
Trainer, on the CPU (the configs, batches and tolerances of
test_torch_peft_train.py)."""

import pytest

from tests.test_torch_peft_train import check_training_steps


@pytest.mark.parametrize("run", ["adapter_v2", "adapter_v2_neox"])
def test_training_steps_match_jax(run):
    check_training_steps(run, "")
