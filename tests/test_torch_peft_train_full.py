"""Full finetuning (every weight an fp32 master, K4's weight gradients, the
head's and its bias's gradients through the chunked loss) of both families
in the port against the JAX Trainer, on the CPU (the configs, batches and
tolerances of test_torch_peft_train.py)."""

import pytest

from tests.test_torch_peft_train import check_training_steps


@pytest.mark.parametrize("run", ["full", "full_neox"])
def test_training_steps_match_jax(run):
    check_training_steps(run, "")
