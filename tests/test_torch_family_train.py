"""The GPT-NeoX / Phi / Falcon family's LoRA finetuning in the port against
the JAX Trainer, on the CPU (the configs and parameter draws of
test_torch_family.py, fp32, batch 4 of micro batches 2).

Tolerances, as `test_torch_train.py`: losses 1e-5 relative; LoRA gradients
1e-4 relative L2 per leaf; the LoRA leaves after three steps atol 1e-6,
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualhyp_tpu.train import TrainConfig as JaxTrainConfig
from dualhyp_tpu.train import Trainer as JaxTrainer
from dualhyp_tpu_torch.ckpt.convert import flat_from_named
from dualhyp_tpu_torch.train import TrainConfig, Trainer
from tests.test_torch_family import FAMILY, _params
from tests.test_torch_gpt import _port_config
from tests.test_torch_train import TRAIN, _jax_grads, _jax_leaf, _rel


def _trainers(family, **train_kw):
    cfg, params = _params(family, seed=5)
    tkw = {**TRAIN, **train_kw}
    jax_trainer = JaxTrainer(cfg, JaxTrainConfig(**tkw),
                             jax.tree_util.tree_map(jnp.asarray, params))
    port = Trainer(_port_config(cfg), TrainConfig(**tkw), params, device="cpu")
    return jax_trainer, port


def _batch(seed, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 380, size=(b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    return {"input_ids": ids, "labels": labels}


@pytest.mark.parametrize("family", FAMILY)
def test_lora_training_steps_match_jax(family):
    """One Trainer step (loss and every LoRA gradient), then two more with a
    warmup and cosine schedule (losses and the LoRA leaves)."""
    jax_trainer, port = _trainers(family, use_cosine=True)
    batch = _batch(0)
    want_grads = _jax_grads(jax_trainer, batch)
    for step in range(3):
        batch = _batch(step)
        want_loss, _ = jax_trainer.train_step(batch, 12, 4, jax.random.key(step))
        got_loss, _ = port.train_step(batch, 12, 4)
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
        if step == 0:
            grads = {n: p.grad for n, p in port.trainable.items()}
            for key, g in flat_from_named(grads, port.model_cfg.n_layer).items():
                assert _rel(g.numpy(), _jax_leaf(want_grads, key)) <= 1e-4, key
    for key, leaf in flat_from_named(port.trainable, port.model_cfg.n_layer).items():
        np.testing.assert_allclose(leaf.detach().numpy(), _jax_leaf(jax_trainer.trainable, key),
                                   rtol=1e-4, atol=1e-6)
