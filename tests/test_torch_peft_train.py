"""The port's training in modes "lora" (LoRA on the MLP too), "adapter",
"adapter_v2" and "full", with AdamW's `mu_dtype`, against the JAX Trainer,
on the CPU: tiny fp32 configs with every PEFT leaf drawn at random
(test_torch_peft.py), batch 4 of micro batches 2, the head's loss chunked
(T - 1 = 15 positions in chunks of 5). The adapter v2 runs are in
test_torch_peft_train_v2.py, the full ones in test_torch_peft_train_full.py,
the bf16 first moment, RelPrompt and the adapter checkpoints in
test_torch_peft_train_mu.py (each file stays under 40 s in one process).

Tolerances, as `test_torch_train.py` holds the LoRA trainer: losses 1e-5
relative; gradients 1e-4 relative L2 per leaf; trainable leaves and the
first moment after three steps rtol 1e-4, atol 1e-6. Two exceptions, each
with its reason:
  * an element whose exact gradient is zero but whose computed one is fp32
    noise (nonzero, at most 1e-6 of its leaf's largest: the K rows of a
    QKV bias or v2 bias, since softmax ignores a shift shared by every key)
    takes AdamW steps of +-lr whose signs are the noise's, in each package
    its own: such elements are left out of the leaf comparison;
  * with a bf16 first moment both sides round the same fp32 moment, and
    where it sits on a rounding edge they may round it one bf16 ulp apart,
    which moves that element's update by up to 2^-8 of itself: at most 10%
    of a leaf's elements may then differ by more than the fp32 bound, none
    by more than 3 steps x lr x 2^-7, and the moments may differ by one
    bf16 ulp of the element or of the leaf's largest moment (the AdamW
    arithmetic itself is held to optax's in `test_adamw_is_optax_adamw`).
The frozen leaves stay bit for bit unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.train import TrainConfig as JaxTrainConfig
from dualhyp_tpu.train import Trainer as JaxTrainer
from dualhyp_tpu_torch.ckpt.convert import flat_from_named
from dualhyp_tpu_torch.train import TrainConfig, Trainer
from dualhyp_tpu_torch.train.trainer import AdamW
from tests.test_torch_gpt import _port_config
from tests.test_torch_peft import _model, _params
from tests.test_torch_quant import _flat
from tests.test_torch_train import _jax_grads, _jax_leaf, _rel

TRAIN = dict(learning_rate=1e-3, batch_size=4, micro_batch_size=2, compute_dtype="float32",
             lm_head_chunk_size=5, log_interval=1, use_cosine=True)
# (PEFT case of test_torch_peft.py, family, mode): each mode on the config
# its --mode builds; full on a biased GPT-NeoX model with a biased head too
RUNS = {
    "lora_mlp": ("lora_mlp", "llama", "lora"),
    "adapter": ("adapter", "llama", "adapter"),
    "adapter_v2": ("adapter_v2", "llama", "adapter_v2"),
    "adapter_v2_neox": ("adapter_v2", "neox", "adapter_v2"),
    "full": ("lora_mlp", "llama", "full"),
    "full_neox": (None, "neox", "full"),
}


def _cfg_params(run):
    case, family, _ = RUNS[run]
    if case is not None:
        return _params(case, family, seed=11)
    return _params("adapter", family, seed=11, use_adapter=False, lm_head_bias=True)


def _batch(seed, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 90, size=(b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    return {"input_ids": ids, "labels": labels}


def _trainers(run, **train_kw):
    cfg, params = _cfg_params(run)
    tkw = {**TRAIN, "mode": RUNS[run][2], **train_kw}
    jax_trainer = JaxTrainer(cfg, JaxTrainConfig(**tkw),
                             jax.tree_util.tree_map(jnp.asarray, params))
    port = Trainer(_port_config(cfg), TrainConfig(**tkw), params, device="cpu")
    return cfg, params, jax_trainer, port


def check_training_steps(run, mu_dtype):
    """One step (its loss and every trainable gradient), two more on the
    warmup and cosine schedule (losses), then the trainable leaves and the
    AdamW moments; the frozen leaves bit for bit as loaded."""
    cfg, params, jax_trainer, port = _trainers(run, mu_dtype=mu_dtype)
    frozen = {n: p.detach().clone() for n, p in port.model.named_parameters()
              if n not in port.trainable}
    want_grads = _jax_grads(jax_trainer, _batch(0))
    noise = {k.replace("/", "::"): (np.abs(v) > 0) & (np.abs(v) <= 1e-6 * np.abs(v).max())
             for k, v in _flat(want_grads) if v is not None}
    for step in range(3):
        batch = _batch(step)
        want_loss, _ = jax_trainer.train_step(batch, 12, 4, jax.random.key(step))
        got_loss, _ = port.train_step(batch, 12, 4)
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
        if step == 0:
            grads = flat_from_named({n: p.grad for n, p in port.trainable.items()},
                                    cfg.n_layer)
            assert sorted(grads) == sorted(
                k.replace("/", "::") for k, v in _flat(want_grads) if v is not None)
            for key, g in grads.items():
                want = _jax_leaf(want_grads, key)
                if np.any(want):
                    assert _rel(g.numpy(), want) <= 1e-4, key
                else:  # a gated-off layer's leaves (adapter_start_layer)
                    assert not g.any(), key
    for key, leaf in flat_from_named(port.trainable, cfg.n_layer).items():
        want = _jax_leaf(jax_trainer.trainable, key)
        keep = ~noise[key]
        err = np.abs(leaf.detach().numpy() - want)[keep]
        off = err > 1e-6 + 1e-4 * np.abs(want)[keep]
        if mu_dtype:
            assert off.mean() <= 0.1 and err.max() <= 3 * TRAIN["learning_rate"] * 2.0 ** -7, (
                key, off.mean(), err.max())
        else:
            assert not off.any(), (key, int(off.sum()), err.max())
    adam = jax_trainer.opt_state.inner_state[0]
    named = {n: port.optimizer.state[p]["exp_avg"] for n, p in port.trainable.items()}
    for key, value in flat_from_named(named, cfg.n_layer).items():
        assert value.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        want = np.asarray(_jax_leaf(adam.mu, key), np.float32)
        # bf16: one ulp of the element or of the leaf's largest moment (an
        # ulp apart one step, the next step's 0.9 mu carries it)
        rtol, atol = (2.0 ** -7, 2.0 ** -7 * np.abs(want).max()) if mu_dtype else (1e-4, 1e-6)
        np.testing.assert_allclose(value.float().numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=key)
    for name, value in frozen.items():
        assert torch.equal(port.model.get_parameter(name), value), name
    assert all(p.dtype == torch.float32 for p in port.trainable.values())


@pytest.mark.parametrize("run", ["lora_mlp", "adapter"])
def test_training_steps_match_jax(run):
    check_training_steps(run, "")


@pytest.mark.parametrize("chunk", [None, 1000])
@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16])
def test_adamw_is_optax_adamw(mu_dtype, chunk):
    """The hand-written AdamW against optax's `adamw` (decay 0.02, lr 1e-2)
    over four steps of random gradients on three leaves: the same fp32
    arithmetic, the first moment rounded to bf16 after the update where
    mu_dtype says; in one multi-tensor pass or (chunk 1000 elements) one a
    leaf."""
    rng = np.random.default_rng(0)
    shapes = ((64, 33), (7,), (16, 40))
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** -k for s in shapes]
             for k in range(4)]
    opt = optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.02,
                      mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    jp = [jnp.asarray(x) for x in p0]
    state = opt.init(jp)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    torch_opt = AdamW(ps, lr=1e-2, weight_decay=0.02, mu_dtype=mu_dtype)
    if chunk:
        torch_opt.CHUNK = chunk
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x)
        torch_opt.step()
    for p, want, want_mu in zip(ps, jp, state[0].mu):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        mu = torch_opt.state[p]["exp_avg"]
        assert mu.dtype == (mu_dtype or torch.float32)
        np.testing.assert_allclose(mu.float().numpy(), np.asarray(want_mu, np.float32),
                                   rtol=2.0 ** -8, atol=1e-9)


CONFIGS = {"lora_mlp": ("lora_mlp", "llama"), "adapter": ("adapter", "llama"),
           "adapter_v2": ("adapter_v2", "neox"), "lora_and_v2": ("lora_and_v2", "llama")}


@pytest.mark.parametrize("mode", ["lora", "adapter", "adapter_v2", "full"])
@pytest.mark.parametrize("config", CONFIGS)
def test_trainable_names_are_the_jax_masks(config, mode):
    """`GPT.trainable_parameters(mode)` marks the leaves the JAX package's
    `select_mask` does: `full_finetune_mask` in mode "full", else
    `trainable_mask` of the config."""
    cfg, params = _params(*CONFIGS[config])
    mask = (jgpt.full_finetune_mask(params) if mode == "full"
            else jgpt.trainable_mask(params, cfg))
    want = sorted(k.replace("/", "::") for k, m in _flat(mask) if m)
    model = _model(cfg, params)
    got = sorted(flat_from_named(model.trainable_parameters(mode), cfg.n_layer))
    assert got == want
    assert model.count_params(True, mode) == sum(
        np.size(v) for k, v in _flat(params) if k.replace("/", "::") in want)

