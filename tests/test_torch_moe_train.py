"""The port's MoE LoRA training against the JAX package's, on the CPU.

Tiny MoE configs (`tests/test_torch_moe._moe_cfg`), fp32, DUALHYP_MOE_IMPL
set for both packages by the `moe_impl` fixture (megablox's gmm in Pallas
interpret mode, its custom VJP with it). On CPU tensors the port runs the
plain versions of L2 and its gradients (`ops.gmm.grouped_matmul_*_plain`).
Tolerances, each with its reason:

  * L2's gradients against `jax.vjp` of megablox `gmm` (its `_gmm_bwd`:
    `gmm` with the other transpose and `tgmm`) and of `ragged_dot`: 1e-5,
    as the forward (the same fp32 products summed in another order);
  * K1's plain backward at head size 128 against `flash_vjp`'s VJP: 1e-5
    (`tests/test_torch_grads.py`'s tolerance at head size 64);
  * Trainer steps: `tests/test_torch_train.py`'s (loss 1e-5 relative, LoRA
    gradients 1e-4 relative L2, leaves and AdamW moments atol 1e-6 / 1e-9
    with rtol 1e-4);
  * the remat modes against no remat: atol 1e-7, the same arithmetic in the
    same order (the recomputed pass draws the same dropout masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

from dualhyp_tpu.ckpt.io import save_params
from dualhyp_tpu.ops.pallas import flash_vjp
from dualhyp_tpu.train import TrainConfig as JaxTrainConfig
from dualhyp_tpu.train import Trainer as JaxTrainer
from dualhyp_tpu_torch.ckpt.convert import flat_from_named, params_from_jax
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.models.gpt import MoE, permute_rows
from dualhyp_tpu_torch.ops import attention, gmm
from dualhyp_tpu_torch.train import TrainConfig, Trainer
from tests.test_torch_gpt import LORA, _port_config
from tests.test_torch_moe import GROUP_SIZES, IMPLS, _jax_params, _moe_cfg
from tests.test_torch_moe import moe_impl  # noqa: F401  (the fixture)
from tests.test_torch_train import TRAIN, _assert_state_matches, _batch, _jax_leaf, _rel

GMM_ATOL = 1e-5
FLASH_ATOL = 1e-5
REMAT_ATOL = 1e-7


def _jax_gmm_grads(fn, lhs, w, g):
    _, vjp = jax.vjp(fn, jnp.asarray(lhs), jnp.asarray(w))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


# group layouts of the gradients: GROUP_SIZES, and groups that straddle the
# card's drhs steps of 64 rows (63, 1, 64, 65 rows, then an empty group and
# a 7-row one)
GRAD_GROUP_SIZES = {**GROUP_SIZES, "step_edges": [63, 1, 64, 65, 0, 7]}


@pytest.mark.parametrize("case", GRAD_GROUP_SIZES)
def test_grouped_matmul_grads_match_megablox_and_ragged_dot(rng, case):
    """dlhs and dW of `GroupedMatmul` (N 16 != K 32) against megablox's VJP
    (transpose_rhs=True, the port's layout: its dW comes back swapped to (E,
    N, K)) and ragged_dot's on the (E, K, N) transpose."""
    sizes = np.asarray(GRAD_GROUP_SIZES[case], np.int32)
    m, k, n = int(sizes.sum()), 32, 16
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), n, k)).astype(np.float32)  # (E, N, K)
    g = rng.normal(size=(m, n)).astype(np.float32)
    tl, tw = (torch.from_numpy(a).requires_grad_() for a in (lhs, w))
    gmm.grouped_matmul(tl, tw, torch.from_numpy(sizes)).backward(torch.from_numpy(g))

    def by_megablox(a, b):
        return megablox.gmm(a, b, jnp.asarray(sizes), preferred_element_type=jnp.float32,
                            tiling=(8, 16, 16), transpose_rhs=True, interpret=True)

    def by_ragged_dot(a, b):
        return jax.lax.ragged_dot(a, b.transpose(0, 2, 1), jnp.asarray(sizes),
                                  precision=jax.lax.Precision.HIGHEST)

    for fn in (by_megablox, by_ragged_dot):
        want_lhs, want_w = _jax_gmm_grads(fn, lhs, w, g)
        np.testing.assert_allclose(tl.grad.numpy(), want_lhs, rtol=0, atol=GMM_ATOL)
        np.testing.assert_allclose(tw.grad.numpy(), want_w, rtol=0, atol=GMM_ATOL)


def test_grouped_matmul_gradcheck_float64(rng):
    """An empty group, a row past the last group (zero output, zero
    gradient); and a frozen weight takes no gradient and keeps no lhs."""
    sizes = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    lhs = torch.from_numpy(rng.normal(size=(7, 8))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(4, 5, 8))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: gmm.grouped_matmul(a, b, sizes), (lhs, w))
    out = gmm.grouped_matmul(lhs, w.detach(), sizes)
    saved_lhs, saved_w, _ = out.grad_fn.saved_tensors
    assert saved_lhs is None and saved_w is not None
    out.sum().backward()
    assert not lhs.grad[6].any()


def test_permute_rows_backward_is_the_inverse_gather(rng):
    perm = rng.permutation(12)
    inv = np.argsort(perm)
    x = torch.from_numpy(rng.normal(size=(12, 5))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(12, 5)))
    y = permute_rows(x, torch.from_numpy(perm), torch.from_numpy(inv))
    assert torch.equal(y, x.detach()[perm])
    y.backward(g)
    assert torch.equal(x.grad, g[inv])
    assert "PermuteRows" in type(y.grad_fn).__name__


@pytest.mark.parametrize("t", [128, 96])
def test_flash_backward_plain_at_head_size_128_matches_jax_vjp(rng, t):
    """T=128: the Pallas `_bwd_kernel` in interpret mode; T=96: XLA's grads."""
    q, do = (rng.normal(size=(1, 8, t, 128)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(1, 2, t, 128)).astype(np.float32) for _ in range(2))
    scale = 128 ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: flash_vjp.flash_attention(a, b, c, scale),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention.causal_attention_plain_lse(tq, tk, tv, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=0, atol=FLASH_ATOL)
    got = attention.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0, atol=FLASH_ATOL)


def _jax_step_grads(trainer, batch):
    """The JAX Trainer's averaged micro-batch LoRA gradients of one step
    (jitted: megablox's interpreted kernel runs slowly op by op)."""
    accum, mb = trainer.cfg.grad_accum, trainer.cfg.micro_batch_size
    ids = np.asarray(batch["input_ids"]).reshape(accum, mb, -1)
    labels = np.asarray(batch["labels"]).reshape(accum, mb, -1)
    grad = jax.jit(jax.grad(trainer._loss))
    grads = [grad(trainer.trainable, trainer.frozen, jnp.asarray(ids[i]),
                  jnp.asarray(labels[i]), None) for i in range(accum)]
    return jax.tree_util.tree_map(lambda *x: sum(x) / accum, *grads)


@pytest.mark.parametrize("moe_impl", IMPLS, indirect=True)
def test_moe_train_steps_match_jax(moe_impl):
    """One step (loss, LoRA gradients, leaves, AdamW moments), then two
    more, of batch 4 in micro batches of 2 on a tiny 4-expert MoE."""
    cfg = _moe_cfg(name=f"tiny-moe-train-{moe_impl}", **LORA)
    params = _jax_params(cfg, seed=4)
    jax_trainer = JaxTrainer(cfg, JaxTrainConfig(**TRAIN),
                             jax.tree_util.tree_map(jnp.asarray, params))
    port = Trainer(_port_config(cfg), TrainConfig(**TRAIN), params, device="cpu")
    assert port.model.moe_impl == moe_impl
    for step in range(3):
        batch = _batch(step)
        if step == 0:
            want_grads = _jax_step_grads(jax_trainer, batch)
        want_loss, want_lr = jax_trainer.train_step(batch, 12, 2, jax.random.key(step))
        got_loss, got_lr = port.train_step(batch, 12, 2)
        assert got_lr == pytest.approx(want_lr, rel=1e-6)
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
        if step == 0:
            grads = {n: p.grad for n, p in port.trainable.items()}
            for key, g in flat_from_named(grads, cfg.n_layer).items():
                assert _rel(g.numpy(), _jax_leaf(want_grads, key)) <= 1e-4, key
            _assert_state_matches(jax_trainer, port)
    assert port.micro_iter == jax_trainer.micro_iter == 6
    _assert_state_matches(jax_trainer, port)


@pytest.mark.parametrize("impl", ["megablox", "dense"])
def test_remat_modes_give_the_same_grads(monkeypatch, impl):
    """remat False, True, "mlp" and "moe" under the same dropout seed give
    the same LoRA gradients. Under "moe" the sparse path's up products run
    once a layer (kept for the backward), as without remat; whole-block
    and MLP remat run them again in the backward. On the dense path "moe"
    is whole-block remat, as the JAX policy degrades there."""
    monkeypatch.setenv("DUALHYP_MOE_IMPL", impl)
    cfg = _moe_cfg(name=f"tiny-moe-remat-{impl}", lora_dropout=0.5, **LORA)
    params = _jax_params(cfg, seed=6)
    ups = []
    real_up = MoE.up
    monkeypatch.setattr(MoE, "up", lambda self, *a: ups.append(1) or real_up(self, *a))
    grads, up_calls = {}, {}
    for remat in (False, True, "mlp", "moe"):
        model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
        trainer = Trainer(model.cfg, TrainConfig(**TRAIN, remat=remat), model)
        ups.clear()
        trainer.train_step(_batch(5), 100, 10, torch.Generator().manual_seed(3))
        grads[remat] = {n: p.grad.clone() for n, p in trainer.trainable.items()}
        up_calls[remat] = len(ups)
    for remat in (True, "mlp", "moe"):
        for name, g in grads[False].items():
            torch.testing.assert_close(grads[remat][name], g, rtol=0, atol=REMAT_ATOL)
    forwards = cfg.n_layer * TrainConfig(**TRAIN).grad_accum
    if impl == "megablox":
        assert up_calls == {False: forwards, True: 2 * forwards, "mlp": 2 * forwards,
                            "moe": forwards}
    else:
        assert not any(up_calls.values())


def test_unknown_remat_raises():
    cfg = _moe_cfg(name="tiny-moe-remat-unknown", **LORA)
    model = params_from_jax(_jax_params(cfg), _port_config(cfg), device="cpu",
                            dtype=torch.float32)
    ids = torch.from_numpy(_batch(1)["input_ids"]).long()
    with pytest.raises(ValueError, match="remat"):
        model(ids, remat="full")


@pytest.fixture
def moe_run(tmp_path, monkeypatch):
    """A tiny MoE checkpoint directory (config JSON, npz weights, a word
    tokenizer) and train/val records, with DUALHYP_MOE_IMPL megablox and
    the working directory at tmp_path."""
    from dualhyp_tpu_torch.data import synthetic
    from tests.test_cli import _write_tokenizer

    ckpt = tmp_path / "tiny-moe-train"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    cfg = _moe_cfg(name="tiny-moe-cli-train", block_size=640, vocab_size=vocab,
                   padding_multiple=8)
    save_params(ckpt / "dualhyp_model.npz", _jax_params(cfg, seed=7))
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    for split, n, seed in (("train", 4, 1), ("val", 2, 2)):
        synthetic.write_json(tmp_path / f"{split}.json",
                             synthetic.make_records(n_uids=n, seed=seed))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DUALHYP_MOE_IMPL", "megablox")
    return ckpt, cfg


def test_finetune_cli_trains_an_moe_and_reloads(tmp_path, moe_run):
    """`main` on an MoE checkpoint directory (bf16, remat, megablox): the
    best, final and train-state npz files are written, the final one the
    whole tree, and it reloads onto the model with the expert stacks."""
    from dualhyp_tpu_torch.cli import finetune_ger
    from dualhyp_tpu_torch.registry import config_from_checkpoint

    ckpt, cfg = moe_run
    finetune_ger.main([
        "--train_path", str(tmp_path / "train.json"), "--val_path", str(tmp_path / "val.json"),
        "--llm_checkpoint", str(ckpt), "--dual_hypotheses", "--prompts_format", "DualHyp",
        "--batch_size", "4", "--micro_batch_size", "2", "--log_interval", "2",
        "--device", "cpu", "--exp_name", "moe", "--lora_r", "4", "--lora_alpha", "8",
        "--num_epochs", "1"])
    out = tmp_path / "runs" / "moe"
    for name in ("best_model.npz", "model_lora_finetuned.npz", "train_state.npz"):
        assert (out / name).is_file(), name
    tree = load_params(out / "model_lora_finetuned.npz")
    assert tree["blocks"]["mlp"]["fc_1"]["weight"].shape[:2] == (cfg.n_layer, cfg.n_expert)
    reloaded = params_from_jax(tree, config_from_checkpoint(ckpt, **LORA), device="cpu",
                               dtype=torch.bfloat16)
    assert reloaded.blocks[0].mlp.impl == "megablox"
    assert reloaded.blocks[0].attn.qkv.lora_B.abs().sum() > 0
    with np.load(out / "train_state.npz") as z:
        assert int(z["extra_epoch"]) == 0 and int(z["meta_opt_step"]) == 1


def test_finetune_cli_saves_the_adapter_alone(tmp_path, moe_run):
    """--save_adapter_only: the best and final files hold the LoRA leaves
    alone, and they load over the base checkpoint through `load_model`'s
    finetuned overlay (what --model_path does) to the saved values, the
    frozen leaves staying the base's."""
    from dualhyp_tpu_torch.cli import common, finetune_ger
    from dualhyp_tpu_torch.registry import config_from_checkpoint

    ckpt, _ = moe_run
    finetune_ger.main([
        "--train_path", str(tmp_path / "train.json"), "--val_path", str(tmp_path / "val.json"),
        "--llm_checkpoint", str(ckpt), "--dual_hypotheses", "--prompts_format", "DualHyp",
        "--batch_size", "4", "--micro_batch_size", "2", "--device", "cpu",
        "--exp_name", "moe_adapter", "--lora_r", "4", "--lora_alpha", "8", "--num_epochs", "1",
        "--save_adapter_only"])
    out = tmp_path / "runs" / "moe_adapter"
    for name in ("best_model.npz", "model_lora_finetuned.npz"):
        tree = load_params(out / name)
        assert set(tree) == {"blocks"} and set(tree["blocks"]) == {"attn"}, name
    cfg = config_from_checkpoint(ckpt, **LORA)
    base = common.load_model(ckpt, cfg, device="cpu", seed=0, dtype=torch.float32)
    tuned = common.load_model(ckpt, cfg, device="cpu", seed=0, dtype=torch.float32,
                              finetuned=out / "model_lora_finetuned.npz")
    saved = load_params(out / "model_lora_finetuned.npz")["blocks"]["attn"]
    for i, block in enumerate(tuned.blocks):
        for leaf in ("lora_A", "lora_B"):
            want = torch.as_tensor(np.asarray(saved["qkv"][leaf][i], np.float32))
            assert torch.equal(getattr(block.attn.qkv, leaf).detach(), want), (i, leaf)
    assert tuned.blocks[0].attn.qkv.lora_B.abs().sum() > 0
    for name, p in base.named_parameters():
        if "lora_" not in name:
            assert torch.equal(tuned.get_parameter(name), p), name
