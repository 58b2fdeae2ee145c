"""The port's RelPrompt training against the JAX package's, on the CPU.

A tiny TinyLlama-shaped RelPrompt config (LoRA on q/k/v/proj with non-zero
lora_B, the two classifiers with non-zero biases, three mask-token rows),
fp32, LoRA and classifier dropout off (the JAX package draws dropout from
its own PRNG; the masks themselves are held in test_torch_relprompt.py);
batches, features and mask targets from numpy seeds. Tolerances:

  * losses (total, LLM, mask): 1e-5 relative (the same fp32 arithmetic,
    sums in another order);
  * both groups' learning rates: the same float32 schedule, 1e-6 relative;
  * LoRA and classifier leaves and both groups' AdamW moments after 1 and 3
    steps: rtol 1e-4, atol 1e-6 (leaves, moment 1) and 1e-9 (moment 2), as
    test_torch_train.py holds the LoRA trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ckpt.io import load_params as jax_load_params
from dualhyp_tpu.cli import finetune_relprompt as jft
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.models import relprompt as jrp
from dualhyp_tpu.train.relprompt import RelPromptTrainConfig as JaxConfig
from dualhyp_tpu.train.relprompt import RelPromptTrainer as JaxTrainer
from dualhyp_tpu_torch.ckpt.convert import flat_from_named
from dualhyp_tpu_torch.ckpt.io import save_params
from dualhyp_tpu_torch.cli import finetune_relprompt as tft
from dualhyp_tpu_torch.train import RelPromptTrainConfig, RelPromptTrainer
from tests import helpers
from tests.test_torch_gpt import LORA, _port_config

RELPROMPT = dict(use_relprompt=True, n_extra_tokens=3, whisper_dim=32, raven_dim=24,
                 classifier_hidden_dim=16, classifier_pool_size=5, classifier_dropout=0.0)
TRAIN = dict(learning_rate=1e-3, classifier_learning_rate=3e-3, mask_loss_weight=0.5,
             batch_size=4, micro_batch_size=4, compute_dtype="float32",
             lm_head_chunk_size=0, use_cosine=True, min_lr_ratio=0.1)
MAX_ITERS, WARMUP = 6, 2


def _params(seed=5):
    cfg = helpers.tiny_llama_config(lora_dropout=0.0, **LORA, **RELPROMPT)
    params = jax.tree_util.tree_map(np.asarray, jrp.init_relprompt_params(
        cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for leaf in (params["blocks"]["attn"]["qkv"], params["blocks"]["attn"]["proj"]):
        leaf["lora_B"] = rng.normal(size=leaf["lora_B"].shape).astype(np.float32) * 0.2
    for name in ("audio_noise_classifier", "visual_noise_classifier"):
        for leaf in params[name].values():
            leaf["bias"] = rng.normal(size=leaf["bias"].shape).astype(np.float32) * 0.1
    return cfg, params


def _batch(seed, cfg, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.padded_vocab_size + 3, size=(b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    labels[labels >= cfg.padded_vocab_size] = -1  # the mask tokens are never targets
    pool = cfg.classifier_pool_size
    return {"input_ids": ids, "labels": labels,
            "audio_features": rng.normal(size=(b, 4 * 2 * pool - 3, cfg.whisper_dim)
                                         ).astype(np.float32),
            "visual_features": rng.normal(size=(b, 3 * pool + 2, cfg.raven_dim)
                                          ).astype(np.float32),
            "audio_mask_targets": rng.integers(0, 3, size=(b, 4)).astype(np.int32),
            "visual_mask_targets": rng.integers(0, 3, size=(b, 5)).astype(np.int32)}


def _pair(**train_kw):
    cfg, params = _params()
    tkw = {**TRAIN, **train_kw}
    jax_trainer = JaxTrainer(cfg, JaxConfig(**tkw), jax.tree_util.tree_map(jnp.asarray, params))
    port = RelPromptTrainer(_port_config(cfg), RelPromptTrainConfig(**tkw), params,
                            device="cpu")
    return cfg, jax_trainer, port


def _leaf(tree, key):
    for part in key.split("::"):
        tree = tree[part]
    return np.asarray(tree)


def _adam(jax_trainer, group):
    """The JAX group's AdamW state (count, mu, nu)."""
    return jax_trainer.opt_state.inner_states[group].inner_state.inner_state[0]


def _assert_state_matches(jax_trainer, port):
    n_layer = port.model_cfg.n_layer
    for key, leaf in flat_from_named(port.trainable, n_layer).items():
        np.testing.assert_allclose(leaf.detach().numpy(), _leaf(jax_trainer.trainable, key),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    for group, torch_group in zip(("llm", "classifier"), port.optimizer.param_groups):
        adam = _adam(jax_trainer, group)
        names = [n for n, p in port.trainable.items()
                 if any(p is q for q in torch_group["params"])]
        assert names and len(names) == len(torch_group["params"])
        for moment, jtree, atol in (("exp_avg", adam.mu, 1e-6), ("exp_avg_sq", adam.nu, 1e-9)):
            named = {n: port.optimizer.state[port.trainable[n]][moment] for n in names}
            for key, value in flat_from_named(named, n_layer).items():
                np.testing.assert_allclose(value.numpy(), _leaf(jtree, key), rtol=1e-4,
                                           atol=atol, err_msg=f"{group} {moment} {key}")
        assert int(adam.count) == int(port.optimizer.state[port.trainable[names[0]]]["step"])


@pytest.mark.parametrize("steps", [1, 3])
def test_steps_match_jax(steps):
    """Losses and both groups' LRs at each step; leaves and moments after."""
    cfg, jax_trainer, port = _pair()
    for i in range(steps):
        batch = _batch(10 + i, cfg)
        want = jax_trainer.train_step(batch, MAX_ITERS, WARMUP, jax.random.key(i))
        got = port.train_step(batch, MAX_ITERS, WARMUP)
        for key in ("loss", "llm_loss", "mask_loss"):
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5), key
        for key in ("lr", "classifier_lr"):
            assert got[key] == pytest.approx(float(want[key]), rel=1e-6), key
    assert port.micro_iter == jax_trainer.micro_iter == steps
    _assert_state_matches(jax_trainer, port)


def test_groups_hold_the_lora_and_classifier_leaves():
    _, jax_trainer, port = _pair()
    llm, cls = (g["params"] for g in port.optimizer.param_groups)
    names = {id(p): n for n, p in port.trainable.items()}
    assert all(".lora_" in names[id(p)] for p in llm)
    assert all(names[id(p)].split(".")[0].endswith("noise_classifier") for p in cls)
    assert len(cls) == 12  # 2 classifiers x 3 layers x (weight, bias)
    # the same leaves the JAX package trains (gpt.trainable_mask)
    want = {"::".join(str(k.key) for k in path) for path, leaf
            in jax.tree_util.tree_leaves_with_path(jax_trainer.trainable) if leaf is not None}
    assert set(flat_from_named(port.trainable, port.model_cfg.n_layer)) == want


def test_only_lora_and_classifier_leaves_move():
    """`wte`, its three appended rows included, and every other frozen leaf
    stay as they were; every trainable leaf moves."""
    cfg, _, port = _pair()
    before = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    for i in range(2):
        port.train_step(_batch(20 + i, cfg), MAX_ITERS, WARMUP)
    for name, p in port.model.named_parameters():
        moved = not torch.equal(before[name], p.detach())
        assert moved == (name in port.trainable), name
    assert "wte.weight" not in port.trainable
    assert port.model.wte.weight.shape[0] == cfg.padded_vocab_size + 3


def test_frozen_bf16_wte_rows_round_like_jax():
    """frozen_dtype="bfloat16" stores `wte`, the appended rows too, in bf16,
    rounded as the JAX trainer casts its frozen tree."""
    cfg, params = _params()
    kw = {**TRAIN, "frozen_dtype": "bfloat16"}
    jax_trainer = JaxTrainer(cfg, JaxConfig(**kw), jax.tree_util.tree_map(jnp.asarray, params))
    port = RelPromptTrainer(_port_config(cfg), RelPromptTrainConfig(**kw), params,
                            device="cpu")
    got = port.model.wte.weight
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_trainer.frozen["wte"]["weight"].astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    for name, p in port.model.named_parameters():
        if name.split(".")[0].endswith("noise_classifier"):
            assert p.dtype == torch.float32 and p.requires_grad, name


def test_validate_matches_jax():
    cfg, jax_trainer, port = _pair()
    batches = [_batch(30, cfg), _batch(31, cfg, b=2, t=12)]
    masked = _batch(32, cfg)
    masked["labels"][:] = -1  # skipped by both
    want = jax_trainer.validate(batches + [masked])
    got = port.validate(batches + [masked])
    assert got["llm_loss"] == pytest.approx(want["llm_loss"], rel=1e-5)
    assert {k: got[k] for k in ("acc", "precision", "recall", "f1")} == \
        {k: want[k] for k in ("acc", "precision", "recall", "f1")}


def test_resume_is_exact(tmp_path):
    """Two steps, save, a third; a fresh trainer that loads the state and
    takes the third step ends where the first did, both groups' moments
    and the LR clock included."""
    cfg, _, first = _pair()
    for i in range(2):
        first.train_step(_batch(40 + i, cfg), MAX_ITERS, WARMUP)
    first.save_train_state(tmp_path / "state.npz", extra={"epoch": 1})
    with np.load(tmp_path / "state.npz") as z:
        keys = set(z.files)
    for moment in ("exp_avg", "exp_avg_sq"):
        assert f"optstate::{moment}::audio_noise_classifier::conv1::weight" in keys
        assert f"optstate::{moment}::blocks::attn::qkv::lora_A" in keys
    assert {"meta_micro_iter", "extra_epoch"} <= keys
    out = first.train_step(_batch(42, cfg), MAX_ITERS, WARMUP)

    _, _, second = _pair()
    assert second.load_train_state(tmp_path / "state.npz") == {"epoch": 1}
    assert second.micro_iter == 2
    again = second.train_step(_batch(42, cfg), MAX_ITERS, WARMUP)
    assert (again["lr"], again["classifier_lr"]) == (out["lr"], out["classifier_lr"])
    for name, p in first.trainable.items():
        assert torch.equal(p, second.trainable[name]), name
        for moment in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(first.optimizer.state[p][moment],
                               second.optimizer.state[second.trainable[name]][moment])


def test_saved_tree_loads_into_jax(tmp_path):
    cfg, jax_trainer, port = _pair()
    port.train_step(_batch(50, cfg), MAX_ITERS, WARMUP)
    save_params(tmp_path / "best_model.npz", port.params)
    tree = jax_load_params(tmp_path / "best_model.npz")
    for name in ("audio_noise_classifier", "visual_noise_classifier"):
        for layer in ("conv1", "conv2", "classifier"):
            for kind in ("weight", "bias"):
                key = f"{name}::{layer}::{kind}"
                np.testing.assert_array_equal(
                    _leaf(tree, key), flat_from_named(port.trainable, cfg.n_layer)[key].numpy())
    assert np.asarray(tree["wte"]["weight"]).shape == (cfg.padded_vocab_size + 3, cfg.n_embd)
    # the JAX package decodes with it
    logits, _ = jgpt.prefill(tree, cfg, jnp.asarray(_batch(51, cfg)["input_ids"]),
                             jnp.full((4,), 16), jgpt.init_cache(cfg, 4, 16, dtype=jnp.float32),
                             compute_dtype=jnp.float32)
    assert np.isfinite(np.asarray(logits)).all()


def test_parser_has_the_jax_flags():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    want = flags(jft.build_parser())
    got = flags(tft.build_parser())
    assert want <= got and got - want == {"--device"}


@pytest.fixture
def relprompt_corpus(tmp_path):
    """A checkpoint directory (the JAX package's base weights without the
    mask rows, a word tokenizer) and seeded RelPrompt train/val JSONs."""
    from dualhyp_tpu.ckpt.io import save_params as jax_save_params
    from dualhyp_tpu_torch.data import synthetic
    from tests.test_torch_decode import _write_tokenizer

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    base = helpers.tiny_llama_config(block_size=320, vocab_size=vocab, padding_multiple=1,
                                     **{**RELPROMPT, "use_relprompt": False,
                                        "n_extra_tokens": 0})
    (ckpt / "dualhyp_config.json").write_text(base.to_json())
    jax_save_params(ckpt / "dualhyp_model.npz", jax.tree_util.tree_map(
        np.asarray, jgpt.init(base, jax.random.key(4))))
    for name, n, seed in (("train", 6, 1), ("val", 2, 2)):
        synthetic.write_json(tmp_path / f"{name}.json",
                             synthetic.make_records(n_uids=n, n_hyps=2, seed=seed))
    return ckpt, base


def _write_features(tmp_path, ckpt, cfg):
    """Seeded noise features of every train and val example as
    `<uid>.npz` files (a feature directory gives a resumed run the same
    features; `--synthetic_features` draws on from one generator)."""
    from argparse import Namespace

    from dualhyp_tpu_torch.cli.common import load_tokenizer
    from dualhyp_tpu_torch.cli.inference_relprompt import add_mask_tokens
    from dualhyp_tpu_torch.data.hypotheses import DualHypothesesMaskDataset

    tok = load_tokenizer(ckpt)
    add_mask_tokens(tok)
    synth = tft.feature_loader(Namespace(whisper_checkpoint=None, feature_dir=None,
                                         synthetic_features=True), _port_config(cfg))
    rng = np.random.default_rng(0)
    out = tmp_path / "feats"
    out.mkdir()
    for split in ("train", "val"):
        ds = DualHypothesesMaskDataset(split, str(tmp_path / f"{split}.json"), tokenizer=tok,
                                       prompts_format="RelPrompt")
        for i in range(len(ds)):
            audio, visual = synth(ds[i], rng)
            np.savez(out / f"{ds[i].uid}.npz", audio=audio, visual=visual)
    return out


def test_cli_trains_and_resumes_on_cpu(relprompt_corpus, tmp_path, monkeypatch):
    """`main` with --device cpu (LoRA and classifier dropout on): 2 epochs of
    2 steps, the two checkpoints, which the JAX package loads; a resumed run
    from the first epoch's state ends where the whole run did. Then one
    epoch on --synthetic_features."""
    ckpt, base = relprompt_corpus
    monkeypatch.chdir(tmp_path)
    argv = ["--train_path", str(tmp_path / "train.json"), "--val_path",
            str(tmp_path / "val.json"), "--llm_checkpoint", str(ckpt), "--dual_hypotheses",
            "--prompts_format", "RelPrompt", "--device", "cpu",
            "--micro_batch_size", "3", "--num_epochs", "2", "--lora_r", "4",
            "--lora_alpha", "8", "--log_interval", "1", "--lr", "1e-3"]
    feats = ["--feature_dir", str(_write_features(tmp_path, ckpt, base.replace(**RELPROMPT)))]
    out = tft.main([*argv, *feats, "--exp_name", "whole"])
    run = tmp_path / "runs" / "whole"
    assert len(out["steps"]) == 4
    assert all(np.isfinite(float(s["loss"])) for s in out["steps"])
    assert {"acc", "f1", "llm_loss"} <= set(out["validation"])
    for name in ("best_model.npz", "model_relprompt_finetuned.npz", "train_state.npz"):
        assert (run / name).is_file(), name
    tree = jax_load_params(run / "model_relprompt_finetuned.npz")
    assert np.asarray(tree["wte"]["weight"]).shape[0] == base.padded_vocab_size + 3
    assert set(tree["audio_noise_classifier"]) == {"conv1", "conv2", "classifier"}

    # the first epoch alone, then --resume for the second
    tft.main([*argv, *feats, "--exp_name", "halves", "--num_epochs", "1"])
    resumed = tft.main([*argv, *feats, "--exp_name", "halves", "--resume"])
    assert len(resumed["steps"]) == 2
    for got, want in zip(resumed["steps"], out["steps"][2:]):
        assert float(got["loss"]) == float(want["loss"])
    for name, p in out["trainer"].trainable.items():
        torch.testing.assert_close(resumed["trainer"].trainable[name], p, rtol=0, atol=0)

    synthetic = tft.main([*argv, "--synthetic_features", "--num_epochs", "1",
                          "--micro_batch_size", "6", "--exp_name", "synthetic"])
    assert len(synthetic["steps"]) == 1


def test_cli_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tft.main(["--train_path", str(tmp_path / "t.json"), "--val_path",
                  str(tmp_path / "v.json")])
