"""The port's LoRA finetuning against the JAX package's, on the CPU.

A tiny TinyLlama-shaped config with LoRA on q/k/v/proj (non-zero lora_B so
every LoRA leaf gets a gradient), fp32, dropout off unless a test says
otherwise; batches from numpy seeds. Tolerances, each with its reason:

  * loss: 1e-5 relative (the same fp32 arithmetic, sums in another order);
  * LoRA gradients: 1e-4 relative L2 per leaf (sums over the batch, the
    sequence and two micro-batches in another order);
  * LoRA leaves and AdamW moments after 1 and 3 steps: atol 1e-6 (leaves,
    moment 1) and 1e-9 (moment 2, which holds squared gradients of ~1e-3),
    rtol 1e-4 — an AdamW step moves a leaf by ~lr = 1e-3 with a size set by
    m / sqrt(v), so gradient differences of 1e-6 relative move it by ~1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ckpt import io as jio
from dualhyp_tpu.data import collate as jcollate
from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.train import TrainConfig as JaxTrainConfig
from dualhyp_tpu.train import Trainer as JaxTrainer
from dualhyp_tpu.train import lr_at_step as jax_lr_at_step
from dualhyp_tpu_torch.ckpt import io
from dualhyp_tpu_torch.ckpt.convert import flat_from_named, params_from_jax, tree_from_model
from dualhyp_tpu_torch.data import collate
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.models.gpt import GPT
from dualhyp_tpu_torch.train import TrainConfig, Trainer, lr_at_step
from tests import helpers
from tests.test_torch_gpt import LORA, _jax_params, _port_config

TRAIN = dict(learning_rate=1e-3, batch_size=4, micro_batch_size=2,
             compute_dtype="float32", lm_head_chunk_size=0, log_interval=1)


def _jax_leaf(tree, key):
    for part in key.split("::"):
        tree = tree[part]
    return np.asarray(tree)


def _batch(seed, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 90, size=(b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    return {"input_ids": ids, "labels": labels}


def _pair(cfg_kw=None, **train_kw):
    cfg = helpers.tiny_llama_config(**{**LORA, **(cfg_kw or {})})
    params = _jax_params(cfg)
    tkw = {**TRAIN, **train_kw}
    jax_trainer = JaxTrainer(cfg, JaxTrainConfig(**tkw),
                             jax.tree_util.tree_map(jnp.asarray, params))
    port = Trainer(_port_config(cfg), TrainConfig(**tkw), params, device="cpu")
    return cfg, jax_trainer, port


def _jax_grads(trainer, batch):
    """The JAX Trainer's averaged micro-batch gradients of one step."""
    accum, mb = trainer.cfg.grad_accum, trainer.cfg.micro_batch_size
    ids = np.asarray(batch["input_ids"]).reshape(accum, mb, -1)
    labels = np.asarray(batch["labels"]).reshape(accum, mb, -1)
    total = None
    for i in range(accum):
        g = jax.grad(trainer._loss)(trainer.trainable, trainer.frozen,
                                    jnp.asarray(ids[i]), jnp.asarray(labels[i]), None)
        total = g if total is None else jax.tree_util.tree_map(jnp.add, total, g)
    return jax.tree_util.tree_map(lambda x: x / accum, total)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_state_matches(jax_trainer, port):
    adam = jax_trainer.opt_state.inner_state[0]
    for key, leaf in flat_from_named(port.trainable, port.model_cfg.n_layer).items():
        np.testing.assert_allclose(leaf.detach().numpy(), _jax_leaf(jax_trainer.trainable, key),
                                   rtol=1e-4, atol=1e-6)
    for moment, jtree, atol in (("exp_avg", adam.mu, 1e-6), ("exp_avg_sq", adam.nu, 1e-9)):
        named = {n: port.optimizer.state[p][moment] for n, p in port.trainable.items()}
        for key, value in flat_from_named(named, port.model_cfg.n_layer).items():
            np.testing.assert_allclose(value.numpy(), _jax_leaf(jtree, key),
                                       rtol=1e-4, atol=atol)
    assert int(adam.count) == int(port.optimizer.state[
        next(iter(port.trainable.values()))]["step"])


@pytest.mark.parametrize("use_cosine", [False, True])
def test_lr_at_step_matches_jax(use_cosine):
    for step in (0, 1, 5, 10, 11, 37, 100, 150):
        kw = dict(base_lr=3e-4, warmup_steps=10, max_iters=100, use_cosine=use_cosine,
                  min_lr_ratio=0.05)
        assert lr_at_step(step, **kw) == pytest.approx(float(jax_lr_at_step(step, **kw)),
                                                       rel=1e-6)


class _Example:
    def __init__(self, rng, uid):
        n = int(rng.integers(5, 140))
        self.input_ids = list(rng.integers(3, 90, size=n))
        self.input_ids_no_response = self.input_ids[: n // 2]
        self.labels = [-1] * (n // 2) + self.input_ids[n // 2:]
        self.uid = uid
        self.ground_truth = f"truth {uid}"


def _examples(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [_Example(rng, f"u{i}") for i in range(n)]


def _same_batch(got, want):
    for key in ("input_ids", "labels", "lengths", "prompt_lengths", "valid"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert got["uids"] == want["uids"] and got["ground_truths"] == want["ground_truths"]


@pytest.mark.parametrize("max_len", [None, 64])
def test_pad_batch_matches_jax(max_len):
    examples = _examples()
    _same_batch(collate.pad_batch(examples, max_len=max_len),
                jcollate.pad_batch(examples, max_len=max_len))


@pytest.mark.parametrize("length_sorted", [False, True])
@pytest.mark.parametrize("epoch", [0, 3])
def test_epoch_batches_match_jax(length_sorted, epoch):
    """11 examples in batches of 4: the last one repeat-pads with zero-loss rows."""
    examples = _examples()
    kw = dict(shuffle=True, seed=5, epoch=epoch, length_sorted=length_sorted)
    got = list(collate.epoch_batches(examples, 4, **kw))
    want = list(jcollate.epoch_batches(examples, 4, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_batch(g, w)
    assert got[-1]["valid"].tolist() == [1, 1, 1, 0]


def test_train_step_matches_jax():
    """One step, batch 4 of micro batches 2: loss, LoRA gradients, then the
    LoRA leaves and AdamW moments."""
    _, jax_trainer, port = _pair()
    batch = _batch(0)
    want_grads = _jax_grads(jax_trainer, batch)
    want_loss, want_lr = jax_trainer.train_step(batch, 100, 10, jax.random.key(0))
    got_loss, got_lr = port.train_step(batch, 100, 10)
    assert got_lr == pytest.approx(want_lr, rel=1e-6)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    grads = {n: p.grad for n, p in port.trainable.items()}
    for key, g in flat_from_named(grads, port.model_cfg.n_layer).items():
        assert _rel(g.numpy(), _jax_leaf(want_grads, key)) <= 1e-4, key
    _assert_state_matches(jax_trainer, port)


def test_three_steps_with_warmup_and_cosine_match_jax():
    _, jax_trainer, port = _pair(use_cosine=True, weight_decay=0.1)
    for step in range(3):
        batch = _batch(step + 1)
        want_loss, want_lr = jax_trainer.train_step(batch, 12, 4, jax.random.key(step))
        got_loss, got_lr = port.train_step(batch, 12, 4)
        # float32 schedules; the cosine may round apart by one ulp
        assert got_lr == pytest.approx(want_lr, rel=1e-6)
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert port.micro_iter == jax_trainer.micro_iter == 6
    _assert_state_matches(jax_trainer, port)


def test_gated_off_layer_decays_like_jax():
    """lora_start_layer=1: layer 0's LoRA leaves get zero gradients and
    still take AdamW's weight decay, as under the JAX package's 0/1 gate."""
    _, jax_trainer, port = _pair(cfg_kw=dict(lora_start_layer=1))
    batch = _batch(4)
    jax_trainer.train_step(batch, 100, 10, jax.random.key(0))
    port.train_step(batch, 100, 10)
    assert float(port.model.blocks[0].attn.qkv.lora_A.grad.abs().max()) == 0.0
    _assert_state_matches(jax_trainer, port)


def test_evaluate_matches_jax():
    """The valid-token mean; an all-masked batch is skipped."""
    _, jax_trainer, port = _pair()
    masked = _batch(9)
    masked["labels"][:] = -1
    batches = [_batch(7, b=2), masked, _batch(8, b=2)]
    assert port.evaluate(batches) == pytest.approx(jax_trainer.evaluate(batches), rel=1e-5)


def _dropout_model(lora_b_zero: bool):
    cfg = helpers.tiny_llama_config(**LORA, lora_dropout=0.5)
    params = _jax_params(cfg)
    if lora_b_zero:
        for leaf in (params["blocks"]["attn"]["qkv"], params["blocks"]["attn"]["proj"]):
            leaf["lora_B"] = np.zeros_like(leaf["lora_B"])
    return params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)


def test_dropout_touches_only_the_lora_branch():
    ids = torch.from_numpy(_batch(3)["input_ids"]).long()
    # lora_B = 0: the LoRA branch adds nothing, so dropout changes nothing
    model = _dropout_model(lora_b_zero=True)
    plain = model(ids)
    dropped = model(ids, generator=torch.Generator().manual_seed(0))
    assert torch.equal(plain, dropped)
    # with a live branch the masks show, and differ by seed
    model = _dropout_model(lora_b_zero=False)
    plain = model(ids)
    one = model(ids, generator=torch.Generator().manual_seed(0))
    two = model(ids, generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(plain, one) and not torch.allclose(one, two)
    assert torch.equal(one, model(ids, generator=torch.Generator().manual_seed(0)))


def test_remat_gives_the_same_grads_under_the_same_seed():
    """The dropout masks come from per-layer seeds, so the rematerialised
    forward draws the masks of the first pass."""
    grads = {}
    for remat in (False, True):
        model = _dropout_model(lora_b_zero=False)
        trainer = Trainer(model.cfg, TrainConfig(**TRAIN, remat=remat), model)
        trainer.train_step(_batch(5), 100, 10, torch.Generator().manual_seed(3))
        grads[remat] = {n: p.grad.clone() for n, p in trainer.trainable.items()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=1e-7)


def test_resume_is_exact(tmp_path):
    """Two steps, save, a third; a fresh trainer that loads the state and
    takes the third step ends where the first did."""
    _, _, first = _pair()
    for seed in (1, 2):
        first.train_step(_batch(seed), 12, 2)
    first.save_train_state(tmp_path / "state.npz", extra={"epoch": 4})
    first.train_step(_batch(3), 12, 2)

    _, _, second = _pair()
    assert second.load_train_state(tmp_path / "state.npz") == {"epoch": 4}
    assert (second.micro_iter, second.opt_step) == (4, 2)
    second.train_step(_batch(3), 12, 2)
    for name, p in first.trainable.items():
        assert torch.equal(p, second.trainable[name]), name
        for moment in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(first.optimizer.state[p][moment],
                               second.optimizer.state[second.trainable[name]][moment])


def test_train_state_keys_follow_the_jax_layout(tmp_path):
    _, jax_trainer, port = _pair()
    port.train_step(_batch(1), 12, 2)
    port.save_train_state(tmp_path / "state.npz")
    jax_trainer.save_train_state(tmp_path / "jax_state.npz")
    with np.load(tmp_path / "state.npz") as z, np.load(tmp_path / "jax_state.npz") as j:
        trainable = sorted(k for k in z.files if k.startswith("trainable::"))
        assert trainable == sorted(k for k in j.files if k.startswith("trainable::"))
        for key in trainable:
            assert z[key].shape == j[key].shape
        assert int(z["meta_micro_iter"]) == 2 and int(z["meta_opt_step"]) == 1


def test_trainable_parameters_are_the_lora_leaves():
    cfg = helpers.tiny_llama_config(**LORA)
    model = GPT(_port_config(cfg), device="cpu", dtype=torch.bfloat16)
    names = sorted(model.trainable_parameters())
    assert names == sorted(f"blocks.{i}.attn.{m}.lora_{ab}" for i in range(cfg.n_layer)
                           for m in ("qkv", "proj") for ab in "AB")
    assert all(p.dtype == torch.float32 for p in model.trainable_parameters().values())
    assert not any(p.requires_grad for p in model.parameters())
    n_lora = sum(p.numel() for p in model.trainable_parameters().values())
    assert model.count_params(trainable_only=True) == n_lora
    assert model.count_params() == sum(p.numel() for p in model.parameters())


def test_frozen_dtype_rounds_the_frozen_leaves():
    cfg = helpers.tiny_llama_config(**LORA)
    params = _jax_params(cfg)
    trainer = Trainer(_port_config(cfg), TrainConfig(**TRAIN, frozen_dtype="bfloat16"),
                      params, device="cpu")
    for name, p in trainer.model.named_parameters():
        want = torch.float32 if name in trainer.trainable else torch.bfloat16
        assert p.dtype == want, name


@pytest.mark.parametrize("seq_len", [64, 1024])
def test_train_flops_per_token_match_jax(seq_len):
    from dualhyp_tpu.utils.monitor import estimate_train_flops_per_token as jax_flops
    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    cfg = helpers.tiny_llama_config(**LORA)
    assert estimate_train_flops_per_token(_port_config(cfg), seq_len) == jax_flops(cfg, seq_len)
    tiny_llama = config_from_name("tiny-llama-1.1b-chat")
    assert estimate_train_flops_per_token(tiny_llama, 1024) == 6760169472


def test_gpu_peak_flops_by_card_name():
    from dualhyp_tpu_torch.utils.monitor import SpeedMonitor, gpu_peak_flops

    assert gpu_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert gpu_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert gpu_peak_flops("Tesla T4") is None
    monitor = SpeedMonitor(peak_flops=1e12)
    for _ in range(3):
        monitor.on_step(tokens=100, samples=2, flops=1e9)
    stats = monitor.stats()
    assert stats["tokens_per_sec"] > 0 and 0 < stats["mfu"]


# ---- checkpoints both ways ----

def test_saved_params_load_in_the_jax_package(tmp_path):
    cfg = helpers.tiny_llama_config(**LORA)
    params = _jax_params(cfg)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.bfloat16)
    io.save_params(tmp_path / "m.npz", tree_from_model(model))
    loaded = jio.load_params(tmp_path / "m.npz")
    got = dict(jio._flatten(loaded))
    want = dict(jio._flatten(params))
    assert set(got) != set(want)  # matrices now carry the @bf16 tag
    for key, value in want.items():
        if key in got:  # LoRA leaves and norm scales stay fp32
            np.testing.assert_array_equal(got[key], value)
        else:
            bits = got[key + "@bf16"]
            np.testing.assert_array_equal(
                bits, io.bits_from_bf16(torch.from_numpy(np.array(value)).bfloat16()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_from_model_inverts_params_from_jax(dtype):
    cfg = helpers.tiny_llama_config(**LORA)
    params = _jax_params(cfg)
    tree = tree_from_model(params_from_jax(params, _port_config(cfg), device="cpu",
                                           dtype=dtype))
    flat = io.flatten(tree)
    for key, value in io.flatten(params).items():
        if key in flat:
            np.testing.assert_array_equal(flat[key], value)
        else:  # a matrix of the bf16 model comes back through @bf16
            assert dtype == torch.bfloat16
            np.testing.assert_array_equal(
                flat[key + io.BF16_TAG],
                io.bits_from_bf16(torch.from_numpy(value).bfloat16()))


def test_port_finetuned_checkpoint_decodes_alike_in_both_packages(tmp_path):
    """Two training steps in the port, `model_lora_finetuned.npz` written as
    the CLI writes it; both packages load it and decode the same greedy
    tokens (fp32)."""
    cfg, _, port = _pair(learning_rate=3e-2)
    for seed in (1, 2):
        port.train_step(_batch(seed), 12, 2)
    io.save_params(tmp_path / "model_lora_finetuned.npz", port.params)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, jio.load_params(tmp_path / "model_lora_finetuned.npz"))
    model = params_from_jax(io.load_params(tmp_path / "model_lora_finetuned.npz"),
                            _port_config(cfg), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 90, size=(2, 9)).astype(np.int32)
    lengths = np.array([9, 5], np.int32)
    ids[1, 5:] = 0
    want, want_len = jax_generate(jparams, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                  max_new_tokens=6, top_k=1, compute_dtype=jnp.float32)
    got, got_len = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                            max_new_tokens=6, top_k=1)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the entry point ----

def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from dualhyp_tpu_torch.cli import finetune_ger

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_config(helpers.tiny_llama_config(**LORA))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(**TRAIN), _jax_params(helpers.tiny_llama_config(**LORA)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_ger.main(["--train_path", str(tmp_path / "t.json"),
                           "--val_path", str(tmp_path / "v.json")])


def test_unported_finetune_options_raise(tiny_checkpoint, tmp_path, monkeypatch):
    """--data_prefetch and --mode adapter are ported (test_torch_packed_
    prefetch.py, test_torch_peft_train.py): the run gets past the model and
    stops at the missing data file. The mesh flags of multi-device training
    (slice 8c) are not ported: the parser refuses them."""
    from dualhyp_tpu_torch.cli import finetune_ger

    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="t.json"):
        finetune_ger.main(["--train_path", "t.json", "--val_path", "v.json",
                           "--device", "cpu", "--llm_checkpoint", str(tiny_checkpoint),
                           "--mode", "adapter", "--data_prefetch"])
    with pytest.raises(SystemExit):
        finetune_ger.main(["--train_path", "t.json", "--val_path", "v.json",
                           "--device", "cpu", "--llm_checkpoint", str(tiny_checkpoint),
                           "--fsdp", "2"])


@pytest.fixture
def tiny_checkpoint(tmp_path):
    """A checkpoint dir the CLI reads: config JSON, npz weights and a word
    tokenizer over the synthetic vocabulary."""
    from tests.test_cli import _write_tokenizer

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    cfg = helpers.tiny_llama_config(block_size=640, vocab_size=vocab, padding_multiple=8)
    jio.save_params(ckpt / "dualhyp_model.npz", jgpt.init(cfg, jax.random.key(0)))
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    return ckpt


@pytest.fixture
def corpus(tmp_path):
    from dualhyp_tpu_torch.data import synthetic

    for split, n, seed in (("train", 8, 1), ("val", 4, 2)):
        synthetic.write_json(tmp_path / f"{split}.json",
                             synthetic.make_records(n_uids=n, seed=seed))
    return tmp_path


def test_finetune_cli_trains_saves_and_resumes(tiny_checkpoint, corpus, monkeypatch):
    """Two epochs on the CPU (bf16, remat, dropout) write the CLI's files;
    a resumed run starts after the last saved epoch."""
    from dualhyp_tpu_torch.cli import finetune_ger

    monkeypatch.chdir(corpus)
    args = ["--train_path", str(corpus / "train.json"), "--val_path", str(corpus / "val.json"),
            "--llm_checkpoint", str(tiny_checkpoint), "--dual_hypotheses",
            "--prompts_format", "DualHyp", "--batch_size", "4", "--micro_batch_size", "2",
            "--log_interval", "2", "--device", "cpu", "--exp_name", "run"]
    finetune_ger.main(args + ["--num_epochs", "1"])
    out = corpus / "runs" / "run"
    for name in ("best_model.npz", "model_lora_finetuned.npz", "train_state.npz",
                 "train.log", "metrics.csv"):
        assert (out / name).is_file(), name
    with np.load(out / "train_state.npz") as z:
        assert int(z["extra_epoch"]) == 0 and int(z["meta_opt_step"]) == 2
    finetune_ger.main(args + ["--num_epochs", "2", "--resume"])
    with np.load(out / "train_state.npz") as z:
        assert int(z["extra_epoch"]) == 1 and int(z["meta_opt_step"]) == 4
    assert "resumed from" in (out / "train.log").read_text()
    tree = io.load_params(out / "model_lora_finetuned.npz")
    assert tree["blocks"]["attn"]["qkv"]["lora_A"].dtype == np.float32


def test_run_training_stops_on_a_non_finite_loss(tiny_checkpoint, corpus):
    """A NaN weight: the loop saves the diverged state and exits."""
    from dualhyp_tpu_torch.cli import common, finetune_ger
    from dualhyp_tpu_torch.data import hypotheses
    from dualhyp_tpu_torch.registry import config_from_checkpoint

    cfg = config_from_checkpoint(tiny_checkpoint, **LORA)
    model = common.load_model(tiny_checkpoint, cfg, device="cpu", seed=0,
                              dtype=torch.float32)
    with torch.no_grad():
        model.blocks[0].attn.qkv.weight[0, 0] = float("nan")
    tok = common.load_tokenizer(tiny_checkpoint)
    ds = hypotheses.DualHypothesesDataset("train", str(corpus / "train.json"), tokenizer=tok)
    tcfg = TrainConfig(batch_size=4, micro_batch_size=2, num_epochs=1, log_interval=2,
                       compute_dtype="float32")
    with pytest.raises(SystemExit, match="non-finite"):
        finetune_ger.run_training(model, tok, ds, ds, tcfg, corpus / "out",
                                  generator=torch.Generator().manual_seed(0))
    assert (corpus / "out" / "train_state_diverged.npz").is_file()
