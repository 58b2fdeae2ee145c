"""Sharded serving and the entry points' mesh flags on gloo CPU ranks
against one rank of the port (whose tokens tests/test_torch_serve.py and
tests/test_torch_decode.py hold to the JAX package's): the slot pool of
`ContinuousBatcher` over data 2 x tensor 2 (4 ranks; the pool sharded
over data, rank 0's requests broadcast at each poll), in fp32 and merged
and quantized to int8 and int4 (the row-parallel int8 product takes the
whole row's activation scale), and `run_inference` over data 2 (2 ranks)
give the one-rank tokens and records exactly; and
`cli.finetune_ger.main` with --dp 2 and with --tensor 2 on a tiny
checkpoint logs the losses of a one-rank run and writes its LoRA leaves.
The CLI's TrainConfig computes in fp32 here (`fp32_train_config`): in
bf16 the splits' reordered gradient sums round apart, and AdamW's first
steps move a leaf by about lr whatever its gradient's size, so only a
bound no wrong all-reduce could break would hold. In fp32 the leaves are
held to 1e-5 (a tenth of lr: a gradient of the wrong sign or a missing
rank's share moves a leaf by about 2 lr) and the losses to 1e-5."""

import sys

import numpy as np
import pytest
import torch

from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.cli import finetune_ger
from dualhyp_tpu_torch.cli.inference_ger import run_inference
from dualhyp_tpu_torch.data import synthetic
from dualhyp_tpu_torch.data.hypotheses import DualHypothesesDataset
from dualhyp_tpu_torch.data.tokenizer import Tokenizer
from dualhyp_tpu_torch.infer.serve import ContinuousBatcher
from dualhyp_tpu_torch.parallel.sharding import leaves
from tests import helpers, torch_dist_worker
from tests.test_torch_decode import _write_tokenizer

LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True)
SERVE_CFG = helpers.tiny_llama_config(n_embd=64, intermediate_size=128, **LORA)
SERVE_KW = dict(slots=4, max_new_tokens=8, chunk_steps=2, draft_len=3)
# wide enough that the quantizers take every linear (>= 256 each way)
QUANT_CFG = helpers.tiny_llama_config(n_embd=256, intermediate_size=512, **LORA)
QUANTIZE = (None, "int8", "int4")


def _serve_cfg(quantize):
    return SERVE_CFG if quantize is None else QUANT_CFG


def _serve_kw(quantize):
    """The quantized products' plain versions are slow on the CPU: fewer
    requests and tokens for those."""
    return SERVE_KW if quantize is None else dict(SERVE_KW, max_new_tokens=4)


def _serve_requests(quantize):
    return _requests() if quantize is None else _requests()[:4]
CLI_ARGS = ["--dual_hypotheses", "--prompts_format", "DualHyp", "--batch_size", "4",
            "--micro_batch_size", "2", "--log_interval", "2", "--device", "cpu",
            "--num_epochs", "1", "--lora_dropout", "0", "--save_adapter_only"]


def _requests():
    rng = np.random.default_rng(3)
    return [(i, rng.integers(3, 96, int(rng.integers(4, 20))).tolist()) for i in range(7)]


def _model(cfg, tree):
    from dualhyp_tpu_torch.ckpt.convert import params_from_jax
    from dualhyp_tpu_torch.config import GPTConfig

    return params_from_jax(tree, GPTConfig(**torch_dist_worker.cfg_dict(cfg)), device="cpu",
                           dtype=torch.float32)


@pytest.fixture(scope="module")
def infer_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("infer")
    vocab = _write_tokenizer(tmp)
    synthetic.write_json(tmp / "test.json", synthetic.make_records(n_uids=5, n_hyps=5, seed=3))
    cfg = helpers.tiny_llama_config(block_size=640, vocab_size=vocab, padding_multiple=8, **LORA)
    return tmp, cfg, torch_dist_worker.random_tree(cfg, 5)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A tiny checkpoint directory (config JSON, npz weights, a word
    tokenizer) and a train / val corpus, as tests/test_torch_train.py makes
    them; the CLI's flags over them."""
    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.config import GPTConfig

    root = tmp_path_factory.mktemp("cli")
    ckpt = root / "tiny-llama-test"
    ckpt.mkdir()
    cfg = GPTConfig(**torch_dist_worker.cfg_dict(helpers.tiny_llama_config(
        block_size=640, vocab_size=_write_tokenizer(ckpt), padding_multiple=8)))
    save_params(ckpt / "dualhyp_model.npz", torch_dist_worker.random_tree(cfg, 0))
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    for split, n, seed in (("train", 8, 1), ("val", 4, 2)):
        synthetic.write_json(root / f"{split}.json", synthetic.make_records(n_uids=n, seed=seed))
    args = ["--train_path", str(root / "train.json"), "--val_path", str(root / "val.json"),
            "--llm_checkpoint", str(ckpt), *CLI_ARGS]
    return root, args


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, infer_setup, cli_setup):
    """The 4-rank serve, and the 2-rank inference and CLI runs, started
    together."""
    tmp, cfg, tree = infer_setup
    root, args = cli_setup
    four = [dict(kind="serve", mesh=dict(data=2, tensor=2), cfg=torch_dist_worker.cfg_dict(
        _serve_cfg(q)), tree=torch_dist_worker.random_tree(_serve_cfg(q), 1),
        requests=_serve_requests(q), quantize=q, **_serve_kw(q)) for q in QUANTIZE]
    two = [dict(kind="inference", mesh=dict(data=2), cfg=torch_dist_worker.cfg_dict(cfg),
                tree=tree, tokenizer_dir=str(tmp), data_path=str(tmp / "test.json"),
                decode_batch=4, max_new_tokens=6)]
    two += [dict(kind="cli", module="dualhyp_tpu_torch.cli.finetune_ger", cwd=str(root),
                 argv=args + ["--exp_name", flag.strip("-"), flag, "2"], fp32=True)
            for flag in ("--dp", "--tensor")]
    # the two ranks run inference and two CLI trainings in a row
    return (torch_dist_worker.Spawn(4, four, tmp_path_factory.mktemp("serve")),
            torch_dist_worker.Spawn(2, two, tmp_path_factory.mktemp("inf"), timeout=180.0))


@pytest.mark.parametrize("quantize", QUANTIZE)
def test_continuous_batcher_data2_tensor2_tokens_equal_one_rank(ranks, quantize):
    from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model

    cfg = _serve_cfg(quantize)
    model = _model(cfg, torch_dist_worker.random_tree(cfg, 1))
    if quantize:
        quantize_model(merge_lora(model), quantize)
    want = ContinuousBatcher(model, **_serve_kw(quantize)).serve(_serve_requests(quantize))
    for rank_tokens in ranks[0].results():
        assert rank_tokens[QUANTIZE.index(quantize)] == {rec["id"]: rec["tokens"]
                                                         for rec in want}


def test_run_inference_data2_records_equal_one_rank(ranks, infer_setup):
    tmp, cfg, tree = infer_setup
    tok = Tokenizer(tmp)
    dataset = DualHypothesesDataset("test", str(tmp / "test.json"), tokenizer=tok,
                                    prompts_format="DualHyp", seed=1337)
    want = run_inference(_model(cfg, tree), tok, dataset, decode_batch=4, max_new_tokens=6)
    for records, metrics in (r[0] for r in ranks[1].results()):
        assert records == want[0] and metrics == want[1]


@pytest.fixture(scope="module")
def one_rank_run(cli_setup):
    """The one-rank CLI run, with the package's own tokenizer as the
    ranks use it."""
    root, args = cli_setup
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setitem(sys.modules, "transformers", None)
        mp.setattr(finetune_ger, "TrainConfig", torch_dist_worker.fp32_train_config)
        finetune_ger.main(args + ["--exp_name", "one"])
    return root / "runs" / "one"


@pytest.mark.parametrize("flag", ["--dp", "--tensor"])
def test_finetune_cli_mesh_saves_one_rank_leaves(flag, ranks, cli_setup, one_rank_run):
    ranks[1].results()
    one, mesh = one_rank_run, cli_setup[0] / "runs" / flag.strip("-")
    want = dict(leaves(load_params(one / "model_lora_finetuned.npz")))
    got = dict(leaves(load_params(mesh / "model_lora_finetuned.npz")))
    assert set(got) == set(want) and all("lora" in k for k in want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
    logged = [np.genfromtxt(run / "metrics.csv", delimiter=",", names=True)["loss"]
              for run in (mesh, one)]
    np.testing.assert_allclose(logged[0], logged[1], rtol=1e-5)
    assert (mesh / "train.log").is_file()
