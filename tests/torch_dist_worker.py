"""Multi-process runs of the port on gloo CPU ranks, for the tests.

`spawn(world, cases, tmp_path)` starts `world` processes (the "spawn"
start method, so each imports this module afresh: it imports torch, numpy
and the port, never JAX), joins them through a `file://` rendezvous under
tmp_path (so test workers never contend for a TCP port), runs every case
on every rank in order and returns each rank's results. One spawn serves
many cases, so process start-up is paid once. The parent joins with a
deadline (DEADLINE) and kills the children when it passes, so a
collective that hangs fails its test and holds up nothing else.

A case is a dict: {"kind": one of CASES, ...its arguments}. Configs come
as dicts of GPTConfig fields, trees as nested dicts of numpy arrays.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
import uuid

import multiprocessing as mp
import numpy as np

# seconds a spawn may take, start-up included: each spawn here takes 5-25 s
# alone, and up to a few times that beside the rest of the suite's workers
DEADLINE = 120.0


class Spawn:
    """`world` gloo ranks running `cases`, started at once; `results()`
    joins them (by the deadline) and returns [rank][case] results, so the
    parent can work while they run."""

    def __init__(self, world: int, cases: list, tmp_path, timeout: float = DEADLINE):
        ctx = mp.get_context("spawn")
        tag = uuid.uuid4().hex[:8]
        init = os.path.join(str(tmp_path), f"init_{tag}")
        self.outs = [os.path.join(str(tmp_path), f"rank{r}_{tag}.pkl") for r in range(world)]
        self.procs = [ctx.Process(target=_child, args=(r, world, init, cases, self.outs[r]),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self._results = None

    def results(self) -> list:
        if self._results is None:
            self._results = self._join()
        return self._results

    def _join(self) -> list:
        try:
            for p in self.procs:
                p.join(max(self.deadline - time.monotonic(), 0.0))
            if any(p.is_alive() for p in self.procs):
                raise TimeoutError(f"{len(self.procs)} ranks did not finish within "
                                   f"{self.timeout} s")
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, (p, out) in enumerate(zip(self.procs, self.outs)):
            if not os.path.exists(out):
                raise RuntimeError(f"rank {r} exited {p.exitcode} with no result")
            with open(out, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        return results


def spawn(world: int, cases: list, tmp_path, timeout: float = DEADLINE) -> list:
    """Run `cases` on `world` gloo ranks; returns [rank][case] results."""
    return Spawn(world, cases, tmp_path, timeout).results()


def assemble(parts: list, mesh: dict, shape) -> np.ndarray:
    """The whole (B, T, ...) array from the ranks' (coords, rows of data x
    fsdp, tokens of seq) parts."""
    out = None
    nb, ns = mesh.get("data", 1) * mesh.get("fsdp", 1), mesh.get("seq", 1)
    b, t = shape
    for coords, part in parts:
        if out is None:
            out = np.zeros((b, t, *part.shape[2:]), part.dtype)
        i = coords["data"] * mesh.get("fsdp", 1) + coords["fsdp"]
        j = coords["seq"]
        out[i * b // nb:(i + 1) * b // nb, j * t // ns:(j + 1) * t // ns] = part
    return out


def _child(rank: int, world: int, init: str, cases: list, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world)
        results = [CASES[case["kind"]](**{k: v for k, v in case.items() if k != "kind"})
                   for case in cases]
        dist.barrier()
        dist.destroy_process_group()
        payload = ("ok", results)
    except BaseException:  # the parent shows the traceback
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def cfg_dict(cfg) -> dict:
    """A config's fields (of either package's GPTConfig) as a dict."""
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def random_tree(cfg, seed: int = 0, lora_b: float = 0.2) -> dict:
    """A parameter tree in the JAX package's layout, in fp32 numpy: the
    port's `init_weights` (the JAX init's distributions, drawn in torch,
    which costs milliseconds where the JAX init compiles for seconds), each
    lora_B drawn normal at `lora_b` so the LoRA branch counts."""
    import torch

    from dualhyp_tpu_torch.ckpt.convert import tree_from_model
    from dualhyp_tpu_torch.models.gpt import GPT

    model = GPT(_cfg(cfg_dict(cfg)), device="cpu", dtype=torch.float32)
    generator = torch.Generator().manual_seed(seed)
    model.init_weights(generator)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=generator) * lora_b)
    return tree_from_model(model)


# ---- cases ----

def _cfg(cfg: dict):
    from dualhyp_tpu_torch.config import GPTConfig

    return GPTConfig(**cfg)


def _mesh(mesh: dict):
    from dualhyp_tpu_torch.parallel import make_mesh, make_pipe_mesh

    if "pipe" in mesh:
        return make_pipe_mesh(mesh["pipe"], data=mesh.get("data", 1))
    return make_mesh(**mesh)


def _model(cfg, tree, mesh, moe_impl=None, lora_impl=None):
    import torch

    from dualhyp_tpu_torch.ckpt.convert import load_tree
    from dualhyp_tpu_torch.models.gpt import GPT

    model = GPT(_cfg(cfg), device="cpu", dtype=torch.float32, mesh=mesh,
                moe_impl=moe_impl, lora_impl=lora_impl)
    load_tree(model, tree)
    return model


def forward(mesh: dict, cfg: dict, tree: dict, idx, moe_impl=None):
    """This rank's logits of its rows (data x fsdp) and tokens (seq) of
    idx: (coords, logits)."""
    import torch

    m = _mesh(mesh)
    model = _model(cfg, tree, m, moe_impl)
    b, t = idx.shape
    nb, ns = m.extent("data", "fsdp"), m.extent("seq")
    i, j = m.index("data", "fsdp"), m.index("seq")
    local = idx[i * b // nb:(i + 1) * b // nb, j * t // ns:(j + 1) * t // ns]
    with torch.no_grad():
        logits = model(torch.as_tensor(local, dtype=torch.long))
    return dict(m.coords), logits.numpy()


def train(mesh, cfg: dict, tcfg: dict, tree: dict, batches: list, moe_impl=None):
    """Trainer steps on the mesh (None: one rank alone): (losses, the
    trainable leaves as a whole tree, evaluate() of the last batch)."""
    from dualhyp_tpu_torch.train.trainer import TrainConfig, Trainer

    m = None if mesh is None else _mesh(mesh)
    tc = TrainConfig(**tcfg)
    if tc.pipeline_stages > 1:
        trainer = Trainer(_cfg(cfg), tc, tree, device="cpu")
    else:
        trainer = Trainer(_cfg(cfg), tc, _model(cfg, tree, m, moe_impl), device="cpu", mesh=m)
    losses = []
    for batch in batches:
        loss, _ = trainer.train_step(batch, max_iters=10, warmup_steps=1)
        losses.append(float(loss))
    val = trainer.evaluate(batches[-1:])
    return losses, trainer.trainable_params, val


def pipeline(mesh: dict, cfg: dict, tree: dict, idx, cotangent, n_micro: int):
    """pipeline_logits on the (data, pipe) mesh and the gradients of
    sum(logits * cotangent) for every parameter (whole leaves, on the
    host): (logits, {tree key: grad})."""
    import torch

    from dualhyp_tpu_torch.ckpt.convert import flat_from_named
    from dualhyp_tpu_torch.parallel import comm, pipeline_logits

    m = _mesh(mesh)
    model = _model(cfg, tree, m)
    for p in model.parameters():
        p.requires_grad_(True)
    logits = pipeline_logits(model, torch.as_tensor(idx, dtype=torch.long), m, n_micro=n_micro)
    (logits * torch.as_tensor(cotangent)).sum().backward()
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[name] = comm.all_reduce_(g.clone(), m.group("data"))
    whole = {}
    for part in comm.all_gather_objects(grads, m.group("pipe")):
        whole.update(part)
    flat = flat_from_named(whole, model.cfg.n_layer)
    return logits.detach().numpy(), {k: v.numpy() for k, v in flat.items()}


def pipe_dropout(mesh: dict, cfg: dict, tree: dict, idx, n_micro: int):
    """pipeline_hidden with LoRA dropout on: (seed 3, seed 3 again, seed 4,
    dropout off)."""
    import torch

    from dualhyp_tpu_torch.parallel import pipeline_hidden

    m = _mesh(mesh)
    model = _model(cfg, tree, m)
    ids = torch.as_tensor(idx, dtype=torch.long)
    with torch.no_grad():
        return [pipeline_hidden(model, ids, m, n_micro=n_micro, generator=None if seed is None
                                else torch.Generator().manual_seed(seed)).numpy()
                for seed in (3, 3, 4, None)]


def serve(mesh: dict, cfg: dict, tree: dict, requests: list, quantize=None, **kw):
    """`ContinuousBatcher(**kw).serve(requests)` on the mesh, the LoRA merged
    and the weights quantized under `quantize`: {id: tokens}."""
    from dualhyp_tpu_torch.infer.serve import ContinuousBatcher

    model = _model(cfg, tree, _mesh(mesh))
    if quantize:
        from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model

        quantize_model(merge_lora(model), quantize)
    batcher = ContinuousBatcher(model, **kw)
    return {rec["id"]: rec["tokens"] for rec in batcher.serve(requests)}


def inference(mesh: dict, cfg: dict, tree: dict, tokenizer_dir: str, data_path: str, **kw):
    """`cli.inference_ger.run_inference(**kw)` on the mesh over a DualHyp
    test set: (records, metrics without the timings)."""
    from dualhyp_tpu_torch.cli.inference_ger import run_inference
    from dualhyp_tpu_torch.data.hypotheses import DualHypothesesDataset
    from dualhyp_tpu_torch.data.tokenizer import Tokenizer

    tok = Tokenizer(tokenizer_dir)
    dataset = DualHypothesesDataset("test", data_path, tokenizer=tok, prompts_format="DualHyp",
                                    seed=1337)
    return run_inference(_model(cfg, tree, _mesh(mesh)), tok, dataset, **kw)


def fp32_train_config(**kw):
    """`TrainConfig(**kw)` computing in fp32 and keeping the frozen leaves
    in fp32: an entry point's TrainConfig in the tests, where the CLI's bf16
    would round a mesh run's reordered sums apart from one rank's."""
    from dualhyp_tpu_torch.train import TrainConfig

    return TrainConfig(**{**kw, "compute_dtype": "float32", "frozen_dtype": ""})


def cli(module: str, argv: list, cwd: str, fp32: bool = False):
    """`module.main(argv)` (an entry point of the port) on this rank, from
    `cwd`, with the package's own tokenizer (`transformers` kept out, as
    on the card's machine; it takes seconds to import); with `fp32`, its
    TrainConfig is `fp32_train_config`."""
    import importlib
    import sys

    sys.modules["transformers"] = None
    os.chdir(cwd)
    entry = importlib.import_module(module)
    if fp32:
        entry.TrainConfig = fp32_train_config
    entry.main(argv)


CASES = {"forward": forward, "train": train, "pipeline": pipeline, "pipe_dropout": pipe_dropout,
         "serve": serve, "inference": inference, "cli": cli}
