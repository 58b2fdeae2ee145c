#!/usr/bin/env python3
"""Run the PyTorch port (dualhyp_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0]

From the root of a checkout, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Each phase
prints one JSON line; a failed phase raises and the script exits non-zero.

  1. device: the card, its power limit, whether nvcc and triton exist; then
     the kernel library is built from `dualhyp_tpu_torch/csrc/*.cu`;
  2. one phase per kernel, at the main path's shapes (bf16, batch 8, prompt
     384, decode rows 8): the kernel against its plain PyTorch version on the
     same inputs, within a stated tolerance, then CUDA-event times of the
     kernel, the plain version and one PyTorch library call where there is
     one, beside the least time the card could take (`bound_ms`);
  3. a depth-2, full-width TinyLlama + LoRA model from seeded numpy weights:
     prefill logits on the card (kernels, bf16) against the CPU (plain
     versions, fp32);
  4. the slice: full-width TinyLlama-1.1B-Chat with LoRA r=16 on q/k/v/proj,
     all 22 layers, random weights from --seed, serving 16 synthetic DualHyp
     requests through `cli.inference_ger.run_inference` (lockstep greedy,
     decode batch 8, 32 new tokens); every kernel's launch count is read
     around this run and must be > 0;
  5. the `{"kernels": [...]}` line, the card's name and power limit, and the
     last line `{"ok": true, "device": {...}}`.

Exits non-zero without printing a result when no CUDA card is present or
when the port's package is not beside the script.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

TOLERANCES = {
    # (atol, rtol): |kernel - plain| <= atol + rtol * |plain| elementwise.
    # rms_norm, rope: fp32 math rounded once to bf16 on both sides; they may
    # round apart by one bf16 ulp (rtol 2^-7).
    "rms_norm": (1e-3, 2.0 ** -7),
    "apply_rope": (1e-3, 2.0 ** -7),
    # flash: the kernel rounds unnormalised P to bf16, the plain version the
    # normalised probabilities; sums run in another order.
    "flash_attention_fwd": (1e-2, 2.0 ** -6),
    # swiglu: sums of 2048 and 5632 fp32 products in another order and with
    # atomics in no fixed order; h may round apart by one bf16 ulp.
    "swiglu_mlp": (1e-2, 2.0 ** -6),
}
# depth-2 logits, card bf16 vs CPU fp32. The logits' spread is ~0.6 here: a
# wiring fault (a transposed head, a wrong cache slot, a lost LoRA branch)
# moves them by about that much, while bf16 weights and activations through
# two blocks move them by a few bf16 ulps of the largest logits (~0.03).
DEPTH2_ATOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernel_times(prof) -> dict:
    """Device time (us) and count of each CUDA kernel in a profile; empty
    when the profiler saw no device activity."""
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key] = (float(us), int(e.count))
    return out


def device_ms(fn, torch, iters: int = 20):
    """Device time of one call of `fn` (all the kernels it launches), from
    torch.profiler; None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = device_kernel_times(prof)
    return sum(us for us, _ in times.values()) / iters / 1e3 if times else None


def bound(bytes_moved: float, flops: float, flop_rate: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, torch) -> float:
    atol, rtol = TOLERANCES[name]
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    if not ok or not math.isfinite(err):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version: "
                           f"max_abs_err {err}, tolerance atol {atol} rtol {rtol}")
    return err


def kernel_phases(torch, seed: int) -> dict:
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention, rmsnorm, rope, swiglu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    b, t, d, inter, nh, g, hs = 8, 384, 2048, 5632, 32, 4, 64
    rows = b * t

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results = {}

    # ---- K2 rms_norm: prefill rows (B*T) and decode rows (B) ----
    scale = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    entry = {}
    for label, n in (("prefill", rows), ("decode", b)):
        x = randn(n, d)
        err = compare("rms_norm", rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale), torch)
        scale_bf16 = scale.to(bf16)
        lib = (time_ms(lambda: F.rms_norm(x, (d,), scale_bf16, 1e-5), torch)
               if hasattr(F, "rms_norm") else None)
        bms, by = bound(2 * n * d * 2 + d * 4, 4 * n * d, FP32_FLOPS)
        entry[label] = dict(
            shape=[n, d], max_abs_err=err,
            ms=time_ms(lambda: rmsnorm.rms_norm(x, scale), torch),
            device_ms=device_ms(lambda: rmsnorm.rms_norm(x, scale), torch),
            plain_ms=time_ms(lambda: rmsnorm.rms_norm_plain(x, scale), torch),
            library_ms=lib, bound_ms=bms, bound_by=by)
    results["rms_norm"] = entry

    # ---- K3 apply_rope: q and k heads read in place from a fused QKV ----
    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.models.gpt import split_heads

    cfg = GPTConfig(n_embd=d, n_head=nh, n_query_groups=g, rotary_percentage=1.0,
                    intermediate_size=inter, mlp_class="LLaMAMLP")
    qkv = randn(b, t, cfg.qkv_out_dim)
    q5, k4, _ = split_heads(cfg, qkv)
    cos, sin = rope.build_rope_cache(t, hs, dtype=bf16, device=dev)
    err = max(compare("apply_rope", rope.apply_rope(x, cos, sin),
                      rope.apply_rope_plain(x, cos, sin), torch) for x in (q5, k4))
    n_q = b * nh * t * hs
    bms, by = bound(2 * n_q * 2 + 2 * t * hs * 2, 4 * n_q, FP32_FLOPS)
    results["apply_rope"] = {"prefill": dict(
        shape=list(q5.shape), max_abs_err=err,
        ms=time_ms(lambda: rope.apply_rope(q5, cos, sin), torch),
        device_ms=device_ms(lambda: rope.apply_rope(q5, cos, sin), torch),
        plain_ms=time_ms(lambda: rope.apply_rope_plain(q5, cos, sin), torch),
        library_ms=None, bound_ms=bms, bound_by=by)}

    # ---- K1 flash attention forward: T = 384, and a ragged T = 200 ----
    def qkv_heads(tt):
        return randn(b, nh, tt, hs), randn(b, g, tt, hs), randn(b, g, tt, hs)

    q, k, v = qkv_heads(200)
    compare("flash_attention_fwd", attention.causal_attention(q, k, v),
            attention.causal_attention_plain(q, k, v), torch)
    q, k, v = qkv_heads(t)
    err = compare("flash_attention_fwd", attention.causal_attention(q, k, v),
                  attention.causal_attention_plain(q, k, v), torch)
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: expand K/V beforehand
        ke, ve = (z.repeat_interleave(nh // g, dim=1) for z in (k, v))
        lib_fn = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
    pairs = b * nh * t * (t + 1) // 2
    bms, by = bound((2 * b * nh * t * hs + 2 * b * g * t * hs) * 2 + b * nh * t * 4,
                    4 * pairs * hs, BF16_TENSOR_FLOPS)
    results["flash_attention_fwd"] = {"prefill": dict(
        shape=[b, nh, g, t, hs], max_abs_err=err,
        ms=time_ms(lambda: attention.causal_attention(q, k, v), torch),
        device_ms=device_ms(lambda: attention.causal_attention(q, k, v), torch),
        plain_ms=time_ms(lambda: attention.causal_attention_plain(q, k, v), torch),
        library_ms=time_ms(lib_fn, torch), bound_ms=bms, bound_by=by)}

    # ---- K4 swiglu_mlp: prefill rows (B*T) and decode rows (B) ----
    w1, w2 = randn(inter, d, std=0.02), randn(inter, d, std=0.02)
    w3 = randn(d, inter, std=0.02)
    entry = {}
    for label, n in (("prefill", rows), ("decode", b)):
        x = randn(n, d)
        err = compare("swiglu_mlp", swiglu.swiglu_mlp(x, w1, w2, w3),
                      swiglu.swiglu_mlp_plain(x, w1, w2, w3), torch)
        bms, by = bound((2 * n * d + 3 * inter * d) * 2, 6 * n * d * inter,
                        BF16_TENSOR_FLOPS)
        entry[label] = dict(
            shape=[n, d, inter], max_abs_err=err,
            ms=time_ms(lambda: swiglu.swiglu_mlp(x, w1, w2, w3), torch),
            device_ms=device_ms(lambda: swiglu.swiglu_mlp(x, w1, w2, w3), torch),
            plain_ms=time_ms(lambda: swiglu.swiglu_mlp_plain(x, w1, w2, w3), torch),
            library_ms=time_ms(lambda: (F.silu(x @ w1.t()) * (x @ w2.t())) @ w3.t(), torch),
            bound_ms=bms, bound_by=by)
    results["swiglu_mlp"] = entry

    for name, entry in results.items():
        emit({"phase": "kernel", "name": name,
              "tolerance": dict(zip(("atol", "rtol"), TOLERANCES[name])), **entry})
    return results


def lora_config(n_layer: int):
    from dualhyp_tpu_torch import config_from_name

    return config_from_name(
        "tiny-llama-1.1b-chat", n_layer=n_layer, lora_r=16, lora_alpha=16,
        lora_query=True, lora_key=True, lora_value=True, lora_projection=True)


def numpy_tree(cfg, seed: int) -> dict:
    """A parameter tree in the JAX package's layout, drawn with numpy (the
    JAX init's scales, lora_B non-zero so the LoRA branch counts)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, n, inter = cfg.n_embd, cfg.n_layer, cfg.intermediate_size
    std = math.sqrt(2.0 / 5 / d)
    proj_std = 1.0 / math.sqrt(d) / n
    r = cfg.lora_r

    def normal(shape, s):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)

    def uniform(shape, bound_):
        return rng.uniform(-bound_, bound_, size=shape).astype(np.float32)

    kv = d // cfg.q_per_kv
    return {
        "wte": {"weight": normal((cfg.padded_vocab_size, d), std)},
        "ln_f": {"scale": 1.0 + normal((d,), 0.1)},
        "lm_head": {"weight": normal((cfg.padded_vocab_size, d), std)},
        "blocks": {
            "norm_1": {"scale": 1.0 + normal((n, d), 0.1)},
            "norm_2": {"scale": 1.0 + normal((n, d), 0.1)},
            "attn": {
                "qkv": {"weight": normal((n, cfg.qkv_out_dim, d), std),
                        "lora_A": uniform((n, 3 * r, d), 1 / math.sqrt(d)),
                        "lora_B": normal((n, d + 2 * kv, r), 0.02)},
                "proj": {"weight": normal((n, d, d), proj_std),
                         "lora_A": uniform((n, r, d), 1 / math.sqrt(d)),
                         "lora_B": normal((n, d, r), 0.02)},
            },
            "mlp": {"fc_1": {"weight": normal((n, inter, d), std)},
                    "fc_2": {"weight": normal((n, inter, d), std)},
                    "proj": {"weight": normal((n, d, inter), proj_std)}},
        },
    }


def depth2_check(torch, seed: int) -> dict:
    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import params_from_jax

    cfg = lora_config(2)
    tree = numpy_tree(cfg, seed)
    card = params_from_jax(tree, cfg, device="cuda", dtype=torch.bfloat16)
    cpu = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    del tree
    rng = np.random.default_rng(seed + 1)
    t = 96  # not a multiple of the flash kernel's 64-row tile
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, t)))
    lengths = torch.tensor([96, 80, 50, 33])
    for i, n in enumerate(lengths.tolist()):
        ids[i, n:] = 0
    got = card.prefill(ids.cuda(), lengths.cuda(), card.init_cache(4, t)).cpu()
    want = cpu.prefill(ids, lengths, cpu.init_cache(4, t))
    err = float((got - want).abs().max())
    result = {"phase": "depth2_card_vs_cpu", "shape": [4, t], "max_abs_err": err,
              "tolerance": DEPTH2_ATOL, "logit_std": float(want.std()),
              "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float().mean())}
    emit(result)
    if not err <= DEPTH2_ATOL:
        raise RuntimeError(f"depth-2 logits: card vs CPU max_abs_err {err} > {DEPTH2_ATOL}")
    del card, cpu
    torch.cuda.empty_cache()
    return result


class WordTokenizer:
    """Whitespace word-level tokenizer over a fixed vocabulary (the card's
    machine has no `tokenizers`)."""

    eos_token = "</s>"

    def __init__(self, words):
        self.vocab = {"<unk>": 0, "</s>": 1, "<s>": 2}
        for w in words:
            self.vocab.setdefault(w, len(self.vocab))
        self.words = {i: w for w, i in self.vocab.items()}
        self.eos_token_id = 1

    def encode(self, text):
        return [self.vocab.get(w, 0) for w in text.split()]

    def decode(self, ids):
        return " ".join(self.words.get(int(i), f"<{int(i)}>") for i in ids)


def slice_run(torch, seed: int) -> dict:
    from dualhyp_tpu_torch.cli.inference_ger import run_inference
    from dualhyp_tpu_torch.data import hypotheses, prompts, synthetic
    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.ops import KERNELS

    cfg = lora_config(22)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.init_weights(gen)
    with torch.no_grad():  # a finetuned adapter's lora_B is not zero
        for block in model.blocks:
            for mod in (block.attn.qkv, block.attn.proj):
                mod.lora_B.copy_(torch.randn(mod.lora_B.shape, generator=gen,
                                             device="cuda") * 0.02)

    records = synthetic.make_records(n_uids=16, n_hyps=5, seed=seed)
    template_words = " ".join(prompts.DualHyp_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "test.json"
        synthetic.write_json(path, records)
        def dataset():
            return hypotheses.DualHypothesesDataset(
                "test", str(path), tokenizer=tok, prompts_format="DualHyp", seed=seed)

        # a twin of the served dataset: the same seeded draws, read ahead
        twin = dataset()
        prompt_lengths = [len(twin[i].input_ids_no_response) for i in range(len(twin))]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kernel in KERNELS.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        out_records, metrics = run_inference(
            model, tok, dataset(), decode_batch=8, max_new_tokens=32,
            temperature=0.2, top_k=1, collect_latency=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: kernel.launches for name, kernel in KERNELS.items()}

        # the same traffic again under torch.profiler: where the device time
        # goes, and how much of the wall the device is idle
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            run_inference(model, tok, dataset(), decode_batch=8, max_new_tokens=32,
                          temperature=0.2, top_k=1)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t1) * 1e3
    times = device_kernel_times(prof)
    busy_ms = sum(us for us, _ in times.values()) / 1e3
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "slice_profile", "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
          "idle_share": (1 - busy_ms / prof_wall_ms) if busy_ms else None,
          "kernels": [{"name": name[:100], "ms": us / 1e3, "count": n}
                      for name, (us, n) in top]})

    result = {"phase": "slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "lora_r": cfg.lora_r, "requests": len(out_records),
              "prompt_tokens": [min(prompt_lengths), max(prompt_lengths)],
              "decode_batch": 8, "max_new_tokens": 32, "wall_s": wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "metrics": metrics, "launches": launches,
              "sample": out_records[0]}
    emit(result)
    if len(out_records) != 16 or not all(isinstance(r["inference"], str) for r in out_records):
        raise RuntimeError("the slice did not answer every request")
    if not all(math.isfinite(metrics[k]) for k in ("WER", "post_ST_wer")):
        raise RuntimeError(f"non-finite metrics {metrics}")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "dualhyp_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dualhyp_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from dualhyp_tpu_torch.ops import KERNELS, _lib

    smi = nvidia_smi_line()
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if Path("/usr/local/cuda/bin/nvcc").is_file() else None)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "triton": importlib.util.find_spec("triton") is not None})
    t0 = time.perf_counter()
    lib = _lib.build(verbose=True)
    emit({"phase": "build", "library": str(lib.relative_to(REPO)),
          "seconds": time.perf_counter() - t0})

    kernels = kernel_phases(torch, args.seed)
    depth2_check(torch, args.seed)
    sliced = slice_run(torch, args.seed)

    sources = {"rms_norm": ("rmsnorm.cu", "dualhyp_tpu/ops/pallas/rmsnorm_kernel.py:26"),
               "apply_rope": ("rope.cu", "dualhyp_tpu/ops/pallas/rope_kernel.py:29"),
               "flash_attention_fwd": ("flash_attention.cu",
                                       "dualhyp_tpu/ops/pallas/flash_vjp.py:77"),
               "swiglu_mlp": ("swiglu.cu", "dualhyp_tpu/ops/pallas/swiglu_kernel.py:37")}
    line = []
    for name in KERNELS:
        src, replaces = sources[name]
        main_shape = kernels[name]["prefill"]
        line.append({
            "name": name, "route": "cuda", "source": f"dualhyp_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sliced["launches"][name],
            "path": "cli.inference_ger.run_inference -> infer.decode.generate -> GPT."
                    + ("prefill" if name in ("apply_rope", "flash_attention_fwd")
                       else "prefill/decode_step"),
            **{k: main_shape[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "device_ms", "shape")},
            **({"decode": kernels[name]["decode"]} if "decode" in kernels[name] else {}),
        })
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
