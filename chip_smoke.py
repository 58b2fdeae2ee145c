#!/usr/bin/env python3
"""Run the PyTorch port (dualhyp_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0]

From the root of a checkout, on a machine with an NVIDIA Hopper card and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Each phase
prints one JSON line; a failed phase raises and the script exits non-zero.

  1. device: the card, its power limit, whether nvcc and triton exist; then
     the kernel library is built from `dualhyp_tpu_torch/csrc/*.cu`, and the
     registers, static shared memory and spills of the wgmma/TMA kernels
     (K1's forward and backward, L1's forward, dQ and dK/dV, K4, K5, K6/K7
     at fp32 and bf16, K8 and L2) and of the row passes K2 and K3 are
     printed from `-Xptxas -v`, and each kernel's count of wgmma
     instructions (HGMMA) from `cuobjdump -sass`;
  2. after 2 s of warm-up work (`warm_up`), one phase per kernel, at the
     main path's shapes (bf16, batch 8, prompt 384, decode rows 8): the
     kernel against its plain PyTorch version on the same inputs, within a
     stated tolerance, then CUDA-event times of the kernel, the plain
     version and one PyTorch library call where there is one, beside the
     least time the card could take (`bound_ms`); K2, K3 and K4 must give
     bitwise-equal outputs on two calls; the host microseconds of a K1
     forward, K4 and K2 call at tiny shapes (K1 and K4 encode TMA tensor
     maps on every call);
  3. a depth-2, full-width TinyLlama + LoRA model from seeded numpy weights:
     prefill logits on the card (kernels, bf16) against the CPU (plain
     versions, fp32);
  4. the decode slice: full-width TinyLlama-1.1B-Chat with LoRA r=16 on
     q/k/v/proj, random weights from --seed, serving 16 synthetic DualHyp
     requests through `cli.inference_ger.run_inference` (lockstep greedy,
     decode batch 8, 32 new tokens); the launch count of each kernel of that
     path is read around this run and must be > 0;
  5. K1's forward (O and the row logsumexp L) and backward kernels against
     the plain pair (B=8, Hq=32, G=4, T=1024 and a ragged T=200), both
     timed at T=1024 beside SDPA's forward and backward, and K2, K3 (both
     directions, on q and on k) and K4 at the training shape of 8192 rows,
     each bitwise repeatable;
  6. a depth-2, full-width TinyLlama + LoRA training step: the loss and
     every LoRA gradient on the card (kernels, bf16) against the CPU (plain
     versions, fp32);
  7. the training slice: LoRA finetuning of full-width TinyLlama-1.1B-Chat,
     all 22 layers, through `cli.finetune_ger.run_training` (bf16, frozen
     leaves bf16, LoRA r=16 alpha=16 dropout 0.05, remat, batch 32 of micro
     batches 8, 64 synthetic train records and 16 val records, 2 epochs = 4
     optimizer steps, then validation and the npz checkpoints); it checks
     the losses, the leaves, the checkpoint's reload and a decode from it,
     and that all five kernels (K3 in both directions) launched; then one
     step under torch.profiler;
  8. the headline training step (`bench.py`'s shape: micro batch 8, T=1024,
     half the labels masked), remat on and off, and with the fused LoRA
     linear (K5) with remat on: median step time, tokens/s, MFU and peak
     memory (the fused-vs-composition A/B), and the device ms of K1's
     forward, its backward and K4 in a profiled step;
  9. K8 (int4 weights times activations) at decode (8) and prefill (3072)
     rows for fc_1, mlp.proj and lm_head (two calls bitwise equal), and K5 (the fused LoRA linear) at
     8, 1536 (the fused slice's prefill: 8 prompts at its bucket of 192),
     3072 and 8192 rows for the fused QKV (rank 48) and proj (rank 16),
     with the LoRA input x itself and a separate one (two calls bitwise
     equal): each against its plain version, timed beside its bound and
     the cuBLAS yardstick (a bf16 matmul on the dequantised weight; the
     three-call LoRA composition);
 10. depth-2, full-width checks, card (kernels, bf16) against CPU (plain,
     fp32) on the same seeded numpy weights: int4 prefill logits (weights
     merged and quantized by the port, so both sides hold the same bytes),
     and a fused-LoRA training step's loss and LoRA gradients;
 11. the quantized and fused decode slices, full-width and 22 layers, the
     decode slice's traffic: (a) LoRA merged, --quantize int4 (K8 launches,
     K4 and K5 do not); (b) merged, --quantize int8 --kv_quant int8; (c)
     unmerged with the fused LoRA linear (K5 launches): p50 latency,
     tokens/s, peak memory and greedy-token agreement with the bf16 slice;
 12. K6 (bidirectional flash-attention forward, the Whisper encoder's
     attention) in fp32 at B=1 H=20 T=S=280 (an utterance of the RelPrompt
     slice), B=1 and B=8 at T=S=1500 (a 30-s window), T=280 against S=1500,
     and in bf16 at B=8 T=S=1500; K7 (its causal flag) in bf16 at B=8 Hq=32
     G=4 T=1024 and a ragged T=200: each against its plain version (the
     Pallas kernel's fp32 P V; at bf16 also the share of elements that
     differ, beside K1's forward, which rounds P, on K7's inputs; two calls
     bitwise equal), timed beside its bound and SDPA; at fp32 the bound is
     that of six bf16 tensor-core products (the kernel's three pieces of
     each operand), beside the CUDA cores' fp32 bound;
 13. a depth-2, full-width (1280, 20 heads, 128 mels) Whisper encoder from
     seeded numpy weights, card (K6, fp32, TF32 off) against CPU (plain,
     fp32), on a 3-s mel and a 30-s `pad_or_trim` mel;
 14. the RelPrompt slice: a random Whisper-large-v3 encoder (all 32 layers,
     written as `config.json` + an F16 `model.safetensors`) and full-width
     TinyLlama-1.1B-Chat + LoRA r=16 with the two classifiers and the 3
     mask-token rows, 16 synthetic RelPrompt requests whose WAVs are written
     from seeded noise: (a) `cli.precompute_features.main` on all 16, (b)
     `cli.inference_relprompt.run_relprompt` with the encoder on the card
     (`--whisper_checkpoint`), decode batch 8, 32 new tokens, greedy, (c) the
     same from (a)'s `--feature_dir`: the mask tokens of (b) and (c) must
     agree; launch counts around (a) and (b), where K6 runs 32 times an
     utterance;
 15. L2 (the grouped matmul of the MoE) against its plain version at the
     Mixtral slices' shapes (decode 16 rows, prefill 6144 rows and the
     training forward's 16384, for fc_1/fc_2 and proj), with skewed and
     with empty experts (timed beside its bound and torch._grouped_mm, or a
     per-expert cuBLAS loop, back to back and one cold call each), in a
     single group, and at the decode shapes with every expert busy (timed
     too), two calls bitwise equal, the decode kernel's launch plan; the
     host us of a decode call beside K2's; K1's
     forward at head size 128 (B=8 Hq=32 G=8, T=384 and a ragged T=200);
 16. one Mixtral MoE layer at the decode and the prefill shape under
     torch.cuda.set_sync_debug_mode("error"): no host sync on that path;
 17. a depth-2, full-width Mixtral-8x7B + LoRA model, card (L2, K1 at
     D=128, bf16) against CPU (plain, fp32): the share of (token, layer)
     routes that agree, and the prefill logits of the rows routed alike;
 18. the Mixtral slice: 8 of 32 layers of Mixtral-8x7B-Instruct at full
     width (23.5 GB of bf16 weights), LoRA r=16 on q/k/v/proj, random weights
     from --seed, serving the decode slice's 16 requests with moe_impl
     "megablox" (L2, the main path; then one decode batch under
     torch.profiler, with L2's
     decode and prefill kernels' device ms and launches) and "dense": p50,
     tokens/s, peak memory, launches, greedy agreement;
 19. L2's gradients at Mixtral's training rows (8 x 1024 tokens x top 2 =
     16384) for fc_1 and proj, skewed, with empty experts and in a single
     group: dlhs and drhs (each two calls bitwise equal) against their plain
     versions, timed beside their
     bound and torch._grouped_mm; K1's backward at head size 128 (B8 Hq32
     G8, T=1024 and a ragged T=200); the MoE layer's backward without host
     syncs, with frozen stacks (dlhs) and trainable ones (drhs too);
 20. a depth-2, full-width Mixtral-8x7B + LoRA training step, card under
     megablox and dense against the CPU (plain, fp32): the share of routes
     that agree, then the loss and LoRA gradients on the rows routed alike;
 21. K2 and K3 (both directions) at Mixtral's training shape: 8192 rows of
     width 4096, q of 32 heads in 8 groups and k of 8 at head size 128, rope
     base 1e6;
 22. the Mixtral training slice: the 8-layer Mixtral with LoRA r=16 through
     `cli.finetune_ger.run_training` (megablox, remat, 4 optimizer steps,
     checkpoints of the LoRA leaves as --save_adapter_only writes them, the
     best one read back and 4 requests decoded), then the 8 x 1024 step
     with remat on and remat "moe" (profiled), with remat under
     DUALHYP_ATTN_IMPL=splash (L1 at head size 128: 2 warm-up, 3 timed and
     1 profiled steps; L1's three kernels launch, K1 does not) and with the
     dense einsums: step time, tokens/s, MFU from the active parameters,
     peak memory, launches (L2 forward, dlhs, K1 both ways or L1, K2, K3 >
     0; drhs and K4 = 0);
 23. L1 (splash attention), after the other kernels' phases: its forward
     (K1's forward kernel body with splash's fp32 P V), dQ (shaped like
     K1's forward) and dK/dV (K1's backward body without dQ) kernels
     against their plain versions at B8 Hq32 G4 T1024
     (training) and T384 (prefill), an unaligned T192 (the scale inside the
     kernels) and Mixtral's B8 Hq32 G8 T1024 D128, dQ and dK/dV two calls
     bitwise equal, timed beside their bound and SDPA's forward and
     backward, with each instance's registers and spills from the build's
     -Xptxas -v;
 24. after the depth-2 training checks, the same step with
     DUALHYP_ATTN_IMPL=splash at T=256 (q rounded with the bf16 scale) and
     T=160 (the scale inside the kernels): L1 launches, K1 does not;
 25. after the 8 x 1024 step, the splash slice: full-width TinyLlama-1.1B
     written as a random HF-layout checkpoint (2.2 GB of bf16 safetensors in
     two shards), converted by `cli.common.load_model` (held against the
     written tensors), then with DUALHYP_ATTN_IMPL=splash the training
     slice's 4 optimizer steps through `run_training`, the best checkpoint
     read back and the decode slice's 16 requests served from it: L1's three
     kernels, K2, K3 and K4 launch, K1 never; then the 8 x 1024 step with
     remat, "own" (K1) against "splash" (L1) in turns own, splash, splash,
     own, one profiled step each;
 26. (after the kernel phases) K4, K5 (QKV rank 48, proj rank 16) and K8
     (qkv, fc_1) at a speculative verify step's rows, slots x (draft 8 +
     1) = 9, 36, 72, 144, which cross K8's (16), K5's (32) and K4's (64)
     decode thresholds: each against its plain version, two calls bitwise
     equal, timed beside its bound and cuBLAS, the middle paths (K8 above
     16 rows, K5 above 32, K4 above 64) beside the design each replaced on
     the same inputs (`was_device_ms`: K8's wgmma tile, K5's rank + TMA
     pair, K4's row tiles; int4 serving must launch K8's middle kernel,
     fused-LoRA serving K5's, the speculative lookup and anchored runs and
     every bf16 serving run K4's middle path); (after
     the depth-2 checks) a
     depth-2, full-width verify step of 9 tokens a row, card against 9
     decode steps on the card and against the CPU (DEPTH2_ATOL);
 27. (after the decode slices) the speculative slice: the decode slice's
     model and 16 requests through `run_inference` with --speculative
     lookup, anchored and --scheduler continuous (draft 8): p50, tokens/s,
     tokens a row a verify step, launches a verify step, greedy agreement
     with the bf16 slice; host syncs counted under sync debug "warn", one
     `lookup_step` alone under "error"; then the serving slice:
     `ContinuousBatcher` with 16 slots, draft 8, chunks of 8 steps, 24
     requests with budgets of 16-64 tokens, in bf16 (lookup, anchored),
     with the int8 KV cache and merged + int4 (K8 at 144 rows), each chunk
     under sync debug "error", one status read a chunk; and
     `cli.serve_ger.Server` answering 4 requests over TCP on 127.0.0.1;
 28. (after the RelPrompt slice) a depth-2, full-width RelPrompt training
     step (fused LoRA, the two classifiers at Whisper-large's and BRAVEn's
     widths), card against CPU: the three losses and every LoRA and
     classifier gradient; then the RelPrompt training slice:
     `cli.finetune_relprompt.main` on full-width TinyLlama-1.1B-Chat with
     3 mask rows, features from the RelPrompt slice's random Whisper-large-v3
     on the card, 32 train and 8 val records, 4 steps of micro batch 8, K5
     for the LoRA linears, one validation and the saves; `best_model.npz`
     read back by `ckpt.io`; one step profiled;
 29. (after the RelPrompt training slice) slice 6: K8 at the Whisper-large-v3
     decoder's linears (1280 x 1280, 5120 x 1280, 1280 x 5120) at a beam
     step's 400 rows (the middle kernel, beside the parent's tile; the int4
     beam must launch it), the cross K/V's 8 x 1500 and a long-form step's
     5, and K6 in bf16 at B8 H20 T=S=1500, each against its plain version,
     timed beside its bound and cuBLAS / SDPA; a depth-2, full-width Whisper
     decoder, card (bf16) against CPU (fp32): the full forward's logits, 8
     cached steps against the full forward, int8 cross and self K/V; the
     ASR slice: `cli.make_json_asr.main --config` on 16 seeded WAVs of 2-12
     s with noise mixed in, the random Whisper-large-v3 with its decoder
     (F16 on disk, so bf16 compute), beam 50, n-best 5, decode batch 8, 64
     new tokens (cut from 224), in bf16, with `quantize: int4` and with
     int8 cross and self K/V: all 16 records, no retry or skip printed, at
     most one host sync a chunk in every beam (torch's sync warnings), K6
     and (int4) K8 launched; ms an utterance, step ms, peak memory, a
     profiled chunk's idle share; the long-form slice: `cli.transcribe.main`
     on a 75-s WAV, beam 5, --quantize int4, --word_timestamps, 32 new
     tokens a window and the fallback to temperature 1.0;
 30. slice 7 and `native`: first of all (after the build), `native`
     (hostops.cc) built by g++, its seconds, and its edit distance, DTW and
     median filter equal to the numpy versions at the long-form slice's
     sizes (the long-form slice then counts its calls of `native.dtw` and
     `native.median_filter`: both > 0); after the long-form slice, a
     depth-2 BRAVEn-large (1024, 16 heads, 4096, the full Conv3D + ResNet-18
     frontend) and a 2-block 1024/16/4096 decoder, card (fp32, TF32 off)
     against CPU: memory and CTC log-probs, the cached step against the full
     forward and the CPU, the psi scores of one beam step (bf16 reported);
     the VSR slice: `cli.make_json_vsr.main --config` on 16 seeded uint8
     96 x 96 mouth ROIs of 3-5 s, random BRAVEn-large + a 1024/16/4096 x 6
     decoder in bf16 (one npz), 1049 tokens, occ_type pixelate, beam 40,
     ctc_weight 0.1, decode batch 16, max_len 40, n-best 5; the AVSR slice:
     `cli.make_json_avsr.main` on 16 (WAV, ROI) pairs of the same lengths,
     random auto_avsr at its public sizes (768/12/3072 x 12 a stream,
     fusion 8192, a 768/12/3072 x 6 decoder, 5049 tokens, bf16), the same
     beam: each 16 records of 5 finite hypotheses, no retry or skip printed,
     one host read a beam chunk and no sync torch reports, no kernel
     launched; ms an utterance, encode ms (CUDA events), step ms, peak
     memory, a profiled chunk's idle share and launches a step; then
     `cli.precompute_features.main --raven_checkpoint` on 4 RelPrompt
     records with ROIs: visual features (frames, 1024), nonzero, and K6 32
     times an utterance;
 31. slice 22, last: `flash_heads_phase`, K1's forward and backward and
     L1's forward, dQ and dK/dV at head sizes 32, 80, 96, 100 and 256 (B8
     T1024 with phi-2's, Gemma-2b's, Phi-3-mini's, open_llama_3b's and
     pythia-14m's heads and groups; the forwards at T384 too) against
     their plain versions, timed beside the bound and SDPA, with each
     instance's registers and spills and K1's layouts (the forward at 80
     and 96 over narrow boxes, the backward at 100 reading its rows in
     place; each beside its parent's device ms, `K1_WAS`), and K1's
     backward at 100 again on the model's rows (q and k through K3, v a
     view of the fused QKV, dO a transposed view) with its peak memory;
     `depth2_family_check`, two blocks at
     full width of phi-2, pythia-1b, falcon-7b, Gemma-2b,
     Phi-3-mini-4k-instruct and open_llama_3b with LoRA, card bf16 against
     CPU fp32: prefill and decode logits, the K/V caches, one LoRA training
     step's loss and gradients; `phi2_slice`, phi-2 at full size (2.8 B
     parameters) written as a random HF Phi directory, loaded through
     `cli.common.load_model`, serving the decode slice's 16 requests through
     `run_inference` in bf16 (one batch profiled over 4 new tokens), 4 LoRA
     finetuning steps through `run_training`, the requests again through K5
     (lora_impl "fused") and merged and int4 (K8); K1 at D80 and K3 at 32
     of 80 channels launched on every run, K2 and K4 never;
 32. slice 23, PEFT breadth, last: `peft_kernel_phase`, K5 at TinyLlama's
     MLP shapes under --lora_mlp (fc_1 / fc_2 O 5632 D 2048, proj O 2048 D
     5632, rank 16) at 8, 1536 and 8192 rows (and 8192 with a separate
     dropout input) against its plain version, timed beside its bound and
     cuBLAS x3 + add; `depth2_peft_check`, two full-width TinyLlama blocks
     in each mode (adapter v1, v2, LoRA on q/k/v/proj and the MLP through
     K5, full), every PEFT leaf non-zero, card bf16 against CPU fp32:
     prefill and decode logits, caches, a Trainer step's loss and every
     trainable gradient; `peft_slice`, full-width TinyLlama-1.1B (22 layers)
     in modes adapter, adapter_v2 and LoRA-on-the-MLP (K5): 4 steps of
     `run_training`, the decode slices' 16 requests through
     `run_inference`, and again merged and int4 (K8, the v2 wrap after it,
     v1's prefix through the quantized QKV); mode full: 4 steps of
     `run_training` at 4 layers, the 8 x 1024 step at 22 layers with
     mu_dtype "" and "bfloat16" (step ms, tokens/s, MFU, peak memory,
     `utils.profiling.compiled_flops` against the analytic count and
     `live_device_memory`), one mode-full step of Mixtral-8x7B at depth 1
     (L2's drhs kernel launches);
 33. slice 24, scale-out, last: `scaleout_kernel_phase`, K1's forward and
     backward at a tensor-2 rank's 16 heads in 2 groups, K2 at a seq-2
     shard, K3 (and K3 transposed) at the tensor-2 heads and a seq shard's
     RoPE offset, K4 at intermediate 2816 and 7168, K5 at QKV out 1280, K8
     at the row-parallel in dims 1024 and 2816, L2 and its dlhs over 4
     local experts (fc_1 and proj), each against its plain version, timed
     beside its bound; `scaleout_slice`, two processes of this script on
     the one card (`--scaleout-child`, gloo on CUDA tensors; first a probe
     of the collectives it takes there) running full-width TinyLlama at 4
     of its 22 layers (SCALEOUT_LAYERS) through `run_training` under data
     2, fsdp 2, tensor 2 (K5) and a
     2-stage pipeline, 2 Trainer steps at seq 2 (T 1024), the 16 requests
     served over data 2, over tensor 2 and over tensor 2 merged and int4
     (K8), and one LoRA step of Mixtral at depth 1 over expert 2 (L2),
     while this process runs each as one rank alone: each run's probe
     logits within 4x the measured bf16 reordering noise of one rank's,
     the losses within 1e-3 of one rank's, the tokens reported against one
     rank's, the kernels launched in both ranks (their own counts);
     per-rank times are two ranks sharing one card, not scaling;
 34. the seconds of each phase, the `{"kernels": [...]}` line (all fifteen
     kernels, launches by path, K4's, K5's and K8's verify rows, K1's and
     L1's rows at each head size, each kernel's scale-out launches by run
     and rank and its local shapes), the card's name and power limit, and
     the last line `{"ok": true, "device": {...}}`.

Exits non-zero without printing a result when no CUDA card is present or
when the port's package is not beside the script.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
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
    # swiglu: sums of 2048 and 5632 fp32 products in another order; h may
    # round apart by one bf16 ulp.
    "swiglu_mlp": (1e-2, 2.0 ** -6),
    # q4_matmul: the same exact bf16 x nibble products as the plain version,
    # summed in fp32 in another order (split K: partials added apart), each
    # group scaled after its sum, rounded once to bf16 on both sides: one or
    # two bf16 ulps apart. A wrong nibble, group or scale moves an output by
    # a whole term (~|x| |w|, 0.02 and more).
    "q4_matmul": (1e-2, 2.0 ** -6),
    # lora_linear: the base and rank sums in another fp32 order (above 16
    # rows s is folded into the base sum, (acc / s + delta) * s, exact for
    # s = 1); the rank tile rounds to bf16 on both sides and may do so one
    # ulp apart (2^-8 of s * delta); the output rounds once. A lost or
    # transposed LoRA branch moves outputs by s * delta (~0.1 here).
    "lora_linear": (1e-2, 2.0 ** -6),
    # grouped_matmul (L2): the same exact bf16 products as the plain version,
    # summed in fp32 in another order and rounded once: one or two bf16 ulps
    # (as q4_matmul). A wrong group or row moves an output by a whole product
    # (~0.1 here).
    "grouped_matmul": (1e-2, 2.0 ** -6),
    # L2's gradients: dlhs as the forward (the same exact bf16 products, fp32
    # sums in another order, one rounding); drhs sums up to 16384 such
    # products a weight element in fp32 (order moves it by ~1e-6 of its
    # size) and rounds once: one or two bf16 ulps too. A wrong group, row or
    # transpose moves an element by a whole product sum.
    "grouped_matmul_dlhs": (1e-2, 2.0 ** -6),
    "grouped_matmul_drhs": (1e-2, 2.0 ** -6),
    # splash_attention_fwd (L1): the kernel's P V is the sum of two bf16
    # products of P's hi and lo halves (P to 2^-16 of itself), the plain
    # version's an fp32 product; both round O once: one bf16 ulp apart at
    # most (rtol 2^-7), and near-zero outputs of cancelling terms differ by
    # the fp32 sums' order (atol). A dropped key or head moves O by ~0.1.
    "splash_attention_fwd": (1e-3, 2.0 ** -7),
}
# flash forward's row logsumexp (fp32 on both sides, from the same exact
# bf16 products summed in another order): |kernel - plain| <= 1e-4 +
# 1e-5 * |plain|. A mask fault that adds or drops one key of row t moves
# that row's L by log(1 +- e^s / Z), ~1e-3 and more for the rows of a tail
# tile (t < 1024, Z ~ t * e^(1/2) for unit-variance logits).
LSE_TOL = (1e-4, 1e-5)
# flash backward: |kernel - plain| <= F + A * rms(plain) + R * |plain|. The
# kernel rounds P and dS to bf16 (2^-9 relative each) before products that
# sum up to q_per_kv * T terms, dQ's in no fixed order (atomics), so its
# error scales with the gradient's overall size, not with each element's
# (A, 2^-4 of the RMS); the outputs round to bf16 on both sides (R, two
# ulps); where the exact gradient is zero (dQ, dK at T=1) both sides hold
# fp32 noise (F, 2^-10). A fault (a wrong mask, a lost head) moves elements
# by about the RMS itself.
FLASH_BWD_TOL = (2.0 ** -10, 2.0 ** -4, 2.0 ** -6)
# L1's dQ and dK/dV (splash) are held to the same: they round P and dS to
# bf16 on both sides before sums of up to q_per_kv * T terms, and an fp32
# S or dP summed in another order may round them one ulp apart.
# the forward-plus-backward pair against the plain pair: Delta = rowsum(dO *
# O) also carries O's forward error (the kernel rounds unnormalised P to
# bf16), and in the first rows, where attention falls on a few keys and O is
# as large as V, that moves single elements of dQ by more than
# FLASH_BWD_TOL's share of the RMS, which the many late rows with small
# gradients set. So the pair is held to a relative L2 error of 2^-6 per
# gradient (~0.003 measured); a fault in one 64-row tile of T=1024 (1/16 of
# the rows) gives ~0.25. Each kernel alone is held elementwise (LSE_TOL, the
# forward's tolerance, FLASH_BWD_TOL).
FLASH_PAIR_REL_L2 = 2.0 ** -6
# depth-2 training step, card bf16 vs CPU fp32: the loss (~ln 32000 = 10.4)
# moves by the logits' bf16 error (~0.03 at most, averaged over tokens), so
# |loss difference| <= 0.05; each LoRA gradient passes ~20 bf16 roundings
# (2^-9 relative each, adding in quadrature to ~1%) on its way, so its
# relative L2 error ||card - cpu|| / ||cpu|| <= 0.05. A wiring fault (a lost
# gradient path, a transposed factor) gives a relative error of ~1.
TRAIN_LOSS_ATOL = 0.05
TRAIN_GRAD_REL = 0.05
# the depth-2 Mixtral training step, card bf16 vs CPU fp32: a near tie of two
# router logits may send a token to another expert under bf16 (ROUTE_AGREEMENT;
# 1-2.5% of the routes measured); at random init the MoE output
# dominates the residual stream (embeddings ~0.01, expert outputs ~0.2), so
# one token routed elsewhere moves the LoRA gradients by 10-20% (measured:
# 0.11-0.18 relative L2 with 1 route of 256 apart, under megablox and dense
# alike). So the step is taken on the rows routed alike at every token and
# layer (the other rows' labels masked on both sides), whose LoRA gradients
# are held to TRAIN_GRAD_REL as TinyLlama's (measured 0.012-0.019). Short
# rows keep most of them whole (10 of 16 rows of 16 tokens measured); at
# least a quarter of the rows must be held.
# depth-2 logits, card bf16 vs CPU fp32. The logits' spread is ~0.6 here: a
# wiring fault (a transposed head, a wrong cache slot, a lost LoRA branch)
# moves them by about that much, while bf16 weights and activations through
# two blocks move them by a few bf16 ulps of the largest logits (~0.03).
DEPTH2_ATOL = 0.1
# K6/K7 (flash_fwd) against their plain versions on unit-normal inputs: fp32
# sums in another order (~1e-6 measured on the card's edge-case tests).
# bf16: both keep P in fp32 for the P V product (the kernel as hi + lo, two
# bf16 products, V exact in bf16) and round the output once, so an element
# differs only where the two fp32 sums round apart, by one bf16 ulp: 2^-7
# at most and on 0.2-0.3% of the elements measured (outputs below 2). A
# kernel that rounds P to bf16 (K1's forward) reads 2^-6 at K7's shapes and
# differs on 36-39% of the elements (PERF.md). The bound sits
# between the two quanta.
FLASH_FWD_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
FLASH_FWD_DIFFER_SHARE = 0.05  # bf16: the share of elements that may differ
# K6/K7 at fp32: bf16 tensor-core products a product (three pieces of each
# operand, the pairs (i, j) with i + j <= 2)
SPLIT_PRODUCTS = 6
# depth-2 Whisper encoder, card (K6, fp32 products with TF32 off) against the
# CPU (plain, fp32): the same fp32 arithmetic summed in another order, held
# to 1e-4 of the largest feature (~5 after the final LayerNorm). One pass of
# TF32 (~1e-3) or a wrong mask of the ragged key tile fails it.
ENCODER_REL_TOL = 1e-4
# the depth-2 RelPrompt step's classifiers (both NoiseClassifiers, fp32 with
# TF32 off on the card, independent of the bf16 LLM): their gradients
# (relative L2) and the mask loss (relative) are the same fp32 arithmetic
# summed in another order (~1e-6 measured). TF32 (~1e-3) or bf16 (~1e-2)
# classifiers fail it.
CLASSIFIER_REL_TOL = 1e-4
# more than the H100's 50 MB L2 cache: read before each cold-cache call (device_ms)
L2_FLUSH_BYTES = 256 << 20
# depth of the decode slice (full width); the training slice keeps all 22
DECODE_LAYERS = 22
# TinyLlama-1.1B's linears that K8 and K5 see: (name, out, in); K8 is also
# timed at 3072 prefill rows of Q4_PREFILL
Q4_SHAPES = (("qkv", 2560, 2048), ("attn_proj", 2048, 2048), ("fc_1", 5632, 2048),
             ("mlp_proj", 2048, 5632), ("lm_head", 32000, 2048))
Q4_PREFILL = ("fc_1", "mlp_proj", "lm_head")
LORA_SHAPES = (("qkv", 2560, 2048, 3), ("proj", 2048, 2048, 1))  # (name, O, D, blocks of r)
LORA_RANK = 16


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


def warm_up(torch, seconds: float = 2.0) -> dict:
    """Keeps the card busy with bf16 products for `seconds`, then makes one
    `device_ms` measurement, before a phase times kernels of a few
    microseconds: the first ones otherwise run while the clocks climb out
    of idle (the build leaves the card idle), and a process's first
    `device_ms` call reads slow (PERF.md). Returns the SM clock and power draw
    before and after, from nvidia-smi."""
    def sample():
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None

    before = sample()
    a = torch.ones(4096, 4096, dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
    device_ms(lambda: a.add_(0), torch)
    return {"sm_clock_power_before": before, "after": sample()}


def l2_flush(torch):
    """A read of L2_FLUSH_BYTES: after it the L2 cache holds none of a
    kernel's inputs."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    return buf.sum


def device_ms(fn, torch, iters: int = 20) -> float:
    """Device time of one call of `fn` with the L2 cache cold: before each
    call an `l2_flush` evicts the L2, so the call reads its inputs from HBM
    as `bound_ms` assumes. CUDA events bracket the call alone on the stream;
    the host enqueues it while the flush runs, so no launch gap counts."""
    flush = l2_flush(torch)
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


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


def compare_scaled(name, got, want, torch) -> dict:
    """The K1 backward's check (FLASH_BWD_TOL); returns the max abs error,
    the relative L2 error and the worst ratio of error to tolerance."""
    f, a, r = FLASH_BWD_TOL
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = f + a * float(want.pow(2).mean().sqrt()) + r * want.abs()
    worst = float((diff / tol).max())
    out = {"max_abs_err": float(diff.max()),
           "rel_l2_err": float((got - want).norm() / want.norm()),
           "worst_err_over_tol": worst}
    if not worst <= 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version: {out}")
    return out


def kernel_phases(torch, seed: int) -> dict:
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention, int4, lora, quant, rmsnorm, rope, swiglu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    b, t, d, inter, nh, g, hs = 8, 384, 2048, 5632, 32, 4, 64
    rows = b * t

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results = {}
    emit({"phase": "warm_up", **warm_up(torch)})

    # ---- K2 rms_norm: prefill rows (B*T) and decode rows (B) ----
    scale = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    entry = {}
    for label, n in (("prefill", rows), ("decode", b)):
        x = randn(n, d)
        err = compare("rms_norm",
                      repeatable("rms_norm", lambda: rmsnorm.rms_norm(x, scale), torch),
                      rmsnorm.rms_norm_plain(x, scale), torch)
        scale_bf16 = scale.to(bf16)
        lib = (time_ms(lambda: F.rms_norm(x, (d,), scale_bf16, 1e-5), torch)
               if hasattr(F, "rms_norm") else None)
        bms, by = bound(2 * n * d * 2 + d * 4, 4 * n * d, FP32_FLOPS)
        entry[label] = dict(
            shape=[n, d], max_abs_err=err,
            ms=time_ms(lambda: rmsnorm.rms_norm(x, scale), torch),
            device_ms=device_ms(lambda: rmsnorm.rms_norm(x, scale), torch),
            plain_ms=time_ms(lambda: rmsnorm.rms_norm_plain(x, scale), torch),
            library_ms=lib, bound_ms=bms, bound_by=by,
            # the yardstick as K2's device_ms is taken: one call, L2 cold
            library_device_ms=(device_ms(lambda: F.rms_norm(x, (d,), scale_bf16, 1e-5), torch)
                               if hasattr(F, "rms_norm") else None))
    results["rms_norm"] = entry

    # ---- K3 apply_rope: q and k heads read in place from a fused QKV ----
    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.models.gpt import split_heads

    cfg = GPTConfig(n_embd=d, n_head=nh, n_query_groups=g, rotary_percentage=1.0,
                    intermediate_size=inter, mlp_class="LLaMAMLP")
    qkv = randn(b, t, cfg.qkv_out_dim)
    q5, k4, _ = split_heads(cfg, qkv)
    cos, sin = rope.build_rope_cache(t, hs, dtype=bf16, device=dev)
    err = max(compare("apply_rope",
                      repeatable("apply_rope", lambda: rope.apply_rope(x, cos, sin), torch),
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
        err = compare("swiglu_mlp", repeatable("swiglu_mlp", lambda: swiglu.swiglu_mlp(x, w1, w2, w3), torch),
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

    # host microseconds a call at tiny shapes, where the card waits on the
    # host: K1's forward and K4 encode their TMA tensor maps (4 and 5-7) on
    # every call, K2 encodes none (the yardstick of one ctypes launch)
    # K8 and K5 at decode rows, where a slice calls them thousands of times
    xs, ws = randn(8, 128), randn(256, 128, std=0.05)
    w3s = randn(128, 256, std=0.05)
    qt, kt = randn(1, 8, 16, hs), randn(1, 2, 16, hs)
    packed, q4_scales = quant.quantize_weight_int4(randn(256, 128, dtype=torch.float32))
    a_s, b_s = randn(16, 128, std=0.05), randn(256, 16, std=0.05)
    emit({"phase": "host_cost", "shapes": {"rms_norm": [8, 128], "swiglu_mlp": [8, 128, 256],
                                           "flash_attention_fwd": [1, 8, 2, 16, hs],
                                           "q4_matmul": [8, 256, 128],
                                           "lora_linear": [8, 256, 128, 16]},
          "host_us": {
              "rms_norm": host_us(lambda: rmsnorm.rms_norm(xs, scale[:128]), torch),
              "swiglu_mlp": host_us(lambda: swiglu.swiglu_mlp(xs, ws, ws, w3s), torch),
              "flash_attention_fwd": host_us(lambda: attention._flash_fwd(qt, kt, kt, 0.125),
                                             torch),
              "q4_matmul": host_us(lambda: int4.q4_matmul(xs, packed, q4_scales), torch),
              "lora_linear": host_us(lambda: lora.lora_linear(xs, ws, a_s, b_s, 1.0), torch)}})
    return results


def repeatable(name, fn, torch):
    """`fn()` twice; raises unless the two outputs (a tensor or a tuple of
    them) are bitwise equal (K4, K6, K8, L2's forward and both gradients and
    L1's dQ and dK/dV sum in a fixed order: no atomics). Returns the output."""
    first, second = fn(), fn()
    pairs = zip(first, second) if isinstance(first, tuple) else ((first, second),)
    for x, y in pairs:
        if not torch.equal(x, y):
            raise RuntimeError(f"{name}: two calls on the same {tuple(x.shape)} output differ")
    return first


def host_us(fn, torch, n: int = 200) -> float:
    """Host microseconds a call of `fn`, enqueued back to back after a
    synchronise (at shapes whose device time is shorter than the host's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def decode_plan(module, *args):
    """`module.decode_plan(*args)` (K8's and K5's decode kernels), None in a
    checkout that has none (a parent measured in turns)."""
    plan = getattr(module, "decode_plan", None)
    return plan(*args) if plan else None


def q4_row(torch, x, packed, scales, w_deq, **extra) -> dict:
    """K8 on x (rows, K) against its plain version (TOLERANCES), two calls
    bitwise equal, timed beside its bound, the plain version and cuBLAS on
    the dequantised weight `w_deq` (back to back and, as device_ms, one cold
    call); `extra` goes into the row after its shape."""
    from dualhyp_tpu_torch.ops import int4

    (rows, k), n = x.shape, packed.shape[0]
    fn = lambda: int4.q4_matmul(x, packed, scales)  # noqa: E731
    plain = lambda: int4.q4_matmul_plain(x, packed, scales)  # noqa: E731
    library = lambda: x @ w_deq.t()  # noqa: E731
    err = compare("q4_matmul", repeatable("q4_matmul", fn, torch), plain(), torch)
    bms, by = bound(rows * k * 2 + n * k // 2 + n * (k // 128) * 4 + rows * n * 2,
                    2 * rows * n * k, BF16_TENSOR_FLOPS)
    return dict(shape=[rows, n, k], **extra, max_abs_err=err, repeats_bitwise=True,
                ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
                plain_ms=time_ms(plain, torch, warmup=1, iters=3),
                library_ms=time_ms(library, torch), library_device_ms=device_ms(library, torch),
                library="cuBLAS bf16 matmul on the dequantised weight",
                bound_ms=bms, bound_by=by)


def q4_mid_row(torch, x, packed, scales, w_deq, **extra) -> dict:
    """`q4_row` with the path K8's dispatch takes at x's rows and, where
    that is the middle kernel, its plan and the parent's tile (the wgmma/TMA
    kernel, with `sum_splits` where it splits K) timed on the same inputs as
    `was_device_ms`: the dispatch with MID_ROWS at DECODE_ROWS, as before
    the middle kernel."""
    from dualhyp_tpu_torch.ops import int4

    (rows, k), n = x.shape, packed.shape[0]
    path_of = getattr(int4, "path_of", None)  # None in a parent measured in turns
    path = (path_of(rows, n, k) if path_of else
            "decode" if rows <= int4.DECODE_ROWS else "wgmma")
    row = q4_row(torch, x, packed, scales, w_deq, path=path, **extra)
    if path == "mid":
        plan = int4.mid_plan(rows, n, k)
        row["plan"] = {key: plan[key] for key in ("tiles", "tokens", "cluster", "ctas", "smem")}
        saved = int4.MID_ROWS
        int4.MID_ROWS = int4.DECODE_ROWS
        try:
            row["was_device_ms"] = device_ms(lambda: int4.q4_matmul(x, packed, scales), torch)
        finally:
            int4.MID_ROWS = saved
        row["was"] = "the parent's wgmma/TMA tile on the same inputs"
    return row


def parent_path_ms(torch, module, fn) -> float:
    """Device ms of `fn` with `module`'s dispatch as before its middle path
    (MID_ROWS at DECODE_ROWS: K5's rank + TMA kernels, K4's row tiles): the
    parent's design on the same inputs."""
    saved = module.MID_ROWS
    module.MID_ROWS = module.DECODE_ROWS
    try:
        return device_ms(fn, torch)
    finally:
        module.MID_ROWS = saved


def lora_row(torch, x, w, a, b, s, xin=None, **extra) -> dict:
    """K5 on x (rows, D) (and a separate xin) against its plain version, as
    `q4_row` holds K8, beside cuBLAS's x W^T + s (xin A^T) B^T; on its
    middle path (`lora.path_of`) with its plan and the parent's design on
    the same inputs (`was_device_ms`)."""
    from dualhyp_tpu_torch.ops import lora

    (rows, d), o, r = x.shape, w.shape[0], a.shape[0]
    xb = x if xin is None else xin
    fn = lambda: lora.lora_linear(x, w, a, b, s, xin=xin)  # noqa: E731
    plain = lambda: lora.lora_linear_plain(x, w, a, b, s, xin)  # noqa: E731
    library = lambda: x @ w.t() + s * ((xb @ a.t()) @ b.t())  # noqa: E731
    err = compare("lora_linear", repeatable("lora_linear", fn, torch), plain(), torch)
    n_x = rows * d * (1 if xin is None else 2)
    # B is stored block-diagonal (O, r) over the q/k/v blocks; each output
    # takes LORA_RANK of its columns
    bms, by = bound((n_x + o * d + r * d + o * r + rows * o) * 2,
                    2 * rows * o * d + 2 * rows * r * d + 2 * rows * o * LORA_RANK,
                    BF16_TENSOR_FLOPS)
    path_of = getattr(lora, "path_of", None)  # None in a parent measured in turns
    path = (path_of(rows) if path_of else "decode" if rows <= lora.DECODE_ROWS else "wgmma")
    row = dict(shape=[rows, o, d, r], separate_xin=xin is not None, max_abs_err=err,
               path=path, **extra,
               repeats_bitwise=True, ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
               plain_ms=time_ms(plain, torch, warmup=1, iters=3),
               library_ms=time_ms(library, torch), library_device_ms=device_ms(library, torch),
               library="cuBLAS x W^T + s (xin A^T) B^T, three products and an add",
               bound_ms=bms, bound_by=by)
    row["share_of_bound"] = bms / row["device_ms"]
    if path == "mid":
        plan = lora.mid_plan(rows, o, d, r, s, xin is not None)
        row["plan"] = {k: plan[k] for k in ("tokens", "wg", "cluster", "ctas", "smem", "stages")}
        row["was_device_ms"] = parent_path_ms(torch, lora, fn)
        row["was"] = "the parent's rank + TMA kernels on the same inputs"
    return row


def q4_lora_phase(torch, seed: int) -> dict:
    """K8 and K5 at the shapes of TinyLlama-1.1B's linears, each against its
    plain version, timed beside its bound and its cuBLAS yardstick (back to
    back and, as the kernel's device_ms, one cold call)."""
    from dualhyp_tpu_torch.ops import int4, lora, quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    q4 = {}
    for name, n, k in Q4_SHAPES:
        packed, scales = quant.quantize_weight_int4(randn(n, k, std=0.02, dtype=torch.float32))
        w_deq = quant.dequantize_weight_int4(packed, scales, bf16)  # the yardstick's weight
        rows_of = [("decode", 8), ("decode_1", 1), ("decode_16", 16)]
        if name in Q4_PREFILL:
            rows_of.append(("prefill", 3072))
        for label, rows in rows_of:
            launch = (decode_plan(int4, rows, n, k) if rows <= int4.DECODE_ROWS else
                      dict(tile=list(int4.tile(rows)[:2]),
                           split_k=list(int4.split_k(rows, n, k // 128))))
            q4[f"{label}_{name}"] = q4_row(torch, randn(rows, k), packed, scales, w_deq,
                                           launch=launch)
        del w_deq
    emit({"phase": "kernel", "name": "q4_matmul",
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["q4_matmul"])), **q4})

    lo = {}
    r = LORA_RANK
    for name, o, d, blocks in LORA_SHAPES:
        w = randn(o, d, std=0.02)
        a = randn(blocks * r, d, std=1 / math.sqrt(d))
        b_small = randn(o, r, std=0.02)
        shapes = (d, (o - d) // 2, (o - d) // 2) if blocks == 3 else (o,)
        b = lora.lora_qkv_block_b(b_small, shapes, r)
        s = 1.0  # lora_alpha / lora_r of the slice
        for rows in (1, 8, 16, 1536, 3072, 8192):
            for separate in (False, True):
                x = randn(rows, d)
                xin = randn(rows, d) if separate else None
                lo[f"{name}_{rows}{'_xin' if separate else ''}"] = lora_row(
                    torch, x, w, a, b, s, xin,
                    launch=decode_plan(lora, rows, o, d, blocks * r, s, separate)
                    if rows <= lora.DECODE_ROWS else None)
    emit({"phase": "kernel", "name": "lora_linear",
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["lora_linear"])), **lo})
    torch.cuda.empty_cache()
    return {"q4_matmul": q4, "lora_linear": lo}


def lora_config(n_layer: int, lora_dropout: float = 0.0):
    from dualhyp_tpu_torch import config_from_name

    return config_from_name(
        "tiny-llama-1.1b-chat", n_layer=n_layer, lora_r=16, lora_alpha=16,
        lora_dropout=lora_dropout, lora_query=True, lora_key=True, lora_value=True,
        lora_projection=True)


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


def depth2_int4_check(torch, seed: int) -> dict:
    """Depth-2 int4 prefill logits, card (K8, bf16) against CPU (plain, fp32):
    the seeded numpy weights merged with their LoRA deltas and quantized by
    the port once, so both sides hold the same packed bytes and scales."""
    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import params_from_jax, tree_from_model
    from dualhyp_tpu_torch.models.gpt import merge_lora
    from dualhyp_tpu_torch.ops import quant

    cfg = lora_config(2)
    merged = merge_lora(params_from_jax(numpy_tree(cfg, seed), cfg, device="cpu",
                                        dtype=torch.float32))
    qtree = quant.quantize_tree(tree_from_model(merged), "int4")
    del merged
    card = params_from_jax(qtree, cfg, device="cuda", dtype=torch.bfloat16)
    cpu = params_from_jax(qtree, cfg, device="cpu", dtype=torch.float32)
    del qtree
    rng = np.random.default_rng(seed + 3)
    t = 96
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, t)))
    lengths = torch.tensor([96, 80, 50, 33])
    for i, n in enumerate(lengths.tolist()):
        ids[i, n:] = 0
    reset_counts()
    got = card.prefill(ids.cuda(), lengths.cuda(), card.init_cache(4, t)).cpu()
    launches = read_counts()
    want = cpu.prefill(ids, lengths, cpu.init_cache(4, t))
    err = float((got - want).abs().max())
    result = {"phase": "depth2_int4_card_vs_cpu", "shape": [4, t], "max_abs_err": err,
              "tolerance": DEPTH2_ATOL, "logit_std": float(want.std()),
              "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
              "launches": launches}
    emit(result)
    if not err <= DEPTH2_ATOL:
        raise RuntimeError(f"depth-2 int4 logits: card vs CPU max_abs_err {err} > {DEPTH2_ATOL}")
    if launches["q4_matmul"] <= 0 or launches["swiglu_mlp"] != 0:
        raise RuntimeError(f"depth-2 int4 prefill launches {launches}")
    del card, cpu
    torch.cuda.empty_cache()
    return result


# substrings of the kernel names of K1's forward, K1's backward, K4, K5 and
# L1's forward and backward in a profile (their device ms a step)
STEP_KERNELS = {"k1_fwd": ("flash_fwd_kernel",), "k1_bwd": ("flash_bwd_kernel", "delta_kernel"),
                "k4": ("swiglu_",), "k5": ("lora_",), "l1_fwd": ("splash_fwd",),
                "l1_bwd": ("splash_dq", "splash_dkv", "splash_rows")}


def step_kernel_ms(prof) -> dict:
    """Device ms of K1's forward and backward, K4, K5 and L1's forward and
    backward in a profiled step."""
    times = device_kernel_times(prof)
    return {f"{key}_ms": sum(us for name, (us, _) in times.items()
                             if any(p in name for p in parts)) / 1e3
            for key, parts in STEP_KERNELS.items()}


def profile_summary(prof, wall_ms: float, top_n: int = 12) -> dict:
    """Device busy time, idle share of the wall, and the top kernels by
    device time of a torch.profiler run."""
    times = device_kernel_times(prof)
    busy_ms = sum(us for us, _ in times.values()) / 1e3
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernels": [{"name": name[:100], "ms": us / 1e3, "count": n}
                        for name, (us, n) in top]}


class WordTokenizer:
    """Whitespace word-level tokenizer over a fixed vocabulary (the card's
    machine has no `tokenizers`). `add_special_tokens` adds tokens that are
    split out of a run of text wherever they occur, as an HF tokenizer's
    added special tokens are, with ids from `special_base` on: the RelPrompt
    mask tokens then take the embedding rows above the model's vocabulary."""

    eos_token = "</s>"

    def __init__(self, words, special_base: int = 32000):
        self.vocab = {"<unk>": 0, "</s>": 1, "<s>": 2}
        for w in words:
            self.vocab.setdefault(w, len(self.vocab))
        self.words = {i: w for w, i in self.vocab.items()}
        self.eos_token_id = 1
        self.special_base = special_base
        self.special = {}

    def __len__(self):
        return len(self.vocab)

    def add_special_tokens(self, tokens):
        if isinstance(tokens, dict):
            tokens = tokens["additional_special_tokens"]
        for t in tokens:
            i = self.special.setdefault(t, self.special_base + len(self.special))
            self.words[i] = t

    def _word(self, w):
        if not self.special:
            return [self.vocab.get(w, 0)]
        import re

        pattern = "(" + "|".join(re.escape(t) for t in self.special) + ")"
        return [self.special[p] if p in self.special else self.vocab.get(p, 0)
                for p in re.split(pattern, w) if p]

    def encode(self, text):
        return [i for w in text.split() for i in self._word(w)]

    def decode(self, ids):
        return " ".join(self.words.get(int(i), f"<{int(i)}>") for i in ids)


# substrings of the kernel names of K8's, K5's and L2's paths in a slice's
# profile (device ms and launches of each): the decode kernels, the prefill
# kernels, and K8's wgmma kernel's pass over split parts
SLICE_KERNELS = {"k8_decode": ("q4_decode_kernel",), "k8_mid": ("q4_mid_kernel",),
                 "k8_prefill": ("q4_tma_kernel",),
                 "k8_split_pass": ("::sum_splits(",), "k5_decode": ("lora_decode_kernel",),
                 "k5_mid": ("LoraMid",), "k4_mid": ("GateMid", "DownMid"),
                 "k5_prefill": ("lora_rank_kernel", "lora_tma_kernel"),
                 "l2_decode": ("gmm_decode_kernel",), "l2_prefill": ("gmm_tma_kernel",)}
DECODE_PATH = ("rms_norm", "apply_rope", "flash_attention_fwd", "swiglu_mlp")
TRAIN_PATH = ("rms_norm", "apply_rope", "flash_attention_fwd", "flash_attention_bwd",
              "swiglu_mlp", "apply_rope_transpose")
# the decode slice's variants: how the model is built and served, which
# kernels must launch on it and which must not; the bf16 slice alone
# profiles a batch (each profile took ~45 s of the script's time)
SLICES = {
    "bf16": dict(lora_impl="xla", quantize=None, kv_quant=None, profile=True,
                 launch=DECODE_PATH, idle=("lora_linear", "q4_matmul")),
    "int4": dict(lora_impl="fused", quantize="int4", kv_quant=None, profile=False,
                 launch=("rms_norm", "apply_rope", "flash_attention_fwd", "q4_matmul"),
                 idle=("swiglu_mlp", "lora_linear")),
    "int8_kv8": dict(lora_impl="xla", quantize="int8", kv_quant="int8", profile=False,
                     launch=("rms_norm", "apply_rope", "flash_attention_fwd"),
                     idle=("swiglu_mlp", "lora_linear", "q4_matmul")),
    "fused": dict(lora_impl="fused", quantize=None, kv_quant=None, profile=False,
                  launch=DECODE_PATH + ("lora_linear",), idle=("q4_matmul",)),
}


def reset_counts():
    from dualhyp_tpu_torch.ops import KERNELS, TRANSPOSED, attention, int4, lora, swiglu

    for kernel in (*KERNELS.values(), *TRANSPOSED.values()):
        kernel.launches = 0
    # (a parent checkout measured in turns may count none of these)
    for by in (getattr(int4, "PATH_LAUNCHES", {}), getattr(attention, "BWD_HEAD_LAUNCHES", {}),
               getattr(lora, "PATH_LAUNCHES", {}), getattr(swiglu, "PATH_LAUNCHES", {})):
        for key in by:
            by[key] = 0


def read_counts() -> dict:
    """Each kernel's launches, the RoPE kernel's transposed ones, K8's, K5's
    and K4's by path (`q4_matmul_mid`, `lora_linear_mid`, `swiglu_mlp_mid`:
    the middle kernels) and K1's backward by head size
    (`flash_attention_bwd_d80`)."""
    from dualhyp_tpu_torch.ops import KERNELS, TRANSPOSED, attention, int4, lora, swiglu

    counts = {name: kernel.launches for name, kernel in KERNELS.items()}
    counts.update({f"{name}_transpose": kernel.launches
                   for name, kernel in TRANSPOSED.items()})
    for name, module in (("q4_matmul", int4), ("lora_linear", lora), ("swiglu_mlp", swiglu)):
        counts.update({f"{name}_{path}": n
                       for path, n in getattr(module, "PATH_LAUNCHES", {}).items()})
    counts.update({f"flash_attention_bwd_d{d}": n
                   for d, n in getattr(attention, "BWD_HEAD_LAUNCHES", {}).items()})
    return counts


def token_agreement(records, reference) -> dict:
    """Greedy-output agreement with a reference run of the same requests:
    the share of answer words (one word one token here) equal position by
    position, and the share of identical answers."""
    ref = {r["uid"]: r["inference"].split() for r in reference}
    same = total = exact = 0
    for r in records:
        got, want = r["inference"].split(), ref[r["uid"]]
        same += sum(a == b for a, b in zip(got, want))
        total += max(len(got), len(want), 1)
        exact += got == want
    return {"token_agreement": same / total, "exact_answers": exact / len(records)}


def serve_requests(torch, model, seed: int, serve: dict, profile_label=None,
                   profile_new_tokens=None) -> tuple:
    """The decode slice's traffic: 16 synthetic DualHyp requests through
    `cli.inference_ger.run_inference` with the launch counts reset before
    and read after; with `profile_label`, one decode batch of that traffic
    again under torch.profiler (the longer of its two batches: profiling
    all 16 requests took 103-119 s a slice, most of it in the trace's
    post-processing), with `profile_new_tokens` in place of the traffic's
    max_new_tokens where given. Returns (records, metrics, wall_s, launches, [shortest,
    longest prompt], the rows of each prefill: `run_inference`'s batches of
    the sorted prompts, each padded to its longest prompt's bucket)."""
    from dualhyp_tpu_torch.cli.inference_ger import run_inference
    from dualhyp_tpu_torch.data import hypotheses, prompts, synthetic
    from dualhyp_tpu_torch.data.collate import bucket_length

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
        prompt_lengths = sorted(len(twin[i].input_ids_no_response) for i in range(len(twin)))
        batch = serve["decode_batch"]
        prefill_rows = [batch * min(bucket_length(max(prompt_lengths[i:i + batch])),
                                    model.cfg.block_size - serve["max_new_tokens"])
                        for i in range(0, len(prompt_lengths), batch)]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out_records, metrics = run_inference(model, tok, dataset(), collect_latency=True,
                                             **serve)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()

        if profile_label:
            # one batch of the traffic again under torch.profiler: where the
            # device time goes, and how much of the wall the device is idle
            from torch.profiler import ProfilerActivity, profile

            fresh = dataset()  # the served draws
            examples = [fresh[i] for i in range(len(fresh))]
            one_batch = sorted(examples, key=lambda e: len(e.input_ids_no_response))[-batch:]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                run_inference(model, tok, one_batch,
                              **{**serve, "max_new_tokens": profile_new_tokens or
                                 serve["max_new_tokens"]})
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t1) * 1e3
            summary = profile_summary(prof, prof_wall_ms)
            times = device_kernel_times(prof)
            paths = {key: {"ms": sum(us for name, (us, _) in times.items()
                                     if any(p in name for p in parts)) / 1e3,
                           "launches": sum(n for name, (_, n) in times.items()
                                           if any(p in name for p in parts))}
                     for key, parts in SLICE_KERNELS.items()}
            emit({"phase": "slice_profile", "variant": profile_label,
                  "profiled_requests": len(one_batch), "profile_s": time.perf_counter() - t1,
                  "new_tokens": profile_new_tokens or serve["max_new_tokens"],
                  "paths": paths, **summary})
    return (out_records, metrics, wall, launches, [prompt_lengths[0], prompt_lengths[-1]],
            prefill_rows)


def random_lora_b(torch, model, gen) -> None:
    """A finetuned adapter's lora_B is not zero: N(0, 0.02) on q/k/v/proj."""
    with torch.no_grad():
        for block in model.blocks:
            for mod in (block.attn.qkv, block.attn.proj):
                mod.lora_B.copy_(torch.randn(mod.lora_B.shape, generator=gen,
                                             device="cuda") * 0.02)


def check_served(records, metrics, launches, launch, idle, label) -> None:
    """Every request answered, finite metrics, the path's kernels launched
    and the kernels off the path not."""
    if len(records) != 16 or not all(isinstance(r["inference"], str) for r in records):
        raise RuntimeError(f"the {label} slice did not answer every request")
    if not all(math.isfinite(metrics[k]) for k in ("WER", "post_ST_wer")):
        raise RuntimeError(f"non-finite metrics {metrics}")
    missing = [name for name in launch if launches[name] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {label} path: {missing}")
    stray = [name for name in idle if launches[name] != 0]
    if stray:
        raise RuntimeError(f"kernels launched off the {label} path: {stray}")


def slice_run(torch, seed: int, variant: str = "bf16", reference=None) -> dict:
    """The decode slice (SLICES[variant]): the model is built from --seed,
    LoRA merged and quantized where the variant says, and serves the 16
    requests once with the launch counts reset before and read after."""
    from dualhyp_tpu_torch.models.gpt import GPT, merge_lora, quantize_model

    spec = SLICES[variant]
    cfg = lora_config(DECODE_LAYERS)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl=spec["lora_impl"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.init_weights(gen)
    random_lora_b(torch, model, gen)
    if spec["quantize"]:  # the CLI's --quantize: merge, then quantize
        quantize_model(merge_lora(model), spec["quantize"])
    serve = dict(decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1,
                 kv_quant=spec["kv_quant"])
    out_records, metrics, wall, launches, prompt_tokens, prefill_rows = serve_requests(
        torch, model, seed, serve, variant if spec["profile"] else None)
    result = {"phase": "slice", "variant": variant, "model": cfg.name,
              "n_layer": cfg.n_layer, "lora_r": cfg.lora_r,
              "lora_impl": spec["lora_impl"], "quantize": spec["quantize"],
              "kv_quant": spec["kv_quant"], "requests": len(out_records),
              "prompt_tokens": prompt_tokens, "prefill_rows": prefill_rows,
              "decode_batch": 8, "max_new_tokens": 32, "wall_s": wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "weight_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
              "metrics": metrics, "launches": launches,
              "sample": out_records[0]}
    if reference is not None:
        result["vs_bf16_slice"] = token_agreement(out_records, reference["records"])
    emit(result)
    result["records"] = out_records
    del model
    torch.cuda.empty_cache()
    check_served(out_records, metrics, launches, spec["launch"], spec["idle"], variant)
    return result


def flash_bwd_phase(torch, seed: int, g: int = 4, hs: int = 64, nh: int = 32) -> dict:
    """K1's forward-plus-backward pair against the plain pair at the training
    shape (B=8, Hq=32, T=1024; TinyLlama's G=4, D=64 or Mixtral's G=8,
    D=128) and a ragged T=200: the kernel's (O, L) against
    `causal_attention_plain_lse`; the backward kernel, fed the kernel's O
    (the forward's (B, T, H, D) view) and L, against the plain backward fed
    the same, and against the plain backward fed the plain forward's; times
    at T=1024 beside SDPA's backward, and of the forward beside SDPA's
    forward (`forward_T1024`)."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    b = 8
    scale = 1.0 / math.sqrt(hs)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    entry = {}
    for t in (200, 1024):
        q, k, v = randn(b, nh, t, hs), randn(b, g, t, hs), randn(b, g, t, hs)
        o, lse = attention._flash_fwd(q, k, v, scale)
        o_plain, lse_plain = attention.causal_attention_plain_lse(q, k, v, scale)
        fwd = {"o_max_abs_err": compare("flash_attention_fwd", o, o_plain, torch),
               "lse_max_abs_err": float((lse - lse_plain).abs().max())}
        if not bool(((lse - lse_plain).abs()
                     <= LSE_TOL[0] + LSE_TOL[1] * lse_plain.abs()).all()):
            raise RuntimeError(f"flash_attention_fwd lse T={t}: kernel disagrees with "
                               f"its plain version: {fwd}, tolerance {LSE_TOL}")
        do = randn(b, nh, t, hs)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        # the backward alone (both fed the kernel's O and L), then the pair
        want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        checks = {name: compare_scaled(f"flash_attention_bwd d{name} T={t}", x, y, torch)
                  for name, x, y in zip("qkv", got, want)}
        want = attention.flash_attention_bwd_plain(q, k, v, o_plain, lse_plain, do, scale)
        pair = {f"d{name}_rel_l2_err": float((x.float() - y.float()).norm() / y.float().norm())
                for name, x, y in zip("qkv", got, want)}
        if not all(e <= FLASH_PAIR_REL_L2 for e in pair.values()):
            raise RuntimeError(f"flash_attention fwd+bwd T={t}: the kernels' pair disagrees "
                               f"with the plain pair: {pair}, tolerance {FLASH_PAIR_REL_L2}")
        del got, want
        entry[f"T{t}"] = {"forward": fwd, **checks, "pair": pair}
    # the T=1024 case's tensors stay for the times
    t = 1024
    pairs = b * nh * t * (t + 1) // 2
    n_q, n_kv = b * nh * t * hs, b * g * t * hs
    fwd = lambda: attention._flash_fwd(q, k, v, scale)  # noqa: E731
    bms, by = bound((2 * n_q + 2 * n_kv) * 2 + b * nh * t * 4, 4 * pairs * hs, BF16_TENSOR_FLOPS)
    forward_t1024 = dict(
        shape=[b, nh, g, t, hs], max_abs_err=entry["T1024"]["forward"]["o_max_abs_err"],
        lse_max_abs_err=entry["T1024"]["forward"]["lse_max_abs_err"],
        ms=time_ms(fwd, torch), device_ms=device_ms(fwd, torch),
        plain_ms=time_ms(lambda: attention.causal_attention_plain(q, k, v, scale), torch,
                         warmup=1, iters=5),
        library_ms=time_ms(lambda: sdpa_gqa(F, q, k, v, scale), torch),
        library="SDPA (causal, enable_gqa)", bound_ms=bms, bound_by=by)
    bwd = lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
    qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, enable_gqa=True)
    lib = lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)  # noqa: E731
    bms, by = bound((3 * n_q + 2 * n_kv) * 2 + (n_q + 2 * n_kv) * 2 + 2 * b * nh * t * 4,
                    10 * hs * pairs, BF16_TENSOR_FLOPS)
    entry.update(
        shape=[b, nh, g, t, hs], max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        ms=time_ms(bwd, torch), device_ms=device_ms(bwd, torch),
        plain_ms=time_ms(lambda: attention.flash_attention_bwd_plain(
            q, k, v, o_plain, lse_plain, do, scale), torch, warmup=1, iters=5),
        library_ms=time_ms(lib, torch), library="SDPA backward (autograd.grad)",
        bound_ms=bms, bound_by=by, forward_T1024=forward_t1024)
    del q, k, v, o, o_plain, lse, lse_plain, do, qr, kr, vr, out
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "flash_attention_bwd", "head_size": hs,
          "tolerance": dict(zip(("atol", "atol_of_rms", "rtol"), FLASH_BWD_TOL)),
          "pair_tolerance": {"rel_l2": FLASH_PAIR_REL_L2},
          "forward_tolerance": {"o": dict(zip(("atol", "rtol"),
                                              TOLERANCES["flash_attention_fwd"])),
                                "lse": dict(zip(("atol", "rtol"), LSE_TOL))},
          **entry})
    return entry


def training_shape_phase(torch, seed: int, cfg=None) -> dict:
    """K2, K3 (forward and transposed, on q and on k) and, for a dense MLP,
    K4 at the training shape of one micro batch, 8 x 1024 = 8192 rows of
    `cfg`'s width, checked (two calls bitwise equal) and timed. cfg:
    TinyLlama-1.1B's shapes by default (width 2048, 32 heads, 4 groups, head
    64); Mixtral-8x7B's give K2 at width 4096 and K3 at 8 groups, head 128,
    rope base 1e6 (its MoE bypasses K4)."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.models.gpt import split_heads
    from dualhyp_tpu_torch.ops import rmsnorm, rope, swiglu

    if cfg is None:
        cfg = GPTConfig(name="tiny-llama-1.1b-chat", n_embd=2048, n_head=32,
                        n_query_groups=4, rotary_percentage=1.0, intermediate_size=5632,
                        mlp_class="LLaMAMLP")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    bf16 = torch.bfloat16
    b, t = 8, 1024
    d, inter, nh, g, hs = (cfg.n_embd, cfg.intermediate_size, cfg.n_head,
                           cfg.n_query_groups, cfg.head_size)
    rows = b * t

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    out = {}
    x = randn(rows, d)
    scale = 1.0 + randn(d, std=0.1, dtype=torch.float32)
    err = compare("rms_norm", repeatable("rms_norm", lambda: rmsnorm.rms_norm(x, scale), torch),
                  rmsnorm.rms_norm_plain(x, scale), torch)
    bms, by = bound(2 * rows * d * 2 + d * 4, 4 * rows * d, FP32_FLOPS)
    scale_bf16 = scale.to(bf16)
    out["rms_norm"] = dict(
        shape=[rows, d], max_abs_err=err,
        ms=time_ms(lambda: rmsnorm.rms_norm(x, scale), torch),
        device_ms=device_ms(lambda: rmsnorm.rms_norm(x, scale), torch),
        plain_ms=time_ms(lambda: rmsnorm.rms_norm_plain(x, scale), torch),
        library_ms=time_ms(lambda: F.rms_norm(x, (d,), scale_bf16, 1e-5), torch),
        bound_ms=bms, bound_by=by,
        library_device_ms=device_ms(lambda: F.rms_norm(x, (d,), scale_bf16, 1e-5), torch))

    # K3 on q (B, G, q_per_kv, T, D) and k (B, G, T, D), read in place from
    # the fused QKV forward; transposed on their gradients, contiguous
    q5, k4, _ = split_heads(cfg, randn(b, t, cfg.qkv_out_dim))
    grads = {"": randn(b, g, nh // g, t, hs), "_k": randn(b, g, t, hs)}
    n_elem = cfg.rope_n_elem
    cos, sin = rope.build_rope_cache(t, n_elem, base=cfg.rope_base, dtype=bf16, device=dev)
    for suffix, view in (("", q5), ("_k", k4)):
        n = view.numel()
        bms, by = bound(2 * n * 2 + 2 * t * n_elem * 2, 4 * n, FP32_FLOPS)
        for label, xin, tr in (("forward", view, False), ("transpose", grads[suffix], True)):
            err = compare("apply_rope", repeatable(
                "apply_rope", lambda: rope.apply_rope(xin, cos, sin, tr), torch),
                rope.apply_rope_plain(xin, cos, sin, tr), torch)
            out[f"apply_rope{suffix}_{label}"] = dict(
                shape=list(xin.shape), max_abs_err=err,
                ms=time_ms(lambda: rope.apply_rope(xin, cos, sin, tr), torch),
                device_ms=device_ms(lambda: rope.apply_rope(xin, cos, sin, tr), torch),
                plain_ms=time_ms(lambda: rope.apply_rope_plain(xin, cos, sin, tr), torch),
                library_ms=None, bound_ms=bms, bound_by=by)
    dense = cfg.mlp_class == "LLaMAMLP"
    tolerance = {k: dict(zip(("atol", "rtol"), TOLERANCES[k]))
                 for k in ("rms_norm", "apply_rope") + ("swiglu_mlp",) * dense}
    if not dense:
        emit({"phase": "training_shape_kernels", "model": cfg.name, "rows": rows,
              "tolerance": tolerance, **out})
        return out

    w1, w2 = randn(inter, d, std=0.02), randn(inter, d, std=0.02)
    w3 = randn(d, inter, std=0.02)
    err = compare("swiglu_mlp", repeatable("swiglu_mlp", lambda: swiglu.swiglu_mlp(x, w1, w2, w3), torch),
                  swiglu.swiglu_mlp_plain(x, w1, w2, w3), torch)
    bms, by = bound((2 * rows * d + 3 * inter * d) * 2, 6 * rows * d * inter,
                    BF16_TENSOR_FLOPS)
    out["swiglu_mlp"] = dict(
        shape=[rows, d, inter], max_abs_err=err,
        ms=time_ms(lambda: swiglu.swiglu_mlp(x, w1, w2, w3), torch),
        device_ms=device_ms(lambda: swiglu.swiglu_mlp(x, w1, w2, w3), torch),
        plain_ms=time_ms(lambda: swiglu.swiglu_mlp_plain(x, w1, w2, w3), torch),
        library_ms=time_ms(lambda: (F.silu(x @ w1.t()) * (x @ w2.t())) @ w3.t(), torch),
        bound_ms=bms, bound_by=by)
    # K4's gradient (plain PyTorch, fp32 with TF32 off), for the record
    g_out = randn(rows, d)
    out["swiglu_mlp_bwd_fp32"] = dict(
        shape=[rows, d, inter],
        ms=time_ms(lambda: swiglu.swiglu_mlp_bwd(x, w1, w2, w3, g_out,
                                                  needs=(True, False, False, False)),
                   torch, warmup=1, iters=5),
        bound_ms=bound(0, 5 * 2 * rows * d * inter, FP32_FLOPS)[0], bound_by="operations")
    emit({"phase": "training_shape_kernels", "model": cfg.name, "rows": rows,
          "tolerance": tolerance, **out})
    return out


def training_shape_mixtral_phase(torch, seed: int) -> dict:
    """`training_shape_phase` at Mixtral-8x7B's widths: K2 at 8192 x 4096,
    K3 at q (8, 8, 4, 1024, 128) and k (8, 8, 1024, 128), rope base 1e6."""
    return training_shape_phase(torch, seed, cfg=mixtral_config(MIXTRAL_LAYERS))


def remat_steps_phase(torch, seed: int) -> dict:
    """The two 8 x 1024 training steps with remat on that K2 and K3 serve:
    full TinyLlama-1.1B + LoRA (2 warm-up, 5 timed steps, as
    `train_step_1024`) and the MIXTRAL_LAYERS-layer Mixtral-8x7B + LoRA under megablox
    (1 warm-up, 5 timed, as `mixtral_step_1024`), each step's seconds and
    their median, with the K2 and K3 launches of the timed steps."""
    import numpy as np

    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    cfg = lora_config(22, lora_dropout=0.05)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(8, 1024)).astype(np.int32)
    labels = ids.copy()
    labels[:, :512] = -1
    batch = {"input_ids": ids, "labels": labels}
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    trainer = Trainer(cfg, TrainConfig(batch_size=8, micro_batch_size=8,
                                       frozen_dtype="bfloat16", lm_head_chunk_size=128,
                                       remat=True), model)
    gen = torch.Generator().manual_seed(seed)
    times = []
    for i in range(7):
        if i == 2:
            reset_counts()
        t0 = time.perf_counter()
        trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    out = {"tinyllama": {"step_s": times[2:], "median_step_s": sorted(times[2:])[2],
                         "launches_5_steps": {k: launches[k] for k in (
                             "rms_norm", "apply_rope", "apply_rope_transpose")}}}
    del trainer, model
    torch.cuda.empty_cache()

    mcfg = config_from_name(MIXTRAL, n_layer=MIXTRAL_LAYERS, lora_r=16, lora_alpha=16,
                            lora_dropout=0.05, lora_query=True, lora_key=True,
                            lora_value=True, lora_projection=True)
    model = GPT(mcfg, device="cuda", dtype=torch.bfloat16, moe_impl="megablox")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    step = mixtral_step_1024(torch, model, mcfg, seed, True, profile=False, timed=5)
    out["mixtral"] = {"shape": step["shape"], "step_s": step["step_s"],
                      "median_step_s": sorted(step["step_s"])[2],
                      "launches_5_steps": {k: step["launches"][k] for k in (
                          "rms_norm", "apply_rope", "apply_rope_transpose")}}
    del model
    torch.cuda.empty_cache()
    emit({"phase": "remat_steps", "micro_batch": 8, "seq_len": 1024,
          "mixtral_layers": MIXTRAL_LAYERS, **out})
    return out


def depth2_train_check(torch, seed: int, lora_impl: str = "xla", attn: str = "own",
                       t: int = 160) -> dict:
    """One Trainer step of a depth-2, full-width TinyLlama + LoRA model from
    seeded numpy weights, dropout off: the loss and every LoRA leaf's
    gradient, card bf16 against CPU fp32. lora_impl "fused": the LoRA
    linears through K5 on the card and its plain version on the CPU. attn
    "splash": DUALHYP_ATTN_IMPL=splash on both sides, so L1's kernels run on
    the card (and K1's must not) and its plain versions on the CPU; at T %
    128 == 0 with q rounded to bf16 times the rounded scale on the card."""
    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import load_tree
    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    cfg = lora_config(2)
    tree = numpy_tree(cfg, seed)
    rng = np.random.default_rng(seed + 2)
    # t = 160: not a multiple of the flash kernels' 64-row tiles
    ids = rng.integers(3, cfg.vocab_size, size=(2, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    batch = {"input_ids": ids, "labels": labels}
    results = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        tcfg = TrainConfig(batch_size=2, micro_batch_size=2, compute_dtype=dtype,
                           frozen_dtype="bfloat16" if device == "cuda" else "",
                           lm_head_chunk_size=128)
        model = GPT(cfg, device=device, dtype=getattr(torch, dtype), lora_impl=lora_impl)
        load_tree(model, tree)
        trainer = Trainer(cfg, tcfg, model)
        if device == "cuda":
            reset_counts()
        with attn_impl(attn):
            loss, _ = trainer.train_step(batch, max_iters=100, warmup_steps=10)
        if device == "cuda":
            launches = read_counts()
        results[device] = (float(loss), {n: p.grad.detach().float().cpu()
                                         for n, p in trainer.trainable.items()})
        del trainer, model
    torch.cuda.empty_cache()
    (loss_card, g_card), (loss_cpu, g_cpu) = results["cuda"], results["cpu"]
    rel = {n: float((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm()) for n in g_cpu}
    result = {"phase": "depth2_train_card_vs_cpu", "lora_impl": lora_impl,
              "attn_impl": attn, "launches": launches, "shape": [2, t],
              "loss_card": loss_card, "loss_cpu": loss_cpu,
              "loss_abs_err": abs(loss_card - loss_cpu), "loss_atol": TRAIN_LOSS_ATOL,
              "grad_rel_l2_err": rel, "grad_rel_tol": TRAIN_GRAD_REL}
    emit(result)
    if not abs(loss_card - loss_cpu) <= TRAIN_LOSS_ATOL:
        raise RuntimeError(f"depth-2 train loss: card {loss_card} vs CPU {loss_cpu}")
    bad = {n: e for n, e in rel.items() if not e <= TRAIN_GRAD_REL}
    if bad:
        raise RuntimeError(f"depth-2 LoRA gradients off: {bad}")
    if (launches["lora_linear"] > 0) != (lora_impl == "fused"):
        raise RuntimeError(f"depth-2 {lora_impl} training step launches {launches}")
    used, unused = ((SPLASH_KERNELS, ("flash_attention_fwd", "flash_attention_bwd"))
                    if attn == "splash" else
                    (("flash_attention_fwd", "flash_attention_bwd"), SPLASH_KERNELS))
    if any(launches[n] <= 0 for n in used) or any(launches[n] for n in unused):
        raise RuntimeError(f"depth-2 training step under attn {attn} launches {launches}")
    return result


def dualhyp_data(tmp: Path, seed: int):
    """The training slices' data: the word tokenizer and seeded synthetic
    DualHyp records (64 train, 16 val, 1 test) written under `tmp`. Returns
    (tokenizer, dataset(split))."""
    from dualhyp_tpu_torch.data import hypotheses, prompts, synthetic

    template_words = " ".join(prompts.DualHyp_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)))
    for name, n, s in (("train", 64, seed), ("val", 16, seed + 1), ("test", 1, seed + 2)):
        synthetic.write_json(tmp / f"{name}.json",
                             synthetic.make_records(n_uids=n, n_hyps=5, seed=s))

    def dataset(split):
        return hypotheses.DualHypothesesDataset(
            split, str(tmp / f"{split}.json"), tokenizer=tok,
            prompts_format="DualHyp", max_input_length=1024, seed=seed)

    return tok, dataset


def timed_training(torch, model, tcfg, tok, dataset, out_dir: Path, seed: int,
                   adapter_only: bool = False) -> dict:
    """`cli.finetune_ger.run_training` on the card with the launch counts
    reset before and read after: tokens/s over the padded batches, MFU
    (the JAX package's count), step times, peak memory, losses.
    adapter_only: its checkpoints hold the LoRA leaves alone
    (--save_adapter_only)."""
    from dualhyp_tpu_torch.cli.finetune_ger import run_training
    from dualhyp_tpu_torch.data import collate
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    cfg = model.cfg
    step_ends, step_tokens = [], []

    def on_step(opt_step, loss, lr):
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())

    # the padded shape of each step, from a twin of the seeded batching
    for epoch in range(tcfg.num_epochs):
        for batch in collate.epoch_batches(dataset("train"), tcfg.batch_size, shuffle=True,
                                           seed=tcfg.seed, epoch=epoch, length_sorted=True):
            step_tokens.append(batch["input_ids"].shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run_training(model, tok, dataset("train"), dataset("val"), tcfg, out_dir,
                       generator=torch.Generator().manual_seed(seed), on_step=on_step,
                       adapter_only=adapter_only)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    step_s = [b - a for a, b in zip([t0] + step_ends[:-1], step_ends)]
    tokens = [shape[0] * shape[1] for shape in step_tokens]
    flops = sum(n * estimate_train_flops_per_token(cfg, shape[1])
                for n, shape in zip(tokens, step_tokens))
    train_s = step_ends[-1] - t0
    return {"out": out, "losses": [float(x) for x in out["losses"]],
            "step_shapes": [list(x) for x in step_tokens], "step_s": step_s,
            "tokens_per_s": sum(tokens) / train_s, "mfu": flops / train_s / BF16_TENSOR_FLOPS,
            "wall_s": wall, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


def train_slice(torch, seed: int) -> dict:
    """LoRA finetuning of full-width TinyLlama-1.1B-Chat through
    `cli.finetune_ger.run_training`, then the checkpoint's reload and one
    decode from it, then one step under torch.profiler."""
    from dualhyp_tpu_torch.ckpt.convert import params_from_jax
    from dualhyp_tpu_torch.ckpt.io import load_params
    from dualhyp_tpu_torch.cli.inference_ger import run_inference
    from dualhyp_tpu_torch.data import collate
    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig

    cfg = lora_config(22, lora_dropout=0.05)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    tcfg = TrainConfig(batch_size=32, micro_batch_size=8, num_epochs=2,
                       frozen_dtype="bfloat16", remat=True, seed=seed,
                       log_interval=32, save_interval=10**6)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lora = set(model.trainable_parameters())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tok, dataset = dualhyp_data(tmp, seed)
        trained = timed_training(torch, model, tcfg, tok, dataset, tmp / "run", seed)
        out, losses, launches = trained.pop("out"), trained["losses"], trained["launches"]

        changed = [n for n in lora if not torch.equal(before[n], model.get_parameter(n))]
        moved_frozen = [n for n, p in model.named_parameters() if n not in lora
                        and not torch.equal(before[n].to(p.dtype), p.detach())]
        del before
        saved = sorted(f.name for f in (tmp / "run").iterdir())

        tree = load_params(tmp / "run" / "model_lora_finetuned.npz")
        reloaded = params_from_jax(tree, cfg, device="cuda", dtype=torch.bfloat16)
        del tree
        mismatch = [n for n, p in reloaded.named_parameters()
                    if not torch.equal(p, model.get_parameter(n).to(p.dtype))]
        records, _ = run_inference(reloaded, tok, dataset("test"), decode_batch=1,
                                   max_new_tokens=8)
        del reloaded
        torch.cuda.empty_cache()

        # one more step (the first epoch's first batch) under torch.profiler
        from torch.profiler import ProfilerActivity, profile

        trainer = out["trainer"]
        batch = next(collate.epoch_batches(dataset("train"), tcfg.batch_size, shuffle=True,
                                           seed=tcfg.seed, epoch=0, length_sorted=True))
        gen = torch.Generator().manual_seed(seed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.train_step(batch, out["max_iters"], out["warmup_steps"], gen)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t1) * 1e3
    emit({"phase": "train_slice_profile", "step_shape": list(batch["input_ids"].shape),
          **profile_summary(prof, prof_wall_ms, top_n=15)})

    result = {"phase": "train_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "lora_r": cfg.lora_r, "lora_dropout": cfg.lora_dropout, "remat": True,
              "batch_size": tcfg.batch_size, "micro_batch_size": tcfg.micro_batch_size,
              "optimizer_steps": len(losses), **trained, "val_loss": out["best_val"],
              "lora_leaves_changed": f"{len(changed)}/{len(lora)}",
              "frozen_leaves_moved": moved_frozen, "saved": saved,
              "reload_mismatch": mismatch, "decoded": records[0]}
    emit(result)
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses {losses}")
    if len(changed) != len(lora) or moved_frozen:
        raise RuntimeError(f"leaves: {len(changed)}/{len(lora)} LoRA changed, "
                           f"frozen moved {moved_frozen}")
    if mismatch or not isinstance(records[0]["inference"], str):
        raise RuntimeError(f"the saved checkpoint did not reload and decode: {mismatch}")
    missing = [name for name in TRAIN_PATH if launches[name] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the training path: {missing}")
    return result


def train_step_1024(torch, seed: int) -> dict:
    """`bench.py`'s training shape on the card: full TinyLlama-1.1B + LoRA
    (dropout 0.05), micro batch 8, T=1024, half the labels masked, accum 1;
    2 warm-up steps and 5 timed steps, remat on and off with the LoRA
    composition, then remat on with the fused LoRA linear (K5): the A/B
    that sets the LoRA default. Launch counts are read around each run."""
    import numpy as np

    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    cfg = lora_config(22, lora_dropout=0.05)
    mb, t = 8, 1024
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(mb, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    batch = {"input_ids": ids, "labels": labels}
    flops_per_step = mb * t * estimate_train_flops_per_token(cfg, t)
    results = {}
    model = None
    for label, remat, impl in (("remat", True, "xla"), ("no_remat", False, "xla"),
                               ("fused_remat", True, "fused")):
        if model is None or model.lora_impl != impl:
            del model
            torch.cuda.empty_cache()
            model = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl=impl)
            model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
        tcfg = TrainConfig(batch_size=mb, micro_batch_size=mb, frozen_dtype="bfloat16",
                           lm_head_chunk_size=128, remat=remat)
        trainer = Trainer(cfg, tcfg, model)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            loss, _ = trainer.train_step(batch, max_iters=1000, warmup_steps=10,
                                         generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        results[label] = {
            "lora_impl": impl, "remat": remat,
            "step_s": times, "median_step_s": med, "tokens_per_s": mb * t / med,
            "mfu": flops_per_step / med / BF16_TENSOR_FLOPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": float(loss), "launches": read_counts()}
        if remat:  # where the device time of one such step goes
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            results[label]["profile"] = {**step_kernel_ms(prof),
                                         **profile_summary(prof, wall_ms, top_n=15)}
            emit({"phase": "train_step_1024_profile", "remat": True, "lora_impl": impl,
                  **results[label]["profile"]})
        del trainer
    emit({"phase": "train_step_1024", "micro_batch": mb, "seq_len": t,
          "flops_per_token": estimate_train_flops_per_token(cfg, t), **results})
    if not all(math.isfinite(r["loss"]) for r in results.values()):
        raise RuntimeError(f"non-finite loss at the training shape: {results}")
    if results["fused_remat"]["launches"]["lora_linear"] <= 0:
        raise RuntimeError("the fused training step never launched K5")
    del model
    torch.cuda.empty_cache()
    return results


# L1 (splash attention) at the shapes of its paths: (label, B, Hq, G, T, D).
# "train" is the 8 x 1024 training step's, "prefill" the decode slices' prompt
# bucket, "unaligned" a bucket the JAX package leaves to XLA (the scale goes
# into the kernels), "d128" Mixtral's training step.
SPLASH_SHAPES = (("train", 8, 32, 4, 1024, 64), ("prefill", 8, 32, 4, 384, 64),
                 ("unaligned", 8, 32, 4, 192, 64), ("d128", 8, 32, 8, 1024, 128))
SPLASH_KERNELS = ("splash_attention_fwd", "splash_attention_dq", "splash_attention_dkv")
# the splash slice: what must launch in its training and in its decoding,
# and what must not (K1 both ways above all)
SPLASH_TRAIN_PATH = SPLASH_KERNELS + ("rms_norm", "apply_rope", "apply_rope_transpose",
                                      "swiglu_mlp")
SPLASH_DECODE_PATH = ("splash_attention_fwd", "rms_norm", "apply_rope", "swiglu_mlp")
SPLASH_IDLE = ("flash_attention_fwd", "flash_attention_bwd", "lora_linear", "q4_matmul")


@contextlib.contextmanager
def attn_impl(name: str):
    """DUALHYP_ATTN_IMPL set to `name` for the block (read at each call)."""
    old = os.environ.get("DUALHYP_ATTN_IMPL")
    os.environ["DUALHYP_ATTN_IMPL"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["DUALHYP_ATTN_IMPL"]
        else:
            os.environ["DUALHYP_ATTN_IMPL"] = old


def kernel_instance(mangled: str) -> str:
    """`name<args>` of a mangled kernel symbol (`_ZN<len><id>...I<args>E...`):
    the last name component and its template arguments (integers, and the
    element types of K2 and K3: `float`, a named type such as
    `__nv_bfloat16`); the bare name where an argument is of another kind."""
    import re

    rest, parts = mangled.removeprefix("_ZN"), []
    while (m := re.match(r"(\d+)", rest)):
        n = int(m[1])
        parts.append(rest[len(m[1]):len(m[1]) + n])
        rest = rest[len(m[1]) + n:]
    name = parts[-1] if parts else mangled
    args, rest = [], rest[1:] if rest.startswith("I") else ""
    while rest and not rest.startswith("E"):
        if (m := re.match(r"L[ib](\d+)E", rest)):
            args.append(m[1])
            rest = rest[m.end():]
        elif (m := re.match(r"(\d+)", rest)):
            end = m.end() + int(m[1])
            args.append(rest[m.end():end])
            rest = rest[end:]
        elif rest[0] == "f":
            args.append("float")
            rest = rest[1:]
        else:
            return name
    return f"{name}<{', '.join(args)}>" if args and rest else name


def ptxas_report(source: str):
    """{kernel instance: registers, spill bytes and static shared memory} of
    a source's kernels, read from the verbose build's `-Xptxas -v` output;
    None when this process did not compile the library (it was already
    built). Dynamic shared memory is chosen at launch and is not in it."""
    import re

    from dualhyp_tpu_torch.ops import _lib

    log = _lib.BUILD_LOGS.get(source)
    if not log:
        return None
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_instance(m[1])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(m[1]) if m else 0
    return out


def sass_counts(lib, opcode: str = "HGMMA"):
    """{kernel instance: count of `opcode` instructions} in the SASS of the
    built library (`cuobjdump -sass`; HGMMA is wgmma's SASS), for the
    kernels that hold any; None where the toolkit has no cuobjdump."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=600, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_instance(m[1])
        elif name and re.search(rf"\b{opcode}\b", line):
            counts[name] = counts.get(name, 0) + 1
    return counts


def sdpa_gqa(F, q, k, v, scale):
    """One causal GQA call of scaled_dot_product_attention (the yardstick):
    enable_gqa where torch has it, else K/V expanded beforehand."""
    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                              enable_gqa=True)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(q, k.repeat_interleave(rep, dim=1),
                                              v.repeat_interleave(rep, dim=1),
                                              is_causal=True, scale=scale)


def splash_phase(torch, seed: int) -> dict:
    """L1's forward, dQ and dK/dV kernels against their plain versions at
    SPLASH_SHAPES, with q and the scale as `ops.splash.causal_attention`
    passes them (q * the bf16 scale and scale 1 at T % 128 == 0, the raw q
    and the scale at other T): O and lse against `splash_fwd_plain`, dQ and
    dK/dV against theirs fed the kernel's O, lse and di, each of the two
    called twice with bitwise-equal outputs. Times beside the bound, the
    plain version and SDPA (forward; its backward, which computes dQ, dK and
    dV together, beside dQ and dK/dV); the registers and spills of each
    instance from the build's -Xptxas -v."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import splash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 23)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {name: {} for name in SPLASH_KERNELS}
    for label, b, nh, g, t, hs in SPLASH_SHAPES:
        scale = 1.0 / math.sqrt(hs)
        q, k, v, do = randn(b, nh, t, hs), randn(b, g, t, hs), randn(b, g, t, hs), \
            randn(b, nh, t, hs)
        if splash.aligned(t):
            q = q * torch.tensor(scale, dtype=torch.bfloat16)
            scale = 1.0
        o, lse = splash.splash_fwd(q, k, v, scale)
        o_plain, lse_plain = splash.splash_fwd_plain(q, k, v, scale)
        checks = {"splash_attention_fwd": {
            "max_abs_err": compare("splash_attention_fwd", o, o_plain, torch),
            "lse_max_abs_err": float((lse - lse_plain).abs().max())}}
        if not bool(((lse - lse_plain).abs() <= LSE_TOL[0] + LSE_TOL[1] * lse_plain.abs()).all()):
            raise RuntimeError(f"splash_attention_fwd lse {label}: kernel disagrees with its "
                               f"plain version: {checks}, tolerance {LSE_TOL}")
        del o_plain, lse_plain
        di = splash.row_dot(o, do)
        args = (q, k, v, lse, do, di, scale)
        checks["splash_attention_dq"] = compare_scaled(
            f"splash_attention_dq {label}",
            repeatable("splash_attention_dq", lambda: splash.splash_dq(*args), torch),
            splash.splash_dq_plain(*args), torch)
        got = repeatable("splash_attention_dkv", lambda: splash.splash_dkv(*args), torch)
        want = splash.splash_dkv_plain(*args)
        dkv = {f"d{n}": compare_scaled(f"splash_attention_dkv d{n} {label}", x, y, torch)
               for n, x, y in zip("kv", got, want)}
        checks["splash_attention_dkv"] = {
            "max_abs_err": max(c["max_abs_err"] for c in dkv.values()), **dkv}
        del got, want
        torch.cuda.empty_cache()

        qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
        sdpa_out = sdpa_gqa(F, qr, kr, vr, scale)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do,
                                                          retain_graph=True), torch)
        pairs = b * nh * t * (t + 1) // 2
        n_q, n_kv, n_rows = b * nh * t * hs, b * g * t * hs, b * nh * t
        runs = {
            # (kernel, plain, SDPA ms, bytes: each input read once and each
            # output written once, operations: 2 flops a MAC a causal pair)
            "splash_attention_fwd": (
                lambda: splash.splash_fwd(q, k, v, scale),
                lambda: splash.splash_fwd_plain(q, k, v, scale),
                time_ms(lambda: sdpa_gqa(F, q, k, v, scale), torch),
                (2 * n_q + 2 * n_kv) * 2 + n_rows * 4, 4 * hs * pairs),
            "splash_attention_dq": (
                lambda: splash.splash_dq(*args), lambda: splash.splash_dq_plain(*args),
                sdpa_bwd_ms, (3 * n_q + 2 * n_kv) * 2 + 2 * n_rows * 4, 6 * hs * pairs),
            "splash_attention_dkv": (
                lambda: splash.splash_dkv(*args), lambda: splash.splash_dkv_plain(*args),
                sdpa_bwd_ms, (2 * n_q + 4 * n_kv) * 2 + 2 * n_rows * 4, 8 * hs * pairs)}
        for name, (fn, plain, lib_ms, n_bytes, flops) in runs.items():
            bms, by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
            out[name][label] = dict(
                shape=[b, nh, g, t, hs], scale=scale, **checks[name],
                ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
                plain_ms=time_ms(plain, torch, warmup=1, iters=5), library_ms=lib_ms,
                library=("SDPA forward (enable_gqa)" if name == "splash_attention_fwd" else
                         "SDPA backward (dQ, dK, dV together; autograd.grad)"),
                bound_ms=bms, bound_by=by)
        del q, k, v, do, o, lse, di, args, qr, kr, vr, sdpa_out
        torch.cuda.empty_cache()
    # the forward is K1's forward kernel body (flash_attention.cu), dK/dV
    # K1's backward body and dQ beside it (flash_attention_bwd.cu)
    reports = [ptxas_report(src) for src in ("flash_attention.cu", "flash_attention_bwd.cu")]
    ptxas = None if None in reports else {**reports[0], **reports[1]}
    for name in SPLASH_KERNELS:
        short = name.replace("splash_attention_", "splash_")
        emit({"phase": "kernel", "name": name,
              "tolerance": (dict(zip(("atol", "rtol"), TOLERANCES[name]), lse=LSE_TOL)
                            if name == "splash_attention_fwd" else
                            dict(zip(("atol", "atol_of_rms", "rtol"), FLASH_BWD_TOL))),
              "ptxas": {k: v for k, v in (ptxas or {}).items() if k.startswith(short + "<")}
              if ptxas is not None else "not measured (library built before this run)",
              **out[name]})
    return out


def write_hf_llama(torch, path: Path, cfg, seed: int) -> dict:
    """A random HF-layout LLaMA checkpoint of `cfg` (bf16 safetensors in two
    shards, drawn on the card from `seed`: std 0.02 matrices, norm weights
    near 1) and its `config.json`. Returns a few written tensors (CPU) to
    hold the conversion against."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, hs, inter = cfg.n_embd, cfg.head_size, cfg.intermediate_size

    def w(*shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(
            torch.bfloat16).cpu()

    path.mkdir(parents=True)
    half = cfg.n_layer // 2
    shards = [{"model.embed_tokens.weight": w(cfg.vocab_size, d)}, {}]
    for i in range(cfg.n_layer):
        shard, p = shards[i >= half], f"model.layers.{i}."
        shard[p + "self_attn.q_proj.weight"] = w(cfg.n_head * hs, d)
        shard[p + "self_attn.k_proj.weight"] = w(cfg.n_query_groups * hs, d)
        shard[p + "self_attn.v_proj.weight"] = w(cfg.n_query_groups * hs, d)
        shard[p + "self_attn.o_proj.weight"] = w(d, cfg.n_head * hs)
        shard[p + "mlp.gate_proj.weight"] = w(inter, d)
        shard[p + "mlp.up_proj.weight"] = w(inter, d)
        shard[p + "mlp.down_proj.weight"] = w(d, inter)
        shard[p + "input_layernorm.weight"] = w(d, std=0.1, mean=1.0)
        shard[p + "post_attention_layernorm.weight"] = w(d, std=0.1, mean=1.0)
    shards[1]["model.norm.weight"] = w(d, std=0.1, mean=1.0)
    shards[1]["lm_head.weight"] = w(cfg.vocab_size, d)
    for i, shard in enumerate(shards):
        write_safetensors(path / f"model-0000{i + 1}-of-00002.safetensors", shard)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "hidden_size": d,
        "intermediate_size": inter, "num_attention_heads": cfg.n_head,
        "num_hidden_layers": cfg.n_layer, "num_key_value_heads": cfg.n_query_groups,
        "vocab_size": cfg.vocab_size, "torch_dtype": "bfloat16"}))
    p = "model.layers.1.self_attn."
    return {"layer1_qkv": [shards[0][p + f"{x}_proj.weight"] for x in "qkv"],
            "lm_head": shards[1]["lm_head.weight"],
            "norm_2_last": shards[1][f"model.layers.{cfg.n_layer - 1}."
                                     "post_attention_layernorm.weight"]}


def splash_slice(torch, seed: int) -> dict:
    """The splash path from an HF-layout checkpoint: full-width TinyLlama-1.1B
    (22 layers, random bf16 weights from --seed) written as safetensors,
    converted by `cli.common.load_model`, then with DUALHYP_ATTN_IMPL=splash
    LoRA finetuning through `cli.finetune_ger.run_training` (the training
    slice's settings: 4 optimizer steps of batch 32 in micro batches of 8),
    the best checkpoint read back, and the decode slice's 16 requests served
    from it. L1's forward, dQ and dK/dV, K2, K3 and K4 must launch, K1 not."""
    from dualhyp_tpu_torch.ckpt.convert import params_from_jax
    from dualhyp_tpu_torch.ckpt.convert_hf import interleave_qkv
    from dualhyp_tpu_torch.ckpt.io import load_params
    from dualhyp_tpu_torch.cli.common import load_model
    from dualhyp_tpu_torch.train import TrainConfig

    cfg = lora_config(22, lora_dropout=0.05)
    result = {"phase": "splash_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "lora_r": cfg.lora_r, "attn_impl": "splash"}
    with tempfile.TemporaryDirectory() as tmp, attn_impl("splash"):
        tmp = Path(tmp)
        hf_dir = tmp / "TinyLlama-1.1B-Chat-v1.0"
        t0 = time.perf_counter()
        written = write_hf_llama(torch, hf_dir, cfg, seed)
        result["hf_checkpoint_gb"] = sum(f.stat().st_size for f in hf_dir.iterdir()) / 1e9
        result["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = load_model(hf_dir, cfg, device="cuda", seed=seed, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        result["load_model_s"] = time.perf_counter() - t0
        shutil.rmtree(hf_dir)
        converted = {
            "layer1_qkv": torch.equal(model.blocks[1].attn.qkv.weight.cpu(),
                                      interleave_qkv(*written["layer1_qkv"], cfg)),
            "lm_head": torch.equal(model.lm_head.weight.cpu(), written["lm_head"]),
            "norm_2_last": torch.equal(model.blocks[-1].norm_2.scale.cpu(),
                                       written["norm_2_last"].float())}
        del written
        result["converted_equal"] = converted
        if not all(converted.values()):
            raise RuntimeError(f"load_model did not convert the HF checkpoint: {converted}")

        tcfg = TrainConfig(batch_size=32, micro_batch_size=8, num_epochs=2,
                           frozen_dtype="bfloat16", remat=True, seed=seed,
                           log_interval=32, save_interval=10**6)
        tok, dataset = dualhyp_data(tmp, seed)
        trained = timed_training(torch, model, tcfg, tok, dataset, tmp / "run", seed)
        out = trained.pop("out")
        result.update(batch_size=tcfg.batch_size, micro_batch_size=tcfg.micro_batch_size,
                      remat=True, val_loss=out["best_val"], **trained)
        del out
        best = load_params(tmp / "run" / "best_model.npz")
        reloaded = params_from_jax(best, cfg, device="cuda", dtype=torch.bfloat16)
        del best
        result["reload_mismatch"] = [
            n for n, p in reloaded.named_parameters()
            if not torch.equal(p, model.get_parameter(n).to(p.dtype))]
        del model
        torch.cuda.empty_cache()
        serve = dict(decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1,
                     kv_quant=None)
        records, metrics, wall, launches, prompt_tokens, _ = serve_requests(
            torch, reloaded, seed, serve)
        del reloaded
        torch.cuda.empty_cache()
    result.update(decode_wall_s=wall, decode_metrics=metrics, decode_launches=launches,
                  decode_prompt_tokens=prompt_tokens, sample=records[0])
    emit(result)
    losses = result["losses"]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"splash training losses {losses}")
    if result["reload_mismatch"]:
        raise RuntimeError(f"the best checkpoint did not reload: {result['reload_mismatch']}")
    missing = [n for n in SPLASH_TRAIN_PATH if result["launches"][n] <= 0]
    stray = [n for n in SPLASH_IDLE if result["launches"][n] != 0]
    if missing or stray:
        raise RuntimeError(f"splash training: never launched {missing}, launched {stray}")
    check_served(records, metrics, launches, SPLASH_DECODE_PATH,
                 SPLASH_IDLE + ("splash_attention_dq", "splash_attention_dkv"), "splash")
    return result


def attn_ab_1024(torch, seed: int) -> dict:
    """The 8 x 1024 training step (remat on, LoRA composition) with
    DUALHYP_ATTN_IMPL "own" (K1) against "splash" (L1), in turns own,
    splash, splash, own on one model: 2 warm-up and 5 timed steps a turn;
    the first turn of each under torch.profiler for one more step (idle
    share, the attention kernels' device ms)."""
    import numpy as np

    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    cfg = lora_config(22, lora_dropout=0.05)
    mb, t = 8, 1024
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(mb, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    batch = {"input_ids": ids, "labels": labels}
    flops_per_step = mb * t * estimate_train_flops_per_token(cfg, t)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    results = {"own": [], "splash": []}
    profiles = {}
    for impl in ("own", "splash", "splash", "own"):
        with attn_impl(impl):
            tcfg = TrainConfig(batch_size=mb, micro_batch_size=mb, frozen_dtype="bfloat16",
                               lm_head_chunk_size=128, remat=True)
            trainer = Trainer(cfg, tcfg, model)
            gen = torch.Generator().manual_seed(seed)
            for _ in range(2):
                trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                loss, _ = trainer.train_step(batch, max_iters=1000, warmup_steps=10,
                                             generator=gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            med = sorted(times)[len(times) // 2]
            results[impl].append({
                "step_s": times, "median_step_s": med, "tokens_per_s": mb * t / med,
                "mfu": flops_per_step / med / BF16_TENSOR_FLOPS,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loss": float(loss), "launches": read_counts()})
            if impl not in profiles:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                attention_ms = {name[:80]: us / 1e3
                                for name, (us, _) in device_kernel_times(prof).items()
                                if "splash_" in name or "flash_fwd_kernel" in name
                                or "flash_bwd_kernel" in name or "delta_kernel" in name}
                summary = profile_summary(prof, wall_ms, top_n=8)
                profiles[impl] = {"wall_ms": wall_ms, "idle_share": summary["idle_share"],
                                  "device_busy_ms": summary["device_busy_ms"],
                                  "attention_kernels_ms": attention_ms,
                                  "attention_ms": sum(attention_ms.values()),
                                  "top_kernels": summary["kernels"]}
            del trainer
    del model
    torch.cuda.empty_cache()
    summary = {impl: {"median_step_s": [r["median_step_s"] for r in runs],
                      "tokens_per_s": [r["tokens_per_s"] for r in runs],
                      "mfu": [r["mfu"] for r in runs],
                      "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
                      "launches": runs[0]["launches"], "profile": profiles[impl]}
               for impl, runs in results.items()}
    emit({"phase": "attn_ab_1024", "micro_batch": mb, "seq_len": t, "remat": True,
          "order": ["own", "splash", "splash", "own"], **summary,
          "runs": {impl: [{k: r[k] for k in ("step_s", "loss")} for r in runs]
                   for impl, runs in results.items()}})
    if not all(math.isfinite(r["loss"]) for runs in results.values() for r in runs):
        raise RuntimeError(f"non-finite loss in the attention A/B: {results}")
    own, spl = summary["own"]["launches"], summary["splash"]["launches"]
    if (own["flash_attention_bwd"] <= 0 or any(own[n] for n in SPLASH_KERNELS)
            or any(spl[n] <= 0 for n in SPLASH_KERNELS)
            or spl["flash_attention_fwd"] or spl["flash_attention_bwd"]):
        raise RuntimeError(f"the A/B ran the wrong attention: own {own}, splash {spl}")
    return summary


def flash_fwd_phase(torch, seed: int) -> dict:
    """K6 and K7 against their plain versions at the encoder's and the
    prefill's shapes, timed beside their bound and SDPA. K7 has no
    production call site, so its driven run is this phase's: the launch
    counts are reset before and read after one call at each K7 shape."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 17)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def errors(got, want):
        torch.cuda.synchronize()
        return (float((got.float() - want.float()).abs().max()),
                float((got != want).float().mean()))

    def check(label, got, want, dtype_name):
        err, share = errors(got, want)
        if not err <= FLASH_FWD_ATOL[dtype_name] or (
                dtype_name == "bfloat16" and not share <= FLASH_FWD_DIFFER_SHARE):
            raise RuntimeError(f"{label}: kernel disagrees with its plain version: "
                               f"max_abs_err {err} (tolerance {FLASH_FWD_ATOL[dtype_name]}), "
                               f"{share} of the elements differ")
        return err, share

    full = {}
    for label, b, t, s_len, dtype in (("b1_t280_f32", 1, 280, 280, torch.float32),
                                      ("b1_t1500_f32", 1, 1500, 1500, torch.float32),
                                      ("b8_t1500_f32", 8, 1500, 1500, torch.float32),
                                      ("b1_t280_s1500_f32", 1, 280, 1500, torch.float32),
                                      ("b8_t1500_bf16", 8, 1500, 1500, torch.bfloat16)):
        h, hs = 20, 64
        name = str(dtype).split(".")[-1]
        q = randn(b, h, t, hs, dtype=dtype)
        k, v = (randn(b, h, s_len, hs, dtype=dtype) for _ in range(2))
        fn = lambda: flash_fwd.full_attention_fwd(q, k, v)  # noqa: E731
        plain = lambda: flash_fwd.full_attention_plain(q, k, v)  # noqa: E731
        err, share = check(f"full_attention_fwd {label}",
                           repeatable("full_attention_fwd", fn, torch), plain(), name)
        elem = q.element_size()
        nbytes = (2 * b * h * t * hs + 2 * b * h * s_len * hs) * elem
        flops = 4 * b * h * t * s_len * hs
        extra = {}
        if dtype == torch.float32:
            # fp32 accuracy on the tensor cores takes six bf16 products a
            # product (three pieces of each operand): the least time is the
            # larger of the bytes and 6 x the operations at the bf16 rate,
            # below the CUDA cores' fp32 rate (the bound of an FFMA kernel)
            bms, by = bound(nbytes, SPLIT_PRODUCTS * flops, BF16_TENSOR_FLOPS)
            extra["bound_ms_cuda_cores"], _ = bound(nbytes, flops, FP32_FLOPS)
        else:
            bms, by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        full[label] = dict(
            shape=[b, h, t, s_len, hs], dtype=name, max_abs_err=err, differ_share=share,
            repeats_bitwise=True,
            ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
            plain_ms=time_ms(plain, torch, warmup=1, iters=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), torch),
            library="SDPA (non-causal)", bound_ms=bms, bound_by=by, **extra)
        del q, k, v
    emit({"phase": "kernel", "name": "full_attention_fwd",
          "tolerance": {"max_abs_err": FLASH_FWD_ATOL,
                        "bfloat16_differ_share": FLASH_FWD_DIFFER_SHARE}, **full})

    causal = {}
    reset_counts()
    for t in (200, 1024):
        b, hq, g, hs = 8, 32, 4, 64
        q = randn(b, hq, t, hs, dtype=torch.bfloat16)
        k, v = (randn(b, g, t, hs, dtype=torch.bfloat16) for _ in range(2))
        got = flash_fwd.causal_attention_fwd(q, k, v)
        causal[f"T{t}"] = (q, k, v, got)
    launches = read_counts()
    for label, (q, k, v, got) in causal.items():
        b, hq, t, hs = q.shape
        g = k.shape[1]
        fn = lambda: flash_fwd.causal_attention_fwd(q, k, v)  # noqa: E731
        plain = lambda: flash_fwd.causal_attention_fwd_plain(q, k, v)  # noqa: E731
        want = plain()
        err, share = check(f"causal_attention_fwd {label}", got, want, "bfloat16")
        if not torch.equal(got, fn()):
            raise RuntimeError(f"causal_attention_fwd {label}: two calls differ")
        # K1's forward on the same inputs: the same kernel body with P rounded
        # to bf16 before one P V product (what the tolerance tells apart from
        # the Pallas arithmetic), and the row logsumexp written too
        k1 = lambda: attention._flash_fwd(q, k, v, 1.0 / math.sqrt(hs))  # noqa: E731
        k1_err, k1_share = errors(k1()[0], want)
        del want
        ke, ve = (z.repeat_interleave(hq // g, dim=1) for z in (k, v))
        pairs = b * hq * t * (t + 1) // 2
        bms, by = bound((2 * b * hq * t * hs + 2 * b * g * t * hs) * 2, 4 * pairs * hs,
                        BF16_TENSOR_FLOPS)
        causal[label] = dict(
            shape=[b, hq, g, t, hs], dtype="bfloat16", max_abs_err=err, differ_share=share,
            repeats_bitwise=True, p_rounded_k1_max_abs_err=k1_err,
            p_rounded_k1_differ_share=k1_share,
            ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
            k1_forward_device_ms=device_ms(k1, torch),
            plain_ms=time_ms(plain, torch, warmup=1, iters=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                               torch),
            library="SDPA (causal, K/V expanded to the query heads)", bound_ms=bms, bound_by=by)
    emit({"phase": "kernel", "name": "causal_attention_fwd",
          "tolerance": {"max_abs_err": FLASH_FWD_ATOL["bfloat16"],
                        "differ_share": FLASH_FWD_DIFFER_SHARE},
          "launches": launches["causal_attention_fwd"], **causal})
    if launches["causal_attention_fwd"] != 2:
        raise RuntimeError(f"K7's driven run launched {launches}")
    torch.cuda.empty_cache()
    return {"full_attention_fwd": full, "causal_attention_fwd": causal,
            "causal_launches": launches}


def numpy_encoder_tree(cfg, seed: int) -> dict:
    """A Whisper encoder tree in the JAX package's layout, drawn with numpy:
    weights N(0, 1/n_state) as the JAX init draws them, and small non-zero
    biases and LayerNorm offsets so that each leaf counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s, n = cfg.n_state, cfg.n_layer
    std = 1.0 / math.sqrt(s)

    def normal(*shape, scale=std, loc=0.0):
        return (loc + rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def lin(out_f, in_f, bias=True):
        leaf = {"weight": normal(n, out_f, in_f)}
        if bias:
            leaf["bias"] = normal(n, out_f, scale=0.02)
        return leaf

    def ln(*shape):
        return {"scale": normal(*shape, scale=0.1, loc=1.0), "bias": normal(*shape, scale=0.02)}

    return {
        "conv1": {"weight": normal(s, cfg.n_mels, 3), "bias": normal(s, scale=0.02)},
        "conv2": {"weight": normal(s, s, 3), "bias": normal(s, scale=0.02)},
        "blocks": {"attn_ln": ln(n, s),
                   "attn": {"query": lin(s, s), "key": lin(s, s, bias=False),
                            "value": lin(s, s), "out": lin(s, s)},
                   "mlp_ln": ln(n, s),
                   "mlp": {"fc1": lin(4 * s, s), "fc2": lin(s, 4 * s)}},
        "ln_post": ln(s),
    }


def depth2_encoder_check(torch, seed: int) -> dict:
    """A depth-2, full-width Whisper-large-v3 encoder from seeded numpy
    weights: features on the card (K6, fp32) against the CPU (plain, fp32)
    for a 3-s mel and a 30-s pad_or_trim mel."""
    import dataclasses

    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import encoder_from_jax
    from dualhyp_tpu_torch.models import whisper as w

    cfg = dataclasses.replace(w.WHISPER_LARGE_V3, n_layer=2)
    tree = numpy_encoder_tree(cfg, seed + 19)
    card, cpu = encoder_from_jax(tree, device="cuda"), encoder_from_jax(tree, device="cpu")
    del tree
    audio = np.random.default_rng(seed + 23).standard_normal(3 * w.SAMPLE_RATE).astype(
        np.float32) * 0.1
    out = {}
    for label, wave in (("3s", audio), ("30s", w.pad_or_trim(audio))):
        mel = torch.from_numpy(w.log_mel_spectrogram(wave, cfg.n_mels)[None])
        reset_counts()
        got = w.encode(card, cfg, mel.cuda()).cpu()
        launches = read_counts()["full_attention_fwd"]
        want = w.encode(cpu, cfg, mel)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        out[label] = {"mel_frames": mel.shape[-1], "features": list(want.shape),
                      "max_abs_err": err, "max_abs_feature": scale,
                      "rel_err": err / scale, "k6_launches": launches}
        if not (err <= ENCODER_REL_TOL * scale and launches == cfg.n_layer):
            raise RuntimeError(f"depth-2 encoder {label}: card vs CPU {out[label]}, "
                               f"tolerance {ENCODER_REL_TOL} of the largest feature")
    result = {"phase": "depth2_encoder_card_vs_cpu", "n_state": cfg.n_state,
              "n_head": cfg.n_head, "n_mels": cfg.n_mels, "n_layer": cfg.n_layer,
              "rel_tolerance": ENCODER_REL_TOL, **out}
    emit(result)
    del card, cpu
    torch.cuda.empty_cache()
    return result


def write_safetensors(path, tensors: dict) -> None:
    """{name: CPU tensor} as a safetensors file (F32, F16 or BF16), with no
    package: an 8-byte little-endian header length, the JSON header, the
    raw little-endian data."""
    import torch

    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fp:
        fp.write(len(raw).to_bytes(8, "little"))
        fp.write(raw)
        for t in tensors.values():
            fp.write(t.contiguous().view(torch.uint8).numpy())


def write_whisper_checkpoint(torch, path: Path, seed: int) -> None:
    """A random Whisper-large-v3 (encoder and decoder) as a HF directory:
    `config.json` and an F16 `model.safetensors`, as openai/whisper-large-v3
    ships it. Weights N(0, 1/n_state) as the JAX init draws them (drawn on
    the card from `seed`), positional embeddings N(0, 0.01), small random
    biases, LayerNorm scales near 1."""
    from dualhyp_tpu_torch.models.whisper import WHISPER_LARGE_V3 as cfg
    from dualhyp_tpu_torch.models.whisper import WHISPER_LARGE_V3_DECODER as dec

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = cfg.n_state

    def normal(*shape, scale=1.0 / math.sqrt(s), loc=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * scale + loc
        return t.half().cpu()

    tensors = {"model.encoder.conv1.weight": normal(s, cfg.n_mels, 3),
               "model.encoder.conv1.bias": normal(s, scale=0.02),
               "model.encoder.conv2.weight": normal(s, s, 3),
               "model.encoder.conv2.bias": normal(s, scale=0.02),
               "model.encoder.layer_norm.weight": normal(s, scale=0.1, loc=1.0),
               "model.encoder.layer_norm.bias": normal(s, scale=0.02)}
    linears = {"self_attn.q_proj": (s, s, True), "self_attn.k_proj": (s, s, False),
               "self_attn.v_proj": (s, s, True), "self_attn.out_proj": (s, s, True),
               "fc1": (4 * s, s, True), "fc2": (s, 4 * s, True)}
    for i in range(cfg.n_layer):
        pre = f"model.encoder.layers.{i}."
        for name, (o, d, bias) in linears.items():
            tensors[pre + name + ".weight"] = normal(o, d)
            if bias:
                tensors[pre + name + ".bias"] = normal(o, scale=0.02)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            tensors[pre + name + ".weight"] = normal(s, scale=0.1, loc=1.0)
            tensors[pre + name + ".bias"] = normal(s, scale=0.02)
    tensors.update({"model.decoder.embed_tokens.weight": normal(dec.n_vocab, s),
                    "model.decoder.embed_positions.weight": normal(dec.n_ctx, s, scale=0.01),
                    "model.decoder.layer_norm.weight": normal(s, scale=0.1, loc=1.0),
                    "model.decoder.layer_norm.bias": normal(s, scale=0.02)})
    for prefix in ("self_attn", "encoder_attn"):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linears[f"{prefix}.{name}"] = (s, s, name != "k_proj")
    for i in range(dec.n_layer):
        pre = f"model.decoder.layers.{i}."
        for name, (o, d, bias) in linears.items():
            tensors[pre + name + ".weight"] = normal(o, d)
            if bias:
                tensors[pre + name + ".bias"] = normal(o, scale=0.02)
        for name in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            tensors[pre + name + ".weight"] = normal(s, scale=0.1, loc=1.0)
            tensors[pre + name + ".bias"] = normal(s, scale=0.02)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "num_mel_bins": cfg.n_mels, "max_source_positions": cfg.n_ctx,
        "d_model": cfg.n_state, "encoder_attention_heads": cfg.n_head,
        "encoder_layers": cfg.n_layer, "vocab_size": dec.n_vocab,
        "max_target_positions": dec.n_ctx, "decoder_attention_heads": dec.n_head,
        "decoder_layers": dec.n_layer}))
    write_safetensors(path / "model.safetensors", tensors)


RELPROMPT_PATH = ("full_attention_fwd", "rms_norm", "apply_rope", "flash_attention_fwd",
                  "swiglu_mlp")
RELPROMPT_IDLE = ("lora_linear", "causal_attention_fwd", "q4_matmul")


def relprompt_slice(torch, seed: int, whisper: Path) -> dict:
    """The RelPrompt slice: (a) precompute_features on the 16 requests, (b)
    run_relprompt with the encoder on the card, (c) the same from (a)'s
    features. Launch counts around (a) and (b). The random Whisper-large-v3
    checkpoint is written to `whisper` (the RelPrompt training slice reads
    it there too)."""
    import argparse as ap

    import numpy as np
    from scipy.io import wavfile

    from dualhyp_tpu_torch.cli import inference_relprompt, precompute_features
    from dualhyp_tpu_torch.cli.finetune_relprompt import feature_loader
    from dualhyp_tpu_torch.data import hypotheses, prompts, synthetic
    from dualhyp_tpu_torch.models import whisper as w
    from dualhyp_tpu_torch.models.relprompt import init_relprompt_params

    cfg = lora_config(DECODE_LAYERS).replace(use_relprompt=True, n_extra_tokens=3)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = init_relprompt_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    random_lora_b(torch, model, gen)
    with torch.no_grad():  # a trained classifier's biases are not zero
        for clf in (model.audio_noise_classifier, model.visual_noise_classifier):
            for layer in clf.children():
                layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen,
                                             device="cuda") * 0.1)
    template_words = " ".join(prompts.RelPrompt_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)),
                        special_base=cfg.padded_vocab_size)
    inference_relprompt.add_mask_tokens(tok)
    serve = dict(seed=seed, decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_whisper_checkpoint(torch, whisper, seed + 29)
        write_s = time.perf_counter() - t0
        records = synthetic.make_records(n_uids=16, n_hyps=5, seed=seed)
        rng = np.random.default_rng(seed)
        for rec in records:
            n = rec["Audio_Corruption"]["total_len"]
            rec["Clean_Wav"] = str(tmp / f"{rec['Uid']}_clean.wav")
            rec["Noise_Wav"] = str(tmp / f"{rec['Uid']}_noise.wav")
            wavfile.write(rec["Clean_Wav"], 16000, (rng.standard_normal(n) * 3000).astype(np.int16))
            wavfile.write(rec["Noise_Wav"], 16000,
                          (rng.standard_normal(n // 3) * 3000).astype(np.int16))
        path = tmp / "test.json"
        synthetic.write_json(path, records)

        def dataset():
            return hypotheses.DualHypothesesMaskDataset(
                "test", str(path), tokenizer=tok, prompts_format="RelPrompt", seed=seed,
                leave_masks=True)

        # (a) the features of every request, written by the CLI
        reset_counts()
        t0 = time.perf_counter()
        written = precompute_features.main(["--json", str(path), "--out_dir",
                                            str(tmp / "feats"), "--whisper_checkpoint",
                                            str(whisper), "--device", "cuda"])
        torch.cuda.synchronize()
        precompute_s = time.perf_counter() - t0
        launches_a = read_counts()
        if written != 16:
            raise RuntimeError(f"precompute_features wrote {written} of 16 feature files")

        # (b) the encoder on the card, feature by feature, timed per utterance
        args = ap.Namespace(whisper_checkpoint=str(whisper), feature_dir=None,
                            synthetic_features=False, device="cuda")
        load = feature_loader(args, cfg)
        feature_ms = []

        def timed(example, rng_):
            t1 = time.perf_counter()
            out = load(example, rng_)
            feature_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        records_b, metrics_b, masks_b = inference_relprompt.run_relprompt(
            model, tok, dataset(), timed, **serve)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        launches_b = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the encoder alone on the longest utterance (B=1), CUDA-event time
        from dualhyp_tpu_torch.cli.make_json_asr import load_whisper
        from dualhyp_tpu_torch.cli.finetune_relprompt import replayed_waveform

        (enc, enc_cfg), _, _ = load_whisper(whisper, device="cuda")
        longest = max(records, key=lambda r: r["Audio_Corruption"]["total_len"])
        mel = torch.from_numpy(w.log_mel_spectrogram(replayed_waveform(longest),
                                                     enc_cfg.n_mels)[None]).cuda()
        encoder_ms = time_ms(lambda: w.encode(enc, enc_cfg, mel), torch, warmup=2, iters=10)
        # where the encoder's device time goes, and how much of its wall is idle
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            w.encode(enc, enc_cfg, mel)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t1) * 1e3
        emit({"phase": "relprompt_encoder_profile", "mel_frames": int(mel.shape[-1]),
              **profile_summary(prof, prof_wall_ms)})
        del enc

        # (c) the features that (a) wrote
        args = ap.Namespace(whisper_checkpoint=None, feature_dir=str(tmp / "feats"),
                            synthetic_features=False, device="cuda")
        records_c, metrics_c, masks_c = inference_relprompt.run_relprompt(
            model, tok, dataset(), feature_loader(args, cfg), **serve)
        # (c) once more: what the card's decoding alone changes between runs
        # on the same prompts (K4 adds its fp32 partials with atomics, in no
        # fixed order)
        records_c2, _, _ = inference_relprompt.run_relprompt(
            model, tok, dataset(), feature_loader(args, cfg), **serve)

    timeless = {k: v for k, v in metrics_b.items()
                if "latency" not in k and k != "tokens_per_s"}
    n_layers = w.WHISPER_LARGE_V3.n_layer
    result = {"phase": "relprompt_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "lora_r": cfg.lora_r, "encoder": "whisper-large-v3 (random, F16 on disk, fp32)",
              "encoder_layers": n_layers, "requests": len(records_b),
              "mel_frames": [min(r["Audio_Corruption"]["total_len"] for r in records) // 160,
                             max(r["Audio_Corruption"]["total_len"] for r in records) // 160],
              "decode_batch": 8, "max_new_tokens": 32, "checkpoint_write_s": write_s,
              "precompute_s": precompute_s, "wall_s": wall_b, "peak_mem_gb": peak_gb,
              "feature_ms_per_utterance": sorted(feature_ms)[len(feature_ms) // 2],
              "encoder_ms_longest_utterance": encoder_ms,
              "encoder_mel_frames_longest": int(mel.shape[-1]),
              "metrics": metrics_b, "metrics_from_feature_dir": metrics_c,
              "masks_agree": masks_b == masks_c,
              "answers_vs_feature_dir": token_agreement(records_c, records_b),
              "answers_feature_dir_twice": token_agreement(records_c2, records_c),
              "launches_precompute": launches_a, "launches": launches_b,
              "sample": records_b[0], "sample_masks": masks_b[records_b[0]["uid"]]}
    emit(result)
    del model
    torch.cuda.empty_cache()
    if len(records_b) != 16 or not all(isinstance(r["inference"], str) for r in records_b):
        raise RuntimeError("the RelPrompt slice did not answer every request")
    if not all(math.isfinite(v) for v in timeless.values() if isinstance(v, float)):
        raise RuntimeError(f"non-finite metrics {metrics_b}")
    if masks_b != masks_c:
        raise RuntimeError("--whisper_checkpoint and --feature_dir gave other mask tokens")
    if launches_b["full_attention_fwd"] != n_layers * 16 or launches_a["full_attention_fwd"] <= 0:
        raise RuntimeError(f"K6 launches: (a) {launches_a['full_attention_fwd']}, "
                           f"(b) {launches_b['full_attention_fwd']} for {n_layers} x 16")
    missing = [name for name in RELPROMPT_PATH if launches_b[name] <= 0]
    stray = [name for name in RELPROMPT_IDLE if launches_b[name] != 0]
    if missing or stray:
        raise RuntimeError(f"RelPrompt slice launches: never {missing}, off the path {stray}")
    return result


MIXTRAL = "Mixtral-8x7B-Instruct-v0.1"
# depth of the Mixtral slice (full width): 8 of 32 layers, 23.5 GB of bf16
# weights (16 fit a card, 47.0 GB, but took the script past its time on a
# slow host); all 32 (93.4 GB) need more than one 80 GB card
MIXTRAL_LAYERS = 8
# L2 at the Mixtral slices' shapes: (name, rows M, N, K). Decode: 8 tokens x
# top 2; prefill: 8 prompts x 384 tokens x top 2 (the longest prompt
# bucket of the kernel phases; the slice's own prompts are shorter);
# train: the training slice's 8 x 1024 tokens x top 2 (its forward and
# remat launches)
GMM_SHAPES = (("decode_fc_1", 16, 14336, 4096), ("decode_proj", 16, 4096, 14336),
              ("prefill_fc_1", 6144, 14336, 4096), ("prefill_proj", 6144, 4096, 14336),
              ("train_fc_1", 16384, 14336, 4096), ("train_proj", 16384, 4096, 14336))
# the Mixtral slice's MoE paths: which kernels must launch and which must not
MOE_PATH = ("grouped_matmul", "flash_attention_fwd", "rms_norm", "apply_rope")
MOE_IDLE = ("swiglu_mlp", "lora_linear", "q4_matmul", "full_attention_fwd",
            "causal_attention_fwd")
# depth-2 Mixtral, card bf16 vs CPU fp32: at least this share of the (token,
# layer) top-2 expert sets must agree (a near tie of two router logits may
# pick another expert under bf16; ~1-2% of routes at these widths), and at
# least half of the prompt rows must agree at every token and layer
ROUTE_AGREEMENT = 0.9


def mixtral_config(n_layer: int):
    from dualhyp_tpu_torch import config_from_name

    return config_from_name(
        MIXTRAL, n_layer=n_layer, lora_r=16, lora_alpha=16, lora_query=True,
        lora_key=True, lora_value=True, lora_projection=True)


def seeded_group_sizes(torch, rows: int, n_expert: int, seed: int, case: str):
    """The group sizes of `rows` expert slots (rows / 2 tokens, top 2) from
    a seeded draw of router logits: "skewed" adds a falling bias over the
    experts (expert 0 the most popular), "empty" never routes to experts 2
    and 5; "single" puts every slot in expert 3; "busy" gives every expert
    rows / n_expert slots (the rest to the first ones)."""
    if case in ("single", "busy"):
        sizes = [0] * n_expert
        if case == "single":
            sizes[3] = rows
        else:
            sizes = [rows // n_expert + (e < rows % n_expert) for e in range(n_expert)]
        return torch.tensor(sizes, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(rows // 2, n_expert, generator=gen, device="cuda")
    if case == "skewed":
        logits += torch.linspace(2.0, -2.0, n_expert, device="cuda")
    else:
        logits[:, [2, 5]] = float("-inf")
    ids = logits.topk(2, dim=-1).indices.reshape(-1)
    sizes = torch.zeros(n_expert, dtype=torch.int64, device="cuda")
    return sizes.scatter_add_(0, ids, torch.ones_like(ids)).to(torch.int32)


def grouped_mm_library(torch, lhs, w, sizes):
    """One PyTorch call for L2's function, as a yardstick: torch._grouped_mm
    where this PyTorch has it and takes these inputs, else a per-expert
    cuBLAS loop whose host read of the group sizes is part of its time."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    if hasattr(torch, "_grouped_mm"):
        def grouped():
            return torch._grouped_mm(lhs, w.transpose(1, 2), offs=offs,
                                     out_dtype=torch.bfloat16)
        try:
            grouped()
            return grouped, "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError):
            pass

    def loop():
        out = torch.empty((lhs.shape[0], w.shape[1]), dtype=lhs.dtype, device=lhs.device)
        start = 0
        for e, end in enumerate(offs.tolist()):  # a host sync
            if end > start:
                torch.matmul(lhs[start:end], w[e].t(), out=out[start:end])
            start = end
        return out
    return loop, "per-expert cuBLAS loop (its host sync of the group sizes included)"


def gmm_phase(torch, seed: int) -> dict:
    """L2's forward against its plain version at the Mixtral slices' six
    shapes, each with skewed experts, empty experts and a single group, and
    at the two decode shapes with every expert busy, two calls bitwise
    equal; all but the single groups timed beside the bound and the library
    yardstick (back to back and one cold call each). The skewed and empty
    draws come first, in the order and from the seeds they have had since
    the phase began (the decode and prefill shapes' inputs do not change as
    shapes are added), then the single groups, then the busy decode draws.
    Then the host microseconds of a decode call at a tiny shape, beside K2's
    (a kernel this phase does not change), three times each."""
    from dualhyp_tpu_torch.ops import gmm, rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(seed + 37)
    n_expert = 8
    weights = {}
    out = {}
    draws = [(shape, case) for shape in GMM_SHAPES for case in ("skewed", "empty")]
    draws += [(shape, "single") for shape in GMM_SHAPES]
    draws += [(shape, "busy") for shape in GMM_SHAPES if shape[0].startswith("decode")]
    for i, ((name, rows, n, k), case) in enumerate(draws):
        if (n, k) not in weights:
            weights[(n, k)] = (torch.randn((n_expert, n, k), generator=gen, device="cuda")
                               * 0.02).to(torch.bfloat16)
        w = weights[(n, k)]
        lhs = torch.randn((rows, k), generator=gen, device="cuda").to(torch.bfloat16)
        sizes = seeded_group_sizes(torch, rows, n_expert, seed + i, case)
        fn = lambda: gmm.grouped_matmul(lhs, w, sizes)  # noqa: E731
        plain = lambda: gmm.grouped_matmul_plain(lhs, w, sizes)  # noqa: E731
        err = compare("grouped_matmul", repeatable("grouped_matmul", fn, torch), plain(),
                      torch)
        entry = dict(shape=[rows, n, k], group_sizes=sizes.tolist(), max_abs_err=err,
                     repeats_bitwise=True)
        if rows <= getattr(gmm, "DECODE_ROWS", 0):
            entry["launch"] = decode_plan(gmm, rows, n, k, n_expert)
        if case != "single":
            lib, lib_name = grouped_mm_library(torch, lhs, w, sizes)
            busy = int((sizes > 0).sum())
            bms, by = bound(rows * k * 2 + busy * n * k * 2 + rows * n * 2 + n_expert * 4,
                            2 * rows * n * k, BF16_TENSOR_FLOPS)
            entry.update(
                ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
                plain_ms=time_ms(plain, torch, warmup=1, iters=3),
                library_ms=time_ms(lib, torch), library_device_ms=device_ms(lib, torch),
                library=lib_name,
                library_max_abs_err=float((lib().float() - plain().float()).abs().max()),
                bound_ms=bms, bound_by=by)
        out[f"{name}_{case}"] = entry
        del lhs
        torch.cuda.empty_cache()
    del weights
    torch.cuda.empty_cache()
    # host microseconds of a decode call (16 rows over 8 experts) at a tiny
    # shape, where the card waits on the host, beside K2's at 8 x 128
    lhs = torch.randn((16, 128), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((n_expert, 256, 128), generator=gen, device="cuda").to(torch.bfloat16)
    sizes = seeded_group_sizes(torch, 16, n_expert, seed, "busy")
    scale = torch.ones(128, dtype=torch.bfloat16, device="cuda")
    host = {"grouped_matmul": [host_us(lambda: gmm.grouped_matmul(lhs, w, sizes), torch)
                               for _ in range(3)],
            "rms_norm": [host_us(lambda: rmsnorm.rms_norm(lhs[:8], scale), torch)
                         for _ in range(3)]}
    out["host_cost"] = {"shapes": {"grouped_matmul": [16, 256, 128, n_expert],
                                   "rms_norm": [8, 128]}, "host_us": host}
    emit({"phase": "kernel", "name": "grouped_matmul",
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["grouped_matmul"])), **out})
    return out


def flash_d128_phase(torch, seed: int) -> dict:
    """K1's forward at Mixtral's head size: B8 Hq32 G8 D128 at T=384 and a
    ragged T=200, O and L against the plain pair, timed beside SDPA."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    b, hq, g, hs = 8, 32, 8, 128
    scale = 1.0 / math.sqrt(hs)
    out = {}
    for t in (200, 384):
        q = torch.randn((b, hq, t, hs), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, g, t, hs), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o, lse = attention._flash_fwd(q, k, v, scale)
        o_plain, lse_plain = attention.causal_attention_plain_lse(q, k, v, scale)
        err = compare("flash_attention_fwd", o, o_plain, torch)
        lse_err = float((lse - lse_plain).abs().max())
        if not bool(((lse - lse_plain).abs() <= LSE_TOL[0] + LSE_TOL[1] * lse_plain.abs()).all()):
            raise RuntimeError(f"flash_attention_fwd D128 T={t} lse: max abs err {lse_err}, "
                               f"tolerance {LSE_TOL}")
        fn = lambda: attention.causal_attention(q, k, v)  # noqa: E731
        pairs = b * hq * t * (t + 1) // 2
        bms, by = bound((2 * b * hq * t * hs + 2 * b * g * t * hs) * 2 + b * hq * t * 4,
                        4 * pairs * hs, BF16_TENSOR_FLOPS)
        out[f"T{t}"] = dict(
            shape=[b, hq, g, t, hs], max_abs_err=err, lse_max_abs_err=lse_err,
            ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
            plain_ms=time_ms(lambda: attention.causal_attention_plain(q, k, v), torch,
                             warmup=1, iters=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), torch),
            library="SDPA (causal, enable_gqa)", bound_ms=bms, bound_by=by)
        del q, k, v, o, o_plain
    emit({"phase": "kernel", "name": "flash_attention_fwd", "head_size": hs,
          "tolerance": {"o": dict(zip(("atol", "rtol"), TOLERANCES["flash_attention_fwd"])),
                        "lse": dict(zip(("atol", "rtol"), LSE_TOL))}, **out})
    return out


def fill_random(torch, models, cfg, gen) -> None:
    """The same random values into every model of `models` (each on its own
    device and dtype), drawn in fp32 on the card from `gen` one parameter
    at a time: weights N(0, std) with the JAX init's stds, norm scales near
    1, uniform lora_A and N(0, 0.02) lora_B so that every leaf counts."""
    d = cfg.n_embd
    std = math.sqrt(2.0 / 5 / d)
    proj_std = 1.0 / math.sqrt(d) / cfg.n_layer
    params = [dict(m.named_parameters()) for m in models]
    with torch.no_grad():
        for name, p in params[0].items():
            x = torch.randn(p.shape, generator=gen, device="cuda")
            if name.endswith("scale"):
                x = 1.0 + 0.1 * x
            elif name.endswith("lora_A"):
                bound_ = 1.0 / math.sqrt(p.shape[-1])
                x = (torch.rand(p.shape, generator=gen, device="cuda") * 2 - 1) * bound_
            elif name.endswith("lora_B"):
                x = 0.02 * x
            elif name.endswith("proj.weight"):
                x = proj_std * x
            else:
                x = std * x
            for other in params:
                other[name].copy_(x.to(other[name].device))
            del x


def prefill_with_routes(torch, model, ids, lengths):
    """Prefill logits and each block's top-k expert sets (L, B, T, k), from
    the MoE inputs captured by forward pre-hooks."""
    from dualhyp_tpu_torch.models.gpt import moe_top_k

    inputs = []
    hooks = [block.mlp.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
             for block in model.blocks]
    logits = model.prefill(ids, lengths, model.init_cache(*ids.shape))
    for hook in hooks:
        hook.remove()
    routes = [moe_top_k((x @ block.mlp.gate.weight.t()).float(), block.mlp.top_k)[1]
              for x, block in zip(inputs, model.blocks)]
    return logits, torch.stack(routes).sort(dim=-1).values


def depth2_mixtral_check(torch, seed: int) -> dict:
    """A depth-2, full-width Mixtral-8x7B + LoRA model: prefill logits on the
    card (L2, K1 at D=128, bf16) against the CPU (plain versions, fp32), on
    the same random weights (drawn on the card, one parameter at a time).
    The routes of both sides are compared; the rows routed alike at every
    token and layer hold their last logits to DEPTH2_ATOL."""
    import numpy as np

    from dualhyp_tpu_torch.models.gpt import GPT

    cfg = mixtral_config(2)
    card = GPT(cfg, device="cuda", dtype=torch.bfloat16, moe_impl="megablox")
    cpu = GPT(cfg, device="cpu", dtype=torch.float32, moe_impl="megablox")
    fill_random(torch, (card, cpu), cfg, torch.Generator(device="cuda").manual_seed(seed + 43))
    # many short rows: a row is held only if all its routes agree
    lengths = torch.tensor([72, 40, 24, 16] + [2 + i % 7 for i in range(20)])
    t = int(lengths.max())  # not a multiple of K1's 64-row tile
    rng = np.random.default_rng(seed + 47)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(len(lengths), t)))
    valid = torch.arange(t)[None, :] < lengths[:, None]
    ids[~valid] = 0
    reset_counts()
    got, got_routes = prefill_with_routes(torch, card, ids.cuda(), lengths.cuda())
    launches = read_counts()
    got, got_routes = got.cpu(), got_routes.cpu()
    t0 = time.perf_counter()
    want, want_routes = prefill_with_routes(torch, cpu, ids, lengths)
    cpu_s = time.perf_counter() - t0
    agree = (got_routes == want_routes).all(-1) | ~valid  # (L, B, T)
    share = float(agree[:, valid].float().mean())
    held = agree.all(0).all(-1)
    err = float((got - want)[held].abs().max()) if bool(held.any()) else float("nan")
    result = {"phase": "depth2_mixtral_card_vs_cpu", "model": cfg.name,
              "n_layer": cfg.n_layer, "rows": len(lengths), "prompt_tokens": lengths.tolist(),
              "route_agreement": share, "route_agreement_min": ROUTE_AGREEMENT,
              "rows_held": int(held.sum()), "max_abs_err_held": err,
              "tolerance": DEPTH2_ATOL, "logit_std": float(want.std()),
              "argmax_agree_held": float((got.argmax(-1) == want.argmax(-1))[held]
                                         .float().mean()),
              "cpu_prefill_s": cpu_s, "launches": launches}
    emit(result)
    del card, cpu
    torch.cuda.empty_cache()
    if not share >= ROUTE_AGREEMENT:
        raise RuntimeError(f"depth-2 Mixtral: {share} of the routes agree, < {ROUTE_AGREEMENT}")
    if not 2 * int(held.sum()) >= len(lengths):
        raise RuntimeError(f"depth-2 Mixtral: only {int(held.sum())} of {len(lengths)} rows "
                           f"routed alike")
    if not err <= DEPTH2_ATOL:
        raise RuntimeError(f"depth-2 Mixtral logits: card vs CPU max_abs_err {err} > "
                           f"{DEPTH2_ATOL}")
    if launches["grouped_matmul"] != 3 * cfg.n_layer or launches["flash_attention_fwd"] != 2:
        raise RuntimeError(f"depth-2 Mixtral prefill launches {launches}")
    return result


def moe_nosync_check(torch, seed: int) -> dict:
    """One Mixtral MoE layer forward (megablox: the router, the sort, L2 x 3,
    the combine) at the decode shape (8 tokens) and at the prefill shape (8
    x 384) under torch.cuda.set_sync_debug_mode("error"): a host sync on
    that path raises. Then its forward and backward at the prefill shape,
    the same way: with the expert stacks frozen (LoRA training: L2's dlhs),
    and with stacks that take gradients (drhs too: the driven run of drhs,
    which LoRA training never launches); the launch counts are read around
    each."""
    from dualhyp_tpu_torch.models.gpt import MoE

    cfg = mixtral_config(1)
    moe = MoE(cfg, torch.bfloat16, torch.device("cuda"), "megablox")
    gen = torch.Generator(device="cuda").manual_seed(seed + 53)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.01)
    out = {}
    for label, shape in (("decode", (8, 1, cfg.n_embd)), ("prefill", (8, 384, cfg.n_embd))):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            moe(x)  # the first call loads the kernel library
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                y = moe(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[label] = {"shape": list(shape), "finite": bool(torch.isfinite(y).all())}
    x = x.detach().requires_grad_()
    stacks = (moe.fc_1.weight, moe.fc_2.weight, moe.proj.weight)
    for label in ("backward_frozen_stacks", "backward_trainable_stacks"):
        for w in stacks:
            w.requires_grad_(label == "backward_trainable_stacks")
            w.grad = None
        x.grad = None
        moe(x).float().square().mean().backward()  # warm: the backward kernels load
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe(x).float().square().mean().backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        grads = [x.grad] + [w.grad for w in stacks if w.requires_grad]
        out[label] = {"shape": list(x.shape), "launches": read_counts(),
                      "finite": all(bool(torch.isfinite(g).all()) for g in grads)}
    emit({"phase": "moe_no_host_sync", "sync_debug_mode": "error", **out})
    del moe, x, stacks
    torch.cuda.empty_cache()
    if not all(v["finite"] for v in out.values()):
        raise RuntimeError(f"MoE layer output not finite: {out}")
    frozen = out["backward_frozen_stacks"]["launches"]
    full = out["backward_trainable_stacks"]["launches"]
    if not (frozen["grouped_matmul_dlhs"] == 3 and frozen["grouped_matmul_drhs"] == 0
            and full["grouped_matmul_dlhs"] == 3 and full["grouped_matmul_drhs"] == 3):
        raise RuntimeError(f"MoE layer backward launches: frozen {frozen}, trainable {full}")
    return out


def mixtral_slice(torch, seed: int) -> dict:
    """The Mixtral slice: MIXTRAL_LAYERS of 32 layers of Mixtral-8x7B-Instruct at full
    width, LoRA r=16 on q/k/v/proj, random weights from --seed, serving the
    decode slice's 16 requests with moe_impl "megablox" (L2, the main path,
    then profiled) and "dense" (plain einsums), one model alive at a time."""
    from dualhyp_tpu_torch.models.gpt import GPT

    cfg = mixtral_config(MIXTRAL_LAYERS)
    serve = dict(decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1)
    runs = {}
    for impl in ("megablox", "dense"):
        t0 = time.perf_counter()
        model = GPT(cfg, device="cuda", dtype=torch.bfloat16, moe_impl=impl)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model.init_weights(gen)
        random_lora_b(torch, model, gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        records, metrics, wall, launches, prompt_tokens, prefill_rows = serve_requests(
            torch, model, seed, serve, f"mixtral_{impl}" if impl == "megablox" else None)
        runs[impl] = dict(
            moe_impl=impl, build_s=build_s, wall_s=wall,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            weight_gb=sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
            metrics=metrics, launches=launches, sample=records[0], records=records)
        del model
        torch.cuda.empty_cache()
        launch = MOE_PATH if impl == "megablox" else MOE_PATH[1:]
        idle = MOE_IDLE if impl == "megablox" else MOE_IDLE + ("grouped_matmul",)
        check_served(records, metrics, launches, launch, idle, f"mixtral {impl}")
    forwards = runs["megablox"]["launches"]["grouped_matmul"] / (3 * cfg.n_layer)
    result = {"phase": "mixtral_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "n_layer_published": 32, "n_expert": cfg.n_expert,
              "n_expert_per_token": cfg.n_expert_per_token, "head_size": cfg.head_size,
              "lora_r": cfg.lora_r, "requests": 16, "prompt_tokens": prompt_tokens,
              "prefill_rows": prefill_rows,
              "decode_batch": 8, "max_new_tokens": 32, "forwards": forwards,
              **{impl: {k: v for k, v in r.items() if k != "records"}
                 for impl, r in runs.items()},
              "megablox_vs_dense": token_agreement(runs["megablox"]["records"],
                                                   runs["dense"]["records"])}
    emit(result)
    if forwards != int(forwards):
        raise RuntimeError(f"L2 launched {forwards} times 3 x {cfg.n_layer} a forward")
    return result


# L2's gradients at Mixtral's training shapes: (name, rows M, N, K); M = 8 x
# 1024 tokens x top 2
GMM_BWD_SHAPES = (("fc_1", 16384, 14336, 4096), ("proj", 16384, 4096, 14336))
# the Mixtral training slice's path: which kernels must launch and which must
# not (the expert stacks are frozen: no weight gradient; no dense MLP)
MOE_TRAIN_PATH = ("grouped_matmul", "grouped_matmul_dlhs", "flash_attention_fwd",
                  "flash_attention_bwd", "rms_norm", "apply_rope", "apply_rope_transpose")
MOE_TRAIN_IDLE = ("grouped_matmul_drhs", "swiglu_mlp", "lora_linear", "q4_matmul",
                  "full_attention_fwd", "causal_attention_fwd")


def first_that_runs(candidates):
    """The first (fn, name) of `candidates` that runs on these inputs (a
    library yardstick that this PyTorch may lack or refuse), else (None,
    None)."""
    for fn, name in candidates:
        try:
            fn()
            return fn, name
        except (RuntimeError, TypeError, ValueError, AttributeError):
            continue
    return None, None


def gmm_bwd_phase(torch, seed: int) -> dict:
    """L2's two gradients at Mixtral's training rows (16384) for fc_1 and
    proj, each with a skewed draw, empty experts and a single group: dlhs
    and drhs (each two calls bitwise equal) against their plain versions; the
    skewed draw timed beside the bound and torch._grouped_mm (dlhs: the (E,
    N, K) stack as it is; drhs: the 2-D x 2-D form with the offsets on the
    reduction axis)."""
    from dualhyp_tpu_torch.ops import gmm

    gen = torch.Generator(device="cuda").manual_seed(seed + 61)
    n_expert = 8
    out = {"grouped_matmul_dlhs": {}, "grouped_matmul_drhs": {}}
    for name, rows, n, k in GMM_BWD_SHAPES:
        w = (torch.randn((n_expert, n, k), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        for case in ("skewed", "empty", "single"):
            g = torch.randn((rows, n), generator=gen, device="cuda").to(torch.bfloat16)
            lhs = torch.randn((rows, k), generator=gen, device="cuda").to(torch.bfloat16)
            sizes = seeded_group_sizes(torch, rows, n_expert, seed + 67 + len(out), case)
            offs = torch.cumsum(sizes, 0, dtype=torch.int32)
            busy = int((sizes > 0).sum())
            flops = 2 * rows * n * k
            kernels = {
                "grouped_matmul_dlhs": (
                    lambda: gmm.grouped_matmul_dlhs(g, w, sizes),
                    lambda: gmm.grouped_matmul_dlhs_plain(g, w, sizes),
                    [(lambda: torch._grouped_mm(g, w, offs=offs, out_dtype=torch.bfloat16),
                      "torch._grouped_mm (M, N) x (E, N, K)")],
                    (rows * n + busy * n * k + rows * k) * 2 + n_expert * 4),
                "grouped_matmul_drhs": (
                    lambda: gmm.grouped_matmul_drhs(g, lhs, sizes),
                    lambda: gmm.grouped_matmul_drhs_plain(g, lhs, sizes),
                    [(lambda: torch._grouped_mm(g.t(), lhs, offs=offs, out_dtype=torch.bfloat16),
                      "torch._grouped_mm (N, M) x (M, K), offsets on M"),
                     (lambda: torch._grouped_mm(g.t().contiguous(), lhs, offs=offs,
                                                out_dtype=torch.bfloat16),
                      "torch._grouped_mm (N, M) x (M, K), offsets on M, g transposed by a copy")],
                    (rows * n + rows * k + n_expert * n * k) * 2 + n_expert * 4)}
            for kname, (fn, plain, libs, nbytes) in kernels.items():
                got = repeatable(kname, fn, torch)
                err = compare(kname, got, plain(), torch)
                del got
                entry = dict(shape=[rows, n, k], group_sizes=sizes.tolist(), max_abs_err=err,
                             repeats_bitwise=True)
                if case == "skewed":
                    lib, lib_name = first_that_runs(libs)
                    bms, by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
                    entry.update(
                        ms=time_ms(fn, torch, iters=10), device_ms=device_ms(fn, torch, iters=10),
                        plain_ms=time_ms(plain, torch, warmup=1, iters=2),
                        library_ms=time_ms(lib, torch, iters=10) if lib else None,
                        library=lib_name, bound_ms=bms, bound_by=by)
                    if lib:
                        entry["library_max_abs_err"] = float(
                            (lib().float() - plain().float()).abs().max())
                out[kname][f"{name}_{case}"] = entry
            del g, lhs
            torch.cuda.empty_cache()
        del w
    torch.cuda.empty_cache()
    for kname, entries in out.items():
        emit({"phase": "kernel", "name": kname,
              "tolerance": dict(zip(("atol", "rtol"), TOLERANCES[kname])), **entries})
    return out


def mixtral_routes(torch, model, ids):
    """Each block's top-k expert sets (L, B, T, k) of one forward without
    grad, from the MoE inputs captured by forward pre-hooks."""
    from dualhyp_tpu_torch.models.gpt import moe_top_k

    inputs = []
    hooks = [block.mlp.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
             for block in model.blocks]
    with torch.no_grad():
        model(ids)
    for hook in hooks:
        hook.remove()
    routes = [moe_top_k((x @ block.mlp.gate.weight.t()).float(), block.mlp.top_k)[1]
              for x, block in zip(inputs, model.blocks)]
    return torch.stack(routes).sort(dim=-1).values


def depth2_mixtral_train_check(torch, seed: int) -> dict:
    """One LoRA Trainer step of a depth-2, full-width Mixtral-8x7B + LoRA
    model at B16 T16 (half the labels masked), on the card (bf16, frozen
    leaves bf16) under moe_impl megablox (L2 and its dlhs, remat "moe") and
    dense (remat on), against the CPU (plain versions, fp32, megablox, no
    remat), on the same random weights: the share of (layer, token) routes
    that agree, then the loss and every LoRA gradient's relative L2 error of
    a step on the rows routed alike under both card paths."""
    import numpy as np

    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    cfg = mixtral_config(2)
    cpu = GPT(cfg, device="cpu", dtype=torch.float32, moe_impl="megablox")
    cards = {impl: GPT(cfg, device="cuda", dtype=torch.bfloat16, moe_impl=impl)
             for impl in ("megablox", "dense")}
    fill_random(torch, (cpu, *cards.values()), cfg,
                torch.Generator(device="cuda").manual_seed(seed + 71))
    rng = np.random.default_rng(seed + 73)
    b, t = 16, 16
    ids = rng.integers(3, cfg.vocab_size, size=(b, t)).astype(np.int32)
    # the trainers first: they round the card's frozen leaves (norm scales
    # included) to bf16, which moves router logits, so the routes are read
    # from the models as they train
    trainers = {impl: Trainer(cfg, TrainConfig(batch_size=b, micro_batch_size=b,
                                               frozen_dtype="bfloat16", lm_head_chunk_size=128,
                                               remat="moe" if impl == "megablox" else True),
                              model)
                for impl, model in cards.items()}
    t0 = time.perf_counter()
    want_routes = mixtral_routes(torch, cpu, torch.from_numpy(ids).long())
    routes = {impl: mixtral_routes(torch, model, torch.from_numpy(ids).long().cuda()).cpu()
              for impl, model in cards.items()}
    agree = {impl: (r == want_routes).all(-1) for impl, r in routes.items()}  # (L, B, T)
    held = (agree["megablox"] & agree["dense"]).all(0).all(-1)  # (B,)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    labels[~held.numpy()] = -1
    batch = {"input_ids": ids, "labels": labels}
    trainer = Trainer(cfg, TrainConfig(batch_size=b, micro_batch_size=b, compute_dtype="float32",
                                       lm_head_chunk_size=128), cpu)
    loss_cpu = float(trainer.train_step(batch, max_iters=100, warmup_steps=10)[0])
    g_cpu = {n: p.grad.detach().float() for n, p in trainer.trainable.items()}
    cpu_s = time.perf_counter() - t0
    del trainer, cpu
    result = {"phase": "depth2_mixtral_train_card_vs_cpu", "model": cfg.name,
              "n_layer": cfg.n_layer, "shape": [b, t], "rows_held": int(held.sum()),
              "loss_cpu": loss_cpu, "loss_atol": TRAIN_LOSS_ATOL,
              "grad_rel_tol": TRAIN_GRAD_REL, "route_agreement_min": ROUTE_AGREEMENT,
              "cpu_s": cpu_s}
    for impl, trainer in trainers.items():
        remat = trainer.cfg.remat
        reset_counts()
        loss = float(trainer.train_step(batch, max_iters=100, warmup_steps=10)[0])
        launches = read_counts()
        rel = {n: float((p.grad.detach().float().cpu() - g_cpu[n]).norm() / g_cpu[n].norm())
               for n, p in trainer.trainable.items()}
        result[impl] = {"remat": remat, "loss_card": loss, "loss_abs_err": abs(loss - loss_cpu),
                        "route_agreement": float(agree[impl].float().mean()),
                        "grad_rel_l2_err_max": max(rel.values()), "grad_rel_l2_err": rel,
                        "launches": launches}
    del trainers, trainer, cards
    torch.cuda.empty_cache()
    emit(result)
    if not 4 * int(held.sum()) >= b:
        raise RuntimeError(f"depth-2 Mixtral training: only {int(held.sum())} of {b} rows "
                           f"routed alike")
    for impl in ("megablox", "dense"):
        r = result[impl]
        if not r["loss_abs_err"] <= TRAIN_LOSS_ATOL:
            raise RuntimeError(f"depth-2 Mixtral {impl} train loss: {r}")
        if not r["route_agreement"] >= ROUTE_AGREEMENT:
            raise RuntimeError(f"depth-2 Mixtral {impl}: routes agree {r['route_agreement']}")
        bad = {n: e for n, e in r["grad_rel_l2_err"].items() if not e <= TRAIN_GRAD_REL}
        if bad:
            raise RuntimeError(f"depth-2 Mixtral {impl} LoRA gradients off: {bad}")
    got = result["megablox"]["launches"]
    if not (got["grouped_matmul"] > 0 and got["grouped_matmul_dlhs"] == 3 * cfg.n_layer
            and got["grouped_matmul_drhs"] == 0 and got["flash_attention_bwd"] == cfg.n_layer):
        raise RuntimeError(f"depth-2 Mixtral megablox training launches {got}")
    if result["dense"]["launches"]["grouped_matmul_dlhs"] != 0:
        raise RuntimeError(f"depth-2 Mixtral dense training launches {result['dense']}")
    return result


def active_flops_per_token(cfg, seq_len: int) -> float:
    """Training flops per token of an MoE counted by its active parameters:
    `estimate_train_flops_per_token` (the JAX package's count, which takes
    2 d inter for any MLP) with each layer's MLP counted as the router's E d
    and k experts of 3 d inter each instead."""
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    d, inter = cfg.n_embd, cfg.intermediate_size
    extra = cfg.n_expert * d + 3 * cfg.n_expert_per_token * d * inter - 2 * d * inter
    return estimate_train_flops_per_token(cfg, seq_len) + 3 * 2 * cfg.n_layer * extra


def mixtral_step_1024(torch, model, cfg, seed: int, remat, profile: bool, warmup: int = 1,
                      timed: int = 2) -> dict:
    """Training steps at 8 x 1024 (half the labels masked) of `model` as it
    stands: `warmup` steps, `timed` timed (the launch counts read around
    them), then one under torch.profiler. A step that does not fit the card
    runs at 8 x 512 instead, and says so."""
    import numpy as np

    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    for t in (1024, 512):
        rng = np.random.default_rng(seed)
        ids = rng.integers(1, cfg.vocab_size, size=(8, t)).astype(np.int32)
        labels = ids.copy()
        labels[:, : t // 2] = -1
        batch = {"input_ids": ids, "labels": labels}
        trainer = Trainer(cfg, TrainConfig(batch_size=8, micro_batch_size=8,
                                           frozen_dtype="bfloat16", lm_head_chunk_size=128,
                                           remat=remat), model)
        gen = torch.Generator().manual_seed(seed)
        try:
            for _ in range(warmup):
                trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            times = []
            for _ in range(timed):
                t0 = time.perf_counter()
                loss, _ = trainer.train_step(batch, max_iters=1000, warmup_steps=10,
                                             generator=gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as exc:
            del trainer
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            emit({"phase": "mixtral_train_step_oom", "remat": remat, "seq_len": t,
                  "error": str(exc).splitlines()[0][:200]})
            continue
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        step = min(times)
        out = {"remat": remat, "moe_impl": model.moe_impl, "shape": [8, t], "step_s": times,
               "tokens_per_s": 8 * t / step,
               "mfu_active": 8 * t * active_flops_per_token(cfg, t) / step / BF16_TENSOR_FLOPS,
               "peak_mem_gb": peak, "loss": float(loss), "launches": launches}
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.train_step(batch, max_iters=1000, warmup_steps=10, generator=gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            out["profile"] = {**step_kernel_ms(prof), **profile_summary(prof, wall_ms, top_n=8)}
            del prof
        del trainer
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        return out
    raise RuntimeError(f"a Mixtral training step with remat={remat!r} fits neither 8 x 1024 "
                       f"nor 8 x 512")


def mixtral_train_slice(torch, seed: int) -> dict:
    """LoRA finetuning of Mixtral-8x7B-Instruct, MIXTRAL_LAYERS of 32 layers
    at full width (random bf16 weights from --seed), moe_impl megablox,
    through `cli.finetune_ger.run_training` with the CLI's settings (frozen
    leaves bf16, LoRA r=16 alpha=16 dropout 0.05, remat): batch 16 of micro
    batches 8, 32 synthetic DualHyp train records and 8 val records, 2
    epochs = 4 optimizer steps, the checkpoints holding the LoRA leaves
    alone (`adapter_only`, the CLI's --save_adapter_only: the whole tree of
    16 layers is 47 GB a file); then the best checkpoint is read back into the model and
    4 requests are decoded
    from it. Then the 8 x 1024 step with remat on and with remat "moe" (each
    profiled), and dense once."""
    from dualhyp_tpu_torch.ckpt.convert import load_tree
    from dualhyp_tpu_torch.ckpt.io import load_params
    from dualhyp_tpu_torch.cli.finetune_ger import run_training
    from dualhyp_tpu_torch.cli.inference_ger import run_inference
    from dualhyp_tpu_torch.data import collate, hypotheses, prompts, synthetic
    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    cfg = config_from_name(MIXTRAL, n_layer=MIXTRAL_LAYERS, lora_r=16, lora_alpha=16,
                           lora_dropout=0.05, lora_query=True, lora_key=True, lora_value=True,
                           lora_projection=True)
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, moe_impl="megablox")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tcfg = TrainConfig(batch_size=16, micro_batch_size=8, num_epochs=2,
                       frozen_dtype="bfloat16", remat=True, seed=seed,
                       log_interval=16, save_interval=10**6)
    template_words = " ".join(prompts.DualHyp_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)))
    lora = sorted(model.trainable_parameters())
    before = {n: model.get_parameter(n).detach().clone() for n in lora}
    step_ends, step_shapes = [], []

    def on_step(opt_step, loss, lr):
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, n, s in (("train", 32, seed), ("val", 8, seed + 1), ("test", 4, seed + 2)):
            synthetic.write_json(tmp / f"{name}.json",
                                 synthetic.make_records(n_uids=n, n_hyps=5, seed=s))

        def dataset(split):
            return hypotheses.DualHypothesesDataset(
                split, str(tmp / f"{split}.json"), tokenizer=tok,
                prompts_format="DualHyp", max_input_length=1024, seed=seed)

        train_ds, val_ds = dataset("train"), dataset("val")
        for epoch in range(tcfg.num_epochs):
            for batch in collate.epoch_batches(dataset("train"), tcfg.batch_size, shuffle=True,
                                               seed=tcfg.seed, epoch=epoch, length_sorted=True):
                step_shapes.append(batch["input_ids"].shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = run_training(model, tok, train_ds, val_ds, tcfg, tmp / "run",
                           generator=torch.Generator().manual_seed(seed), on_step=on_step,
                           adapter_only=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(x) for x in out["losses"]]
        changed = [n for n in lora if not torch.equal(before[n], model.get_parameter(n))]
        del before, out
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        saved = {f.name: f.stat().st_size for f in (tmp / "run").iterdir()}

        # the best checkpoint read back into the model: its LoRA leaves are
        # the trained ones, then 4 requests decode from it
        t1 = time.perf_counter()
        tree = load_params(tmp / "run" / "best_model.npz")
        trained = {n: model.get_parameter(n).detach().clone() for n in lora}
        load_tree(model, tree, strict=False)
        del tree
        reload_s = time.perf_counter() - t1
        mismatch = [n for n in lora if not torch.equal(trained[n], model.get_parameter(n))]
        del trained
        records, metrics = run_inference(model, tok, dataset("test"), decode_batch=4,
                                         max_new_tokens=16, top_k=1)
    step_s = [b - a for a, b in zip([t0] + step_ends[:-1], step_ends)]
    tokens = [shape[0] * shape[1] for shape in step_shapes]
    train_s = step_ends[-1] - t0
    flops_jax = sum(n * estimate_train_flops_per_token(cfg, shape[1])
                    for n, shape in zip(tokens, step_shapes))
    flops_active = sum(n * active_flops_per_token(cfg, shape[1])
                       for n, shape in zip(tokens, step_shapes))
    result = {"phase": "mixtral_train_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "n_layer_published": 32, "moe_impl": "megablox", "lora_r": cfg.lora_r,
              "lora_dropout": cfg.lora_dropout, "remat": True, "build_s": build_s,
              "batch_size": tcfg.batch_size, "micro_batch_size": tcfg.micro_batch_size,
              "optimizer_steps": len(losses), "step_shapes": [list(x) for x in step_shapes],
              "losses": losses, "step_s": step_s, "tokens_per_s": sum(tokens) / train_s,
              "mfu_jax_count": flops_jax / train_s / BF16_TENSOR_FLOPS,
              "mfu_active": flops_active / train_s / BF16_TENSOR_FLOPS,
              "active_flops_note": "router E d plus k = 2 experts of 3 d inter a layer",
              "wall_s": wall, "peak_mem_gb": peak_gb, "launches": launches,
              "lora_leaves_changed": f"{len(changed)}/{len(lora)}", "saved_bytes": saved,
              "reload_s": reload_s, "reload_mismatch": mismatch, "decoded": records[0],
              "decode_metrics": metrics}
    emit(result)
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"Mixtral training losses {losses}")
    if len(changed) != len(lora) or mismatch:
        raise RuntimeError(f"Mixtral LoRA leaves: {len(changed)}/{len(lora)} changed, "
                           f"reload mismatch {mismatch}")
    if len(records) != 4 or not all(isinstance(r["inference"], str) for r in records):
        raise RuntimeError("the Mixtral checkpoint did not decode every request")
    missing = [name for name in MOE_TRAIN_PATH if launches[name] <= 0]
    stray = [name for name in MOE_TRAIN_IDLE if launches[name] != 0]
    if missing or stray:
        raise RuntimeError(f"Mixtral training slice launches: never {missing}, "
                           f"off the path {stray}")

    steps = {}
    for label, remat in (("remat", True), ("remat_moe", "moe")):
        steps[label] = mixtral_step_1024(torch, model, cfg, seed, remat, profile=True)
        emit({"phase": "mixtral_train_step_1024", "label": label, **steps[label]})
    # L1 at head size 128 on a path: the same step with remat, attention
    # through splash (DUALHYP_ATTN_IMPL, read at each call)
    with attn_impl("splash"):
        steps["splash_remat"] = mixtral_step_1024(torch, model, cfg, seed, True, profile=True,
                                                  warmup=2, timed=3)
    emit({"phase": "mixtral_train_step_1024", "label": "splash_remat", **steps["splash_remat"]})
    for block in model.blocks:  # the same weights through the dense einsums
        block.mlp.impl = "dense"
    model.moe_impl = "dense"
    steps["dense_remat"] = mixtral_step_1024(torch, model, cfg, seed, True, profile=False)
    emit({"phase": "mixtral_train_step_1024", "label": "dense_remat", **steps["dense_remat"]})
    del model
    torch.cuda.empty_cache()
    for label, r in steps.items():
        got = r["launches"]
        if not math.isfinite(r["loss"]) or got["grouped_matmul_drhs"] or got["swiglu_mlp"]:
            raise RuntimeError(f"Mixtral 8 x 1024 step {label}: {r}")
        if (got["grouped_matmul_dlhs"] > 0) != (label != "dense_remat"):
            raise RuntimeError(f"Mixtral 8 x 1024 step {label} launches {got}")
        splash_on = label == "splash_remat"  # L1's three kernels and K1 never, or K1 both ways
        if (any(got[n] <= 0 for n in SPLASH_KERNELS) if splash_on else
                any(got[n] for n in SPLASH_KERNELS)) or \
                any((got[n] > 0) == splash_on for n in ("flash_attention_fwd",
                                                         "flash_attention_bwd")):
            raise RuntimeError(f"Mixtral 8 x 1024 step {label} attention launches {got}")
    forwards = {label: steps[label]["launches"]["grouped_matmul"] / (3 * cfg.n_layer)
                for label in ("remat", "remat_moe")}
    result["step_1024"] = steps
    result["l2_forwards_per_step"] = forwards
    return result


# ---- a verify step's rows, speculative decoding, serving, RelPrompt training ----

# a verify step's rows: slots x (draft_len + 1) at draft 8, for 1, 4, 8 and 16
# slots; they cross K8's decode threshold (16 rows), K5's (32), K4's (64)
VERIFY_ROWS = (9, 36, 72, 144)
DRAFT_LEN = 8


def verify_rows_phase(torch, seed: int) -> dict:
    """K4, K5 (the fused QKV at rank 48 and proj at rank 16) and K8 (qkv and
    fc_1) at a verify step's rows, each against its plain version (two calls
    bitwise equal), timed beside its bound and its cuBLAS yardstick; the
    rows on a middle path (K4 above 64 rows, K5 above 32, K8 above 16)
    beside the parent's design on the same inputs (`was_device_ms`)."""
    from dualhyp_tpu_torch.ops import lora, quant, swiglu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 61)
    bf16 = torch.bfloat16
    d, inter = 2048, 5632

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    out = {"swiglu_mlp": {}, "lora_linear": {}, "q4_matmul": {}}
    w1, w2 = randn(inter, d, std=0.02), randn(inter, d, std=0.02)
    w3 = randn(d, inter, std=0.02)
    for rows in VERIFY_ROWS:
        x = randn(rows, d)
        fn = lambda: swiglu.swiglu_mlp(x, w1, w2, w3)  # noqa: E731
        plain = lambda: swiglu.swiglu_mlp_plain(x, w1, w2, w3)  # noqa: E731
        library = lambda: (  # noqa: E731
            torch.nn.functional.silu(x @ w1.t()) * (x @ w2.t())) @ w3.t()
        bms, by = bound((2 * rows * d + 3 * inter * d) * 2, 6 * rows * d * inter,
                        BF16_TENSOR_FLOPS)
        path_of = getattr(swiglu, "path_of", None)  # None in a parent measured in turns
        path = (path_of(rows) if path_of else
                "decode" if rows <= swiglu.DECODE_ROWS else "rows")
        row = out["swiglu_mlp"][f"verify_{rows}"] = dict(
            shape=[rows, d, inter], path=path,
            max_abs_err=compare("swiglu_mlp", repeatable("swiglu_mlp", fn, torch), plain(),
                                torch),
            repeats_bitwise=True, ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
            plain_ms=time_ms(plain, torch, warmup=1, iters=20),
            library_ms=time_ms(library, torch), library_device_ms=device_ms(library, torch),
            bound_ms=bms, bound_by=by)
        row["share_of_bound"] = bms / row["device_ms"]
        if path == "mid":
            plan = swiglu.mid_plan(rows, d, inter)
            row["plan"] = {"pdl": plan["pdl"], **{
                stage: {k: plan[stage][k] for k in ("tokens", "wg", "cluster", "ctas", "smem")}
                for stage in ("gate", "down")}}
            row["was_device_ms"] = parent_path_ms(torch, swiglu, fn)
            row["was"] = "the parent's row tiles on the same inputs"
    r = LORA_RANK
    for name, o, dd, blocks in LORA_SHAPES:
        w = randn(o, dd, std=0.02)
        a = randn(blocks * r, dd, std=1 / math.sqrt(dd))
        shapes = (dd, (o - dd) // 2, (o - dd) // 2) if blocks == 3 else (o,)
        b = lora.lora_qkv_block_b(randn(o, r, std=0.02), shapes, r)
        for rows in VERIFY_ROWS:
            out["lora_linear"][f"{name}_verify_{rows}"] = lora_row(
                torch, randn(rows, dd), w, a, b, 1.0)
    for name, n, k in Q4_SHAPES:
        if name not in ("qkv", "fc_1"):
            continue
        packed, scales = quant.quantize_weight_int4(randn(n, k, std=0.02, dtype=torch.float32))
        w_deq = quant.dequantize_weight_int4(packed, scales, bf16)
        for rows in VERIFY_ROWS:
            out["q4_matmul"][f"{name}_verify_{rows}"] = q4_mid_row(
                torch, randn(rows, k), packed, scales, w_deq)
    for name, entry in out.items():
        emit({"phase": "kernel_verify_rows", "name": name,
              "tolerance": dict(zip(("atol", "rtol"), TOLERANCES[name])), **entry})
    torch.cuda.empty_cache()
    return out


def depth2_verify_check(torch, seed: int) -> dict:
    """A depth-2, full-width TinyLlama + LoRA model from seeded numpy
    weights: `verify_step` logits of K = 9 tokens a row on the card (bf16,
    kernels) against 9 successive `decode_step`s on the card and against
    the CPU's `verify_step` (plain, fp32), each within DEPTH2_ATOL."""
    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import params_from_jax

    cfg = lora_config(2)
    tree = numpy_tree(cfg, seed)
    card = params_from_jax(tree, cfg, device="cuda", dtype=torch.bfloat16)
    cpu = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    del tree
    rng = np.random.default_rng(seed + 5)
    t, k = 96, DRAFT_LEN + 1
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, t)))
    lengths = torch.tensor([96, 80, 50, 33])
    for i, n in enumerate(lengths.tolist()):
        ids[i, n:] = 0
    chunk = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, k)))
    slots = t + k + 1

    def prefilled(model, device):
        cache = model.init_cache(4, slots)
        model.prefill(ids.to(device), lengths.to(device), cache)
        return cache

    cache = prefilled(card, "cuda")
    reset_counts()
    got = card.verify_step(chunk.cuda(), lengths.cuda(), cache).cpu()
    launches = read_counts()
    cache = prefilled(card, "cuda")
    steps = torch.stack([card.decode_step(chunk[:, i].cuda(), (lengths + i).cuda(), cache)
                         for i in range(k)], dim=1).cpu()
    want = cpu.verify_step(chunk, lengths, prefilled(cpu, "cpu"))
    err_cpu = float((got - want).abs().max())
    err_steps = float((got - steps).abs().max())
    result = {"phase": "depth2_verify_card_vs_cpu", "shape": [4, t, k], "rows": 4 * k,
              "max_abs_err_vs_cpu": err_cpu, "max_abs_err_vs_decode_steps": err_steps,
              "tolerance": DEPTH2_ATOL, "logit_std": float(want.std()),
              "argmax_agree_vs_cpu": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
              "argmax_agree_vs_decode_steps": float(
                  (got.argmax(-1) == steps.argmax(-1)).float().mean()),
              "launches": launches}
    emit(result)
    del card, cpu
    torch.cuda.empty_cache()
    if not (err_cpu <= DEPTH2_ATOL and err_steps <= DEPTH2_ATOL):
        raise RuntimeError(f"depth-2 verify logits: vs CPU {err_cpu}, vs decode steps "
                           f"{err_steps} > {DEPTH2_ATOL}")
    if any(launches[n] <= 0 for n in ("rms_norm", "swiglu_mlp")):
        raise RuntimeError(f"depth-2 verify step launches {launches}")
    return result


def relprompt_numpy_tree(cfg, seed: int) -> dict:
    """`numpy_tree` with the 3 mask-token rows appended to `wte` and the two
    classifiers (torch's default bounds, biases N(0, 0.1))."""
    import numpy as np

    tree = numpy_tree(cfg, seed)
    rng = np.random.default_rng(seed + 8)
    wte = tree["wte"]["weight"]
    extra = rng.standard_normal((cfg.n_extra_tokens, cfg.n_embd), dtype=np.float32) * wte.std()
    tree["wte"]["weight"] = np.concatenate([wte, extra])
    h = cfg.classifier_hidden_dim

    def layer(shape):
        fan_in = int(np.prod(shape[1:]))
        return {"weight": rng.uniform(-1, 1, size=shape).astype(np.float32) / math.sqrt(fan_in),
                "bias": rng.standard_normal(shape[0], dtype=np.float32) * np.float32(0.1)}

    for name, dim in (("audio_noise_classifier", cfg.whisper_dim),
                      ("visual_noise_classifier", cfg.raven_dim)):
        tree[name] = {"conv1": layer((h, dim, 3)), "conv2": layer((h, h, 3)),
                      "classifier": layer((3, h))}
    return tree


def depth2_relprompt_train_check(torch, seed: int) -> dict:
    """One `RelPromptTrainer` step of a depth-2, full-width TinyLlama + LoRA
    RelPrompt model (the classifiers over Whisper-large's 1280 and BRAVEn's
    1024 feature widths, the 3 mask-token rows) from seeded numpy weights,
    LoRA through K5 (DUALHYP_LORA_IMPL=fused), dropout off: the total and
    LLM losses (TRAIN_LOSS_ATOL), the LoRA gradients (TRAIN_GRAD_REL), the
    classifier gradients and the mask loss (CLASSIFIER_REL_TOL), card
    (bf16 LLM, fp32 classifiers) against CPU fp32."""
    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import load_tree
    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import RelPromptTrainConfig, RelPromptTrainer

    cfg = lora_config(2).replace(use_relprompt=True, n_extra_tokens=3)
    tree = relprompt_numpy_tree(cfg, seed)
    rng = np.random.default_rng(seed + 9)
    b, t, pool = 2, 160, cfg.classifier_pool_size
    ids = rng.integers(3, cfg.effective_padded_vocab_size, size=(b, t)).astype(np.int32)
    labels = np.where(ids < cfg.padded_vocab_size, ids, -1)
    labels[:, : t // 2] = -1
    batch = {"input_ids": ids, "labels": labels,
             "audio_features": rng.standard_normal((b, 6 * 2 * pool, cfg.whisper_dim),
                                                   dtype=np.float32),
             "visual_features": rng.standard_normal((b, 6 * pool, cfg.raven_dim),
                                                    dtype=np.float32),
             "audio_mask_targets": rng.integers(0, 3, size=(b, 6)),
             "visual_mask_targets": rng.integers(0, 3, size=(b, 6))}
    results = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        tcfg = RelPromptTrainConfig(batch_size=b, micro_batch_size=b, compute_dtype=dtype,
                                    frozen_dtype="bfloat16" if device == "cuda" else "",
                                    lm_head_chunk_size=128, remat=True)
        model = GPT(cfg, device=device, dtype=getattr(torch, dtype), lora_impl="fused")
        load_tree(model, tree)
        trainer = RelPromptTrainer(cfg, tcfg, model)
        if device == "cuda":
            reset_counts()
        out = trainer.train_step(batch, max_iters=100, warmup_steps=10)
        if device == "cuda":
            launches = read_counts()
        results[device] = ({k: float(out[k]) for k in ("loss", "llm_loss", "mask_loss")},
                           {n: p.grad.detach().float().cpu() for n, p in trainer.trainable.items()})
        del trainer, model
    torch.cuda.empty_cache()
    (loss_card, g_card), (loss_cpu, g_cpu) = results["cuda"], results["cpu"]
    rel = {n: float((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm()) for n in g_cpu}
    loss_err = {k: abs(loss_card[k] - loss_cpu[k]) for k in loss_card}
    mask_rel = loss_err["mask_loss"] / abs(loss_cpu["mask_loss"])
    tol = {n: CLASSIFIER_REL_TOL if "noise_classifier" in n else TRAIN_GRAD_REL for n in rel}
    result = {"phase": "depth2_relprompt_train_card_vs_cpu", "lora_impl": "fused",
              "shape": [b, t], "launches": launches, "loss_card": loss_card,
              "loss_cpu": loss_cpu, "loss_abs_err": loss_err, "loss_atol": TRAIN_LOSS_ATOL,
              "mask_loss_rel_err": mask_rel,
              "grad_rel_l2_err_max": {"lora": max(e for n, e in rel.items() if "lora_" in n),
                                      "classifier": max(e for n, e in rel.items()
                                                        if "noise_classifier" in n)},
              "grad_rel_l2_err": rel,
              "grad_rel_tol": {"lora": TRAIN_GRAD_REL, "classifier": CLASSIFIER_REL_TOL},
              "mask_loss_rel_tol": CLASSIFIER_REL_TOL}
    emit(result)
    if not (all(e <= TRAIN_LOSS_ATOL for e in loss_err.values())
            and mask_rel <= CLASSIFIER_REL_TOL):
        raise RuntimeError(f"depth-2 RelPrompt losses: card {loss_card} vs CPU {loss_cpu}")
    bad = {n: e for n, e in rel.items() if not e <= tol[n]}
    if bad:
        raise RuntimeError(f"depth-2 RelPrompt gradients off: {bad}")
    missing = [n for n in RELPROMPT_TRAIN_PATH if n != "full_attention_fwd" and launches[n] <= 0]
    if missing:
        raise RuntimeError(f"depth-2 RelPrompt step never launched {missing}")
    return result


@contextlib.contextmanager
def lora_impl_env(name: str):
    """DUALHYP_LORA_IMPL set to `name` for the block (`GPT` reads it when it
    is built)."""
    old = os.environ.get("DUALHYP_LORA_IMPL")
    os.environ["DUALHYP_LORA_IMPL"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["DUALHYP_LORA_IMPL"]
        else:
            os.environ["DUALHYP_LORA_IMPL"] = old


def write_wavs(records, tmp: Path, seed: int) -> None:
    """Each record's clean and noise WAVs from seeded noise (16 kHz int16)."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    for rec in records:
        n = rec["Audio_Corruption"]["total_len"]
        rec["Clean_Wav"] = str(tmp / f"{rec['Uid']}_clean.wav")
        rec["Noise_Wav"] = str(tmp / f"{rec['Uid']}_noise.wav")
        wavfile.write(rec["Clean_Wav"], 16000, (rng.standard_normal(n) * 3000).astype(np.int16))
        wavfile.write(rec["Noise_Wav"], 16000,
                      (rng.standard_normal(n // 3) * 3000).astype(np.int16))


def relprompt_tokenizer(cfg):
    """The word tokenizer over the synthetic vocabulary and the RelPrompt
    template, with the mask tokens at the rows above the model's vocabulary."""
    from dualhyp_tpu_torch.cli.inference_relprompt import add_mask_tokens
    from dualhyp_tpu_torch.data import prompts, synthetic

    template_words = " ".join(prompts.RelPrompt_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)),
                        special_base=cfg.padded_vocab_size)
    add_mask_tokens(tok)
    return tok


# the RelPrompt training path: K6 for the features, then the LLM's forward
# and backward with K5 (DUALHYP_LORA_IMPL=fused)
RELPROMPT_TRAIN_PATH = ("full_attention_fwd", "rms_norm", "apply_rope", "apply_rope_transpose",
                        "flash_attention_fwd", "flash_attention_bwd", "swiglu_mlp",
                        "lora_linear")


def relprompt_train_slice(torch, seed: int, whisper: Path) -> dict:
    """`cli.finetune_relprompt.main` on the full-width TinyLlama-1.1B-Chat
    RelPrompt config (22 layers, 32000 + 3 embedding rows, LoRA r=16 on
    q/k/v/proj, random weights from --seed: the checkpoint directory holds
    no weights), features through `--whisper_checkpoint` (the random
    Whisper-large-v3 on the card, K6), 32 train and 8 val records, micro
    batch 8, one epoch = 4 optimizer steps, one validation, the saves; the
    LoRA linears through K5. The card's machine has no `tokenizers`: the
    CLI's tokenizer loader returns the word tokenizer. Then the saved
    `best_model.npz` is read back by `ckpt.io` and held against the trained
    leaves, and one step is profiled."""
    from unittest import mock

    import numpy as np

    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.ckpt.convert import flat_from_named
    from dualhyp_tpu_torch.ckpt.io import load_params
    from dualhyp_tpu_torch.cli import common, finetune_relprompt
    from dualhyp_tpu_torch.data import collate, synthetic

    cfg = config_from_name("tiny-llama-1.1b-chat", use_relprompt=True, n_extra_tokens=3)
    tok = relprompt_tokenizer(cfg)
    feature_s, step_ends, fed = [], [], []
    build = finetune_relprompt.build_feature_batch

    def timed_features(examples, loader, rng, cfg_):
        t1 = time.perf_counter()
        out = build(examples, loader, rng, cfg_)
        torch.cuda.synchronize()
        feature_s.append(time.perf_counter() - t1)
        fed.append(examples)
        return out

    def on_step(opt_step, out):
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "tiny-llama-1.1b-chat"  # the registry's config, no weights
        ckpt.mkdir()
        for name, n, s in (("train", 32, seed + 3), ("val", 8, seed + 4)):
            records = synthetic.make_records(n_uids=n, n_hyps=5, seed=s)
            write_wavs(records, tmp, s)
            synthetic.write_json(tmp / f"{name}.json", records)
        argv = ["--train_path", str(tmp / "train.json"), "--val_path", str(tmp / "val.json"),
                "--llm_checkpoint", str(ckpt), "--dual_hypotheses", "--prompts_format",
                "RelPrompt", "--whisper_checkpoint", str(whisper), "--device", "cuda",
                "--micro_batch_size", "8", "--num_epochs", "1", "--log_interval", "4",
                "--seed", str(seed), "--exp_name", "relprompt_train"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.chdir(tmp), lora_impl_env("fused"), \
                mock.patch.object(common, "load_tokenizer", lambda _dir: tok), \
                mock.patch.object(finetune_relprompt, "build_feature_batch", timed_features):
            out = finetune_relprompt.main(argv, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run = tmp / "runs" / "relprompt_train"
        saved = sorted(f.name for f in run.iterdir())
        trainer = out["trainer"]
        tree = load_params(run / "best_model.npz")
        flat = flat_from_named(trainer.trainable, cfg.n_layer, device="cpu")
        reload_mismatch = []
        for key, want in flat.items():
            got = tree
            for part in key.split("::"):
                got = got[part]
            if not np.array_equal(np.asarray(got), want.numpy()):
                reload_mismatch.append(key)
        wte_rows = int(np.asarray(tree["wte"]["weight"]).shape[0]) if not isinstance(
            tree["wte"]["weight"], torch.Tensor) else int(tree["wte"]["weight"].shape[0])
        del tree

        # the padded shape of each step (the batches the features were built
        # for: the train steps', then the validation's)
        n_steps = len(out["steps"])
        step_shapes = [list(collate.pad_batch(ex)["input_ids"].shape) for ex in fed[:n_steps]]
        # one more step under torch.profiler, on the last step's examples with
        # seeded features of their lengths
        from torch.profiler import ProfilerActivity, profile

        batch = collate.pad_batch(fed[n_steps - 1])
        batch.update(build(fed[n_steps - 1], finetune_relprompt.feature_loader(
            argparse.Namespace(whisper_checkpoint=None, feature_dir=None,
                               synthetic_features=True), cfg), np.random.default_rng(seed),
            cfg))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.train_step(batch, out["max_iters"], out["warmup_steps"])
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t1) * 1e3
    emit({"phase": "relprompt_train_profile", "step_shape": list(batch["input_ids"].shape),
          **profile_summary(prof, prof_wall_ms, top_n=12)})
    steps = out["steps"]
    step_s = [b - a for a, b in zip([t0] + step_ends[:-1], step_ends)]
    # a step's interval less its batch's feature extraction (the encoder)
    train_s = [s - f for s, f in zip(step_s, feature_s)]
    tokens = [shape[0] * shape[1] for shape in step_shapes]
    result = {"phase": "relprompt_train_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "embedding_rows": wte_rows, "lora_r": trainer.model_cfg.lora_r,
              "lora_impl": "fused", "remat": True, "micro_batch_size": 8,
              "optimizer_steps": len(steps), "step_shapes": step_shapes,
              "step_s": step_s, "feature_s_per_batch": feature_s[:len(steps)],
              "feature_s_validation": sum(feature_s[len(steps):]),
              "train_step_ms": [s * 1e3 for s in train_s],
              "tokens_per_s": sum(tokens) / sum(train_s),
              # after the first step (the process's first backward of these
              # shapes)
              "tokens_per_s_steps_2_on": sum(tokens[1:]) / sum(train_s[1:]),
              "train_step_ms_median": sorted(train_s)[len(train_s) // 2] * 1e3,
              "wall_s": wall,
              "peak_mem_gb": peak_gb,
              "losses": [float(s["loss"]) for s in steps],
              "llm_losses": [float(s["llm_loss"]) for s in steps],
              "mask_losses": [float(s["mask_loss"]) for s in steps],
              "lrs": [(s["lr"], s["classifier_lr"]) for s in steps],
              "validation": out["validation"], "saved": saved,
              "reload_mismatch": reload_mismatch, "launches": launches}
    emit(result)
    del trainer, out
    torch.cuda.empty_cache()
    if len(steps) != 4 or not all(math.isfinite(x) for x in result["losses"]):
        raise RuntimeError(f"RelPrompt training losses {result['losses']}")
    if reload_mismatch or wte_rows != cfg.effective_padded_vocab_size:
        raise RuntimeError(f"best_model.npz did not read back: {reload_mismatch}, "
                           f"{wte_rows} embedding rows")
    if not {"best_model.npz", "model_relprompt_finetuned.npz", "train_state.npz"} <= set(saved):
        raise RuntimeError(f"RelPrompt training saved {saved}")
    missing = [name for name in RELPROMPT_TRAIN_PATH if launches[name] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the RelPrompt training path: {missing}")
    return result


def count_syncs(torch, fn):
    """(fn's result, the host syncs torch reports while it runs: sync debug
    mode "warn", each warning counted). The mode before is restored after;
    the syncs of a count nested inside fn are that count's, not this one's."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    # "called a synchronizing CUDA operation"; not the notice that the debug
    # mode is a prototype, which the process's first switch to it prints
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


# the speculative decode path: K1 (prefill), K2, K3 (prefill), K4; a verify
# step's K4 at 72 rows runs its middle path
SPEC_PATH = DECODE_PATH
SPEC_MODES = {"lookup": dict(speculative="lookup"), "anchored": dict(speculative="anchored"),
              "continuous": dict(scheduler="continuous")}


def spec_decode_slice(torch, seed: int, reference: dict) -> dict:
    """The decode slice's model and 16 requests (decode batch 8, 32 new
    tokens, greedy) through `run_inference` with --speculative lookup,
    --speculative anchored and --scheduler continuous (draft 8): p50,
    tokens/s, tokens a row emits a verify step, verify steps, launches,
    greedy agreement with the bf16 decode slice; the lookup run once more
    with torch's sync debug mode counting host syncs; one batch of seeded
    prompts through `generate_lookup` under torch.profiler; one
    `lookup_step` alone under sync debug "error"."""
    from dualhyp_tpu_torch.infer.decode import lookup_step
    from dualhyp_tpu_torch.models.gpt import GPT

    cfg = lora_config(DECODE_LAYERS)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl="xla")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.init_weights(gen)
    random_lora_b(torch, model, gen)
    runs = {}
    for mode, options in SPEC_MODES.items():
        serve = dict(decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1,
                     kv_quant=None, draft_len=DRAFT_LEN, **options)
        records, metrics, wall, launches, prompt_tokens, _ = serve_requests(
            torch, model, seed, serve)
        steps = metrics["verify_steps"]
        runs[mode] = {"metrics": metrics, "wall_s": wall, "prompt_tokens": prompt_tokens,
                      "launches": launches,
                      "launches_per_verify_step": {k: v / steps for k, v in launches.items()
                                                   if v},
                      "vs_bf16_slice": token_agreement(records, reference["records"]),
                      "sample": records[0]}
        check_served(records, metrics, launches, SPEC_PATH, ("lora_linear", "q4_matmul"),
                     f"speculative {mode}")
        if mode != "continuous" and launches["swiglu_mlp_mid"] <= 0:
            raise RuntimeError(f"speculative {mode} never ran K4's middle path at "
                               f"{8 * (DRAFT_LEN + 1)} verify rows")
    # host syncs of the whole lookup run (the loop reads one flag a verify
    # step; the prefill and the copies back add theirs)
    serve = dict(decode_batch=8, max_new_tokens=32, top_k=1, draft_len=DRAFT_LEN,
                 speculative="lookup")
    (_, metrics, *_), syncs = count_syncs(torch, lambda: serve_requests(torch, model, seed,
                                                                        serve))
    # where a verify step's time goes: one batch of 8 seeded prompts of 192
    # tokens (the slice's bucket), 16 new tokens, under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    from dualhyp_tpu_torch.infer.decode import generate_lookup

    b, t = 8, 192
    ids = torch.randint(3, cfg.vocab_size, (b, t), generator=gen, device="cuda")
    lengths = torch.full((b,), t, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, _, (prof_steps, _) = generate_lookup(model, ids, lengths, max_new_tokens=16,
                                                draft_len=DRAFT_LEN, return_steps=True)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    emit({"phase": "spec_decode_profile", "batch": [b, t], "max_new_tokens": 16,
          "verify_steps": prof_steps, **profile_summary(prof, prof_wall_ms)})
    # a verify step alone makes no host sync
    cache = model.init_cache(b, t + 2 * (DRAFT_LEN + 1))
    first = model.prefill(ids, lengths, cache).argmax(-1)
    tokens = torch.zeros((b, t + 2 * (DRAFT_LEN + 1)), dtype=torch.long, device="cuda")
    tokens[:, :t] = ids
    state = (tokens, lengths, torch.zeros_like(lengths), cache,
             torch.zeros(b, dtype=torch.bool, device="cuda"), first, 0)
    lookup_step(model, state, draft_len=DRAFT_LEN, ngram=3, eos_id=None, max_new_tokens=32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lookup_step(model, state, draft_len=DRAFT_LEN, ngram=3, eos_id=None,
                    max_new_tokens=32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    result = {"phase": "spec_decode_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "decode_batch": 8, "max_new_tokens": 32, "draft_len": DRAFT_LEN,
              "verify_rows": 8 * (DRAFT_LEN + 1), "runs": runs,
              "host_syncs_lookup_run": syncs, "verify_steps_lookup_run": metrics["verify_steps"],
              "host_syncs_per_verify_step": syncs / metrics["verify_steps"],
              "lookup_step_host_syncs": 0}
    emit(result)
    del model, cache, state
    torch.cuda.empty_cache()
    return result


def serve_traffic(seed: int, n: int = 24):
    """`n` synthetic DualHyp requests for the batcher: (id, prompt ids,
    budget drawn from 16-64, best-hypothesis ids), with the word tokenizer."""
    import numpy as np

    from dualhyp_tpu_torch.data import hypotheses, prompts, synthetic

    template_words = " ".join(prompts.DualHyp_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)))
    rng = np.random.default_rng(seed + 17)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve.json"
        synthetic.write_json(path, synthetic.make_records(n_uids=n, n_hyps=5, seed=seed + 17))
        ds = hypotheses.DualHypothesesDataset("test", str(path), tokenizer=tok,
                                              prompts_format="DualHyp", seed=seed)
        requests = []
        for i in range(len(ds)):
            ex = ds[i]
            best = ex.records[0]["nhyps_asr"]["hyps"][0]
            requests.append((i, list(ex.input_ids_no_response), int(rng.integers(16, 65)),
                             tok.encode(best)))
    return tok, requests


# (label, draft source, KV cache, profiled); "fused_lora" runs a copy of the
# model built with lora_impl "fused" (K5 at 144 verify rows, its middle
# kernel), "int4" the model merged and quantized (K8 at 144 rows); every
# run but int4 takes K4's middle path at 144 rows
SERVE_RUNS = (("bf16_lookup", "lookup", None, True), ("bf16_anchored", "anchored", None, False),
              ("int8_kv", "lookup", "int8", False), ("fused_lora", "lookup", None, True),
              ("int4", "anchored", None, True))


def serve_slice(torch, seed: int) -> dict:
    """`ContinuousBatcher` on the decode slice's model: 16 slots, draft 8,
    chunks of 8 verify steps, 24 requests with budgets of 16-64 tokens, in
    bf16 (lookup, anchored), with the int8 KV cache, with LoRA through K5
    (lora_impl "fused": K5 at 144 rows, its middle kernel) and merged +
    int4 (--quantize int4: K8 at 144 rows, its middle kernel); K4 at 144
    rows on its middle path in every run but int4. Each chunk
    runs under torch's sync debug mode "error" (a host sync raises); the
    whole serve runs under "warn", each refill counted on its own: each
    run reports p50, tokens/s, chunks, the host syncs a chunk outside the
    refills (its status read and the finished rows' gathers) and a refill.
    In the bf16 lookup, fused and int4 runs one chunk of the full pool is
    profiled. Then `cli.serve_ger.Server` answers 4 requests over TCP on
    127.0.0.1."""
    import socket
    import threading

    import numpy as np

    from dualhyp_tpu_torch.cli import serve_ger
    from dualhyp_tpu_torch.infer.serve import ContinuousBatcher
    from dualhyp_tpu_torch.models.gpt import GPT, merge_lora, quantize_model

    cfg = lora_config(DECODE_LAYERS)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl="xla")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.init_weights(gen)
    random_lora_b(torch, model, gen)
    tok, requests = serve_traffic(seed)

    def batcher_for(served_model, source, kv_quant):
        batcher = ContinuousBatcher(served_model, slots=16, max_new_tokens=64,
                                    draft_len=DRAFT_LEN, chunk_steps=8,
                                    eos_id=tok.eos_token_id, draft_source=source,
                                    kv_quant=kv_quant)
        chunk = batcher._chunk

        def guarded():  # no host sync inside a chunk
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return chunk()
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        batcher._chunk = guarded
        return batcher

    runs = {}
    fused = None
    for label, source, kv_quant, profiled in SERVE_RUNS:
        if label == "fused_lora":  # the same weights, LoRA through K5
            fused = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl="fused")
            fused.load_state_dict(model.state_dict())
        if label == "int4":  # the CLI's --quantize int4: merge, then quantize
            fused = None
            quantize_model(merge_lora(model), "int4")
        served_model = fused if label == "fused_lora" else model
        batcher = batcher_for(served_model, source, kv_quant)
        # warm: a refill and a chunk
        batcher.serve([(rid, prompt, 2, hyp) for rid, prompt, _, hyp in requests[:2]])
        batcher.chunks = batcher.host_reads = batcher.row_gathers = 0
        refill_syncs, refill = [], batcher._refill_rows

        def counted_refill(*args, refill=refill, refill_syncs=refill_syncs):
            refill_syncs.append(count_syncs(torch, lambda: refill(*args))[1])

        batcher._refill_rows = counted_refill
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        served, syncs = count_syncs(torch, lambda: batcher.serve(requests))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        budgets = {rid: cap for rid, _, cap, _ in requests}
        prompts_of = {rid: p for rid, p, _, _ in requests}
        generated = [len(r["tokens"]) - r["prompt_len"] for r in served]
        over = [r["id"] for r, g in zip(served, generated) if g > budgets[r["id"]]
                or r["tokens"][:r["prompt_len"]] != prompts_of[r["id"]]]
        runs[label] = {"draft_source": source, "kv_quant": kv_quant,
                       "quantize": "int4" if label == "int4" else None,
                       "requests": len(served), "wall_s": wall,
                       "p50_latency_s": float(np.percentile([r["latency_s"] for r in served], 50)),
                       "p90_latency_s": float(np.percentile([r["latency_s"] for r in served], 90)),
                       "generated_tokens": sum(generated), "tokens_per_s": sum(generated) / wall,
                       "chunks": batcher.chunks, "verify_steps": batcher.chunks * 8,
                       "tokens_per_slot_verify_step": sum(generated) / (batcher.chunks * 8 * 16),
                       "host_reads": batcher.host_reads, "row_gathers": batcher.row_gathers,
                       "chunk_sync_debug_mode": "error", "host_syncs_in_chunks": 0,
                       "host_syncs": syncs + sum(refill_syncs),
                       "host_syncs_outside_refills": syncs,
                       "host_syncs_per_chunk": syncs / batcher.chunks,
                       "refills": len(refill_syncs),
                       "host_syncs_per_refill": sum(refill_syncs) / max(len(refill_syncs), 1),
                       "host_syncs_per_verify_step": (syncs + sum(refill_syncs))
                       / (batcher.chunks * 8),
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "over_budget_or_prompt_changed": over, "launches": launches}
        if profiled:  # one chunk of the full pool under torch.profiler
            from torch.profiler import ProfilerActivity, profile

            batcher = batcher_for(served_model, source, kv_quant)
            batcher.start()
            for req in requests:
                batcher.submit(*req)
            batcher.poll()  # the first refill and chunk
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                batcher.poll()
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t1) * 1e3
            times = device_kernel_times(prof)
            paths = {key: {"ms": sum(us for name, (us, _) in times.items()
                                     if any(p in name for p in parts)) / 1e3,
                           "launches": sum(n for name, (_, n) in times.items()
                                           if any(p in name for p in parts))}
                     for key, parts in SLICE_KERNELS.items()}
            runs[label]["profile"] = {"chunk_steps": 8, "busy_slots": 16, "paths": paths,
                                      **profile_summary(prof, prof_wall_ms)}
            emit({"phase": "serve_profile", "run": label, **runs[label]["profile"]})
        emit({"phase": "serve_run", "run": label, **runs[label]})
        if len(served) != len(requests) or over:
            raise RuntimeError(f"serve run {label}: {len(served)} of {len(requests)} served, "
                               f"over budget or prompt changed {over}")
        # outside the refills a poll reads the status once a chunk, and a
        # gather uploads the finished slots' index and reads their rows
        chunks, gathers = runs[label]["chunks"], runs[label]["row_gathers"]
        if syncs > chunks + 2 * gathers:
            raise RuntimeError(f"serve run {label}: {syncs} host syncs outside the refills "
                               f"over {chunks} chunks and {gathers} gathers")
        need = {"int4": ("q4_matmul", "rms_norm", "apply_rope", "flash_attention_fwd"),
                "fused_lora": SPEC_PATH + ("lora_linear",)}.get(label, SPEC_PATH)
        missing = [n for n in need if launches[n] <= 0]
        if missing:
            raise RuntimeError(f"kernels never launched in serve run {label}: {missing}")
    if (runs["int4"]["profile"]["paths"]["k8_mid"]["launches"] <= 0
            or runs["int4"]["launches"]["q4_matmul_mid"] <= 0):
        raise RuntimeError("int4 serving never ran K8's middle kernel at 144 verify rows")
    if (runs["fused_lora"]["profile"]["paths"]["k5_mid"]["launches"] <= 0
            or runs["fused_lora"]["launches"]["lora_linear_mid"] <= 0):
        raise RuntimeError("fused-LoRA serving never ran K5's middle kernel at 144 verify rows")
    for label in ("bf16_lookup", "bf16_anchored", "int8_kv", "fused_lora"):
        if runs[label]["launches"]["swiglu_mlp_mid"] <= 0:
            raise RuntimeError(f"serve run {label} never ran K4's middle path at 144 verify rows")
    if runs["bf16_lookup"]["profile"]["paths"]["k4_mid"]["launches"] <= 0:
        raise RuntimeError("the bf16 serving profile shows no launch of K4's middle kernels")

    # the TCP server: 4 requests end to end
    batcher = batcher_for(model, "anchored", None)
    server = serve_ger.Server(batcher, tok)
    ready, holder = threading.Event(), {}

    def ready_cb(port):
        holder["port"] = port
        ready.set()

    thread = threading.Thread(target=server.run, args=("127.0.0.1", 0, ready_cb), daemon=True)
    thread.start()
    t0 = time.perf_counter()
    replies = {}
    try:
        if not ready.wait(timeout=60):
            raise RuntimeError("the server did not start")
        with socket.create_connection(("127.0.0.1", holder["port"]), timeout=60) as conn:
            for i in range(4):
                hyps = ["the cat sat on the mat", "the bat sat on the mat", "cat sat"]
                req = {"id": f"r{i}", "nhyps_asr": hyps, "max_new": 16 + 8 * i}
                if i % 2:
                    req["nhyps_vsr"] = ["the cat sat on a mat", "a cat sat"]
                conn.sendall((json.dumps(req) + "\n").encode())
            conn.settimeout(120)
            buf = b""
            while len(replies) < 4:
                data = conn.recv(1 << 16)
                if not data:
                    raise RuntimeError("the server closed the connection early")
                buf += data
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    rec = json.loads(line)
                    if "error" in rec:
                        raise RuntimeError(f"the server answered {rec}")
                    replies[rec["id"]] = rec
    finally:
        server.stop()
        thread.join(timeout=30)
    tcp = {"requests": 4, "wall_s": time.perf_counter() - t0,
           "latency_s": sorted(r["latency_s"] for r in replies.values()),
           "sample": replies["r0"], "stopped": not thread.is_alive()}
    result = {"phase": "serve_slice", "model": cfg.name, "n_layer": cfg.n_layer, "slots": 16,
              "draft_len": DRAFT_LEN, "chunk_steps": 8, "verify_rows": 16 * (DRAFT_LEN + 1),
              "requests": len(requests), "budgets": [16, 64],
              "runs": {k: {x: y for x, y in v.items() if x != "profile"} for k, v in runs.items()},
              "tcp": tcp}
    emit({"phase": "serve_tcp", **tcp})
    emit(result)
    del model, batcher, server
    torch.cuda.empty_cache()
    if not tcp["stopped"] or not all(isinstance(r["text"], str) for r in replies.values()):
        raise RuntimeError(f"the TCP server round trip failed: {tcp}")
    return result


# ---------------------------------------------------------------------------
# slice 6: offline ASR n-best and long-form transcription (the Whisper decoder
# and its batched beam search)
# ---------------------------------------------------------------------------

# the Whisper-large-v3 decoder's linears that K8 sees under int4: (name, N, K)
WHISPER_Q4_SHAPES = (("attn", 1280, 1280), ("fc1", 5120, 1280), ("fc2", 1280, 5120))
# K8's rows on the slice: a beam step (decode batch 8 x beam 50), the cross
# K/V of 8 windows of 1500 frames (key and value only), a long-form step of
# beam 5 at one utterance (the decode kernel)
WHISPER_Q4_ROWS = (("beam_step", 400), ("cross_kv", 8 * 1500), ("longform_step", 5))
ASR_BEAM, ASR_NBEST, ASR_BATCH = 50, 5, 8
# the sample length is cut from the reference's 224 to 64 new tokens (the
# random model rarely ends a beam, so every batch runs its whole budget)
ASR_MAX_NEW = 64
ASR_UTTERANCES = 16
ASR_IDLE = ("flash_attention_fwd", "rms_norm", "apply_rope", "swiglu_mlp", "lora_linear",
            "causal_attention_fwd", "grouped_matmul")
# depth-2, full-width decoder, card (bf16 weights and activations) against
# the CPU (fp32): logits of spread ~1 move by a few bf16 ulps of the largest
# (~0.03) through two blocks; a wiring fault (a transposed head, a wrong
# cache column or parent, a lost scale) moves them by about their spread.
# The int8 K/V round on both sides and a code at a rounding tie may differ
# by one, which moves a logit by ~1e-3 here.
WHISPER_DEPTH2_ATOL = 0.1


def numpy_decoder_tree(cfg, seed: int) -> dict:
    """A Whisper decoder tree in the JAX package's layout, drawn with numpy
    as `numpy_encoder_tree` draws the encoder."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s, n = cfg.n_state, cfg.n_layer
    std = 1.0 / math.sqrt(s)

    def normal(*shape, scale=std, loc=0.0):
        return (loc + rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def lin(out_f, in_f, bias=True):
        leaf = {"weight": normal(n, out_f, in_f)}
        if bias:
            leaf["bias"] = normal(n, out_f, scale=0.02)
        return leaf

    def attn():
        return {"query": lin(s, s), "key": lin(s, s, bias=False), "value": lin(s, s),
                "out": lin(s, s)}

    def ln(*shape):
        return {"scale": normal(*shape, scale=0.1, loc=1.0), "bias": normal(*shape, scale=0.02)}

    return {"token_embedding": normal(cfg.n_vocab, s),
            "positional_embedding": normal(cfg.n_ctx, s, scale=0.01),
            "blocks": {"attn_ln": ln(n, s), "attn": attn(), "cross_ln": ln(n, s),
                       "cross": attn(), "mlp_ln": ln(n, s),
                       "mlp": {"fc1": lin(4 * s, s), "fc2": lin(s, 4 * s)}},
            "ln": ln(s)}


def whisper_kernel_phase(torch, seed: int) -> dict:
    """K8 at the Whisper decoder's shapes and rows (WHISPER_Q4_SHAPES x
    WHISPER_Q4_ROWS; the beam step's 400 rows on the middle kernel beside
    the parent's tile, `q4_mid_row`) and K6 in bf16 at the encoder's B8 H20
    T=S=1500, each against its plain version, timed beside its bound and the
    library call (cuBLAS on the dequantised weight; SDPA)."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import flash_fwd, quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    q4 = {}
    for name, n, k in WHISPER_Q4_SHAPES:
        packed, scales = quant.quantize_weight_int4(randn(n, k, std=1 / math.sqrt(k),
                                                          dtype=torch.float32))
        w_deq = quant.dequantize_weight_int4(packed, scales, bf16)
        for label, rows in WHISPER_Q4_ROWS:
            if label == "cross_kv" and name != "attn":
                continue
            q4[f"whisper_{label}_{name}"] = q4_mid_row(
                torch, randn(rows, k), packed, scales, w_deq)
        del w_deq, packed, scales
    emit({"phase": "kernel", "name": "q4_matmul", "shapes_of": "whisper-large-v3 decoder",
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["q4_matmul"])), **q4})

    b, h, t, hs = 8, 20, 1500, 64
    q, k, v = (randn(b, h, t, hs) for _ in range(3))
    fn = lambda: flash_fwd.full_attention_fwd(q, k, v)  # noqa: E731
    plain = lambda: flash_fwd.full_attention_plain(q, k, v)  # noqa: E731
    got, want = repeatable("full_attention_fwd", fn, torch), plain()
    err = float((got.float() - want.float()).abs().max())
    share = float((got != want).float().mean())
    if not (err <= FLASH_FWD_ATOL["bfloat16"] and share <= FLASH_FWD_DIFFER_SHARE):
        raise RuntimeError(f"full_attention_fwd bf16 at the ASR encoder's shape: max_abs_err "
                           f"{err}, {share} of the elements differ")
    bms, by = bound((2 * b * h * t * hs + 2 * b * h * t * hs) * 2, 4 * b * h * t * t * hs,
                    BF16_TENSOR_FLOPS)
    k6 = dict(shape=[b, h, t, t, hs], dtype="bfloat16", max_abs_err=err, differ_share=share,
              repeats_bitwise=True, ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
              plain_ms=time_ms(plain, torch, warmup=1, iters=5),
              library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), torch),
              library="SDPA (non-causal)", bound_ms=bms, bound_by=by)
    emit({"phase": "kernel", "name": "full_attention_fwd", "asr_b8_t1500_bf16": k6})
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return {"q4_matmul": q4, "full_attention_fwd": {"asr_b8_t1500_bf16": k6}}


def depth2_whisper_decoder_check(torch, seed: int) -> dict:
    """A depth-2, full-width Whisper-large-v3 decoder from seeded numpy
    weights, card (bf16) against the CPU (fp32): the full forward's logits;
    8 cached steps against the full forward (card and CPU); and the same 8
    steps with int8 cross and self K/V, card against CPU."""
    import dataclasses

    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import decoder_from_jax
    from dualhyp_tpu_torch.models import whisper as w

    cfg = dataclasses.replace(w.WHISPER_LARGE_V3_DECODER, n_layer=2)
    tree = numpy_decoder_tree(cfg, seed + 43)
    card = decoder_from_jax(tree, device="cuda", dtype=torch.bfloat16)
    cpu = decoder_from_jax(tree, device="cpu", dtype=torch.float32)
    del tree
    rng = np.random.default_rng(seed + 47)
    b, steps = 2, 8
    feats = torch.from_numpy(rng.standard_normal((b, 1500, cfg.n_state), dtype=np.float32))
    toks = torch.from_numpy(rng.integers(0, 50257, size=(b, steps)))
    feats_card = feats.to("cuda", torch.bfloat16)
    out = {}

    def err(a, b_):
        return float((a.float().cpu() - b_.float().cpu()).abs().max())

    full_card = w.decode_logits(card, cfg, toks.cuda(), feats_card, compute_dtype=torch.bfloat16)
    full_cpu = w.decode_logits(cpu, cfg, toks, feats)
    out["full_forward"] = err(full_card, full_cpu)
    out["logit_spread"] = float(full_cpu.std())

    def walk(params, device, feats_, quant_kv):
        cross = w.precompute_cross_kv(params, cfg, feats_, quantize=quant_kv)
        cache = w.init_self_cache(cfg, b, steps, dtype=params["token_embedding"].dtype,
                                  quantize=quant_kv, device=device)
        return torch.stack([w.decode_step_cached(params, cfg, toks[:, s].to(device), s, cache,
                                                 cross) for s in range(steps)], dim=1)

    for quant_kv in (None, "int8"):
        reset_counts()
        got = walk(card, "cuda", feats_card, quant_kv)
        want = walk(cpu, "cpu", feats, quant_kv)
        label = quant_kv or "float"
        out[f"cached_{label}_card_vs_cpu"] = err(got, want)
        if quant_kv is None:
            out["cached_card_vs_full_card"] = err(got, full_card)
            out["cached_cpu_vs_full_cpu"] = err(want, full_cpu)
    result = {"phase": "depth2_whisper_decoder_card_vs_cpu", "n_state": cfg.n_state,
              "n_head": cfg.n_head, "n_vocab": cfg.n_vocab, "n_layer": cfg.n_layer,
              "batch": b, "steps": steps, "frames": 1500, "atol": WHISPER_DEPTH2_ATOL, **out}
    emit(result)
    bad = {k: v for k, v in out.items() if k != "logit_spread" and not v <= WHISPER_DEPTH2_ATOL}
    if bad or out["cached_cpu_vs_full_cpu"] > 1e-3:
        raise RuntimeError(f"depth-2 decoder: {bad or out}")
    del card, cpu
    torch.cuda.empty_cache()
    return result


class SyntheticWhisperTokenizer:
    """`data.synthetic.whisper_vocabulary` as the tokenizer duck type the
    ASR path calls, without the `tokenizers` package: words and runs of
    punctuation split on whitespace, unknown ones to <unk>."""

    def __init__(self):
        import re

        from dualhyp_tpu_torch.data.synthetic import whisper_vocabulary

        self.vocab = whisper_vocabulary()
        self.inverse = {i: t for t, i in self.vocab.items()}
        self.n_text = self.vocab["<|endoftext|>"]
        self.split = re.compile(r"\w+|[^\w\s]+").findall

    def convert_tokens_to_ids(self, token):
        return self.vocab.get(token)

    def encode(self, text, add_special_tokens=False):
        return [self.vocab.get(p, self.vocab["<unk>"]) for p in self.split(text)]

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(self.inverse[int(i)] for i in ids
                        if not (skip_special_tokens and int(i) >= self.n_text))


@contextlib.contextmanager
def whisper_tokenizer_route(whisper: Path):
    """The synthetic Whisper tokenizer reaches the CLIs as the checkpoint's
    `tokenizer.json` where `tokenizers` imports; otherwise through the
    `load_whisper` seam. Yields the route's name."""
    from dualhyp_tpu_torch.cli import make_json_asr
    from dualhyp_tpu_torch.data.synthetic import whisper_tokenizer_json

    if importlib.util.find_spec("tokenizers") is not None:
        (whisper / "tokenizer.json").write_text(json.dumps(whisper_tokenizer_json(),
                                                           ensure_ascii=False))
        yield "tokenizer.json through tokenizers"
        return
    original = make_json_asr.load_whisper

    def load(checkpoint_dir, need_tokenizer=False, **kw):
        enc, dec, _ = original(checkpoint_dir, need_tokenizer=False, **kw)
        return enc, dec, SyntheticWhisperTokenizer() if need_tokenizer else None

    make_json_asr.load_whisper = load
    try:
        yield "load_whisper seam (no tokenizers package)"
    finally:
        make_json_asr.load_whisper = original


@contextlib.contextmanager
def counted_beams(torch, log: list, profile_first: bool = False):
    """Wraps the beam search the CLIs call: for each call, its wall time,
    chunks, steps and the host syncs torch reports over it (sync debug
    "warn"), appended to `log`. profile_first: the first call is followed
    by one more chunk (16 steps and its prefill, the same inputs) under
    torch.profiler, its idle share appended as {"profiled_chunk": ...}. The
    encoder's wall time is logged too ({"encode_s": ...})."""
    from dualhyp_tpu_torch.cli import make_json_asr
    from dualhyp_tpu_torch.infer import whisper_device_beam as wdb
    from dualhyp_tpu_torch.models import whisper as w

    beam, encode = wdb.device_beam_search_batch, w.encode

    def counted(*args, **kwargs):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, syncs = count_syncs(torch, lambda: beam(*args, **{**kwargs, "stats": stats}))
        torch.cuda.synchronize()
        log.append({"utterances": int(args[2].shape[0]), "seconds": time.perf_counter() - t0,
                    "syncs": syncs, **stats})
        if profile_first and sum("profiled_chunk" in e for e in log) == 0:
            from torch.profiler import ProfilerActivity, profile

            one = {**kwargs, "max_new_tokens": wdb.MULTI_UTT_CHUNK}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                beam(*args, **one)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t1) * 1e3
            log.append({"profiled_chunk": profile_summary(prof, wall_ms, top_n=8)})
        return out

    def timed_encode(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kwargs)
        torch.cuda.synchronize()
        log.append({"encode_s": time.perf_counter() - t0})
        return out

    # the CLIs reach the beam through make_json_asr's name for it and
    # (infer.transcribe, at each call) through the module's
    make_json_asr.device_beam_search_batch = counted
    wdb.device_beam_search_batch = counted
    w.encode = timed_encode
    try:
        yield
    finally:
        make_json_asr.device_beam_search_batch = beam
        wdb.device_beam_search_batch = beam
        w.encode = encode


def check_beams(beams: list, label: str) -> dict:
    """Host syncs a beam: at most one a chunk (the chunk's read; the prefill
    reads nothing back)."""
    calls = [b for b in beams if "syncs" in b]
    over = [b for b in calls if b["syncs"] > b["chunks"]]
    if not calls or over:
        raise RuntimeError(f"{label}: beams {calls}: more host syncs than chunks in {over}")
    return {"beams": len(calls), "steps": sum(b["steps"] for b in calls),
            "chunks": sum(b["chunks"] for b in calls),
            "host_syncs": sum(b["syncs"] for b in calls),
            "beam_s": sum(b["seconds"] for b in calls),
            "encode_s": sum(b["encode_s"] for b in beams if "encode_s" in b),
            "step_ms": 1e3 * sum(b["seconds"] for b in calls) / max(
                1, sum(b["steps"] for b in calls))}


def write_asr_manifest(tmp: Path, seed: int):
    """ASR_UTTERANCES seeded WAVs of 2-12 s (noise, the random model's
    input), their captions, and a noise WAV to mix in: (manifest, noise)."""
    import numpy as np
    from scipy.io import wavfile

    from dualhyp_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    records = synthetic.make_records(n_uids=ASR_UTTERANCES, n_hyps=1, seed=seed)
    lines = []
    for i, rec in enumerate(records):
        seconds = 2.0 + 10.0 * i / (ASR_UTTERANCES - 1)
        path = tmp / f"asr_{i:02d}.wav"
        wavfile.write(path, 16000, (rng.standard_normal(int(seconds * 16000)) * 3000)
                      .astype(np.int16))
        lines.append(f"{rec['Uid']}\t{path}\t{rec['Caption']}")
    manifest = tmp / "manifest.tsv"
    manifest.write_text("\n".join(lines) + "\n")
    noise = tmp / "noise.wav"
    wavfile.write(noise, 16000, (rng.standard_normal(16000 * 6) * 3000).astype(np.int16))
    return manifest, noise


def whisper_asr_slice(torch, seed: int, whisper: Path) -> dict:
    """Slice 6's main path: `cli.make_json_asr.main --config` on the random
    Whisper-large-v3 (F16 on disk, so bf16 compute: K6 at bf16), 16 WAVs
    of 2-12 s with noise mixed in, beam 50, n-best 5, decode batch 8, 64
    new tokens; three runs: bf16, `quantize: int4` (K8) and int8 cross and
    self K/V. Each must write all 16 records, 5 hypotheses each, with no
    retry and no skip printed, and no beam may sync the host more than once
    a chunk."""
    import io

    from dualhyp_tpu_torch.cli import make_json_asr
    from dualhyp_tpu_torch.models import whisper as w

    runs = (("bf16", {}), ("int4", {"quantize": "int4"}),
            ("int8_kv", {"cross_kv_quant": "int8", "self_kv_quant": "int8"}))
    out = {}
    with tempfile.TemporaryDirectory() as tmp, whisper_tokenizer_route(whisper) as route:
        tmp = Path(tmp)
        manifest, noise = write_asr_manifest(tmp, seed + 53)
        for label, extra in runs:
            cfg = {"model_checkpoint": str(whisper), "manifest": str(manifest),
                   "noise_wav": str(noise), "output_file": str(tmp / f"asr_{label}.json"),
                   "beam_size": ASR_BEAM, "n_best": ASR_NBEST, "decode_batch": ASR_BATCH,
                   "max_new_tokens": ASR_MAX_NEW, "seed": seed, "dataset_name": "synthetic",
                   **extra}
            (tmp / f"{label}.json").write_text(json.dumps(cfg))
            beams, printed = [], io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with counted_beams(torch, beams, profile_first=label == "bf16"), \
                    contextlib.redirect_stdout(printed):
                records = make_json_asr.main(["--config", str(tmp / f"{label}.json")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            text = printed.getvalue()
            beam = check_beams(beams, f"ASR {label}")
            profiled = next((b["profiled_chunk"] for b in beams if "profiled_chunk" in b), None)
            out[label] = {
                "records": len(records), "wall_s": wall,
                "ms_per_utterance": 1e3 * (beam["beam_s"] + beam["encode_s"]) / ASR_UTTERANCES,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "host_syncs_per_chunk": beam["host_syncs"] / beam["chunks"],
                **beam, "launches": launches,
                **({"profiled_chunk": profiled} if profiled else {}),
                "sample": records[0]["nhyps"] if records else None}
            emit({"phase": "whisper_asr_slice", "run": label, **out[label]})
            if ("retrying per utterance" in text or "skip " in text
                    or len(records) != ASR_UTTERANCES):
                raise RuntimeError(f"ASR {label}: {len(records)} records; printed {text!r}")
            for rec in records:
                scores = rec["nhyps"]["scores"]
                if len(rec["nhyps"]["hyps"]) != ASR_NBEST or not all(map(math.isfinite, scores)):
                    raise RuntimeError(f"ASR {label}: record {rec}")
            k6 = launches["full_attention_fwd"]
            k8 = launches["q4_matmul"]
            n_enc = w.WHISPER_LARGE_V3.n_layer * -(-ASR_UTTERANCES // ASR_BATCH)
            stray = [name for name in ASR_IDLE if launches[name] != 0]
            mid = launches["q4_matmul_mid"]  # the beam's 400 rows
            if k6 != n_enc or (k8 > 0) != (label == "int4") or (mid > 0) != (k8 > 0) or stray:
                raise RuntimeError(f"ASR {label}: K6 {k6} (want {n_enc}), K8 {k8} (middle "
                                   f"kernel {mid}), off the path {stray}")
        hyps = {label: [r["nhyps"]["hyps"][0] for r in json.loads(
            (tmp / f"asr_{label}.json").read_text())] for label, _ in runs}
    result = {"phase": "whisper_asr_slice", "model": "whisper-large-v3 (random, F16 on disk, "
              "bf16 compute)", "tokenizer_route": route, "utterances": ASR_UTTERANCES,
              "beam": ASR_BEAM, "n_best": ASR_NBEST, "decode_batch": ASR_BATCH,
              "max_new_tokens": ASR_MAX_NEW,
              "first_hyp_agreement_vs_bf16": {
                  label: sum(a == b for a, b in zip(hyps[label], hyps["bf16"])) / ASR_UTTERANCES
                  for label in hyps if label != "bf16"},
              **{label: {k: v for k, v in r.items() if k not in ("sample", "launches")}
                 for label, r in out.items()}}
    emit(result)
    torch.cuda.empty_cache()
    return {**result, "launches": {label: r["launches"] for label, r in out.items()}}


LONGFORM_SECONDS = 75
# long-form cuts: 32 new tokens a window (from 224) and one fallback
# temperature (1.0; the CLI's default ladder is 0.2, 0.4, ..., 1.0): a random
# model fails the log-probability threshold in every window, and each
# fallback samples token by token on the host stepper (~50 ms a step at
# full width, host-bound)
LONGFORM_MAX_NEW = 32


def longform_slice(torch, seed: int, whisper: Path) -> dict:
    """`cli.transcribe.main` on one seeded 75-s WAV: beam 5, --quantize int4
    (K8 at 5-row beam steps on its decode kernel), --word_timestamps,
    --language en, LONGFORM_MAX_NEW new tokens a window and the fallback
    to temperature 1.0: the JSON holds beam-5 n-best streams with segments
    and word timings."""
    import io

    import numpy as np
    from scipy.io import wavfile

    from dualhyp_tpu_torch.cli import transcribe

    with tempfile.TemporaryDirectory() as tmp, whisper_tokenizer_route(whisper) as route:
        tmp = Path(tmp)
        rng = np.random.default_rng(seed + 59)
        wav = tmp / "long.wav"
        wavfile.write(wav, 16000, (rng.standard_normal(LONGFORM_SECONDS * 16000) * 3000)
                      .astype(np.int16))
        beams, printed = [], io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        native_calls = {}
        with counted_beams(torch, beams), counted_native(native_calls), \
                contextlib.redirect_stdout(printed):
            transcribe.main([str(wav), "--whisper_checkpoint", str(whisper), "--output_dir",
                             str(tmp / "out"), "--beam_size", "5", "--quantize", "int4",
                             "--word_timestamps", "--language", "en",
                             "--max_new_tokens", str(LONGFORM_MAX_NEW),
                             "--temperature_increment_on_fallback", "1.0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        data = json.loads((tmp / "out" / "long.json").read_text())
    beam = check_beams(beams, "long-form")
    segments = [s for hyp in data for s in hyp["segments"]]
    words = [wd for s in segments for wd in s.get("words", [])]
    result = {"phase": "longform_slice", "seconds_of_audio": LONGFORM_SECONDS,
              "tokenizer_route": route, "beam": 5, "quantize": "int4",
              "max_new_tokens": LONGFORM_MAX_NEW, "temperatures": [0.0, 1.0], "wall_s": wall,
              "realtime_factor": LONGFORM_SECONDS / wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "hypotheses": len(data), "segments": len(segments), "words": len(words),
              "segment_temperatures": sorted({s["temperature"] for s in segments}),
              "native_calls": native_calls,
              **beam, "launches": launches, "printed": printed.getvalue()[-300:]}
    emit(result)
    finite = all(math.isfinite(x) for s in segments for x in (s["start"], s["end"],
                                                              s["avg_logprob"]))
    if (len(data) != 5 or not segments or not words or not finite
            or launches["q4_matmul"] <= 0 or launches["full_attention_fwd"] <= 0
            or not native_calls.get("dtw") or not native_calls.get("median_filter")):
        raise RuntimeError(f"long-form slice: {result}")
    return result


# ---------------------------------------------------------------------------
# slice 7: the native host ops, and offline VSR / AVSR n-best generation
# ---------------------------------------------------------------------------

# the long-form slice's host alignment: text tokens x the frames of a 30-s
# window (DTW), and the alignment heads' rows filtered over those frames
NATIVE_DTW_SHAPE = (40, 1500)
NATIVE_MEDIAN_ROWS = 160
NATIVE_WER_PAIRS = 2000


@contextlib.contextmanager
def counted_native(calls: dict):
    """Counts the calls of `native.dtw` and `native.median_filter` (the long-
    form slice's word timing reaches them through the module)."""
    from dualhyp_tpu_torch import native

    originals = {name: getattr(native, name) for name in ("dtw", "median_filter")}

    def counter(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return originals[name](*args, **kwargs)
        return call

    for name in originals:
        setattr(native, name, counter(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(native, name, fn)


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of fn() (host code: no card work to wait for)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def native_phase(torch, seed: int) -> dict:
    """`native` (hostops.cc) built by g++ into the checkout's build directory,
    then edit_distance_batch, dtw and median_filter against the plain numpy
    versions the port keeps, on seeded inputs at the long-form slice's sizes:
    equal, and their host ms beside each other's."""
    import numpy as np

    from dualhyp_tpu_torch import native
    from dualhyp_tpu_torch.infer import evaluate
    from dualhyp_tpu_torch.infer import whisper_timing as wt

    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 71)
    cost = rng.standard_normal(NATIVE_DTW_SHAPE).astype(np.float32)
    got, want = native.dtw(cost), wt.dtw(cost)
    rows = rng.standard_normal((NATIVE_MEDIAN_ROWS, NATIVE_DTW_SHAPE[1])).astype(np.float32)
    med = np.stack([native.median_filter(r, 7) for r in rows])
    words = [f"w{i}" for i in range(50)]
    refs = [list(rng.choice(words, rng.integers(5, 30))) for _ in range(NATIVE_WER_PAIRS)]
    hyps = [list(rng.choice(words, rng.integers(5, 30))) for _ in range(NATIVE_WER_PAIRS)]
    dists = native.edit_distance_batch(refs, hyps)
    plain = [evaluate.edit_distance(r, h) for r, h in zip(refs, hyps)]
    result = {
        "phase": "native", "library": str(lib.relative_to(REPO)), "build_s": build_s,
        "dtw": {"shape": list(NATIVE_DTW_SHAPE), "path_len": len(got[0]),
                "equal": all(np.array_equal(a, b) for a, b in zip(got, want)),
                "native_host_ms": host_ms(lambda: native.dtw(cost)),
                "plain_host_ms": host_ms(lambda: wt.dtw(cost), reps=3)},
        "median_filter": {"rows": NATIVE_MEDIAN_ROWS, "width": 7,
                          "equal": bool(np.array_equal(med, wt.median_filter(rows, 7))),
                          "native_host_ms": host_ms(
                              lambda: [native.median_filter(r, 7) for r in rows]),
                          "plain_host_ms": host_ms(lambda: wt.median_filter(rows, 7))},
        "edit_distance": {"pairs": NATIVE_WER_PAIRS,
                          "equal": bool(np.array_equal(dists, plain)),
                          "native_host_ms": host_ms(lambda: native.edit_distance_batch(refs, hyps)),
                          "plain_host_ms": host_ms(lambda: [evaluate.edit_distance(r, h)
                                                            for r, h in zip(refs, hyps)], reps=3)}}
    emit(result)
    if not all(result[k]["equal"] for k in ("dtw", "median_filter", "edit_distance")):
        raise RuntimeError(f"native against the numpy versions: {result}")
    return result


# BRAVEn-large (the JAX package's default VSR encoder) and its ESPnet decoder
VSR_VOCAB = 1049            # <blank> + 1047 unigram pieces + <sos/eos>
VSR_DECODER = dict(attention_dim=1024, attention_heads=16, linear_units=4096, num_blocks=6)
# auto_avsr at its public audiovisual sizes (scripts/bench_make_json_avsr.py)
AVSR_VOCAB = 5049           # <blank> + 5047 unigram pieces + <sos/eos>
AVSR_FUSION_HIDDEN = 8192
AVSR_DECODER = dict(attention_dim=768, attention_heads=12, linear_units=3072, num_blocks=6)
VSR_UTTERANCES = 16
VSR_BEAM = 40
VSR_BATCH = 16
VSR_MAX_LEN = 40            # tokens a hypothesis (the CLI's default is 100)
VSR_NBEST = 5
VSR_CTC_WEIGHT = 0.1
# card (fp32, TF32 off) against CPU (fp32) at depth 2: a share of the
# largest value, as the Whisper encoder's check holds its features
VSR_REL_TOL = 1e-4


def depth2_vsr_check(torch, seed: int) -> dict:
    """BRAVEn-large at depth 2 (1024 wide, 16 heads, 4096 units, the full
    Conv3D + ResNet-18 frontend) and a 2-block 1024/16/4096 decoder, from
    seeded fp32 weights, card (fp32 under exact_fp32) against CPU (fp32):
    the encoder's memory and CTC log-probs, the cached decoder step against
    the full forward and the CPU's step, and the psi scores of one beam
    step, each within VSR_REL_TOL of its largest value; the same trees in
    bf16 on the card against the CPU, reported."""
    import dataclasses

    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import raven_from_jax
    from dualhyp_tpu_torch.cli.make_json_vsr import encode_ctc_batch
    from dualhyp_tpu_torch.device import exact_fp32
    from dualhyp_tpu_torch.infer import joint_device_beam as jdb
    from dualhyp_tpu_torch.models import espnet_decoder as ed
    from dualhyp_tpu_torch.models import raven

    cfg = dataclasses.replace(raven.BRAVEN_LARGE, num_blocks=2)
    dcfg = ed.EspnetDecoderConfig(odim=VSR_VOCAB, **{**VSR_DECODER, "num_blocks": 2})
    gen = torch.Generator().manual_seed(seed + 73)
    cpu = {"frontend": raven.init_conv3d_frontend(gen), "encoder": raven.init_encoder(cfg, gen),
           "decoder": ed.init_decoder(dcfg, gen), "ctc": ed.init_ctc(VSR_VOCAB, 1024, gen)}
    rng = np.random.default_rng(seed + 79)
    videos = [rng.standard_normal((t, 88, 88)).astype(np.float32) for t in (48, 37)]
    out, checks = {}, []

    def rel(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).abs().max() / want.abs().max())

    want_m, want_c = encode_ctc_batch(cpu["frontend"], cpu["encoder"], cpu["ctc"], cfg, videos,
                                      as_device=True)
    for dtype in (torch.float32, torch.bfloat16):
        card = raven_from_jax(cpu, device="cuda", dtype=dtype)
        got_m, got_c = encode_ctc_batch(card["frontend"], card["encoder"], card["ctc"], cfg,
                                        videos, as_device=True)
        errs = {"memory_rel_err": max(rel(got_m[0][i, :t], want_m[0][i, :t])
                                      for i, t in enumerate(want_m[1])),
                "ctc_log_probs_rel_err": max(rel(got_c[0][i, :t], want_c[0][i, :t])
                                             for i, t in enumerate(want_c[1]))}
        out[str(dtype).split(".")[-1]] = errs
        if dtype == torch.float32:
            checks += list(errs.items())
    del card

    # the cached decoder step: 2 utterances x 4 rows, 6 positions
    card = raven_from_jax(cpu, device="cuda")
    rows = torch.from_numpy(rng.integers(1, VSR_VOCAB - 1, size=(8, 6)))
    dec_err = full_err = 0.0
    with torch.no_grad(), exact_fp32():
        for side, tree, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
            memory = want_m[0].to(dev)
            mlen = torch.from_numpy(want_m[1].astype(np.int64)).to(dev)
            kv = ed.precompute_cross_kv(tree["decoder"], dcfg, memory)
            cache = ed.init_self_cache(dcfg, 8, 6, device=dev)
            table = ed.position_table(dcfg, 6, dev)
            steps = torch.stack([ed.decode_step_cached(
                tree["decoder"], dcfg, rows[:, p].to(dev), p, cache, kv, mlen, table,
                n_per_group=4)[0] for p in range(6)], dim=1)
            if side == "cpu":
                cpu_steps = steps
            else:
                full = ed.decode_logits(tree["decoder"], dcfg, rows.to(dev),
                                        memory.repeat_interleave(4, dim=0),
                                        memory_length=mlen.repeat_interleave(4))
                full_err, dec_err = rel(steps, full), rel(steps, cpu_steps)
    checks += [("cached_step_vs_full_forward_rel_err", full_err),
               ("cached_step_card_vs_cpu_rel_err", dec_err)]

    # the psi scores of one beam step, beam 40 x 2 utterances, 60 candidates
    ctc_x = want_c[0]
    valid = torch.from_numpy(np.repeat(want_c[1], VSR_BEAM).astype(np.int64))
    r_prev = torch.from_numpy(rng.normal(-5, 2, (2 * VSR_BEAM, ctc_x.shape[1], 2))
                              .astype(np.float32))
    last = torch.from_numpy(rng.integers(1, VSR_VOCAB - 1, 2 * VSR_BEAM))
    cand = torch.from_numpy(rng.integers(0, VSR_VOCAB, (2 * VSR_BEAM, 60)))
    cand[:, 0] = last
    psi = {}
    with torch.no_grad(), exact_fp32():
        for dev in ("cpu", "cuda"):
            psi[dev] = jdb.ctc_psi_scores(ctc_x.to(dev), valid.to(dev), r_prev.to(dev),
                                          last.to(dev), cand.to(dev), 3, 0, VSR_VOCAB - 1,
                                          VSR_BEAM)
    rankable = psi["cpu"] > -1e9  # LOG_ZERO marks blank and flushed candidates on both
    checks.append(("psi_rel_err", rel(psi["cuda"][rankable], psi["cpu"][rankable])))
    checks.append(("psi_log_zero_mismatch", float(not torch.equal(
        psi["cuda"].cpu() <= -1e9, ~rankable))))
    out.update({"float32": {**out["float32"], **dict(checks[2:])}})
    result = {"phase": "depth2_vsr_card_vs_cpu", "encoder": "BRAVEn-large width, 2 blocks",
              "decoder": {**VSR_DECODER, "num_blocks": 2}, "vocab": VSR_VOCAB,
              "frames": [48, 37], "rel_tolerance": VSR_REL_TOL, **out}
    emit(result)
    bad = [(k, v) for k, v in checks if not v <= VSR_REL_TOL]
    if bad:
        raise RuntimeError(f"depth-2 VSR card vs CPU beyond {VSR_REL_TOL}: {bad}")
    del card, cpu
    torch.cuda.empty_cache()
    return result


def write_token_list(path: Path, vocab: int) -> None:
    """<blank>, vocab - 2 SentencePiece-like pieces, <sos/eos>."""
    pieces = [f"▁w{i}" if i % 3 == 0 else f"p{i}" for i in range(vocab - 2)]
    path.write_text("\n".join(f"{p} {i}" for i, p in enumerate(
        ["<blank>", *pieces, "<sos/eos>"])) + "\n", encoding="utf-8")


def write_vsr_checkpoint(torch, path: Path, seed: int) -> dict:
    """Random BRAVEn-large with its Conv3D frontend, a 1024/16/4096 x 6
    decoder and the CTC head, drawn on the card from `seed`, written in bf16
    as one npz (the JAX package's layout)."""
    from dualhyp_tpu_torch.ckpt.convert import _leaves
    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.models import espnet_decoder as ed
    from dualhyp_tpu_torch.models import raven

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.bfloat16)
    dcfg = ed.EspnetDecoderConfig(odim=VSR_VOCAB, **VSR_DECODER)
    tree = {"frontend": raven.init_conv3d_frontend(gen, **kw),
            "encoder": raven.init_encoder(raven.BRAVEN_LARGE, gen, **kw),
            "decoder": ed.init_decoder(dcfg, gen, **kw),
            "ctc": ed.init_ctc(VSR_VOCAB, raven.BRAVEN_LARGE.attention_dim, gen, **kw)}
    save_params(path, tree)
    n = sum(t.numel() for _, t in _leaves(tree))
    del tree
    torch.cuda.empty_cache()
    return {"parameters": n, "bytes": path.stat().st_size}


def write_avsr_checkpoint(torch, path: Path, seed: int) -> dict:
    """Random auto_avsr at its public audiovisual sizes: the Conv3D and
    Conv1D frontends, two 768/12/3072 x 12 conformers (macaron, conv kernel
    31, bare Linear embeddings), the BatchNorm fusion MLP (1536 -> 8192 ->
    768), a 768/12/3072 x 6 decoder and the CTC head over 5049 tokens, in
    bf16 as one npz."""
    from dualhyp_tpu_torch.ckpt.convert import _leaves
    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.models import avsr
    from dualhyp_tpu_torch.models import espnet_decoder as ed
    from dualhyp_tpu_torch.models import raven

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.bfloat16)
    enc = raven.AUTO_AVSR_CONFORMER
    d = enc.attention_dim
    tree = {"video_frontend": raven.init_conv3d_frontend(gen, **kw),
            "audio_frontend": avsr.init_conv1d_frontend(gen, **kw),
            "video_encoder": raven.init_encoder(enc, gen, embed_norm=False, **kw),
            "audio_encoder": raven.init_encoder(enc, gen, embed_norm=False, **kw),
            "fusion": avsr.init_mlp_head(2 * d, AVSR_FUSION_HIDDEN, d, gen, **kw),
            "decoder": ed.init_decoder(ed.EspnetDecoderConfig(odim=AVSR_VOCAB, **AVSR_DECODER),
                                       gen, **kw),
            "ctc": ed.init_ctc(AVSR_VOCAB, d, gen, **kw)}
    save_params(path, tree)
    n = sum(t.numel() for _, t in _leaves(tree))
    del tree
    torch.cuda.empty_cache()
    return {"parameters": n, "bytes": path.stat().st_size}


def vsr_lengths():
    """VSR_UTTERANCES frame counts over 3-5 s at 25 fps."""
    return [75 + 50 * i // (VSR_UTTERANCES - 1) for i in range(VSR_UTTERANCES)]


def write_rois(tmp: Path, seed: int, lengths) -> list:
    """Seeded uint8 96 x 96 mouth ROIs as .npy files (the card's machine has
    no h5py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    paths = []
    for i, t in enumerate(lengths):
        path = tmp / f"roi_{i:02d}.npy"
        np.save(path, rng.integers(0, 256, size=(t, 96, 96), dtype=np.uint8))
        paths.append(path)
    return paths


@contextlib.contextmanager
def counted_joint_beams(torch, log: list, profile_first: bool = False):
    """Wraps the joint beam and the encoders the VSR/AVSR CLIs call: for each
    beam, its wall time, stats (chunks, steps, host reads) and the host syncs
    torch reports over it (sync debug "warn"); for each encode its ms by CUDA
    events, and the seconds the npz takes to read. profile_first: the first
    beam is followed by one chunk (16 steps, the same inputs) under
    torch.profiler: its idle share and device kernel launches a step."""
    from dualhyp_tpu_torch.cli import make_json_avsr, make_json_vsr
    from dualhyp_tpu_torch.infer import joint_device_beam as jdb

    beam = jdb.joint_device_beam_batch
    encoders = {make_json_vsr: ("encode_ctc_batch", make_json_vsr.encode_ctc_batch),
                make_json_avsr: ("encode_ctc_batch_av", make_json_avsr.encode_ctc_batch_av)}

    def counted(*args, **kwargs):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, syncs = count_syncs(torch, lambda: beam(*args, **{**kwargs, "stats": stats}))
        torch.cuda.synchronize()
        log.append({"utterances": len(out), "seconds": time.perf_counter() - t0,
                    "torch_syncs": syncs, **stats})
        if profile_first and sum("profiled_chunk" in e for e in log) == 0:
            from torch.profiler import ProfilerActivity, profile

            one = {**kwargs, "max_len": 16}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                beam(*args, **one)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t1) * 1e3
            summary = profile_summary(prof, wall_ms, top_n=8)
            launches = sum(n for _, n in device_kernel_times(prof).values())
            log.append({"profiled_chunk": {**summary, "steps": 16,
                                           "launches_per_step": launches / 16}})
        return out

    def timed(fn):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            log.append({"encode_ms": start.elapsed_time(end)})
            return out
        return call

    def loaded(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            log.append({"load_s": time.perf_counter() - t0})
            return out
        return call

    loaders = {module: module.load_params for module in (make_json_vsr, make_json_avsr)}
    for module in (make_json_vsr, make_json_avsr, jdb):
        module.joint_device_beam_batch = counted
    for module, (name, fn) in encoders.items():
        setattr(module, name, timed(fn))
    for module, fn in loaders.items():
        module.load_params = loaded(fn)
    try:
        yield
    finally:
        for module in (make_json_vsr, make_json_avsr, jdb):
            module.joint_device_beam_batch = beam
        for module, (name, fn) in encoders.items():
            setattr(module, name, fn)
        for module, fn in loaders.items():
            module.load_params = fn


def check_joint_beams(log: list, label: str) -> dict:
    """One host sync a beam chunk: the chunk's read (an event wait, which
    torch's sync debug mode does not see) and no sync torch reports."""
    calls = [b for b in log if "torch_syncs" in b]
    bad = [b for b in calls if b["torch_syncs"] or b["host_reads"] != b["chunks"]]
    if not calls or bad:
        raise RuntimeError(f"{label}: beams {calls}: host syncs beyond one read a chunk in {bad}")
    chunks = sum(b["chunks"] for b in calls)
    steps = sum(b["steps"] for b in calls)
    beam_s = sum(b["seconds"] for b in calls)
    return {"beams": len(calls), "steps": steps, "chunks": chunks,
            "host_syncs_per_chunk": sum(b["torch_syncs"] + b["host_reads"] for b in calls) / chunks,
            "torch_reported_syncs": sum(b["torch_syncs"] for b in calls),
            "beam_s": beam_s, "step_ms": 1e3 * beam_s / steps,
            "encode_ms": sum(b["encode_ms"] for b in log if "encode_ms" in b),
            "checkpoint_read_s": sum(b["load_s"] for b in log if "load_s" in b)}


def run_generator(torch, label: str, module, config: Path, reference_launches=None) -> dict:
    """`module.main --config` (make_json_vsr or make_json_avsr) with the beams
    and encodes counted, launches read around it; fails on a retry, a skip,
    a missing record or a record without VSR_NBEST finite hypotheses."""
    import io

    log, printed = [], io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with counted_joint_beams(torch, log, profile_first=True), contextlib.redirect_stdout(printed):
        records = module.main(["--config", str(config)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    text = printed.getvalue()
    beam = check_joint_beams(log, label)
    profiled = next((b["profiled_chunk"] for b in log if "profiled_chunk" in b), None)
    result = {"phase": label, "records": len(records), "wall_s": wall,
              "ms_per_utterance": (1e3 * beam["beam_s"] + beam["encode_ms"]) / VSR_UTTERANCES,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **beam,
              "profiled_chunk": profiled, "launches": launches,
              "retries_or_skips": text.count("falling back") + text.count("skip "),
              "sample": records[0]["nhyps"] if records else None}
    emit(result)
    if result["retries_or_skips"] or len(records) != VSR_UTTERANCES:
        raise RuntimeError(f"{label}: {len(records)} records; printed {text!r}")
    for rec in records:
        scores = rec["nhyps"]["scores"]
        if len(rec["nhyps"]["hyps"]) != VSR_NBEST or not all(map(math.isfinite, scores)):
            raise RuntimeError(f"{label}: record {rec}")
    stray = [name for name, n in launches.items() if n]
    if stray:  # no TPU kernel lies on the VSR/AVSR paths
        raise RuntimeError(f"{label}: kernels launched off their paths: {stray}")
    return result


def generator_config(tmp: Path, checkpoint: Path, manifest: Path, vocab: int, seed: int,
                     **model) -> Path:
    tokens = tmp / f"tokens_{vocab}.txt"
    write_token_list(tokens, vocab)
    cfg = {"token_list": str(tokens), "model_checkpoint": str(checkpoint),
           "manifest": str(manifest), "output_file": str(tmp / f"{checkpoint.stem}.json"),
           "beam_size": VSR_BEAM, "ctc_weight": VSR_CTC_WEIGHT, "decode_batch": VSR_BATCH,
           "max_len": VSR_MAX_LEN, "n_best": VSR_NBEST, "occ_type": "pixelate", "seed": seed,
           "dataset_name": "synthetic", **model}
    path = tmp / f"{checkpoint.stem}_config.json"
    path.write_text(json.dumps(cfg))
    return path


def vsr_slice(torch, seed: int, braven: Path) -> dict:
    """Slice 7's main path: `cli.make_json_vsr.main --config` on 16 seeded
    mouth ROIs (uint8 96 x 96, 3-5 s at 25 fps, occ_type pixelate), random
    BRAVEn-large + frontend, a 1024/16/4096 x 6 decoder and the CTC head in
    bf16 (one npz, written to `braven`, which the visual-feature phase reads
    too), a 1049-entry token list; beam 40, ctc_weight 0.1, decode batch 16,
    max_len 40, n-best 5."""
    from dualhyp_tpu_torch.cli import make_json_vsr
    from dualhyp_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    written = write_vsr_checkpoint(torch, braven, seed + 83)
    write_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        records = synthetic.make_records(n_uids=VSR_UTTERANCES, n_hyps=1, seed=seed)
        rois = write_rois(tmp, seed + 89, vsr_lengths())
        manifest = tmp / "manifest.tsv"
        manifest.write_text("".join(f"{r['Uid']}\t{p}\t{r['Caption']}\n"
                                    for r, p in zip(records, rois)))
        config = generator_config(tmp, braven, manifest, VSR_VOCAB, seed, decoder=VSR_DECODER)
        result = run_generator(torch, "vsr_slice", make_json_vsr, config)
    result = {**result, "model": "BRAVEn-large (random, bf16) + 1024/16/4096 x 6 decoder",
              "checkpoint": {**written, "write_s": write_s}, "frames": vsr_lengths(),
              "beam": VSR_BEAM, "max_len": VSR_MAX_LEN, "decode_batch": VSR_BATCH}
    emit({k: v for k, v in result.items() if k not in ("sample", "launches")})
    torch.cuda.empty_cache()
    return result


def avsr_slice(torch, seed: int) -> dict:
    """`cli.make_json_avsr.main --config` on 16 (WAV, ROI) pairs of the VSR
    slice's lengths (640 samples a frame), random auto_avsr at its public
    audiovisual sizes in bf16; the VSR slice's beam and reports."""
    import numpy as np
    from scipy.io import wavfile

    from dualhyp_tpu_torch.cli import make_json_avsr
    from dualhyp_tpu_torch.data import synthetic
    from dualhyp_tpu_torch.models import raven

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        checkpoint = tmp / "auto_avsr.npz"
        written = write_avsr_checkpoint(torch, checkpoint, seed + 97)
        write_s = time.perf_counter() - t0
        records = synthetic.make_records(n_uids=VSR_UTTERANCES, n_hyps=1, seed=seed + 1)
        rois = write_rois(tmp, seed + 101, vsr_lengths())
        rng = np.random.default_rng(seed + 103)
        lines = []
        for rec, roi, t in zip(records, rois, vsr_lengths()):
            wav = tmp / f"{rec['Uid']}.wav"
            wavfile.write(wav, 16000, (rng.standard_normal(t * 640) * 3000).astype(np.int16))
            lines.append(f"{rec['Uid']}\t{wav}\t{roi}\t{rec['Caption']}\n")
        manifest = tmp / "manifest.tsv"
        manifest.write_text("".join(lines))
        enc = {f: getattr(raven.AUTO_AVSR_CONFORMER, f) for f in (
            "attention_dim", "attention_heads", "linear_units", "num_blocks", "macaron_style",
            "use_cnn_module", "cnn_module_kernel")}
        config = generator_config(tmp, checkpoint, manifest, AVSR_VOCAB, seed,
                                  video_encoder=enc, audio_encoder=enc, decoder=AVSR_DECODER)
        result = run_generator(torch, "avsr_slice", make_json_avsr, config)
    result = {**result, "model": "auto_avsr (random, bf16): 768/12/3072 x 12 a stream, fusion "
                                 "8192, 768/12/3072 x 6 decoder, vocab 5049",
              "checkpoint": {**written, "write_s": write_s}, "frames": vsr_lengths()}
    emit({k: v for k, v in result.items() if k not in ("sample", "launches")})
    torch.cuda.empty_cache()
    return result


def precompute_visual_phase(torch, seed: int, whisper: Path, braven: Path) -> dict:
    """`cli.precompute_features.main --raven_checkpoint` on 4 RelPrompt
    records with mouth ROIs: the random Whisper-large-v3 (K6, 32 launches an
    utterance) and the VSR slice's BRAVEn-large; each record's visual
    features (frames, 1024), nonzero and finite, its occlusion replayed."""
    import numpy as np

    from dualhyp_tpu_torch.cli import precompute_features
    from dualhyp_tpu_torch.data import synthetic
    from dualhyp_tpu_torch.models import whisper as w

    n = 4
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        records = synthetic.make_records(n_uids=n, n_hyps=5, seed=seed + 107)
        write_wavs(records, tmp, seed + 109)
        rois = write_rois(tmp, seed + 113, [r["Visual_Corruption"]["total_len"] for r in records])
        for rec, roi in zip(records, rois):
            rec["Mouthroi"] = str(roi)
        synthetic.write_json(tmp / "test.json", records)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        written = precompute_features.main(["--json", str(tmp / "test.json"), "--out_dir",
                                            str(tmp / "feats"), "--whisper_checkpoint",
                                            str(whisper), "--raven_checkpoint", str(braven),
                                            "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        shapes, finite, nonzero = [], True, True
        for rec in records:
            with np.load(tmp / "feats" / f"{rec['Uid']}.npz") as z:
                visual = z["visual"]
            shapes.append(list(visual.shape))
            finite &= bool(np.isfinite(visual).all())
            nonzero &= bool(np.abs(visual).max() > 0)
    want = [[r["Visual_Corruption"]["total_len"], 1024] for r in records]
    result = {"phase": "precompute_visual", "records": written, "wall_s": wall,
              "visual_shapes": shapes, "finite": finite, "nonzero": nonzero,
              "launches": launches}
    emit(result)
    k6 = launches["full_attention_fwd"]
    if (written != n or shapes != want or not (finite and nonzero)
            or k6 != w.WHISPER_LARGE_V3.n_layer * n):
        raise RuntimeError(f"precompute --raven_checkpoint: {result}, K6 want "
                           f"{w.WHISPER_LARGE_V3.n_layer * n}, shapes want {want}")
    return result


# ---- slice 22: the GPT-NeoX / Phi / Falcon family, K1 at every head size ----

# (config, query heads, KV groups, head size) of the training shapes at which
# flash_heads_phase holds K1 and L1 at the head sizes other than 64 and 128
FLASH_HEAD_CONFIGS = (("phi-2", 32, 32, 80), ("Gemma-2b", 8, 1, 256),
                      ("Phi-3-mini-4k-instruct", 32, 32, 96), ("open_llama_3b", 32, 32, 100),
                      ("pythia-14m", 4, 4, 32))
FLASH_HEADS_B, FLASH_HEADS_T, FLASH_HEADS_PREFILL_T = 8, 1024, 384
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd") + SPLASH_KERNELS
# K1's instances at B8 Hq32 G32 T1024 before their redesigns, the "was" of
# their rows: device ms on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's
# K1 rows) of the forward and the backward at 80 and 96 over two
# zero-filled 64-column boxes (one warpgroup of 64 keys in the backward),
# and of the backward at 100 on the wrapper's copies padded to 104 columns
# (the copies' 0.5038 ms included)
K1_WAS = {("flash_attention_fwd", 80): (0.2307, "the instance over two 64-column boxes"),
          ("flash_attention_fwd", 96): (0.2358, "the instance over two 64-column boxes"),
          ("flash_attention_bwd", 80): (1.1072, "the instance over two 64-column boxes"),
          ("flash_attention_bwd", 96): (1.1997, "the instance over two 64-column boxes"),
          ("flash_attention_bwd", 100): (1.8662, "the 104-column instance on padded copies, "
                                                 "the copies included")}
# depth2_family_check's configs: phi-2; pythia-1b (D 256, a separate
# norm_2, rotary 64 of 256); falcon-7b (71 heads of one group, a shared
# norm, no bias); and the RMSNorm configs whose head sizes (256, 96, 100)
# K1 once refused on the card
FAMILY_DEPTH2 = ("phi-2", "pythia-1b", "falcon-7b", "Gemma-2b", "Phi-3-mini-4k-instruct",
                 "open_llama_3b")
# depth-2 K/V caches, card bf16 vs CPU fp32, relative L2 error over the
# whole cache: bf16 projections round K and V by 2^-9 relative each (~0.004
# after two blocks); a wrong slot, head or rotation gives ~1
DEPTH2_CACHE_REL = 0.05
PHI2 = "phi-2"
# phi2_slice: which kernels launch on each run and which must not (a
# LayerNorm model runs no K2, its GPT-NeoX MLP no K4)
PHI2_IDLE = ("rms_norm", "swiglu_mlp", "grouped_matmul") + SPLASH_KERNELS
PHI2_RUNS = {
    "bf16": dict(launch=("flash_attention_fwd", "apply_rope"),
                 idle=PHI2_IDLE + ("lora_linear", "q4_matmul")),
    "fused": dict(launch=("flash_attention_fwd", "apply_rope", "lora_linear"),
                  idle=PHI2_IDLE + ("q4_matmul",)),
    "int4": dict(launch=("flash_attention_fwd", "apply_rope", "q4_matmul"),
                 idle=PHI2_IDLE + ("lora_linear",)),
}
PHI2_PROFILE_NEW_TOKENS = 4
# phi2_kernel_phase: phi-2's linears under int4 (name, N, K), K8's shapes
# on phi2_slice's int4 run, the head at decode rows only (a prefill takes
# each row's last token); its LoRA linears under K5 (name, O, D, blocks of
# r 16); the rows a call takes there: a decode step of batch 8 and a
# prefill of 8 prompts padded to 192 tokens (phi2_slice's prefill_rows)
PHI2_Q4_SHAPES = (("qkv", 7680, 2560), ("attn_proj", 2560, 2560), ("fc", 10240, 2560),
                  ("mlp_proj", 2560, 10240), ("lm_head", 51200, 2560))
PHI2_LORA_SHAPES = (("qkv", 7680, 2560, 3), ("proj", 2560, 2560, 1))
PHI2_ROWS = (("decode", 8), ("prefill", 1536))
# K3 at phi-2's partial rotary (32 of 80 channels) on q and k read in place
# from the fused QKV: the prefill (B8 T192) and the training shape (B8
# T1024, also transposed on contiguous gradients)
PHI2_ROPE_SHAPES = (("prefill", 192, False), ("train", 1024, True))
PHI2_TRAIN_PATH = ("flash_attention_fwd", "flash_attention_bwd", "apply_rope",
                   "apply_rope_transpose")


def family_lora_config(name: str, **kw):
    """A registry config with the slices' LoRA (r 16, alpha 16, q/k/v/proj)."""
    from dualhyp_tpu_torch import config_from_name

    return config_from_name(name, lora_r=16, lora_alpha=16, lora_query=True, lora_key=True,
                            lora_value=True, lora_projection=True, **kw)


def peak_mb(fn, torch) -> float:
    """The device memory one call of fn allocates at its peak, in MiB (what
    it holds when it returns included)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def k1_bwd_fused_qkv(torch, gen, b, nh, t, hs, scale) -> dict:
    """K1's backward on the rows the model hands it (MHA, as open_llama_3b):
    q and k through K3 (contiguous), v a view of the fused QKV projection
    (a group stride of 3 heads), dO the (B, H, T, D) view of a (B, T, H D)
    gradient; against the plain version, timed, with its peak memory."""
    from dualhyp_tpu_torch.ops import attention, rope

    dev = torch.device("cuda")
    qkv = torch.randn((b, t, nh, 3, hs), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope.build_rope_cache(t, hs, device=dev, dtype=torch.bfloat16)
    q = rope.apply_rope(qkv[:, :, :, 0].transpose(1, 2), cos, sin)
    k = rope.apply_rope(qkv[:, :, :, 1].transpose(1, 2), cos, sin)
    v = qkv[:, :, :, 2].transpose(1, 2)
    do = torch.randn((b, t, nh * hs), generator=gen, device=dev).to(torch.bfloat16)
    do = do.view(b, t, nh, hs).transpose(1, 2)
    o, lse = attention._flash_fwd(q, k, v, scale)
    fn = lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
    checks = {f"d{n}": compare_scaled(f"flash_attention_bwd d{n} D{hs} fused QKV", x, y, torch)
              for n, x, y in zip("qkv", fn(), attention.flash_attention_bwd_plain(
                  q, k, v, o, lse, do, scale))}
    return dict(strides={n: list(x.stride()) for n, x in zip(("q", "k", "v", "do"),
                                                              (q, k, v, do))},
                max_abs_err=max(c["max_abs_err"] for c in checks.values()), **checks,
                device_ms=device_ms(fn, torch, iters=5), peak_mb=peak_mb(fn, torch))


def flash_heads_phase(torch, seed: int) -> dict:
    """K1's forward and backward and L1's forward, dQ and dK/dV at the head
    sizes other than 64 and 128 (32, 80, 96, 100, 256), each against its plain version
    at FLASH_HEAD_CONFIGS' training shapes (B8 T1024, the config's own heads
    and groups: phi-2, Gemma-2b, Phi-3-mini, open_llama_3b, pythia-14m's
    head size with 4 heads), the forwards at the prefill shape (T384) too.
    Every kernel runs on the raw q at the softmax scale. Times beside the
    bound (the head size's own operations and bytes, not the padded
    tiles'), the plain version and SDPA (forward; its backward beside the
    gradient kernels); each instance's registers and spills; K1's layouts
    (`fwd_layout`, `bwd_layout`) and, where an instance was redesigned
    since (the forward at 80 and 96, the backward at 80, 96 and 100), the
    parent's device ms (`K1_WAS`). At head size 100 the forward's padded
    copies are timed alone (`pad_copy`), and K1's backward, which reads its
    rows in place, reports its peak memory and runs again on the model's
    layout (`k1_bwd_fused_qkv`). Returns {kernel: {"d<D>": row}}."""
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention, splash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {name: {} for name in FLASH_KERNELS}
    for config, nh, g, hs in FLASH_HEAD_CONFIGS:
        scale = 1.0 / math.sqrt(hs)
        b, t = FLASH_HEADS_B, FLASH_HEADS_T
        q, k, v, do = randn(b, nh, t, hs), randn(b, g, t, hs), randn(b, g, t, hs), \
            randn(b, nh, t, hs)
        o, lse = attention._flash_fwd(q, k, v, scale)
        o_plain, lse_plain = attention.causal_attention_plain_lse(q, k, v, scale)
        checks = {"flash_attention_fwd": {
            "max_abs_err": compare("flash_attention_fwd", o, o_plain, torch),
            "lse_max_abs_err": float((lse - lse_plain).abs().max())}}
        bad_lse = not bool(((lse - lse_plain).abs()
                            <= LSE_TOL[0] + LSE_TOL[1] * lse_plain.abs()).all())
        del o_plain, lse_plain
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        bwd = {f"d{n}": compare_scaled(f"flash_attention_bwd d{n} D{hs}", x, y, torch)
               for n, x, y in zip("qkv", got, want)}
        checks["flash_attention_bwd"] = {"max_abs_err": max(c["max_abs_err"]
                                                            for c in bwd.values()), **bwd}
        del got, want
        so, slse = splash.splash_fwd(q, k, v, scale)
        so_plain, slse_plain = splash.splash_fwd_plain(q, k, v, scale)
        checks["splash_attention_fwd"] = {
            "max_abs_err": compare("splash_attention_fwd", so, so_plain, torch),
            "lse_max_abs_err": float((slse - slse_plain).abs().max())}
        bad_lse |= not bool(((slse - slse_plain).abs()
                             <= LSE_TOL[0] + LSE_TOL[1] * slse_plain.abs()).all())
        if bad_lse:
            raise RuntimeError(f"flash/splash lse at D{hs}: a kernel disagrees with its plain "
                               f"version: {checks}, tolerance {LSE_TOL}")
        del so_plain, slse_plain
        di = splash.row_dot(so, do)
        args = (q, k, v, slse, do, di, scale)
        checks["splash_attention_dq"] = compare_scaled(
            f"splash_attention_dq D{hs}", splash.splash_dq(*args),
            splash.splash_dq_plain(*args), torch)
        dkv = {f"d{n}": compare_scaled(f"splash_attention_dkv d{n} D{hs}", x, y, torch)
               for n, x, y in zip("kv", splash.splash_dkv(*args), splash.splash_dkv_plain(*args))}
        checks["splash_attention_dkv"] = {"max_abs_err": max(c["max_abs_err"]
                                                             for c in dkv.values()), **dkv}
        torch.cuda.empty_cache()

        qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
        sdpa_out = sdpa_gqa(F, qr, kr, vr, scale)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do,
                                                          retain_graph=True), torch, iters=5)
        pairs = b * nh * t * (t + 1) // 2
        n_q, n_kv, n_rows = b * nh * t * hs, b * g * t * hs, b * nh * t
        runs = {
            # (kernel, plain, SDPA ms, bytes: each input read once, each
            # output written once; operations: 2 flops a MAC a causal pair)
            "flash_attention_fwd": (
                lambda: attention._flash_fwd(q, k, v, scale),
                lambda: attention.causal_attention_plain(q, k, v, scale),
                time_ms(lambda: sdpa_gqa(F, q, k, v, scale), torch, iters=5),
                (2 * n_q + 2 * n_kv) * 2 + n_rows * 4, 4 * hs * pairs),
            "flash_attention_bwd": (
                lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale),
                lambda: attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale),
                sdpa_bwd_ms, (3 * n_q + 2 * n_kv) * 2 + (n_q + 2 * n_kv) * 2 + n_rows * 4,
                10 * hs * pairs),
            "splash_attention_fwd": (
                lambda: splash.splash_fwd(q, k, v, scale),
                lambda: splash.splash_fwd_plain(q, k, v, scale),
                None, (2 * n_q + 2 * n_kv) * 2 + n_rows * 4, 4 * hs * pairs),
            "splash_attention_dq": (
                lambda: splash.splash_dq(*args), lambda: splash.splash_dq_plain(*args),
                sdpa_bwd_ms, (3 * n_q + 2 * n_kv) * 2 + 2 * n_rows * 4, 6 * hs * pairs),
            "splash_attention_dkv": (
                lambda: splash.splash_dkv(*args), lambda: splash.splash_dkv_plain(*args),
                sdpa_bwd_ms, (2 * n_q + 4 * n_kv) * 2 + 2 * n_rows * 4, 8 * hs * pairs)}
        for name, (fn, plain, lib_ms, n_bytes, flops) in runs.items():
            if lib_ms is None:  # L1's forward beside the same SDPA forward as K1's
                lib_ms = out["flash_attention_fwd"][f"d{hs}"]["library_ms"]
            bms, by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
            out[name][f"d{hs}"] = dict(
                config=config, shape=[b, nh, g, t, hs], **checks[name],
                ms=time_ms(fn, torch, iters=10), device_ms=device_ms(fn, torch, iters=5),
                plain_ms=time_ms(plain, torch, warmup=1, iters=2), library_ms=lib_ms,
                library=("SDPA forward (enable_gqa)" if name.endswith("_fwd") else
                         "SDPA backward (dQ, dK, dV together; autograd.grad)"),
                bound_ms=bms, bound_by=by)
            plan = getattr(attention, {"flash_attention_fwd": "fwd_layout",
                                       "flash_attention_bwd": "bwd_layout"}.get(name, ""), None)
            if plan is not None:  # (a parent checkout may lack the planner)
                out[name][f"d{hs}"]["layout"] = plan(hs)
            if (name, hs) in K1_WAS:
                was_ms, was = K1_WAS[name, hs]
                out[name][f"d{hs}"].update(was_device_ms=was_ms, was=f"{was} (PERF.md)")
        dp = attention.padded_head_size(hs)
        if dp != hs:  # the forward's zero-padded copies, timed alone
            n_in = sum(x.numel() for x in (q, k, v))
            out["flash_attention_fwd"][f"d{hs}"]["pad_copy"] = dict(
                padded_head_size=dp, bytes=2 * n_in * (1 + dp / hs),
                ms=time_ms(lambda: [attention._pad_heads(x, dp) for x in (q, k, v)], torch,
                           iters=10))
        if hs == 100:  # K1's backward on the model's rows, which it reads in place
            out["flash_attention_bwd"][f"d{hs}"].update(
                peak_mb=peak_mb(lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale),
                                torch),
                fused_qkv=k1_bwd_fused_qkv(torch, gen, b, nh, t, hs, scale))
        del q, k, v, do, o, lse, so, slse, di, args, qr, kr, vr, sdpa_out
        torch.cuda.empty_cache()

        # the forwards at the prefill shape
        t = FLASH_HEADS_PREFILL_T
        q, k, v = randn(b, nh, t, hs), randn(b, g, t, hs), randn(b, g, t, hs)
        pairs, n_q, n_kv, n_rows = b * nh * t * (t + 1) // 2, b * nh * t * hs, \
            b * g * t * hs, b * nh * t
        bms, by = bound((2 * n_q + 2 * n_kv) * 2 + n_rows * 4, 4 * hs * pairs,
                        BF16_TENSOR_FLOPS)
        lib_ms = time_ms(lambda: sdpa_gqa(F, q, k, v, scale), torch, iters=10)
        for name, fn, plain in (
                ("flash_attention_fwd", lambda: attention._flash_fwd(q, k, v, scale)[0],
                 lambda: attention.causal_attention_plain(q, k, v, scale)),
                ("splash_attention_fwd", lambda: splash.splash_fwd(q, k, v, scale)[0],
                 lambda: splash.splash_fwd_plain(q, k, v, scale)[0])):
            out[name][f"d{hs}"][f"prefill_T{t}"] = dict(
                shape=[b, nh, g, t, hs], max_abs_err=compare(name, fn(), plain(), torch),
                ms=time_ms(fn, torch, iters=10), device_ms=device_ms(fn, torch, iters=5),
                plain_ms=time_ms(plain, torch, warmup=1, iters=2), library_ms=lib_ms,
                bound_ms=bms, bound_by=by)
        del q, k, v
        torch.cuda.empty_cache()
    reports = [ptxas_report(src) for src in ("flash_attention.cu", "flash_attention_bwd.cu")]
    ptxas = ("not measured (library built before this run)" if None in reports else
             {k: v for k, v in {**reports[0], **reports[1]}.items()
              if any(f"<{d}" in k for d in (32, 80, 96, 100, 104, 256))})
    emit({"phase": "flash_heads", "tolerance": {
              "forward": dict(zip(("atol", "rtol"), TOLERANCES["flash_attention_fwd"]),
                              lse=LSE_TOL),
              "splash_forward": dict(zip(("atol", "rtol"), TOLERANCES["splash_attention_fwd"])),
              "gradients": dict(zip(("atol", "atol_of_rms", "rtol"), FLASH_BWD_TOL))},
          "ptxas": ptxas, **out})
    return out


def phi2_kernel_phase(torch, seed: int) -> dict:
    """K8, K5 and K3 at the shapes phi2_slice gives them, each against its
    plain version at TOLERANCES, timed beside its bound and, for K8 and K5,
    the cuBLAS yardstick (`q4_row`, `lora_row`): K8 at phi-2's five linears
    (PHI2_Q4_SHAPES x PHI2_ROWS), K5 at q/k/v and proj with rank 16, K3 at
    32 of 80 channels on fused-QKV views (PHI2_ROPE_SHAPES), and K1's
    backward at phi-2's training shape (B8, 32 heads, T1024) at head sizes
    80 and 96 (Phi-3's) beside SDPA's backward and the instance it replaced
    (K1_WAS). Returns {kernel: {row: result}}."""
    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.models.gpt import split_heads
    from dualhyp_tpu_torch.ops import lora, quant, rope

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 53)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    q4 = {}
    for name, n, k in PHI2_Q4_SHAPES:
        packed, scales = quant.quantize_weight_int4(randn(n, k, std=0.02, dtype=torch.float32))
        w_deq = quant.dequantize_weight_int4(packed, scales, bf16)
        for label, rows in PHI2_ROWS:
            if name != "lm_head" or label == "decode":
                q4[f"phi2_{label}_{name}"] = q4_row(torch, randn(rows, k), packed, scales,
                                                    w_deq)
        del packed, scales, w_deq
    emit({"phase": "kernel", "name": "q4_matmul", "shapes_of": PHI2,
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["q4_matmul"])), **q4})

    lo = {}
    for name, o, d, blocks in PHI2_LORA_SHAPES:
        w, a = randn(o, d, std=0.02), randn(blocks * LORA_RANK, d, std=1 / math.sqrt(d))
        shapes = (d, (o - d) // 2, (o - d) // 2) if blocks == 3 else (o,)
        b = lora.lora_qkv_block_b(randn(o, LORA_RANK, std=0.02), shapes, LORA_RANK)
        for label, rows in PHI2_ROWS:
            lo[f"phi2_{label}_{name}"] = lora_row(torch, randn(rows, d), w, a, b, 1.0)
    emit({"phase": "kernel", "name": "lora_linear", "shapes_of": PHI2,
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["lora_linear"])), **lo})

    cfg = config_from_name(PHI2)
    hs, n_elem, b = cfg.head_size, cfg.rope_n_elem, 8
    ro = {}
    for label, t, with_transpose in PHI2_ROPE_SHAPES:
        q5, k4, _ = split_heads(cfg, randn(b, t, cfg.qkv_out_dim))
        cos, sin = rope.build_rope_cache(t, n_elem, base=cfg.rope_base, dtype=bf16, device=dev)
        runs = [("q", q5, False), ("k", k4, False)]
        if with_transpose:
            runs += [("q_transpose", randn(*q5.shape), True),
                     ("k_transpose", randn(*k4.shape), True)]
        for part, x, tr in runs:
            fn = lambda: rope.apply_rope(x, cos, sin, tr)  # noqa: E731
            plain = lambda: rope.apply_rope_plain(x, cos, sin, tr)  # noqa: E731
            n = x.numel()
            bms, by = bound(2 * n * 2 + 2 * t * n_elem * 2, 4 * (n // hs) * n_elem, FP32_FLOPS)
            ro[f"phi2_{label}_{part}"] = dict(
                shape=list(x.shape), n_elem=n_elem, transpose=tr,
                max_abs_err=compare("apply_rope", repeatable("apply_rope", fn, torch), plain(),
                                    torch),
                repeats_bitwise=True, ms=time_ms(fn, torch), device_ms=device_ms(fn, torch),
                plain_ms=time_ms(plain, torch), library_ms=None, bound_ms=bms, bound_by=by)
        del q5, k4, runs
    emit({"phase": "kernel", "name": "apply_rope", "shapes_of": PHI2,
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["apply_rope"])), **ro})
    del cos, sin
    torch.cuda.empty_cache()

    # K1's backward at phi-2's training shape (32 heads of 80, MHA, 8 x
    # 1024) and Phi-3's head size (96): the narrow-box instances
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import attention

    bwd = {}
    b, nh, t = 8, 32, 1024
    for config, hs in ((PHI2, 80), ("Phi-3-mini-4k-instruct", 96)):
        scale = hs ** -0.5
        q, k, v, do = (randn(b, nh, t, hs) for _ in range(4))
        o, lse = attention._flash_fwd(q, k, v, scale)
        fn = lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
        plain = lambda: attention.flash_attention_bwd_plain(  # noqa: E731
            q, k, v, o, lse, do, scale)
        checks = {f"d{n}": compare_scaled(f"flash_attention_bwd d{n} D{hs}", x, y, torch)
                  for n, x, y in zip("qkv", fn(), plain())}
        qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
        sdpa_out = sdpa_gqa(F, qr, kr, vr, scale)
        pairs, n_q = b * nh * t * (t + 1) // 2, b * nh * t * hs
        bms, by = bound(10 * n_q + b * nh * t * 4, 10 * hs * pairs, BF16_TENSOR_FLOPS)
        bwd[f"d{hs}"] = dict(
            config=config, shape=[b, nh, nh, t, hs],
            layout=getattr(attention, "bwd_layout", str)(hs),
            max_abs_err=max(c["max_abs_err"] for c in checks.values()), **checks,
            ms=time_ms(fn, torch, iters=10), device_ms=device_ms(fn, torch, iters=5),
            plain_ms=time_ms(plain, torch, warmup=1, iters=2),
            library_ms=time_ms(lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do,
                                                           retain_graph=True), torch, iters=5),
            library="SDPA backward (dQ, dK, dV together; autograd.grad)",
            bound_ms=bms, bound_by=by, was_device_ms=K1_WAS["flash_attention_bwd", hs][0],
            was=K1_WAS["flash_attention_bwd", hs][1] + " (PERF.md)")
        del q, k, v, do, o, lse, qr, kr, vr, sdpa_out
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "flash_attention_bwd", "shapes_of": f"{PHI2} training",
          "tolerance": dict(zip(("atol", "atol_of_rms", "rtol"), FLASH_BWD_TOL)), **bwd})
    return {"q4_matmul": q4, "lora_linear": lo, "apply_rope": ro, "flash_attention_bwd": bwd}


def randomize_family_leaves(torch, model, gen) -> None:
    """A finetuned-looking model: every lora_B, bias and adapter v2 bias
    N(0, 0.02), every norm and adapter v2 scale 1 + N(0, 0.1), adapter v1's
    gates N(0, 0.3), so the biases, LayerNorm and PEFT leaves count (the
    init's are 0 and 1)."""
    draws = {"lora_B": (0.0, 0.02), "bias": (0.0, 0.02), "scale": (1.0, 0.1),
             "gating_factor": (0.0, 0.3)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            suffix = next((k for k in draws if name.endswith(k)), None)
            if suffix is not None:
                mean, std = draws[suffix]
                p.copy_(mean + torch.randn(p.shape, generator=gen, device=p.device) * std)


def depth2_family_check(torch, seed: int) -> dict:
    """Two blocks of each FAMILY_DEPTH2 config at full width, LoRA on
    q/k/v/proj, card bf16 against CPU fp32 on the same weights (drawn on the
    card, then copied to the CPU in fp32): the prefill logits and one decode
    step's (DEPTH2_ATOL), the K/V caches (DEPTH2_CACHE_REL), and one LoRA
    Trainer step, dropout off: the loss (TRAIN_LOSS_ATOL) and every LoRA
    gradient (TRAIN_GRAD_REL). K1's forward and backward and K3 must launch
    on the card; K2 and K4 exactly where the config has an RMSNorm and a
    gated MLP without biases. Returns {config: result}."""
    import numpy as np

    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    results = {}
    for name in FAMILY_DEPTH2:
        cfg = family_lora_config(name, n_layer=2)
        card = GPT(cfg, device="cuda", dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        card.init_weights(gen)
        randomize_family_leaves(torch, card, gen)
        cpu = GPT(cfg, device="cpu", dtype=torch.float32)
        cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()})
        rng = np.random.default_rng(seed + 1)
        t = 96  # not a multiple of the flash kernel's 64-row tile
        ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, t)))
        lengths = torch.tensor([96, 61])
        ids[1, 61:] = 0
        reset_counts()
        caches = {"cuda": card.init_cache(2, t + 1), "cpu": cpu.init_cache(2, t + 1)}
        got = card.prefill(ids.cuda(), lengths.cuda(), caches["cuda"]).cpu()
        want = cpu.prefill(ids, lengths, caches["cpu"])
        token = want.argmax(-1)
        got_step = card.decode_step(token.cuda(), lengths.cuda(), caches["cuda"]).cpu()
        want_step = cpu.decode_step(token, lengths, caches["cpu"])
        errs = {"prefill_logits": float((got - want).abs().max()),
                "decode_logits": float((got_step - want_step).abs().max())}
        cache_rel = {f"layer{i}_{kv}": float((c.float().cpu() - w).norm() / w.norm())
                     for i, (lc, lw) in enumerate(zip(caches["cuda"], caches["cpu"]))
                     for kv, c, w in zip("kv", lc, lw)}
        del caches
        # one LoRA training step at the same T
        ids = rng.integers(3, cfg.vocab_size, size=(2, t)).astype(np.int32)
        labels = ids.copy()
        labels[:, : t // 2] = -1
        batch = {"input_ids": ids, "labels": labels}
        steps = {}
        for device, model, dtype in (("cuda", card, "bfloat16"), ("cpu", cpu, "float32")):
            tcfg = TrainConfig(batch_size=2, micro_batch_size=2, compute_dtype=dtype,
                               lm_head_chunk_size=128)
            trainer = Trainer(cfg, tcfg, model)
            loss, _ = trainer.train_step(batch, max_iters=100, warmup_steps=10)
            steps[device] = (float(loss), {n: p.grad.detach().float().cpu()
                                           for n, p in trainer.trainable.items()})
            del trainer
        launches = read_counts()
        del card, cpu
        torch.cuda.empty_cache()
        (loss_card, g_card), (loss_cpu, g_cpu) = steps["cuda"], steps["cpu"]
        rel = {n: float((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm()) for n in g_cpu}
        rms = cfg.norm_class == "RMSNorm"
        k4 = cfg.mlp_class in ("LLaMAMLP", "GemmaMLP") and not cfg.bias
        must = ("flash_attention_fwd", "flash_attention_bwd", "apply_rope",
                "apply_rope_transpose") + (("rms_norm",) if rms else ()) + \
            (("swiglu_mlp",) if k4 else ())
        never = (() if rms else ("rms_norm",)) + (() if k4 else ("swiglu_mlp",)) + \
            ("lora_linear", "q4_matmul") + SPLASH_KERNELS
        result = {"phase": "depth2_family_card_vs_cpu", "config": name,
                  "head_size": cfg.head_size, "rope_n_elem": cfg.rope_n_elem,
                  "norm": cfg.norm_class, "mlp": cfg.mlp_class, "bias": cfg.bias,
                  "heads": [cfg.n_head, cfg.n_query_groups], "width": cfg.n_embd,
                  **errs, "logit_std": float(want.std()), "logit_atol": DEPTH2_ATOL,
                  "cache_rel_l2_err": cache_rel, "cache_rel_tol": DEPTH2_CACHE_REL,
                  "loss_card": loss_card, "loss_cpu": loss_cpu,
                  "loss_abs_err": abs(loss_card - loss_cpu), "loss_atol": TRAIN_LOSS_ATOL,
                  "grad_rel_l2_err_max": max(rel.values()), "grad_rel_tol": TRAIN_GRAD_REL,
                  "launches": launches}
        emit(result)
        results[name] = result
        if not max(errs.values()) <= DEPTH2_ATOL:
            raise RuntimeError(f"depth-2 {name} logits: card vs CPU {errs} > {DEPTH2_ATOL}")
        if not max(cache_rel.values()) <= DEPTH2_CACHE_REL:
            raise RuntimeError(f"depth-2 {name} caches: card vs CPU {cache_rel}")
        if not abs(loss_card - loss_cpu) <= TRAIN_LOSS_ATOL:
            raise RuntimeError(f"depth-2 {name} train loss: card {loss_card} vs CPU {loss_cpu}")
        bad = {n: e for n, e in rel.items() if not e <= TRAIN_GRAD_REL}
        if bad:
            raise RuntimeError(f"depth-2 {name} LoRA gradients off: {bad}")
        if any(launches[n] <= 0 for n in must) or any(launches[n] for n in never):
            raise RuntimeError(f"depth-2 {name}: launches {launches}, must {must}, "
                               f"never {never}")
    return results


def write_hf_phi(torch, path: Path, cfg, seed: int) -> dict:
    """A random HF-layout Phi checkpoint of `cfg` (phi-2's tensor names, bf16
    safetensors in two shards, drawn on the card from `seed`: std 0.02
    matrices and biases, LayerNorm weights near 1) and its `config.json`.
    Returns a few written tensors (CPU) to hold the conversion against."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, hs, inter = cfg.n_embd, cfg.head_size, cfg.intermediate_size

    def w(*shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(
            torch.bfloat16).cpu()

    def linear(shard, name, out_f, in_f):
        shard[name + ".weight"], shard[name + ".bias"] = w(out_f, in_f), w(out_f)

    def norm(shard, name):
        shard[name + ".weight"], shard[name + ".bias"] = w(d, std=0.1, mean=1.0), w(d)

    path.mkdir(parents=True)
    half = cfg.n_layer // 2
    shards = [{"model.embed_tokens.weight": w(cfg.vocab_size, d)}, {}]
    for i in range(cfg.n_layer):
        shard, p = shards[i >= half], f"model.layers.{i}."
        for x in "qkv":
            linear(shard, p + f"self_attn.{x}_proj", cfg.n_head * hs, d)
        linear(shard, p + "self_attn.dense", d, cfg.n_head * hs)
        linear(shard, p + "mlp.fc1", inter, d)
        linear(shard, p + "mlp.fc2", d, inter)
        norm(shard, p + "input_layernorm")
    norm(shards[1], "model.final_layernorm")
    linear(shards[1], "lm_head", cfg.vocab_size, d)
    for i, shard in enumerate(shards):
        write_safetensors(path / f"model-0000{i + 1}-of-00002.safetensors", shard)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["PhiForCausalLM"], "hidden_size": d, "intermediate_size": inter,
        "num_attention_heads": cfg.n_head, "num_hidden_layers": cfg.n_layer,
        "partial_rotary_factor": cfg.rotary_percentage, "vocab_size": cfg.vocab_size,
        "torch_dtype": "bfloat16"}))
    p = "model.layers.1.self_attn."
    return {"layer1_qkv": [shards[0][p + f"{x}_proj.weight"] for x in "qkv"],
            "layer1_qkv_bias": [shards[0][p + f"{x}_proj.bias"] for x in "qkv"],
            "lm_head_bias": shards[1]["lm_head.bias"],
            "ln_f_bias": shards[1]["model.final_layernorm.bias"]}


def phi2_slice(torch, seed: int) -> dict:
    """phi-2 at full size (32 layers, width 2560, 32 heads of 80, rotary 32
    of 80, intermediate 10240, vocab 51200, 2.8 B parameters) with LoRA r 16
    on q/k/v/proj: random bf16 weights from --seed written as an HF Phi
    directory (5.6 GB) and loaded through `cli.common.load_model` (the
    port's `convert_phi_family`); then the decode slices' traffic (16
    DualHyp requests, decode batch 8, 32 new tokens, greedy) through
    `cli.inference_ger.run_inference` in bf16 (one batch profiled), LoRA
    finetuning through `cli.finetune_ger.run_training` (4 optimizer steps of
    batch 32 in micro batches of 8, remat on, the training slice's
    settings), the traffic again with the LoRA linears through K5 (a model
    built with lora_impl "fused" holding the same weights), and once more
    merged and int4 (K8), as `--quantize int4` runs it. K1 (D 80) and K3 (n_elem
    32 of 80) must launch on every run, K1's backward and K3's transposed
    launch in training, K5 and K8 on their runs; K2 and K4 never (LayerNorm,
    the GPT-NeoX MLP)."""
    from dualhyp_tpu_torch.ckpt.convert_hf import interleave_qkv
    from dualhyp_tpu_torch.cli.common import load_model
    from dualhyp_tpu_torch.models.gpt import GPT, merge_lora, quantize_model
    from dualhyp_tpu_torch.train import TrainConfig

    cfg = family_lora_config(PHI2, lora_dropout=0.05)
    result = {"phase": "phi2_slice", "model": cfg.name, "n_layer": cfg.n_layer,
              "width": cfg.n_embd, "heads": cfg.n_head, "head_size": cfg.head_size,
              "rope_n_elem": cfg.rope_n_elem, "intermediate": cfg.intermediate_size,
              "vocab": cfg.padded_vocab_size, "lora_r": cfg.lora_r}
    serve = dict(decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1, kv_quant=None)
    runs = {}

    def served(label, model, profile):
        # the profiled batch decodes PHI2_PROFILE_NEW_TOKENS tokens: with 32
        # its trace took 71 s to post-process, with 8 23 s (NVIDIA H100
        # 80GB HBM3 hosts)
        records, metrics, wall, launches, prompt_tokens, prefill_rows = serve_requests(
            torch, model, seed, serve, f"phi2_{label}" if profile else None,
            profile_new_tokens=PHI2_PROFILE_NEW_TOKENS)
        runs[label] = {"wall_s": wall, "metrics": metrics,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "prompt_tokens": prompt_tokens, "prefill_rows": prefill_rows,
                       "launches": launches, "sample": records[0]}
        check_served(records, metrics, launches, PHI2_RUNS[label]["launch"],
                     PHI2_RUNS[label]["idle"], f"phi-2 {label}")
        return records

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        hf_dir = tmp / "phi-2"
        t0 = time.perf_counter()
        written = write_hf_phi(torch, hf_dir, cfg, seed)
        result["hf_checkpoint_gb"] = sum(f.stat().st_size for f in hf_dir.iterdir()) / 1e9
        result["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = load_model(hf_dir, cfg, device="cuda", seed=seed, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        result["load_model_s"] = time.perf_counter() - t0
        shutil.rmtree(hf_dir)
        qkv = model.blocks[1].attn.qkv
        converted = {
            "layer1_qkv": torch.equal(qkv.weight.cpu(),
                                      interleave_qkv(*written["layer1_qkv"], cfg)),
            "layer1_qkv_bias": torch.equal(qkv.bias.cpu(),
                                           interleave_qkv(*written["layer1_qkv_bias"], cfg)),
            "lm_head_bias": torch.equal(model.lm_head.bias[:cfg.vocab_size].cpu(),
                                        written["lm_head_bias"]),
            "ln_f_bias": torch.equal(model.ln_f.bias.cpu(), written["ln_f_bias"].float())}
        del written
        result["converted_equal"] = converted
        if not all(converted.values()):
            raise RuntimeError(f"load_model did not convert the phi-2 checkpoint: {converted}")
        result["parameters"] = sum(p.numel() for p in model.parameters())
        result["weight_gb"] = sum(p.numel() * p.element_size()
                                  for p in model.parameters()) / 1e9
        random_lora_b(torch, model, torch.Generator(device="cuda").manual_seed(seed + 1))
        reference = served("bf16", model, profile=True)

        tcfg = TrainConfig(batch_size=32, micro_batch_size=8, num_epochs=2,
                           frozen_dtype="bfloat16", remat=True, seed=seed,
                           log_interval=32, save_interval=10**6)
        tok, dataset = dualhyp_data(tmp, seed)
        # the LoRA leaves alone in the checkpoints (--save_adapter_only): the
        # whole tree would be 5.6 GB a file
        trained = timed_training(torch, model, tcfg, tok, dataset, tmp / "run", seed,
                                 adapter_only=True)
        out = trained.pop("out")
        result["train"] = dict(batch_size=tcfg.batch_size,
                               micro_batch_size=tcfg.micro_batch_size, remat=True,
                               val_loss=out["best_val"], **trained)
        del out
        losses = trained["losses"]
        if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"phi-2 training losses {losses}")
        # every K1 backward at phi-2's head size: the D80 instance
        missing = [n for n in PHI2_TRAIN_PATH + ("flash_attention_bwd_d80",)
                   if trained["launches"][n] <= 0]
        stray = [n for n in PHI2_IDLE + ("lora_linear", "q4_matmul")
                 if trained["launches"][n] != 0]
        if missing or stray:
            raise RuntimeError(f"phi-2 training: never launched {missing}, launched {stray}")

        fused = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl="fused")
        fused.load_state_dict(model.state_dict())
        del model
        torch.cuda.empty_cache()
        reference = served("fused", fused, profile=False)
        quantize_model(merge_lora(fused), "int4")  # what --quantize int4 runs
        torch.cuda.empty_cache()
        records = served("int4", fused, profile=False)
        runs["int4"]["vs_fused"] = token_agreement(records, reference)
        del fused
        torch.cuda.empty_cache()
    result["runs"] = {k: {key: v for key, v in r.items() if key != "sample"}
                      for k, r in runs.items()}
    result["sample"] = runs["bf16"]["sample"]
    emit(result)
    result["runs"] = runs
    return result


# ---- PEFT breadth (slice 23): adapter v1 / v2, LoRA on the MLP, mode full ----
# K5 at the MLP's shapes under --lora_mlp, TinyLlama's (name, O, D): fc_1 and
# fc_2 take O 5632 D 2048, proj O 2048 D 5632; rank 16; at a decode step's 8
# rows, the decode slices' 1536 prefill rows and the 8 x 1024 training rows
# (with the dropout's separate input there, as training runs it)
PEFT_LORA_SHAPES = (("mlp_fc", 5632, 2048), ("mlp_proj", 2048, 5632))
PEFT_LORA_ROWS = (8, 1536, 8192)
PEFT_MODES = ("adapter", "adapter_v2", "lora_mlp", "full")
# the Trainer's mode of each (LoRA on the MLP trains in mode "lora")
TRAIN_MODE = {"adapter": "adapter", "adapter_v2": "adapter_v2", "lora_mlp": "lora",
              "full": "full"}
# the full-mode slice's run_training depth: every weight is an fp32 master,
# and run_training writes the whole tree twice and the trainable leaves with
# both moments at each epoch's end (13 GB at 22 layers); its 8 x 1024 steps
# keep all 22 layers
PEFT_FULL_TRAIN_LAYERS = 4
PEFT_IDLE = ("grouped_matmul", "grouped_matmul_dlhs", "grouped_matmul_drhs") + SPLASH_KERNELS
PEFT_DECODE = ("rms_norm", "apply_rope", "flash_attention_fwd")
PEFT_TRAIN = ("rms_norm", "apply_rope", "apply_rope_transpose", "flash_attention_fwd",
              "flash_attention_bwd")
# peft_slice's runs: the kernels that must launch and those that must not. K4
# runs unless fc_1 has LoRA, adapter v2's wrap or a quantized weight; K5 on
# the fused LoRA linears; K8 on int4 weights (adapter v1's prefix through the
# quantized QKV too)
PEFT_RUNS = {
    "adapter_train": dict(launch=PEFT_TRAIN + ("swiglu_mlp",),
                          idle=PEFT_IDLE + ("lora_linear", "q4_matmul")),
    "adapter_bf16": dict(launch=PEFT_DECODE + ("swiglu_mlp",),
                         idle=PEFT_IDLE + ("lora_linear", "q4_matmul")),
    "adapter_int4": dict(launch=PEFT_DECODE + ("q4_matmul",),
                         idle=PEFT_IDLE + ("lora_linear", "swiglu_mlp")),
    "adapter_v2_train": dict(launch=PEFT_TRAIN,
                             idle=PEFT_IDLE + ("lora_linear", "q4_matmul", "swiglu_mlp")),
    "adapter_v2_bf16": dict(launch=PEFT_DECODE,
                            idle=PEFT_IDLE + ("lora_linear", "q4_matmul", "swiglu_mlp")),
    "adapter_v2_int4": dict(launch=PEFT_DECODE + ("q4_matmul",),
                            idle=PEFT_IDLE + ("lora_linear", "swiglu_mlp")),
    "lora_mlp_train": dict(launch=PEFT_TRAIN + ("lora_linear",),
                           idle=PEFT_IDLE + ("q4_matmul", "swiglu_mlp")),
    "lora_mlp_fused": dict(launch=PEFT_DECODE + ("lora_linear",),
                           idle=PEFT_IDLE + ("q4_matmul", "swiglu_mlp")),
    "lora_mlp_int4": dict(launch=PEFT_DECODE + ("q4_matmul",),
                          idle=PEFT_IDLE + ("lora_linear", "swiglu_mlp")),
    "full_train": dict(launch=PEFT_TRAIN + ("swiglu_mlp",),
                       idle=PEFT_IDLE + ("lora_linear", "q4_matmul")),
    "full_moe": dict(launch=PEFT_TRAIN[1:] + ("grouped_matmul", "grouped_matmul_dlhs",
                                              "grouped_matmul_drhs"),
                     idle=SPLASH_KERNELS + ("lora_linear", "q4_matmul", "swiglu_mlp")),
}
# compiled_flops of the full-mode 8 x 1024 step against the analytic counts:
# its forward against a third of estimate_train_flops_per_token; the whole
# step against that estimate plus what the backward recomputes (K4's two
# gate products, attention's logits)
FLOPS_REL_TOL = 0.10


def peft_config(mode: str, n_layer: int, **kw):
    """TinyLlama-1.1B-Chat as `cli.common.model_config_from_args` builds it
    for --mode: adapter v1 (lora_r 0), v2 (v1 too), LoRA r 16 on q/k/v/proj
    and the MLP (--lora_mlp), or no PEFT leaves (full)."""
    from dualhyp_tpu_torch import config_from_name

    lora = dict(lora_r=16, lora_alpha=16, lora_query=True, lora_key=True, lora_value=True,
                lora_projection=True)
    extra = {"adapter": dict(use_adapter=True), "full": {},
             "adapter_v2": dict(use_adapter=True, use_adapter_v2=True),
             "lora_mlp": dict(lora, lora_mlp=True)}[mode]
    return config_from_name("tiny-llama-1.1b-chat", n_layer=n_layer, **{**extra, **kw})


def peft_kernel_phase(torch, seed: int) -> dict:
    """K5 at the MLP's shapes under --lora_mlp (PEFT_LORA_SHAPES x
    PEFT_LORA_ROWS, the training rows with a separate dropout input too),
    each against `lora_linear_plain` at TOLERANCES, two calls bitwise equal,
    timed beside its bound and cuBLAS x3 + add (`lora_row`)."""
    from dualhyp_tpu_torch.ops import lora

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 61)
    r = LORA_RANK

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    lo = {}
    for name, o, d in PEFT_LORA_SHAPES:
        w, a, b = randn(o, d, std=0.02), randn(r, d, std=1 / math.sqrt(d)), randn(o, r, std=0.02)
        for rows in PEFT_LORA_ROWS:
            lo[f"{name}_{rows}"] = lora_row(
                torch, randn(rows, d), w, a, b, 1.0,
                launch=decode_plan(lora, rows, o, d, r, 1.0, False)
                if rows <= lora.DECODE_ROWS else None)
        rows = PEFT_LORA_ROWS[-1]
        lo[f"{name}_{rows}_xin"] = lora_row(torch, randn(rows, d), w, a, b, 1.0, randn(rows, d))
    emit({"phase": "kernel", "name": "lora_linear", "shapes_of": "TinyLlama's MLP (--lora_mlp)",
          "tolerance": dict(zip(("atol", "rtol"), TOLERANCES["lora_linear"])), **lo})
    torch.cuda.empty_cache()
    return {"lora_linear": lo}


def depth2_peft_check(torch, seed: int) -> dict:
    """Two blocks of TinyLlama at full width in each PEFT_MODES mode (the
    adapter from layer 1, so one layer runs it gated off; LoRA on the MLP
    through K5 on the card and its plain version on the CPU), every PEFT
    leaf drawn non-zero, card bf16 against CPU fp32 on the same weights:
    prefill and decode logits (DEPTH2_ATOL), the K/V caches
    (DEPTH2_CACHE_REL), and one Trainer step of the mode: the loss
    (TRAIN_LOSS_ATOL) and the gradient of every trainable leaf
    (TRAIN_GRAD_REL; zero on both sides where the gate is off): the adapter
    prefix and gates, v2's scales, biases and norms, the MLP's LoRA, every
    weight in mode full (fp32 masters on the card)."""
    import numpy as np

    from dualhyp_tpu_torch.models.gpt import GPT
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    results = {}
    for mode in PEFT_MODES:
        cfg = peft_config(mode, 2, adapter_start_layer=1)
        impl = "fused" if mode == "lora_mlp" else "xla"
        card = GPT(cfg, device="cuda", dtype=torch.bfloat16, lora_impl=impl)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        card.init_weights(gen)
        randomize_family_leaves(torch, card, gen)
        cpu = GPT(cfg, device="cpu", dtype=torch.float32, lora_impl=impl)
        cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()})
        rng = np.random.default_rng(seed + 3)
        t = 96
        ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, t)))
        lengths = torch.tensor([96, 61])
        ids[1, 61:] = 0
        reset_counts()
        caches = {"cuda": card.init_cache(2, t + 1), "cpu": cpu.init_cache(2, t + 1)}
        got = card.prefill(ids.cuda(), lengths.cuda(), caches["cuda"]).cpu()
        want = cpu.prefill(ids, lengths, caches["cpu"])
        token = want.argmax(-1)
        got_step = card.decode_step(token.cuda(), lengths.cuda(), caches["cuda"]).cpu()
        want_step = cpu.decode_step(token, lengths, caches["cpu"])
        errs = {"prefill_logits": float((got - want).abs().max()),
                "decode_logits": float((got_step - want_step).abs().max())}
        cache_rel = {f"layer{i}_{kv}": float((c.float().cpu() - w).norm() / w.norm())
                     for i, (lc, lw) in enumerate(zip(caches["cuda"], caches["cpu"]))
                     for kv, c, w in zip("kv", lc, lw)}
        del caches
        ids = rng.integers(3, cfg.vocab_size, size=(2, t)).astype(np.int32)
        labels = ids.copy()
        labels[:, : t // 2] = -1
        batch = {"input_ids": ids, "labels": labels}
        steps = {}
        for device, model, dtype in (("cuda", card, "bfloat16"), ("cpu", cpu, "float32")):
            tcfg = TrainConfig(batch_size=2, micro_batch_size=2, compute_dtype=dtype,
                               lm_head_chunk_size=128, mode=TRAIN_MODE[mode])
            trainer = Trainer(cfg, tcfg, model)
            loss, _ = trainer.train_step(batch, max_iters=100, warmup_steps=10)
            steps[device] = (float(loss), {n: p.grad.detach().float().cpu()
                                           for n, p in trainer.trainable.items()})
            del trainer
        launches = read_counts()
        del card, cpu
        torch.cuda.empty_cache()
        (loss_card, g_card), (loss_cpu, g_cpu) = steps["cuda"], steps["cpu"]
        rel = {n: float((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm()) if g_cpu[n].any()
               else float(g_card[n].abs().max()) for n in g_cpu}
        k4 = mode in ("adapter", "full")
        # adapter v1 trains layer 1 alone here: no gradient goes back through
        # an attention, so K1's backward and K3's transpose do not run
        must = (PEFT_DECODE if mode == "adapter" else PEFT_TRAIN) + (
            ("swiglu_mlp",) if k4 else ()) + (("lora_linear",) if mode == "lora_mlp" else ())
        never = PEFT_IDLE + ("q4_matmul",) + (() if k4 else ("swiglu_mlp",)) + (
            () if mode == "lora_mlp" else ("lora_linear",))
        worst = max(rel, key=rel.get)
        result = {"phase": "depth2_peft_card_vs_cpu", "mode": mode, "lora_impl": impl,
                  "width": cfg.n_embd, "adapter_start_layer": cfg.adapter_start_layer,
                  **errs, "logit_std": float(want.std()), "logit_atol": DEPTH2_ATOL,
                  "cache_rel_l2_err_max": max(cache_rel.values()),
                  "cache_rel_tol": DEPTH2_CACHE_REL,
                  "loss_card": loss_card, "loss_cpu": loss_cpu,
                  "loss_abs_err": abs(loss_card - loss_cpu), "loss_atol": TRAIN_LOSS_ATOL,
                  "trainable_leaves": len(rel), "grad_rel_l2_err_max": rel[worst],
                  "grad_rel_worst_leaf": worst, "grad_rel_tol": TRAIN_GRAD_REL,
                  "launches": launches}
        emit(result)
        results[mode] = result
        if not max(errs.values()) <= DEPTH2_ATOL:
            raise RuntimeError(f"depth-2 {mode} logits: card vs CPU {errs} > {DEPTH2_ATOL}")
        if not max(cache_rel.values()) <= DEPTH2_CACHE_REL:
            raise RuntimeError(f"depth-2 {mode} caches: card vs CPU {cache_rel}")
        if not abs(loss_card - loss_cpu) <= TRAIN_LOSS_ATOL:
            raise RuntimeError(f"depth-2 {mode} train loss: card {loss_card} vs CPU {loss_cpu}")
        bad = {n: e for n, e in rel.items() if not e <= TRAIN_GRAD_REL}
        if bad:
            raise RuntimeError(f"depth-2 {mode} gradients off: {bad}")
        if any(launches[n] <= 0 for n in must) or any(launches[n] for n in never):
            raise RuntimeError(f"depth-2 {mode}: launches {launches}, must {must}, "
                               f"never {never}")
    return results


def check_launches(launches, label) -> None:
    """PEFT_RUNS[label]'s kernels launched, its idle ones not."""
    spec = PEFT_RUNS[label]
    missing = [n for n in spec["launch"] if launches[n] <= 0]
    stray = [n for n in spec["idle"] if launches[n] != 0]
    if missing or stray:
        raise RuntimeError(f"peft {label}: never launched {missing}, launched {stray}")


def full_step_1024(torch, model, cfg, seed: int, mu_dtype: str, flops: bool) -> dict:
    """Mode-full Trainer steps of `model` at 8 x 1024 (half the labels
    masked, remat off, the head's loss chunked): 2 warm-up and 3 timed, the
    launch counts read around them, then the AdamW step alone (3 on the
    last gradients, host clock after a synchronise); with `flops`, one step
    under torch.profiler, then one step and one forward under
    `profiling.compiled_flops` and the card's memory
    (`profiling.live_device_memory`)."""
    import numpy as np

    from dualhyp_tpu_torch.train import TrainConfig, Trainer
    from dualhyp_tpu_torch.utils import profiling
    from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token

    mb, t = 8, 1024
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(mb, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 2] = -1
    batch = {"input_ids": ids, "labels": labels}
    per_token = estimate_train_flops_per_token(cfg, t)
    trainer = Trainer(cfg, TrainConfig(batch_size=mb, micro_batch_size=mb, mode="full",
                                       mu_dtype=mu_dtype, lm_head_chunk_size=128,
                                       remat=False), model)
    for _ in range(2):
        trainer.train_step(batch, max_iters=1000, warmup_steps=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch, max_iters=1000, warmup_steps=10)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    out = {"mode": "full", "mu_dtype": mu_dtype or "float32", "remat": False,
           "shape": [mb, t], "step_ms": [x * 1e3 for x in times], "median_step_ms": med * 1e3,
           "tokens_per_s": mb * t / med, "mfu": mb * t * per_token / med / BF16_TENSOR_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "loss": float(loss),
           "moment_bytes": sum(s["exp_avg"].numel() * s["exp_avg"].element_size()
                               for s in trainer.optimizer.state.values()),
           "launches": read_counts()}
    # the AdamW step alone, on the last step's gradients (which stay in .grad)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        trainer.optimizer.step()
    torch.cuda.synchronize()
    out["optimizer_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    if flops:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, max_iters=1000, warmup_steps=10)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["profile"] = {**step_kernel_ms(prof), **profile_summary(prof, wall_ms, top_n=12)}
        del prof
        step = profiling.compiled_flops(
            lambda: trainer.train_step(batch, max_iters=1000, warmup_steps=10))
        x = torch.from_numpy(ids).long().cuda()
        with torch.no_grad():
            forward = profiling.compiled_flops(lambda: model(x, return_hidden=True))
        # the head's product, which the forward above leaves to the loss
        forward += 2 * mb * t * cfg.n_embd * cfg.padded_vocab_size
        d, inter, hs = cfg.n_embd, cfg.intermediate_size, cfg.head_size
        recompute = cfg.n_layer * (2 * 2 * d * inter + 2 * cfg.n_head * hs * t)
        out["flops"] = {
            "step": step, "forward": forward, "estimate_per_step": mb * t * per_token,
            "recompute_per_step": mb * t * recompute,
            "step_over_estimate": step / (mb * t * per_token),
            "forward_over_estimate_third": forward / (mb * t * per_token / 3),
            "step_over_estimate_plus_recompute": step / (mb * t * (per_token + recompute)),
            "live_device_memory": profiling.live_device_memory()}
        for key in ("forward_over_estimate_third", "step_over_estimate_plus_recompute"):
            if not abs(out["flops"][key] - 1) <= FLOPS_REL_TOL:
                raise RuntimeError(f"compiled_flops off the estimate: {out['flops']}")
    del trainer
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    if not math.isfinite(out["loss"]):
        raise RuntimeError(f"full-mode step at 8 x 1024: {out}")
    return out


def peft_slice(torch, seed: int) -> dict:
    """PEFT breadth on full-width TinyLlama-1.1B-Chat (22 layers, width 2048,
    bf16, random weights from --seed, the PEFT leaves drawn non-zero):
    for --mode adapter and adapter_v2, and for LoRA r 16 on q/k/v/proj and
    the MLP through K5 (lora_impl "fused"): 4 optimizer steps of
    `cli.finetune_ger.run_training` (batch 32 of micro batches 8, remat,
    2 epochs of 64 records, --save_adapter_only), then the decode slices'
    traffic (16 DualHyp requests, decode batch 8, 32 new tokens, greedy)
    through `cli.inference_ger.run_inference`, and again as --quantize int4
    runs it (LoRA merged first): K8, the adapter v1 prefix through the
    quantized QKV. Mode full: 4 steps of run_training at
    PEFT_FULL_TRAIN_LAYERS layers (1 epoch of batch 16 in micro batches 8),
    then the 8 x 1024 step at 22 layers with mu_dtype "" and "bfloat16"
    (`full_step_1024`, compiled_flops held to the analytic counts); and one
    mode-full step of Mixtral-8x7B at full width and depth 1 (moe_impl
    megablox, 8 x 1024), where L2's drhs kernel (`tgmm_tma_kernel`) must
    launch. Each run's kernels must launch (PEFT_RUNS), the others not."""
    import numpy as np

    from dualhyp_tpu_torch import config_from_name
    from dualhyp_tpu_torch.ckpt.io import flatten, load_params
    from dualhyp_tpu_torch.models.gpt import GPT, is_peft_leaf, merge_lora, quantize_model
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    serve = dict(decode_batch=8, max_new_tokens=32, temperature=0.2, top_k=1, kv_quant=None)
    result = {"phase": "peft_slice", "model": "tiny-llama-1.1b-chat", "width": 2048}
    runs = {}

    def served(label, model, reference=None):
        records, metrics, wall, launches, _, _ = serve_requests(torch, model, seed, serve)
        runs[label] = {"wall_s": wall, "metrics": metrics, "launches": launches,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if reference is not None:
            runs[label]["vs_bf16"] = token_agreement(records, reference)
        check_served(records, metrics, launches, PEFT_RUNS[label]["launch"],
                     PEFT_RUNS[label]["idle"], f"peft {label}")
        return records

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tok, dataset = dualhyp_data(tmp, seed)
        for mode in PEFT_MODES[:3]:
            fused = mode == "lora_mlp"
            cfg = peft_config(mode, 22, lora_dropout=0.05 if fused else 0.0)
            model = GPT(cfg, device="cuda", dtype=torch.bfloat16,
                        lora_impl="fused" if fused else "xla")
            gen = torch.Generator(device="cuda").manual_seed(seed)
            model.init_weights(gen)
            randomize_family_leaves(torch, model, gen)
            peft = model.trainable_parameters(TRAIN_MODE[mode])
            before = {n: p.detach().clone() for n, p in peft.items()}
            tcfg = TrainConfig(batch_size=32, micro_batch_size=8, num_epochs=2,
                               frozen_dtype="bfloat16", remat=True, seed=seed, log_interval=32,
                               save_interval=10**6, mode=TRAIN_MODE[mode])
            trained = timed_training(torch, model, tcfg, tok, dataset, tmp / f"run_{mode}",
                                     seed, adapter_only=True)
            out = trained.pop("out")
            saved = load_params(tmp / f"run_{mode}" / "model_lora_finetuned.npz")
            saved_keys = list(flatten(saved))
            changed = sum(not torch.equal(before[n], p) for n, p in peft.items())
            runs[f"{mode}_train"] = {**trained, "val_loss": out["best_val"],
                                     "trainable_leaves": len(peft),
                                     "trainable_params": sum(p.numel() for p in peft.values()),
                                     "leaves_changed": changed,
                                     "saved_leaves": len(saved_keys)}
            del out, before, saved
            losses = trained["losses"]
            if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
                raise RuntimeError(f"peft {mode} training losses {losses}")
            if changed != len(peft) or not all(is_peft_leaf(k, cfg) for k in saved_keys):
                raise RuntimeError(f"peft {mode}: {changed}/{len(peft)} leaves changed, "
                                   f"saved {saved_keys[:4]}")
            check_launches(trained["launches"], f"{mode}_train")
            label = f"{mode}_fused" if fused else f"{mode}_bf16"
            reference = served(label, model)
            if fused:
                merge_lora(model)
            quantize_model(model, "int4")  # what --quantize int4 runs
            torch.cuda.empty_cache()
            served(f"{mode}_int4", model, reference)
            del model
            torch.cuda.empty_cache()

        cfg = peft_config("full", PEFT_FULL_TRAIN_LAYERS)
        model = GPT(cfg, device="cuda", dtype=torch.bfloat16)
        model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
        tcfg = TrainConfig(batch_size=16, micro_batch_size=8, num_epochs=1, remat=True,
                           seed=seed, log_interval=16, save_interval=10**6, mode="full")
        trained = timed_training(torch, model, tcfg, tok, dataset, tmp / "run_full", seed)
        out = trained.pop("out")
        masters = all(p.dtype == torch.float32 for p in model.parameters())
        runs["full_train"] = {**trained, "n_layer": cfg.n_layer, "val_loss": out["best_val"],
                              "fp32_masters": masters}
        del out, model
        torch.cuda.empty_cache()
        if len(trained["losses"]) != 4 or not all(math.isfinite(x) for x in trained["losses"]):
            raise RuntimeError(f"peft full training losses {trained['losses']}")
        if not masters:
            raise RuntimeError("mode full left a weight out of the fp32 masters")
        check_launches(trained["launches"], "full_train")

    cfg = peft_config("full", 22)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    steps = {}
    for mu_dtype in ("", "bfloat16"):
        steps[mu_dtype or "float32"] = full_step_1024(torch, model, cfg, seed, mu_dtype,
                                                      flops=not mu_dtype)
    result["full_step_1024"] = steps
    del model
    torch.cuda.empty_cache()
    for key, step in steps.items():
        runs[f"full_1024_{key}"] = {"launches": step["launches"]}
        check_launches(step["launches"], "full_train")

    cfg = config_from_name(MIXTRAL, n_layer=1)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, moe_impl="megablox")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(8, 1024)).astype(np.int32)
    labels = ids.copy()
    labels[:, :512] = -1
    trainer = Trainer(cfg, TrainConfig(batch_size=8, micro_batch_size=8, mode="full",
                                       lm_head_chunk_size=128, remat=False), model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss, _ = trainer.train_step({"input_ids": ids, "labels": labels}, 1000, 10)
    torch.cuda.synchronize()
    runs["full_moe"] = {"model": cfg.name, "n_layer": 1, "shape": [8, 1024],
                        "step_ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss),
                        "parameters": sum(p.numel() for p in model.parameters()),
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": read_counts()}
    del trainer, model
    torch.cuda.empty_cache()
    if not math.isfinite(runs["full_moe"]["loss"]):
        raise RuntimeError(f"full-mode Mixtral step: {runs['full_moe']}")
    check_launches(runs["full_moe"]["launches"], "full_moe")
    result["runs"] = runs
    emit(result)
    return result


# ---- slice 24 (ROADMAP 8c): scale-out, two ranks sharing the one card ----
# The card's machine has one H100, so the mesh paths run as two processes on
# it (CUDA_VISIBLE_DEVICES=0, gloo on CUDA tensors: NCCL refuses two ranks on
# one GPU). What this checks is the kernels at each rank's local shapes, and
# the collectives and the entry points on CUDA tensors; the per-rank times
# are two ranks sharing one card, not scaling.

# the run_training runs of the two ranks: (label, mesh extents or None for
# the pipeline's own mesh, TrainConfig fields, lora_impl)
SCALEOUT_TRAIN = (("dp2", dict(data=2), {}, "xla"),
                  ("fsdp2", dict(fsdp=2), {}, "xla"),
                  ("tensor2", dict(tensor=2), {}, "fused"),
                  ("pipe2", None, dict(pipeline_stages=2, pipeline_microbatches=2), "xla"))
SCALEOUT_SEQ_T = 1024  # the seq 2 steps' sequence length (512 tokens a rank)
# TinyLlama's depth in the scale-out runs (full width; 4 of its 22 layers,
# two a pipeline stage: every collective of a block still runs, and the
# script's time stays under its limit on a slow host)
SCALEOUT_LAYERS = 4
# a rank's bf16 loss against one rank's of the same batch (the largest
# measured was 1.6e-4, tensor 2 on an H100)
SCALEOUT_LOSS_RTOL = 1e-3
# the probe batch (rows, tokens) whose fp32 logits each run takes before its
# first step, held to one rank's: the max abs error may be at most
# SCALEOUT_PROBE_FACTOR times the bf16 reordering noise measured in the same
# run, the max abs difference of one rank's logits of the whole batch and of
# its rows one at a time (the same function; the products over fewer rows
# take other cuBLAS tilings, as a pipeline's microbatches or a seq shard's
# tokens do), with the LoRA products apart and fused (K5)
SCALEOUT_PROBE = (2, 64)
SCALEOUT_PROBE_FACTOR = 4.0
# the kernels that must launch on the ranks, and on which run
SCALEOUT_LAUNCH = {"flash_attention_fwd": "dp2", "flash_attention_bwd": "dp2",
                   "rms_norm": "fsdp2", "apply_rope": "seq2", "swiglu_mlp": "tensor2",
                   "lora_linear": "tensor2", "q4_matmul": "serve_tensor2_int4",
                   "apply_rope_transpose": "tensor2",
                   "grouped_matmul": "mixtral_expert2", "grouped_matmul_dlhs": "mixtral_expert2"}


def scaleout_kernel_phase(torch, seed: int) -> dict:
    """The kernels at the local shapes that the scale-out path gives them, each
    against its plain version and timed beside its bound: K1's forward and
    backward at TinyLlama's heads under tensor 2 (16 heads in 2 groups, B8
    T1024); K2 at a seq 2 shard (8 x 512 rows); K3 on q and k of a tensor-2
    fused QKV (1280 wide) and at a seq shard's offset (RoPE rows 512-1023);
    K4 at intermediate 2816 (TinyLlama under tensor 2, 8192 rows) and 7168
    (Mixtral, 2048 rows); K5 at the tensor-2 QKV (out 1280, rank 48, 8192
    rows); K8 at the row-parallel in dims 1024 and 2816 (decode 8 and prefill
    3072 rows); K3 transposed (the backward) on the tensor-2 q and k
    gradients; L2 and its lhs gradient over 4 local experts of Mixtral's
    fc_1 and proj (2048 slots, the local groups a skewed draw gives rank 0)."""
    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.models.gpt import split_heads
    from dualhyp_tpu_torch.ops import gmm, lora, quant, rmsnorm, rope, swiglu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 71)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def row(name, fn, plain, bytes_moved, flops, rate, shape, library=None, **extra):
        err = compare(name, repeatable(name, fn, torch), plain(), torch)
        bms, by = bound(bytes_moved, flops, rate)
        return dict(shape=shape, **extra, max_abs_err=err, ms=time_ms(fn, torch),
                    device_ms=device_ms(fn, torch),
                    plain_ms=time_ms(plain, torch, warmup=1, iters=3),
                    library_ms=time_ms(library, torch) if library else None,
                    **({"library_device_ms": device_ms(library, torch)} if library else {}),
                    bound_ms=bms, bound_by=by)

    emit({"phase": "warm_up", **warm_up(torch)})
    out = {"flash_attention": flash_bwd_phase(torch, seed, g=2, hs=64, nh=16)}
    fwd = out["flash_attention"]["forward_T1024"]
    out["flash_attention_fwd"] = {"tp_heads16_groups2": fwd}
    out["flash_attention_bwd"] = {"tp_heads16_groups2": {
        k: v for k, v in out.pop("flash_attention").items() if k != "forward_T1024"}}

    d, rows = 2048, 8 * 512
    x, scale = randn(rows, d), 1.0 + randn(d, std=0.1, dtype=torch.float32)
    scale_bf16 = scale.to(bf16)  # F.rms_norm's weight in x's dtype
    out["rms_norm"] = {"seq2_rows": row(
        "rms_norm", lambda: rmsnorm.rms_norm(x, scale), lambda: rmsnorm.rms_norm_plain(x, scale),
        2 * rows * d * 2 + d * 4, 4 * rows * d, FP32_FLOPS, [rows, d],
        library=lambda: torch.nn.functional.rms_norm(x, (d,), scale_bf16, 1e-5),
        library_name="F.rms_norm (bf16 weight)")}

    cfg = GPTConfig(n_embd=d, n_head=32, n_query_groups=4, rotary_percentage=1.0,
                    intermediate_size=5632, mlp_class="LLaMAMLP")
    b, t, hs = 8, 1024, 64
    qkv = randn(b, t, cfg.qkv_out_dim // 2)  # a tensor-2 rank's 2 of the 4 groups
    q5, k4, _ = split_heads(cfg, qkv)
    cos, sin = rope.build_rope_cache(t, hs, dtype=bf16, device=dev)
    entry = {}
    # the backward's K3 (transposed) takes the contiguous gradient of q, k
    gq, gk = randn(*q5.shape), randn(*k4.shape)
    for label, z, c, s, tr in (
            ("tp_q_heads16", q5, cos, sin, False), ("tp_k_groups2", k4, cos, sin, False),
            ("seq2_offset512_q", q5[:, :, :, 512:], cos[512:], sin[512:], False),
            ("tp_q_heads16_transpose", gq, cos, sin, True),
            ("tp_k_groups2_transpose", gk, cos, sin, True)):
        n = z.numel()
        entry[label] = row("apply_rope", lambda: rope.apply_rope(z, c, s, transpose=tr),
                           lambda: rope.apply_rope_plain(z, c, s, transpose=tr),
                           2 * n * 2 + 2 * c.shape[0] * hs * 2, 4 * n, FP32_FLOPS,
                           list(z.shape), kernel="apply_rope_transpose" if tr else "apply_rope")
    out["apply_rope"] = entry
    del gq, gk

    entry = {}
    for label, dd, inter, n_rows in (("tp_tinyllama_inter2816", 2048, 2816, 8192),
                                     ("tp_mixtral_inter7168", 4096, 7168, 2048)):
        w1, w2 = randn(inter, dd, std=0.02), randn(inter, dd, std=0.02)
        w3, xx = randn(dd, inter, std=0.02), randn(n_rows, dd)
        entry[label] = row("swiglu_mlp", lambda: swiglu.swiglu_mlp(xx, w1, w2, w3),
                           lambda: swiglu.swiglu_mlp_plain(xx, w1, w2, w3),
                           (2 * n_rows * dd + 3 * inter * dd) * 2, 6 * n_rows * dd * inter,
                           BF16_TENSOR_FLOPS, [n_rows, dd, inter],
                           library=lambda: (torch.nn.functional.silu(xx @ w1.t())
                                            * (xx @ w2.t())) @ w3.t(),
                           library_name="cuBLAS x3 (silu(x W1^T) * x W2^T) W3^T")
        del w1, w2, w3, xx
    out["swiglu_mlp"] = entry

    o, r = 1280, LORA_RANK
    w, a = randn(o, d, std=0.02), randn(3 * r, d, std=1 / math.sqrt(d))
    bb = lora.lora_qkv_block_b(randn(cfg.qkv_out_dim, r, std=0.02),
                               (d, (cfg.qkv_out_dim - d) // 2, (cfg.qkv_out_dim - d) // 2),
                               r)[:o]  # rank 0's rows of the block-diagonal B
    out["lora_linear"] = {"tp_qkv_out1280": lora_row(torch, randn(8192, d), w, a, bb, 1.0)}

    entry = {}
    for name, n, k in (("attn_proj_in1024", 2048, 1024), ("mlp_proj_in2816", 2048, 2816)):
        packed, scales = quant.quantize_weight_int4(randn(n, k, std=0.02, dtype=torch.float32))
        w_deq = quant.dequantize_weight_int4(packed, scales, bf16)
        for label, n_rows in (("decode", 8), ("prefill", 3072)):
            entry[f"{label}_{name}"] = q4_row(torch, randn(n_rows, k), packed, scales, w_deq)
    out["q4_matmul"] = entry

    # L2 as expert 2's rank 0 runs it: all 2048 slots of Mixtral's 8
    # experts (a skewed draw), sorted with its 4 local experts first; the
    # groups are theirs and the rows past them come out zero
    n_local, slots = 4, 2048
    sizes = seeded_group_sizes(torch, slots, 8, seed, "skewed")[:n_local].contiguous()
    used = int(sizes.sum())
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    out["grouped_matmul"], out["grouped_matmul_dlhs"] = {}, {}
    for name, n, k in (("fc_1", 14336, 4096), ("proj", 4096, 14336)):
        w, lhs, g = randn(n_local, n, k, std=0.02), randn(slots, k), randn(slots, n)
        lib, lib_name = grouped_mm_library(torch, lhs, w, sizes)
        out["grouped_matmul"][f"ep_local_experts4_{name}"] = row(
            "grouped_matmul", lambda: gmm.grouped_matmul(lhs, w, sizes),
            lambda: gmm.grouped_matmul_plain(lhs, w, sizes),
            used * k * 2 + n_local * n * k * 2 + slots * n * 2, 2 * used * n * k,
            BF16_TENSOR_FLOPS, [slots, n, k], library=lib, library_name=lib_name,
            group_sizes=sizes.tolist())
        lib, lib_name = first_that_runs([(
            lambda: torch._grouped_mm(g, w, offs=offs, out_dtype=torch.bfloat16),
            "torch._grouped_mm (M, N) x (E, N, K)")])
        out["grouped_matmul_dlhs"][f"ep_local_experts4_{name}"] = row(
            "grouped_matmul_dlhs", lambda: gmm.grouped_matmul_dlhs(g, w, sizes),
            lambda: gmm.grouped_matmul_dlhs_plain(g, w, sizes),
            used * n * 2 + n_local * n * k * 2 + slots * k * 2, 2 * used * n * k,
            BF16_TENSOR_FLOPS, [slots, n, k], library=lib, library_name=lib_name,
            group_sizes=sizes.tolist())
        del w, lhs, g
        torch.cuda.empty_cache()
    emit({"phase": "scaleout_kernel_phase", **out})
    return out


def scaleout_data(tmp: Path, seed: int):
    """The scale-out runs' data: the word tokenizer and seeded DualHyp
    records, 16 train (2 steps of 8), 8 val and 16 test (the served
    requests). Returns (tokenizer, dataset(split), requests)."""
    from dualhyp_tpu_torch.data import hypotheses, prompts, synthetic

    template_words = " ".join(prompts.DualHyp_PROMPTS.values()).split()
    tok = WordTokenizer(sorted(set(synthetic.word_vocabulary()) | set(template_words)))
    for name, n, s in (("train", 16, seed), ("val", 8, seed + 1), ("test", 16, seed + 2)):
        synthetic.write_json(tmp / f"{name}.json",
                             synthetic.make_records(n_uids=n, n_hyps=5, seed=s))

    def dataset(split):
        return hypotheses.DualHypothesesDataset(
            split, str(tmp / f"{split}.json"), tokenizer=tok,
            prompts_format="DualHyp", max_input_length=1024, seed=seed)

    test = dataset("test")
    requests = [(i, list(test[i].input_ids_no_response)) for i in range(len(test))]
    return tok, dataset, requests


def scaleout_tree(torch, cfg, seed: int, moe_impl=None) -> dict:
    """A random model's whole tree, on the card (every rank draws the same
    one from the seed), in the layout `load_tree` takes."""
    from dualhyp_tpu_torch.ckpt.convert import flat_from_named
    from dualhyp_tpu_torch.ckpt.io import unflatten
    from dualhyp_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, moe_impl=moe_impl)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    tree = unflatten(flat_from_named(dict(model.named_parameters()), cfg.n_layer))
    del model
    return tree


def scaleout_probe(torch, model, seed: int, path: Path) -> str:
    """This rank's fp32 logits of the seeded probe batch (SCALEOUT_PROBE),
    saved on the host to `path`: every row, and under seq the rank's tokens;
    on a pipe mesh through `pipeline_logits`. One rank alone also saves the
    logits of the rows one at a time (`path` with "_rows" before ".pt", the
    reordering noise). Returns the file's name."""
    import numpy as np

    from dualhyp_tpu_torch.parallel import pipeline_logits

    ids = torch.as_tensor(np.random.default_rng(seed + 5).integers(3, 32000, SCALEOUT_PROBE),
                          device="cuda")
    mesh = model.mesh
    with torch.no_grad():
        if mesh is not None and "pipe" in mesh.shape:
            logits = pipeline_logits(model, ids, mesh, n_micro=2)
        else:
            if mesh is not None:
                t = ids.shape[1] // mesh.extent("seq")
                ids = ids[:, mesh.index("seq") * t:(mesh.index("seq") + 1) * t]
            logits = model(ids)
            if mesh is None:
                torch.save(torch.cat([model(ids[i:i + 1]) for i in range(ids.shape[0])]).cpu(),
                           path.with_name(f"{path.stem}_rows.pt"))
    torch.save(logits.cpu(), path)
    return path.name


def scaleout_runs(torch, seed: int, mesh_of, probe_dir: Path) -> dict:
    """The scale-out workloads on this process, each on the mesh `mesh_of(
    label, extents)` gives (None: one rank alone, the reference): the four
    run_training runs of SCALEOUT_TRAIN, two Trainer steps at seq 2, the
    16 requests served over data 2 (bf16), over tensor 2 (bf16) and over
    tensor 2 merged and in int4, one LoRA step of Mixtral at depth 1 over
    expert 2. Returns, for each, the losses or tokens, step seconds, peak
    memory, launch counts and the name of its probe logits' file in
    `probe_dir` (`scaleout_probe`, before the first step)."""
    import numpy as np

    from dualhyp_tpu_torch.ckpt.convert import load_tree
    from dualhyp_tpu_torch.infer.serve import ContinuousBatcher
    from dualhyp_tpu_torch.models.gpt import GPT, merge_lora, quantize_model
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    bf16 = torch.bfloat16
    cfg = lora_config(SCALEOUT_LAYERS)
    tree = scaleout_tree(torch, cfg, seed)
    runs = {}
    done = {}  # one rank alone: the run_training runs that are the same run

    def model_on(label, extents, lora_impl="xla", model_cfg=cfg, model_tree=None,
                 moe_impl=None, mesh=None):
        mesh = mesh or mesh_of(label, extents)
        model = GPT(model_cfg, device="cuda", dtype=bf16, lora_impl=lora_impl,
                    moe_impl=moe_impl, mesh=mesh)
        load_tree(model, tree if model_tree is None else model_tree)
        return model

    def settle():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tok, dataset, requests = scaleout_data(tmp, seed)
        for label, extents, extra, lora_impl in SCALEOUT_TRAIN:
            mesh = mesh_of(label, extents)
            if mesh is None:
                # one rank alone: no pipeline, and one run a LoRA implementation
                extra = {}
                if lora_impl in done:
                    runs[label] = runs[done[lora_impl]]
                    continue
                done[lora_impl] = label
            settle()
            model = model_on(label, extents, lora_impl, mesh=mesh)
            probe = scaleout_probe(torch, model, seed, probe_dir / f"{label}.pt")
            tcfg = TrainConfig(batch_size=8, micro_batch_size=8, num_epochs=1,
                               frozen_dtype="bfloat16", remat=True, seed=seed, log_interval=8,
                               save_interval=10**6, **extra)
            trained = timed_training(torch, model, tcfg, tok, dataset, tmp / label, seed,
                                     adapter_only=True)
            runs[label] = {k: trained[k] for k in ("losses", "step_s", "peak_mem_gb",
                                                   "launches")}
            runs[label]["val_loss"] = trained["out"]["best_val"]
            runs[label]["probe"] = probe
            del model, trained
        # seq 2: the Trainer at T 1024, 512 tokens a rank, two steps
        settle()
        model = model_on("seq2", dict(seq=2))
        probe = scaleout_probe(torch, model, seed, probe_dir / "seq2.pt")
        trainer = Trainer(cfg, TrainConfig(batch_size=2, micro_batch_size=2,
                                           frozen_dtype="bfloat16", remat=True, seed=seed),
                          model, mesh=model.mesh)
        rng = np.random.default_rng(seed)
        ids = rng.integers(3, 32000, (2, SCALEOUT_SEQ_T)).astype(np.int64)
        labels = ids.copy()
        labels[:, : SCALEOUT_SEQ_T // 2] = -1
        reset_counts()
        losses, step_s = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            loss, _ = trainer.train_step({"input_ids": ids, "labels": labels}, 10, 1)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
        runs["seq2"] = {"losses": losses, "step_s": step_s, "launches": read_counts(),
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "probe": probe}
        del model, trainer
        # the 16 requests served: over data 2 and tensor 2 in bf16, over tensor
        # 2 merged + int4 (one rank alone serves each model once)
        served_one = {}
        for label, extents, quantize in (("serve_data2", dict(data=2), None),
                                         ("serve_tensor2", dict(tensor=2), None),
                                         ("serve_tensor2_int4", dict(tensor=2), "int4")):
            if mesh_of(label, extents) is None and quantize in served_one:
                runs[label] = runs[served_one[quantize]]
                continue
            served_one[quantize] = label
            settle()
            model = model_on(label, extents)
            if quantize:
                merge_lora(model)
                quantize_model(model, quantize)
            probe = scaleout_probe(torch, model, seed, probe_dir / f"{label}.pt")
            batcher = ContinuousBatcher(model, slots=16, max_new_tokens=32, chunk_steps=8,
                                        eos_id=tok.eos_token_id)
            reset_counts()
            t0 = time.perf_counter()
            served = batcher.serve(requests)
            torch.cuda.synchronize()
            runs[label] = {"tokens": {str(r["id"]): r["tokens"] for r in served},
                           "prompt_lens": {str(r["id"]): r["prompt_len"] for r in served},
                           "wall_s": time.perf_counter() - t0, "chunks": batcher.chunks,
                           "launches": read_counts(), "probe": probe,
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            del model, batcher
    del tree
    # Mixtral at depth 1 (megablox: L2), expert 2: one LoRA step
    settle()
    mcfg = mixtral_config(1)
    mtree = scaleout_tree(torch, mcfg, seed + 1, moe_impl="megablox")
    model = model_on("mixtral_expert2", dict(expert=2), model_cfg=mcfg, model_tree=mtree,
                     moe_impl="megablox")
    del mtree
    probe = scaleout_probe(torch, model, seed, probe_dir / "mixtral_expert2.pt")
    trainer = Trainer(mcfg, TrainConfig(batch_size=4, micro_batch_size=4,
                                        frozen_dtype="bfloat16", remat=True, seed=seed),
                      model, mesh=model.mesh)
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(3, 32000, (4, 256)).astype(np.int64)
    reset_counts()
    t0 = time.perf_counter()
    loss, _ = trainer.train_step({"input_ids": ids, "labels": ids}, 10, 1)
    runs["mixtral_expert2"] = {"losses": [float(loss)], "step_s": [time.perf_counter() - t0],
                               "launches": read_counts(), "probe": probe,
                               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, trainer
    settle()
    return runs


def gloo_cuda_probe(torch) -> dict:
    """Which collectives this gloo group takes on CUDA tensors, each checked
    for its values on two ranks ("ok", or what went wrong): those that
    `parallel.comm` uses. Send / recv is not tried: torch documents gloo's
    as CPU-only, and a failed collective ends the group."""
    import torch.distributed as dist

    rank, dev = dist.get_rank(), torch.device("cuda", 0)
    x = torch.arange(4, device=dev, dtype=torch.float32) + 10 * rank
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    split = [0, 4] if rank == 0 else [4, 0]

    def run(fn, out, want):
        fn(out)
        return out.cpu().tolist() == want

    trials = {
        "all_reduce": lambda: run(lambda y: dist.all_reduce(y), x.clone(),
                                  [10., 12., 14., 16.]),
        "all_reduce_max_bf16": lambda: run(
            lambda y: dist.all_reduce(y, op=dist.ReduceOp.MAX), x.to(torch.bfloat16),
            [10., 11., 12., 13.]),
        "broadcast": lambda: run(lambda y: dist.broadcast(y, src=0), x.clone(),
                                 [0., 1., 2., 3.]),
        "all_gather_single": lambda: run(lambda y: gather(y, x), x.new_empty(8),
                                         [0., 1., 2., 3., 10., 11., 12., 13.]),
        "reduce_scatter_single": lambda: run(lambda y: scatter(y, x), x.new_empty(2),
                                             [10., 12.] if rank == 0 else [14., 16.]),
        "all_to_all_single_shift": lambda: run(
            lambda y: dist.all_to_all_single(y, x, split, split), x.new_empty(4),
            [10., 11., 12., 13.] if rank == 0 else [0., 1., 2., 3.]),
    }
    out = {}
    for name, trial in trials.items():
        try:
            out[name] = "ok" if trial() else "wrong values"
        except Exception as exc:  # a backend's refusal is the probe's finding
            out[name] = f"{type(exc).__name__}: {str(exc)[:120]}"
    return out


def scaleout_child(torch, seed: int, out: Path) -> None:
    """One rank of scaleout_slice (its own process, `--scaleout-child`):
    joins the two-rank gloo group on the card and runs `scaleout_runs` on
    meshes of the world's two ranks; writes the results to `out`."""
    import torch.distributed as dist

    from dualhyp_tpu_torch.parallel import init_distributed, make_mesh, make_pipe_mesh

    init_distributed(backend="gloo", device="cuda:0")

    def mesh_of(label, extents):
        return make_pipe_mesh(2) if extents is None else make_mesh(**extents)

    probe = gloo_cuda_probe(torch)
    probe_dir = out.parent / f"{out.stem}_probe"
    probe_dir.mkdir()
    runs = scaleout_runs(torch, seed, mesh_of, probe_dir)
    out.write_text(json.dumps({"rank": dist.get_rank(), "runs": runs, "gloo_cuda": probe}))
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def scaleout_slice(torch, seed: int) -> dict:
    """Scale-out (slice 24) as two ranks on the one card: two processes of
    this script (`--scaleout-child`, CUDA_VISIBLE_DEVICES=0, LOCAL_RANK 0,
    RANK 0 / 1, WORLD_SIZE 2, gloo) run `scaleout_runs` on their meshes while
    this process runs the same workloads as one rank alone. Each rank's loss
    must be within SCALEOUT_LOSS_RTOL of the one rank's on the same batch,
    and each run's probe logits within SCALEOUT_PROBE_FACTOR times the
    measured bf16 reordering noise of the one rank's; the served tokens are
    reported against the one rank's; the kernels of SCALEOUT_LAUNCH must
    launch in both ranks (their own counts). The step times are two ranks
    sharing one card, not scaling."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", LOCAL_RANK="0", WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = []
        for rank in range(2):
            log = open(tmp / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--seed", str(seed),
                 "--scaleout-child", str(tmp / f"rank{rank}.json")],
                env=dict(env, RANK=str(rank)), stdout=log, stderr=subprocess.STDOUT), log))
        try:
            t0 = time.perf_counter()
            (tmp / "one").mkdir()
            one = scaleout_runs(torch, seed, lambda label, extents: None, tmp / "one")
            one_s = time.perf_counter() - t0
            rcs = [p.wait(timeout=900) for p, _ in procs]
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        if any(rcs):
            tails = {r: (tmp / f"rank{r}.log").read_text()[-3000:] for r in range(2)}
            raise RuntimeError(f"scale-out ranks exited {rcs}: {tails}")
        done = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        ranks = [d["runs"] for d in done]
        # each run's probe logits: one rank's, and the two ranks' (under seq
        # each holds its half of the tokens)
        probes, noises = {}, {}
        for label, ref in one.items():
            want = torch.load(tmp / "one" / ref["probe"])
            rows = tmp / "one" / ref["probe"].replace(".pt", "_rows.pt")
            if label in ("dp2", "tensor2"):  # LoRA apart, fused
                noises[label] = float((torch.load(rows) - want).abs().max())
            got = [torch.load(tmp / f"rank{r}_probe" / ranks[r][label]["probe"])
                   for r in range(2)]
            if label == "seq2":
                got = [torch.cat(got, dim=1)] * 2
            probes[label] = (want, got)
    noises["fused_vs_apart"] = float((probes["dp2"][0] - probes["tensor2"][0]).abs().max())
    noise = max(noises.values())
    result = {"phase": "scaleout_slice", "ranks": 2, "sharing": "two ranks on one card "
              "(gloo on CUDA tensors), per-rank times are not scaling", "one_rank_s": one_s,
              "gloo_cuda": [d["gloo_cuda"] for d in done],
              "probe": {"shape": list(SCALEOUT_PROBE), "bf16_reordering_noise": noise,
                        "noise_of": "the most of max |one rank's logits of the whole batch - "
                                    "of its rows one at a time| (LoRA apart: dp2, fused: "
                                    "tensor2) and max |fused - apart|", "noises": noises,
                        "limit": SCALEOUT_PROBE_FACTOR * noise,
                        "logits_std": float(probes["dp2"][0].std())},
              "runs": {}}
    bad = []
    for label, ref in one.items():
        entry = {"one_rank": {k: v for k, v in ref.items() if k not in ("tokens", "prompt_lens")}}
        want, got_logits = probes[label]
        for r, runs in enumerate(ranks):
            got = runs[label]
            entry[f"rank{r}"] = {k: v for k, v in got.items()
                                 if k not in ("tokens", "prompt_lens")}
            err = float((got_logits[r] - want).abs().max()) \
                if got_logits[r].shape == want.shape else float("inf")
            entry[f"rank{r}"]["probe_max_abs_err"] = err
            if not err <= SCALEOUT_PROBE_FACTOR * noise:
                bad.append(f"{label} rank {r}: probe logits off by {err} (noise {noise})")
            if "losses" in ref:
                rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
                entry[f"rank{r}"]["loss_rel_err"] = rel
                if not (len(rel) == len(ref["losses"]) and max(rel) <= SCALEOUT_LOSS_RTOL):
                    bad.append(f"{label} rank {r}: losses {got['losses']} vs {ref['losses']}")
            else:
                same = sum(got["tokens"][i] == ref["tokens"][i] for i in ref["tokens"])
                entry[f"rank{r}"]["requests_equal_to_one_rank"] = f"{same}/{len(ref['tokens'])}"
                # the tokens each request generated before it first parted
                # from one rank's, of the one rank's count
                entry[f"rank{r}"]["generated_before_parting"] = [
                    [next((j for j, (a, b) in enumerate(zip(got["tokens"].get(i, []), want_t))
                           if a != b), min(len(got["tokens"].get(i, [])), len(want_t)))
                     - ref["prompt_lens"][i], len(want_t) - ref["prompt_lens"][i]]
                    for i, want_t in ref["tokens"].items()]
                if sorted(got["tokens"]) != sorted(ref["tokens"]):
                    bad.append(f"{label} rank {r}: served {len(got['tokens'])} requests")
        result["runs"][label] = entry
    for name, label in SCALEOUT_LAUNCH.items():
        counts = [runs[label]["launches"][name] for runs in ranks]
        if min(counts) <= 0:
            bad.append(f"{name} launched {counts} times on {label}")
    result["launches_by_rank"] = {label: [runs[label]["launches"] for runs in ranks]
                                  for label in ranks[0]}
    emit(result)
    if bad:
        raise RuntimeError(f"scale-out: {bad}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scaleout-child", type=Path, default=None,
                        help="run one rank of scaleout_slice, writing its results here")
    args = parser.parse_args(argv)

    import torch

    if args.scaleout_child is not None:
        sys.path.insert(0, str(REPO))
        scaleout_child(torch, args.seed, args.scaleout_child)
        return 0

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
    # registers, static shared memory and spills of the wgmma/TMA kernels
    emit({"phase": "ptxas", **{src: ptxas_report(src) or "not measured (built before this run)"
                               for src in ("flash_attention.cu", "flash_attention_bwd.cu",
                                           "flash_fwd.cu", "swiglu.cu", "int4_matmul.cu",
                                           "grouped_matmul.cu", "lora_linear.cu",
                                           "rmsnorm.cu", "rope.cu")}})
    # the kernels on the tensor cores: wgmma (HGMMA) instructions in their SASS
    emit({"phase": "sass", "HGMMA": sass_counts(lib)})
    emit({"phase": "l2_flush", "bytes": L2_FLUSH_BYTES, "ms": time_ms(l2_flush(torch), torch)})

    seconds = {}

    def run(label, fn, *a, **kw):
        t1 = time.perf_counter()
        out = fn(torch, args.seed, *a, **kw)
        seconds[label] = time.perf_counter() - t1
        return out

    run("native_phase", native_phase)
    kernels = run("kernel_phases", kernel_phases)
    kernels.update(run("q4_lora_phase", q4_lora_phase))
    verify_rows = run("verify_rows_phase", verify_rows_phase)
    fwd = run("flash_fwd_phase", flash_fwd_phase)
    kernels.update({k: fwd[k] for k in ("full_attention_fwd", "causal_attention_fwd")})
    kernels["grouped_matmul"] = run("gmm_phase", gmm_phase)
    kernels["flash_attention_fwd"]["d128"] = run("flash_d128_phase", flash_d128_phase)
    kernels.update(run("gmm_bwd_phase", gmm_bwd_phase))
    kernels.update(run("splash_phase", splash_phase))
    run("depth2_check", depth2_check)
    run("depth2_int4_check", depth2_int4_check)
    run("depth2_encoder_check", depth2_encoder_check)
    run("depth2_verify_check", depth2_verify_check)
    sliced = run("decode_slice", slice_run)
    slices = {variant: run(f"{variant}_slice", slice_run, variant, reference=sliced)
              for variant in ("int4", "int8_kv8", "fused")}
    spec = run("spec_decode_slice", spec_decode_slice, reference=sliced)
    served = run("serve_slice", serve_slice)
    whisper_dir = tempfile.TemporaryDirectory()
    whisper = Path(whisper_dir.name) / "whisper"
    relprompt = run("relprompt_slice", relprompt_slice, whisper)
    run("depth2_relprompt_train_check", depth2_relprompt_train_check)
    relprompt_train = run("relprompt_train_slice", relprompt_train_slice, whisper)
    whisper_kernels = run("whisper_kernel_phase", whisper_kernel_phase)
    for name in ("q4_matmul", "full_attention_fwd"):
        kernels[name].update(whisper_kernels[name])
    run("depth2_whisper_decoder_check", depth2_whisper_decoder_check)
    asr = run("whisper_asr_slice", whisper_asr_slice, whisper)
    longform = run("longform_slice", longform_slice, whisper)
    run("depth2_vsr_check", depth2_vsr_check)
    braven = Path(whisper_dir.name) / "braven_large.npz"
    vsr = run("vsr_slice", vsr_slice, braven)
    avsr = run("avsr_slice", avsr_slice)
    visual = run("precompute_visual_phase", precompute_visual_phase, whisper, braven)
    whisper_dir.cleanup()
    kernels["flash_attention_bwd"] = {"train": run("flash_bwd_phase", flash_bwd_phase)}
    kernels["flash_attention_bwd"]["d128"] = run("flash_bwd_d128_phase", flash_bwd_phase,
                                                 g=8, hs=128)
    train_shapes = run("training_shape_phase", training_shape_phase)
    train_shapes_moe = run("training_shape_mixtral_phase", training_shape_mixtral_phase)
    run("depth2_train_check", depth2_train_check)
    run("depth2_train_check_fused", depth2_train_check, lora_impl="fused")
    depth2_splash = {t: run(f"depth2_train_check_splash_T{t}", depth2_train_check,
                            attn="splash", t=t) for t in (256, 160)}
    trained = run("train_slice", train_slice)
    stepped = run("train_step_1024", train_step_1024)
    splashed = run("splash_slice", splash_slice)
    attn_ab = run("attn_ab_1024", attn_ab_1024)
    nosync = run("moe_nosync_check", moe_nosync_check)
    depth2_moe = run("depth2_mixtral_check", depth2_mixtral_check)
    depth2_moe_train = run("depth2_mixtral_train_check", depth2_mixtral_train_check)
    mixtral = run("mixtral_slice", mixtral_slice)
    mixtral_train = run("mixtral_train_slice", mixtral_train_slice)
    heads = run("flash_heads_phase", flash_heads_phase)
    phi2_kernels = run("phi2_kernel_phase", phi2_kernel_phase)
    for name in ("q4_matmul", "lora_linear"):
        kernels[name].update(phi2_kernels[name])
    depth2_family = run("depth2_family_check", depth2_family_check)
    phi2 = run("phi2_slice", phi2_slice)
    kernels["lora_linear"].update(run("peft_kernel_phase", peft_kernel_phase)["lora_linear"])
    depth2_peft = run("depth2_peft_check", depth2_peft_check)
    peft = run("peft_slice", peft_slice)
    scale_kernels = run("scaleout_kernel_phase", scaleout_kernel_phase)
    scaled = run("scaleout_slice", scaleout_slice)
    emit({"phase": "phase_seconds", **seconds})

    sources = {"rms_norm": ("rmsnorm.cu", "dualhyp_tpu/ops/pallas/rmsnorm_kernel.py:26"),
               "apply_rope": ("rope.cu", "dualhyp_tpu/ops/pallas/rope_kernel.py:29"),
               "flash_attention_fwd": ("flash_attention.cu",
                                       "dualhyp_tpu/ops/pallas/flash_vjp.py:77"),
               "flash_attention_bwd": ("flash_attention_bwd.cu",
                                       "dualhyp_tpu/ops/pallas/flash_vjp.py:121"),
               "swiglu_mlp": ("swiglu.cu", "dualhyp_tpu/ops/pallas/swiglu_kernel.py:37"),
               "lora_linear": ("lora_linear.cu", "dualhyp_tpu/ops/pallas/lora_kernel.py:42"),
               "q4_matmul": ("int4_matmul.cu", "dualhyp_tpu/ops/pallas/int4_kernel.py:36"),
               "full_attention_fwd": ("flash_fwd.cu", "dualhyp_tpu/ops/pallas/flash_fwd.py:118"),
               "causal_attention_fwd": ("flash_attention.cu",
                                        "dualhyp_tpu/ops/pallas/flash_fwd.py:179"),
               "grouped_matmul": ("grouped_matmul.cu",
                                  "jax/experimental/pallas/ops/tpu/megablox/gmm.py:526 "
                                  "(megablox gmm, called at dualhyp_tpu/models/gpt.py:516)"),
               "grouped_matmul_dlhs": ("grouped_matmul.cu",
                                       "jax/experimental/pallas/ops/tpu/megablox/ops.py:80 "
                                       "(_gmm_bwd's gmm with the other transpose, pallas_call "
                                       "gmm.py:526)"),
               "grouped_matmul_drhs": ("grouped_matmul.cu",
                                       "jax/experimental/pallas/ops/tpu/megablox/gmm.py:763 "
                                       "(tgmm, called by _gmm_bwd at ops.py:90)"),
               **{name: ("flash_attention.cu" if name == "splash_attention_fwd" else
                         "flash_attention_bwd.cu",
                         "jax/experimental/pallas/ops/tpu/splash_attention/"
                         f"splash_attention_kernel.py:{line} ({fn}, reached from "
                         "dualhyp_tpu/ops/pallas/flash_attention.py:66)")
                  for name, line, fn in (
                      ("splash_attention_fwd", 1137, "flash_attention_kernel :696"),
                      ("splash_attention_dq", 1635, "_flash_attention_dq_kernel :1307"),
                      ("splash_attention_dkv", 2196, "_flash_attention_dkv_kernel :1669"))}}
    # each kernel's main path, and the shape of its row in the line
    main_path = {"lora_linear": ("fused_slice", "qkv_1536"),
                 "q4_matmul": ("int4_slice", "decode_fc_1"),
                 "full_attention_fwd": ("relprompt_slice", "b1_t280_f32"),
                 "causal_attention_fwd": ("causal_attention_fwd_phase", "T1024"),
                 "grouped_matmul": ("mixtral_slice", "decode_fc_1_skewed"),
                 "grouped_matmul_dlhs": ("mixtral_train_slice", "fc_1_skewed"),
                 "grouped_matmul_drhs": ("peft_full_moe", "fc_1_skewed"),
                 "splash_attention_fwd": ("splash_slice", "prefill"),
                 "splash_attention_dq": ("splash_slice", "train"),
                 "splash_attention_dkv": ("splash_slice", "train")}
    call_paths = {
        "full_attention_fwd": "cli.inference_relprompt.run_relprompt -> "
                              "cli.finetune_relprompt feature loader -> models.whisper.encode "
                              "-> _mha, each of 32 layers; cli.precompute_features.main -> "
                              "the same encode; cli.make_json_asr.main -> "
                              "decode_beams_from_mels -> encode in bf16 (an F16 checkpoint); "
                              "cli.transcribe.main -> infer.transcribe -> encode; "
                              "cli.precompute_features.main --raven_checkpoint (beside the "
                              "BRAVEn encoder, which runs no kernel)",
        "q4_matmul": "cli.inference_ger.run_inference --quantize int4 -> GPT.prefill/"
                     "decode_step; cli.make_json_asr.main (quantize: int4) -> "
                     "whisper_device_beam -> models.whisper.decode_step_cached / "
                     "precompute_cross_kv -> _dec_linear; cli.transcribe.main --quantize int4",
        "causal_attention_fwd": "no production call site (the JAX package calls "
                                "causal_attention_fwd from its tests only): this script's "
                                "K7 kernel phase",
        "grouped_matmul": "cli.inference_ger.run_inference -> GPT.prefill/decode_step -> "
                          "MoE._sparse (moe_impl megablox), 3 launches a layer a forward; "
                          "cli.finetune_ger.run_training -> GPT.forward (+ remat)",
        "grouped_matmul_dlhs": "cli.finetune_ger.run_training -> train.Trainer.train_step -> "
                               "GPT.forward + backward -> MoE (moe_impl megablox) -> "
                               "GroupedMatmul.backward, 3 launches a layer a micro step",
        "grouped_matmul_drhs": "train.Trainer.train_step (mode full) -> GPT.forward + "
                               "backward -> MoE (moe_impl megablox) -> GroupedMatmul.backward "
                               "with trainable expert stacks, 3 launches a layer a micro step "
                               "(peft_slice's Mixtral step); LoRA training launches it 0 "
                               "times",
        **{name: "DUALHYP_ATTN_IMPL=splash: cli.finetune_ger.run_training -> "
                 "train.Trainer.train_step -> GPT.forward (+ remat, + backward) -> "
                 "ops.attention.causal_attention -> ops.splash.SplashAttention; "
                 "cli.inference_ger.run_inference -> GPT.prefill (forward only)"
           for name in SPLASH_KERNELS}}
    paths = {"decode_slice": sliced["launches"], "train_slice": trained["launches"],
             **{f"{v}_slice": slices[v]["launches"] for v in slices},
             **{f"train_step_1024_{k}": r["launches"] for k, r in stepped.items()},
             "relprompt_slice": relprompt["launches"],
             "relprompt_precompute": relprompt["launches_precompute"],
             "relprompt_train_slice": relprompt_train["launches"],
             **{f"asr_slice_{k}": r for k, r in asr["launches"].items()},
             "longform_slice": longform["launches"],
             "vsr_slice": vsr["launches"], "avsr_slice": avsr["launches"],
             "precompute_visual": visual["launches"],
             **{f"spec_decode_{k}": r["launches"] for k, r in spec["runs"].items()},
             **{f"serve_{k}": r["launches"] for k, r in served["runs"].items()},
             "causal_attention_fwd_phase": fwd["causal_launches"],
             "mixtral_slice": mixtral["megablox"]["launches"],
             "mixtral_dense_slice": mixtral["dense"]["launches"],
             "depth2_mixtral": depth2_moe["launches"],
             "mixtral_train_slice": mixtral_train["launches"],
             **{f"mixtral_train_1024_{k}": r["launches"]
                for k, r in mixtral_train["step_1024"].items()},
             **{f"depth2_mixtral_train_{k}": depth2_moe_train[k]["launches"]
                for k in ("megablox", "dense")},
             "moe_layer_lhs_grads": nosync["backward_frozen_stacks"]["launches"],
             "moe_layer_weight_grads": nosync["backward_trainable_stacks"]["launches"],
             "splash_slice": splashed["launches"],
             "splash_slice_decode": splashed["decode_launches"],
             **{f"depth2_train_splash_T{t}": r["launches"] for t, r in depth2_splash.items()},
             **{f"attn_ab_1024_{k}": r["launches"] for k, r in attn_ab.items()},
             **{f"phi2_{k}": r["launches"] for k, r in phi2["runs"].items()},
             "phi2_train": phi2["train"]["launches"],
             **{f"peft_{k}": r["launches"] for k, r in peft["runs"].items()},
             **{f"depth2_peft_{k}": r["launches"] for k, r in depth2_peft.items()},
             **{f"depth2_family_{k}": r["launches"] for k, r in depth2_family.items()}}
    # the runs whose every K1 launch is at one of those head sizes (the
    # launch counts are the wrapper's, over all head sizes)
    head_paths = {80: ("phi2_bf16", "phi2_fused", "phi2_int4", "phi2_train",
                       "depth2_family_phi-2"),
                  256: ("depth2_family_pythia-1b", "depth2_family_Gemma-2b"),
                  96: ("depth2_family_Phi-3-mini-4k-instruct",),
                  100: ("depth2_family_open_llama_3b",), 32: ()}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "shape")
    train_rows = {"rms_norm": train_shapes["rms_norm"],
                  "apply_rope": train_shapes["apply_rope_forward"],
                  "swiglu_mlp": train_shapes["swiglu_mlp"]}
    moe_train_rows = {"rms_norm": {"mixtral_train_rows": "rms_norm"},
                      "apply_rope": {"mixtral_train_rows": "apply_rope_forward",
                                     "mixtral_train_rows_transpose": "apply_rope_transpose"}}
    line = []
    for name in KERNELS:
        src, replaces = sources[name]
        path, shape = main_path.get(name, ("train_slice", None))
        main_shape = (kernels[name][shape] if shape else
                      kernels[name].get("prefill", kernels[name].get("train")))
        launches = {p: counts[name] for p, counts in paths.items()}
        if name == "apply_rope":
            launches["train_slice_transpose"] = trained["launches"]["apply_rope_transpose"]
        entry = {
            "name": name, "route": "cuda", "source": f"dualhyp_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[path], "main_path": path,
            "launches_by_path": launches,
            "path": call_paths.get(
                name, "cli.finetune_ger.run_training -> train.Trainer.train_step -> "
                      "GPT.forward (+ backward); cli.inference_ger.run_inference -> "
                      "GPT.prefill/decode_step"),
            **{k: main_shape[k] for k in keys},
            **({"decode": kernels[name]["decode"]} if "decode" in kernels[name] else {}),
        }
        if shape:  # K5, K6, K7, K8: every measured shape beside the main one
            entry["shapes"] = {k: {key: v[key] for key in keys + ("bound_ms_cuda_cores",
                                                                  "library_device_ms")
                                   if key in v}
                               for k, v in kernels[name].items()}
        if name == "full_attention_fwd":  # fp32: the CUDA cores' bound beside the split one
            entry["bound_ms_cuda_cores"] = main_shape["bound_ms_cuda_cores"]
        if name in train_rows:
            entry["train_rows"] = {k: train_rows[name][k] for k in keys}
        if name in verify_rows:  # K4, K5, K8 at a verify step's rows, each row's path
            entry["verify_rows"] = {
                k: {key: v[key] for key in keys + ("path", "library_device_ms",
                                                   "share_of_bound", "was_device_ms")
                    if key in v}
                for k, v in verify_rows[name].items()}
        if name in ("q4_matmul", "lora_linear", "swiglu_mlp"):  # the middle paths' launches
            entry["middle_kernel_launches"] = {p: counts[f"{name}_mid"]
                                               for p, counts in paths.items()
                                               if counts.get(f"{name}_mid")}
        if name == "apply_rope":
            entry["train_rows_transpose"] = {
                k: train_shapes["apply_rope_transpose"][k] for k in keys}
        for key, row in moe_train_rows.get(name, {}).items():  # width 4096, head 128
            entry[key] = {k: train_shapes_moe[row][k] for k in keys}
        if name == "flash_attention_fwd":  # Mixtral's head size; both training shapes
            entry["d128"] = {k: kernels[name]["d128"]["T384"][k] for k in keys}
            for key, head in (("train_T1024", "train"), ("d128_train_T1024", "d128")):
                row = kernels["flash_attention_bwd"][head]["forward_T1024"]
                entry[key] = {k: row[k] for k in keys}
        if name == "flash_attention_bwd":
            entry["d128"] = {k: kernels[name]["d128"][k] for k in keys}
        if name in FLASH_KERNELS:  # the head sizes other than 64 and 128
            for hs, runs_at in head_paths.items():
                row = heads[name][f"d{hs}"]
                entry[f"d{hs}"] = {
                    **{k: row[k] for k in keys}, "config": row["config"],
                    "launches": sum(launches[p] for p in runs_at),
                    "launches_by_path": {p: launches[p] for p in runs_at},
                    **({"prefill": {k: row[f"prefill_T{FLASH_HEADS_PREFILL_T}"][k]
                                    for k in keys}}
                       if f"prefill_T{FLASH_HEADS_PREFILL_T}" in row else {})}
        if name == "apply_rope":  # partial rotary, 32 of phi-2's 80 channels
            entry["phi2_partial_rotary"] = {k: {key: v[key] for key in keys}
                                            for k, v in phi2_kernels[name].items()}
            entry["phi2_partial_rotary_launches"] = {
                p: launches[p] for p in ("phi2_bf16", "phi2_train")}
            entry["phi2_partial_rotary_transpose_launches"] = phi2["train"]["launches"][
                "apply_rope_transpose"]
        if name in SPLASH_KERNELS:
            entry["launches"] = launches["splash_slice"] + (
                launches["splash_slice_decode"] if name == "splash_attention_fwd" else 0)
            entry["main_path"] = "splash_slice (training + decode)"
        # scale-out: each rank's launches on each run (two ranks sharing the
        # card), and the kernel at the local shapes those runs give it
        entry["scaleout"] = {
            "launches_by_run": {label: [counts[name] for counts in by_rank]
                                for label, by_rank in scaled["launches_by_rank"].items()},
            **({"local_shapes": {k: {key: v.get(key) for key in keys}
                                 for k, v in scale_kernels[name].items()}}
               if name in scale_kernels else {})}
        line.append(entry)
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
