"""GER correction server: a continuous-batching TCP serving loop.

Counterpart of `dualhyp_tpu/cli/serve_ger.py`. Newline-delimited JSON over
TCP, one request a line:

    {"id": "u1", "nhyps_asr": ["best hyp", "other", ...],
     "nhyps_vsr": ["...", ...],          # optional (DualHyp prompt)
     "max_new": 64}                      # optional per-request budget

or a raw prompt: {"id": "u1", "prompt": "..."}. One response line a
completed request, in completion order:

    {"id": "u1", "text": "corrected transcript", "latency_s": 0.21}

The decode pool is `infer/serve.ContinuousBatcher` (slot refill and
speculative drafting, greedy: the eval protocol); a request enters a slot
as soon as one frees. Runs on the card unless --device names another:

    python -m dualhyp_tpu_torch.cli.serve_ger \\
        --llm_checkpoint checkpoints/TinyLlama/... \\
        --model_path runs/exp/best_model.npz --port 8787

--quantize int8|int4 merges the LoRA deltas into the weights and quantizes
them (int4 runs kernel K8), as `cli.inference_ger` does.

The mesh flags (--dp, --fsdp, --tensor, --expert, --seq) serve from a
torchrun job, one card a rank: rank 0 owns the socket and the queue, the
slot pool shards over data x fsdp, and the other ranks follow rank 0's
polls (`ContinuousBatcher.follow`):

  torchrun --nproc_per_node 2 -m dualhyp_tpu_torch.cli.serve_ger --tensor 2 ...
"""

from __future__ import annotations

import argparse
import json
import selectors
import socket
import threading
from pathlib import Path

import torch

from dualhyp_tpu_torch.cli import common
from dualhyp_tpu_torch.cli.inference_ger import hypothesis_ids
from dualhyp_tpu_torch.data.prompts import get_prompts_format
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.infer.evaluate import extract_response


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, default=None,
                        help="finetuned adapter/model npz (optional: serve the base "
                             "model when omitted)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--slots", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=150)
    parser.add_argument("--draft_len", type=int, default=8)
    parser.add_argument("--chunk_steps", type=int, default=8)
    parser.add_argument("--draft_source", choices=["lookup", "anchored"],
                        default="anchored",
                        help="speculative draft source: 'anchored' follows the "
                             "request's best ASR hypothesis span (nhyps_asr[0], or "
                             "'hypothesis' given explicitly) with a monotone "
                             "pointer; 'lookup' is whole-buffer suffix n-grams")
    parser.add_argument("--quantize", choices=[None, "int8", "int4"], default=None)
    common.add_mesh_args(parser)
    parser.add_argument("--seed", type=int, default=1337,
                        help="seed of the random init of weights the checkpoint lacks")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises without one)")
    common.add_model_args(parser)
    common.add_data_args(parser)
    return parser


def build_request_prompt(fmt_name: str, nhyps_asr, nhyps_vsr=None) -> str:
    """The prompt of a live request (the datasets' strings; the hypotheses
    keep their order, no train-time shuffling). A single-hypothesis request
    gets an EMPTY other-hypotheses section, as the datasets pack hyps[1:]."""
    def others(hyps):
        return [h for h in hyps[1:]]

    fmt = get_prompts_format(fmt_name)
    if fmt_name == "DualHyp" and nhyps_vsr:
        p1 = fmt["prompt_1"].replace("<<<ASR_NHYPS>>>", nhyps_asr[0]).replace(
            "<<<VSR_NHYPS>>>", nhyps_vsr[0])
        p2 = fmt["prompt_2"].replace(
            "<<<ASR_NHYPS>>>", "\n".join(others(nhyps_asr))
        ).replace("<<<VSR_NHYPS>>>", "\n".join(others(nhyps_vsr)))
        return p1 + p2 + fmt["prompt_3"]
    return (fmt["prompt_1"] + nhyps_asr[0] + fmt["prompt_2"] + "\n"
            + "\n".join(others(nhyps_asr)) + fmt["prompt_3"])


class Server:
    """The accept-and-read loop around a `ContinuousBatcher`: requests are
    submitted as their lines arrive, and a chunk runs whenever any is
    pending."""

    def __init__(self, batcher, tokenizer):
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.conn_of = {}     # request id -> connection
        self.prompt_of = {}   # request id -> prompt text
        self.buffers = {}     # connection -> partial line buffer
        self._stop = threading.Event()
        self._stopped = threading.Event()

    def stop(self, timeout: float = 10.0):
        """Ask the accept loop to exit; returns once it has."""
        self._stop.set()
        self._stopped.wait(timeout)

    def handle_line(self, conn, line: str):
        try:
            req = json.loads(line)
            rid = req["id"]
            if "prompt" in req:
                prompt_text = req["prompt"]
            else:
                # VSR hypotheses select the DualHyp template, else GER
                fmt = "DualHyp" if req.get("nhyps_vsr") else "GER"
                prompt_text = build_request_prompt(fmt, req["nhyps_asr"],
                                                   req.get("nhyps_vsr"))
            ids = self.tokenizer.encode(prompt_text)
            self.conn_of[rid] = conn
            self.prompt_of[rid] = prompt_text
            hyp = req.get("hypothesis")
            if hyp is None and req.get("nhyps_asr"):
                hyp = req["nhyps_asr"][0]
            hyp_ids = hypothesis_ids(self.tokenizer, hyp) if isinstance(hyp, str) else hyp
            self.batcher.submit(rid, ids, req.get("max_new"), hyp_ids)
        except Exception as exc:
            self._send(conn, {"error": f"{type(exc).__name__}: {exc}", "line": line[:200]})

    def _send(self, conn, obj):
        try:
            conn.sendall((json.dumps(obj) + "\n").encode("utf-8"))
        except OSError:
            pass

    def flush_completed(self):
        for rec in self.batcher.poll():
            rid = rec["id"]
            conn = self.conn_of.pop(rid, None)
            self.prompt_of.pop(rid, None)
            full = self.tokenizer.decode(rec["tokens"])
            decoded_prompt = self.tokenizer.decode(rec["tokens"][:rec["prompt_len"]])
            if conn is not None:
                self._send(conn, {"id": rid, "text": extract_response(full, decoded_prompt),
                                  "latency_s": round(rec["latency_s"], 4)})

    def run(self, host: str, port: int, ready_cb=None):
        sel = selectors.DefaultSelector()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen()
        srv.setblocking(False)
        sel.register(srv, selectors.EVENT_READ, "accept")
        self.batcher.start()
        if ready_cb is not None:
            ready_cb(srv.getsockname()[1])
        print(f"serving on {srv.getsockname()}", flush=True)
        try:
            while not self._stop.is_set():
                # a short timeout when idle; none while decoding is in flight
                timeout = 0.0 if self.batcher.pending else 0.05
                for key, _ in sel.select(timeout=timeout):
                    if key.data == "accept":
                        conn, _ = srv.accept()
                        conn.setblocking(False)
                        sel.register(conn, selectors.EVENT_READ, "read")
                        self.buffers[conn] = b""
                        continue
                    conn = key.fileobj
                    try:
                        data = conn.recv(1 << 16)
                    except OSError:
                        data = b""
                    if not data:
                        sel.unregister(conn)
                        self.buffers.pop(conn, None)
                        conn.close()
                        continue
                    self.buffers[conn] += data
                    while b"\n" in self.buffers[conn]:
                        line, _, rest = self.buffers[conn].partition(b"\n")
                        self.buffers[conn] = rest
                        if line.strip():
                            self.handle_line(conn, line.decode("utf-8"))
                if self.batcher.pending:
                    self.flush_completed()
        finally:
            srv.close()
            for conn in list(self.buffers):
                try:
                    conn.close()
                except OSError:
                    pass
            self.buffers.clear()
            sel.close()
            self._stopped.set()


def load_batcher(args):
    """(the `ContinuousBatcher` the flags describe, the tokenizer): the
    model on --device (the card by default) with the finetuned leaves over
    the base weights, LoRA merged and quantized under --quantize."""
    from dualhyp_tpu_torch.infer.serve import ContinuousBatcher
    from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model

    mesh = None
    if common.wants_mesh(args):
        mesh, device = common.mesh_from_args(args)
    else:
        device = resolve_device(args.device)
    checkpoint_dir = Path(args.llm_checkpoint)
    tokenizer = common.load_tokenizer(checkpoint_dir)
    model_cfg = common.model_config_from_args(args)
    model = common.load_model(checkpoint_dir, model_cfg, device=device, seed=args.seed,
                              finetuned=args.model_path, mesh=mesh)
    if args.quantize:
        if model_cfg.any_lora:
            merge_lora(model)
        quantize_model(model, args.quantize)
    batcher = ContinuousBatcher(
        model, slots=args.slots, max_new_tokens=args.max_new_tokens,
        draft_len=args.draft_len, chunk_steps=args.chunk_steps,
        eos_id=getattr(tokenizer, "eos_token_id", None), draft_source=args.draft_source)
    return batcher, tokenizer


def main(argv=None):
    args = build_parser().parse_args(argv)
    batcher, tokenizer = load_batcher(args)
    if batcher.mesh is not None and torch.distributed.get_rank() != 0:
        batcher.start()
        batcher.follow()
        return
    try:
        Server(batcher, tokenizer).run(args.host, args.port)
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
