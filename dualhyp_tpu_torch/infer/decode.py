"""Batched autoregressive decoding with a fixed-size KV cache.

Counterpart of `sample_token` and `generate` of `dualhyp_tpu/infer/decode.py`
(lockstep, greedy or top-k):

  * the whole batch decodes in lockstep from right-padded, ragged prompts;
  * the first token comes from the prefill logits at each row's last valid
    position;
  * sampling matches the reference: logits / temperature, top-k mask,
    categorical draw; top_k=1 is argmax, the eval protocol;
  * an EOS token is neither written nor counted; a finished row keeps its
    length and its cache slots;
  * the loop ends early once every row has finished.

Where the JAX package runs a `lax.while_loop`, this is a Python loop that
asks the device once a step whether every row is done.
"""

from __future__ import annotations

from typing import Optional

import torch

from dualhyp_tpu_torch.models.gpt import GPT


def sample_token(logits, *, temperature: float, top_k: Optional[int],
                 generator: Optional[torch.Generator] = None):
    """(B, V) logits -> (B,) token ids (ref: generate/base.py:62-70)."""
    if top_k is not None and top_k == 1:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: GPT, prompt_ids, prompt_lengths, *, max_new_tokens: int = 150,
             temperature: float = 1.0, top_k: Optional[int] = None,
             eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None):
    """prompt_ids: (B, T) right-padded; prompt_lengths: (B,).

    Returns (tokens (B, T + max_new_tokens), total_lengths (B,)), int64 on
    the model's device; total_lengths counts the prompt and the generated
    tokens without the EOS token."""
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device).long()
    b, t = prompt_ids.shape
    max_seq = t + max_new_tokens
    if max_seq > model.cfg.block_size:
        raise ValueError(f"{max_seq} exceeds block_size {model.cfg.block_size}")
    rows = torch.arange(b, device=device)

    cache = model.init_cache(b, max_seq)
    logits = model.prefill(prompt_ids, prompt_lengths, cache)
    tokens = torch.zeros((b, max_seq), dtype=torch.long, device=device)
    tokens[:, :t] = prompt_ids

    first = sample_token(logits, temperature=temperature, top_k=top_k,
                         generator=generator)
    done = (torch.zeros(b, dtype=torch.bool, device=device) if eos_id is None
            else first == eos_id)
    tokens[rows, prompt_lengths] = torch.where(done, 0, first)
    lengths = prompt_lengths + (~done).long()
    last = first

    step = 0
    while step < max_new_tokens - 1 and not bool(done.all()):
        # `last` sits at slot lengths-1; the model predicts slot `lengths`
        logits = model.decode_step(last, lengths - 1, cache, active=~done)
        tok = sample_token(logits, temperature=temperature, top_k=top_k,
                           generator=generator)
        newly_done = done if eos_id is None else (done | (tok == eos_id))
        tokens[rows, lengths] = torch.where(newly_done, 0, tok)
        lengths = torch.where(newly_done, lengths, lengths + 1)
        done, last = newly_done, tok
        step += 1
    return tokens, lengths
