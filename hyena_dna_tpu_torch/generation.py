"""Autoregressive generation for the port's Hyena LMs (mirrors
`hyena_dna_tpu/generation.py`): greedy, temperature, top-k and top-p
sampling, each new token from a full forward pass.

The buffer is the JAX package's: one (B, P + n) token buffer, the prompt
left-aligned and the rest padding, and every step runs the model over the
whole buffer and reads the logits at the position before the one it fills.
Causality makes the later positions irrelevant to that logit, but the conv
I/O dtype follows the buffer length (bf16 from L = 2^15,
`models/hyena.py::CONV_IO_BF16_MIN_L`), so a forward over the prefix only
would change the numbers at that threshold. On the card each forward runs
kernels A and B once per layer. Sampling draws from a `torch.Generator` on
the model's device; it cannot reproduce JAX's categorical draws, so only
greedy decoding (temperature 0) matches the JAX package token for token.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sample_logits(generator: Optional[torch.Generator], logits: torch.Tensor,
                   temperature: float, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: argmax at temperature 0, else a
    draw from softmax(logits / temperature) restricted to the top-k ids
    and to the smallest set whose probability reaches top_p (at least one)."""
    logits = logits.float()
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = ((cum - probs) < top_p).sum(-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt: torch.Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None, temperature: float = 1.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             pad_token_id: int = 4) -> torch.Tensor:
    """prompt (B, P) -> (B, P + max_new_tokens) on the model's device.
    `generator` (on that device) draws the samples; temperature 0 is greedy
    and needs none."""
    device = next(model.parameters()).device
    b, p = prompt.shape
    buf = torch.full((b, p + max_new_tokens), pad_token_id, dtype=prompt.dtype, device=device)
    buf[:, :p] = prompt.to(device)
    for pos in range(max(p, 1), p + max_new_tokens):
        logits = model(buf)
        nxt = _sample_logits(generator, logits[:, pos - 1], temperature, top_k, top_p)
        buf[:, pos] = nxt.to(buf.dtype)
    return buf
