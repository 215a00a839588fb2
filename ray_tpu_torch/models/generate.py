"""Simple batched generation over the contiguous KV cache.

Counterpart of ray_tpu/models/generate.py: the standalone/offline path
(tests, batch inference) and the engine-independent oracle of the serving
engine: engine output must equal `generate`'s greedy output for the same
prompt. Online serving uses serve/engine.py's paged-cache engine instead.
Plain PyTorch throughout: the reference's path runs no Pallas kernel
beyond prefill's attention and norms.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import rope_frequencies
from .config import ModelConfig
from .transformer import decode_step, prefill


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: Optional[int] = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B]; draws come from `gen`."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -2e30)
    # Gumbel-max, as jax.random.categorical draws
    e = torch.empty_like(logits).exponential_(generator=gen)
    return (logits - e.log()).argmax(dim=-1)


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor,
             gen: Optional[torch.Generator] = None, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: Optional[int] = None) -> torch.Tensor:
    """prompt [B, T] -> generated tokens [B, max_new_tokens]: prefill, then
    one decode_step per token, the tokens staying on the prompt's device."""
    B, T = prompt.shape
    rope = (rope_frequencies(cfg.hdim, cfg.max_seq_len, cfg.rope_theta, device=prompt.device)
            if cfg.positional == "rope" else None)
    logits, cache = prefill(params, cfg, prompt, T + max_new_tokens, rope_tables=rope)
    pos = torch.full((B,), T, dtype=torch.long, device=prompt.device)
    toks = []
    for _ in range(max_new_tokens):
        tok = sample_token(logits, gen, temperature, top_k)
        logits, cache = decode_step(params, cfg, cache, tok, pos, rope_tables=rope)
        toks.append(tok)
        pos = pos + 1
    return torch.stack(toks, dim=1)
