"""Rotary position embeddings (RoPE), plain PyTorch.

Counterpart of ray_tpu/ops/rope.py: the half-rotation (Llama/NeoX)
convention, f32 math, optional linear position scaling. Elementwise work
that needs no kernel of its own.
"""

from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     scaling: Optional[float] = None, dtype=torch.float32,
                     device=None):
    """Precompute (cos, sin) tables: each [max_len, head_dim // 2]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    if scaling is not None:
        pos = pos / scaling
    ang = torch.outer(pos, inv_freq)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate x [B, T, H, D] by the tables; positions [B, T] selects rows
    (defaults to arange(T) — pass real positions for decode/packed batches)."""
    T = x.shape[1]
    if positions is None:
        c = cos[:T][None, :, None, :]
        s = sin[:T][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
