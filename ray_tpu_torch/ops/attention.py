"""Causal flash attention forward (kernel K2, csrc/flash_attention.cu).

Counterpart of ray_tpu/ops/attention.py's forward. Public layout is the
model's [B, T, H, D] with grouped-query attention (kv head = h // g). The
kernel reads q/k/v through their strides, takes any T, and keeps its
softmax statistics in f32. The lse variant and the backward kernels belong
to the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dispatch

_NEG_INF = -2.0e30
_MAX_HEAD_DIM = 128  # csrc/attention_tile.cuh kTileMaxD


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K2: O(T^2) attention, [B, T, H, D], f32 scores and
    products, output in q's dtype."""
    B, Tq, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    g = H // KVH
    qh = q.reshape(B, Tq, KVH, g, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    if causal:
        q_pos = torch.arange(Tq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Tq, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head / grouped-query attention.

    Args:
      q: [B, T, H, D]; k, v: [B, T, KVH, D] with H % KVH == 0 (GQA).
      causal: apply the causal mask (query t sees keys <= t).
      scale: score scale, default 1/sqrt(D).
    Returns [B, T, H, D] in q's dtype.
    """
    B, Tq, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if not dispatch.use_kernel(q, k, v):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    if H % KVH or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form a GQA problem")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes head_dim <= "
                         f"{_MAX_HEAD_DIM}, got {D}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if q.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("flash_attention: the kernel takes a unit stride on D "
                         "and k, v of equal strides")
    dispatch.check_kv_layout("flash_attention", k, v)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    dispatch.launch(
        "flash_attention", "rtt_flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Tq, Tk, H, KVH, D, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2), int(bool(causal)), float(scale),
        dispatch.dtype_code(q))
    return o
