"""Attention over the serving engine's paged KV cache (kernels K5, K6 and
K7, csrc/paged_attention.cu).

Counterpart of ray_tpu/ops/paged_attention.py. Cache layout per layer:
k_pages / v_pages [KVH, num_pages, page_size, D]; the engine passes one
layer's slice of its [L, KVH, P, ps, D] pool, which the kernels read in
place. Decode (K5) attends one query per sequence, chunk (K6) one
sequence's prefill chunk, verify (K7) a span of S = k + 1 speculative rows
per sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dispatch
from .attention import _MAX_HEAD_DIM

_NEG_INF = -2.0e30


def _masked_softmax_values(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                           equation: str) -> torch.Tensor:
    """softmax over the last axis of the masked scores, masked entries then
    zeroed so a row with no visible key gives 0 (the kernels' l == 0 rule)."""
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum(equation, p, v)


def _paged_reference(q, k_pages, v_pages, page_table, lengths, scale):
    """Plain version of K5: gathers the whole table. q [B,H,D] -> o [B,H,D]."""
    B, H, D = q.shape
    KVH, _, page_size, _ = k_pages.shape
    g = H // KVH
    ctx = page_table.shape[1] * page_size
    table = page_table.long()
    # [KVH, B, pages, ps, D] -> [B, KVH, ctx, D]
    kg = k_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    vg = v_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    qf = q.reshape(B, KVH, g, D).float()
    s = torch.einsum("bcgd,bctd->bcgt", qf, kg) * scale
    mask = torch.arange(ctx, device=q.device)[None, :] < lengths.long()[:, None]
    o = _masked_softmax_values(s, mask[:, None, None, :], vg, "bcgt,bctd->bcgd")
    return o.reshape(B, H, D).to(q.dtype)


def _chunk_reference(q, k_pages, v_pages, page_table, start, total, scale):
    """Plain version of K6 for ONE sequence's chunk. q [C,H,D] -> o [C,H,D];
    key j visible to query row c iff j <= start + c and j < total."""
    C, H, D = q.shape
    KVH, _, page_size, _ = k_pages.shape
    g = H // KVH
    ctx = page_table.shape[0] * page_size
    table = page_table.long()
    kg = k_pages[:, table].reshape(KVH, ctx, D).float()
    vg = v_pages[:, table].reshape(KVH, ctx, D).float()
    qf = q.reshape(C, KVH, g, D).float()
    s = torch.einsum("ckgd,ktd->ckgt", qf, kg) * scale
    keypos = torch.arange(ctx, device=q.device)
    qpos = start + torch.arange(C, device=q.device)
    mask = (keypos[None, :] <= qpos[:, None]) & (keypos[None, :] < total)
    o = _masked_softmax_values(s, mask[:, None, None, :], vg, "ckgt,ktd->ckgd")
    return o.reshape(C, H, D).to(q.dtype)


def _verify_reference(q, k_pages, v_pages, page_table, positions, scale):
    """Plain version of K7: gathers the whole table. q [B,S,H,D] ->
    o [B,S,H,D]; key j visible to query (b, s) iff j <= positions[b] + s."""
    B, S, H, D = q.shape
    KVH, _, page_size, _ = k_pages.shape
    g = H // KVH
    ctx = page_table.shape[1] * page_size
    table = page_table.long()
    # [KVH, B, pages, ps, D] -> [B, KVH, ctx, D]
    kg = k_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    vg = v_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    qf = q.reshape(B, S, KVH, g, D).float()
    s = torch.einsum("bscgd,bctd->bscgt", qf, kg) * scale
    keypos = torch.arange(ctx, device=q.device)
    qpos = positions.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = keypos[None, None, :] <= qpos[:, :, None]  # [B, S, ctx]
    o = _masked_softmax_values(s, mask[:, :, None, None, :], vg, "bscgt,bctd->bscgd")
    return o.reshape(B, S, H, D).to(q.dtype)


def _check_pools(name, q, k_pages, v_pages, page_table, H):
    KVH = k_pages.shape[0]
    if H % KVH or k_pages.shape != v_pages.shape or k_pages.shape[3] != q.shape[-1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)} do not form a GQA problem")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{name}: q and the page pools must share one dtype")
    if page_table.dtype != torch.int32:
        raise TypeError(f"{name}: the page table must be int32")
    for t in (q, k_pages, v_pages, page_table):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous inputs")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim <= {_MAX_HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    dispatch.check_kv_layout(name, k_pages, v_pages)


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One decode step of attention over a paged KV cache.

    Args:
      q: [B, H, D] — current token's query per sequence.
      k_pages/v_pages: [KVH, num_pages, page_size, D].
      page_table: [B, pages_per_seq] int32 page ids (unused tail arbitrary).
      lengths: [B] int32 valid context length per sequence; 0 gives zeros.
    Returns [B, H, D].
    """
    B, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if not dispatch.use_kernel(q, k_pages, v_pages, page_table, lengths):
        return _paged_reference(q, k_pages, v_pages, page_table, lengths, scale)
    _check_pools("paged_attention_decode", q, k_pages, v_pages, page_table, H)
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or not lengths.is_contiguous() or page_table.shape[0] != B):
        raise ValueError("paged_attention_decode: lengths must be contiguous int32 "
                         "[B] and page_table [B, pages_per_seq]")
    KVH, P, ps, _ = k_pages.shape
    o = torch.empty_like(q)
    if B == 0:
        return o
    dispatch.launch(
        "paged_attention_decode", "rtt_paged_attention_decode", q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(),
        B, H, KVH, D, P, ps, page_table.shape[1], float(scale), dispatch.dtype_code(q))
    return o


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          page_table: torch.Tensor, start: int, total: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention for ONE sequence over its paged KV.

    The engine writes a prompt chunk's KV into the sequence's pages, then
    calls this with the chunk's queries: key position j is visible to query
    row c iff ``j <= start + c`` and ``j < total``. Only the first
    ceil(total / page_size) pages are read.

    Args:
      q: [C, H, D] — the chunk's queries (rope applied).
      k_pages/v_pages: [KVH, num_pages, page_size, D] (chunk KV written).
      page_table: [pages_per_seq] int32 page ids for this sequence.
      start: the chunk's first token position (host int).
      total: visibility cap, usually start + C (host int).
    Returns [C, H, D].
    """
    C, H, D = q.shape
    start, total = int(start), int(total)
    if scale is None:
        scale = D ** -0.5
    if not dispatch.use_kernel(q, k_pages, v_pages, page_table):
        return _chunk_reference(q, k_pages, v_pages, page_table, start, total, scale)
    _check_pools("paged_attention_chunk", q, k_pages, v_pages, page_table, H)
    if page_table.dim() != 1 or start < 0:
        raise ValueError("paged_attention_chunk: page_table must be [pages_per_seq] "
                         "and start >= 0")
    KVH, P, ps, _ = k_pages.shape
    o = torch.empty_like(q)
    if C == 0:
        return o
    dispatch.launch(
        "paged_attention_chunk", "rtt_paged_attention_chunk", q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        o.data_ptr(), C, H, KVH, D, P, ps, page_table.shape[0], start, total,
        float(scale), dispatch.dtype_code(q))
    return o


def paged_attention_verify(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, positions: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Speculative-decode verify attention over the paged KV cache.

    The engine writes the span's KV (last committed token + k draft tokens,
    at positions p..p+k) into each sequence's pages, then scores all
    S = k + 1 positions in one call: key j is visible to query row s of
    sequence b iff ``j <= positions[b] + s``. S = 1 is exactly
    paged_attention_decode with lengths = positions + 1. Keys past the
    table's end (a span launched near max_seq_len) are never read.

    Args:
      q: [B, S, H, D] — span queries per sequence (rope applied).
      k_pages/v_pages: [KVH, num_pages, page_size, D] (span KV written).
      page_table: [B, pages_per_seq] int32 page ids.
      positions: [B] int32 — position of each sequence's row 0; read on the
        card by the kernel, so a round needs no readback before the launch.
    Returns [B, S, H, D].
    """
    B, S, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if not dispatch.use_kernel(q, k_pages, v_pages, page_table, positions):
        return _verify_reference(q, k_pages, v_pages, page_table, positions, scale)
    _check_pools("paged_attention_verify", q, k_pages, v_pages, page_table, H)
    if (positions.dtype != torch.int32 or positions.shape != (B,)
            or not positions.is_contiguous() or page_table.dim() != 2
            or page_table.shape[0] != B):
        raise ValueError("paged_attention_verify: positions must be contiguous int32 "
                         "[B] and page_table [B, pages_per_seq]")
    KVH, P, ps, _ = k_pages.shape
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    dispatch.launch(
        "paged_attention_verify", "rtt_paged_attention_verify", q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), o.data_ptr(),
        B, S, H, KVH, D, P, ps, page_table.shape[1], float(scale), dispatch.dtype_code(q))
    return o
