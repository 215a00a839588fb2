"""Attention over the serving engine's paged KV cache (kernels K5, K6 and
K7, csrc/paged_attention.cu).

Counterpart of ray_tpu/ops/paged_attention.py. Cache layout per layer:
k_pages / v_pages [KVH, num_pages, page_size, D]; the engine passes one
layer's slice of its [L, KVH, P, ps, D] pool, which the kernels read in
place. Decode (K5) attends one query per sequence, chunk (K6) one
sequence's prefill chunk, verify (K7) a span of S = k + 1 speculative rows
per sequence. K5, and K7 in bf16 at head_dim 64/128, split each
sequence's keys over CTAs and merge the splits on the card
(`_paged_split_reference` and `_verify_split_reference` spell out that
arithmetic for the tests).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dispatch
from .attention import _MAX_HEAD_DIM, _TENSOR_CORE_HEAD_DIMS

_NEG_INF = -2.0e30
DECODE_SPLIT_KEYS = 128  # keys per split of K5, csrc/paged_attention.cu kSplitKeys
VERIFY_SPLIT_KEYS = 128  # keys per split of K7's tensor-core path, kVerifySplitKeys


def _tensor_core(dtype: torch.dtype, head_dim: int) -> bool:
    """K6 and K7 run on the tensor-core tile for bf16 at head_dim 64/128,
    on the FMA tile otherwise (csrc/paged_attention.cu)."""
    return dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_HEAD_DIMS


def kernel_symbol(op: str, dtype: torch.dtype, head_dim: int) -> str:
    """Name of the CUDA kernel that `op`'s C entry point launches first for
    inputs of this dtype and head_dim, as a profiler shows it:
    "paged_attention_chunk" (K6) and "paged_attention_verify" (K7) run the
    tensor-core tile (wgmma) for bf16 at head_dim 64/128, the FMA tile
    otherwise; K7's wgmma kernel is followed by paged_combine_kernel."""
    stem = {"paged_attention_chunk": "paged_chunk",
            "paged_attention_verify": "paged_verify"}[op]
    return f"{stem}_{'wgmma' if _tensor_core(dtype, head_dim) else 'fma'}_kernel"


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


def _paged_split_reference(q, k_pages, v_pages, page_table, lengths, scale,
                           split_keys: int = None):
    """K5's split-and-merge arithmetic in plain PyTorch (used by tests only;
    `_paged_reference` is the plain version the wrapper runs). Each
    sequence's keys [0, pps * ps) are cut into splits of `split_keys`; a
    split with a live key (below min(lengths[b], pps * ps)) gives the
    unnormalised O_i, its max m_i and its sum l_i in f32, and the merge is
    o = sum e^(m_i - M) O_i / sum e^(m_i - M) l_i over the live splits;
    none live gives 0. q [B, H, D] -> o [B, H, D]."""
    split_keys = split_keys or DECODE_SPLIT_KEYS
    B, H, D = q.shape
    KVH, _, page_size, _ = k_pages.shape
    g = H // KVH
    ctx = page_table.shape[1] * page_size
    table = page_table.long()
    kg = k_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    vg = v_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    s = torch.einsum("bcgd,bctd->bcgt", q.reshape(B, KVH, g, D).float(), kg) * scale
    live = torch.arange(ctx, device=q.device)[None, :] < lengths.long().clamp(max=ctx)[:, None]
    out = _split_merge(s, live[:, None, None, :], vg, -(-ctx // split_keys), split_keys,
                       "bcgnt,bcntd->bcgnd")
    return out.reshape(B, H, D).to(q.dtype)


def _split_merge(s, live, vg, n_split, split_keys, o_eq):
    """The split-and-merge arithmetic shared by `_paged_split_reference` and
    `_verify_split_reference`: s [..., ctx] f32 scores, live [..., ctx] the
    visible keys (True only below a row's key count), vg [B, KVH, ctx, D].
    Per split of `split_keys` keys: O_i unnormalised, m_i and l_i; merged as
    sum e^(m_i - M) O_i / sum e^(m_i - M) l_i over the splits holding a
    visible key; none gives 0."""
    B, KVH, ctx, D = vg.shape
    pad = n_split * split_keys - ctx  # the last split may end past the table
    s = torch.nn.functional.pad(s, (0, pad), value=_NEG_INF)
    vg = torch.nn.functional.pad(vg, (0, 0, 0, pad))
    live = torch.nn.functional.pad(live, (0, pad))
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    s = s.reshape(*s.shape[:-1], n_split, split_keys)
    live = live.reshape(*live.shape[:-1], n_split, split_keys)
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum(o_eq, p, vg.reshape(B, KVH, n_split, split_keys, D))
    split_live = live.any(dim=-1)
    big_m = torch.where(split_live, m, torch.full_like(m, _NEG_INF)).amax(dim=-1, keepdim=True)
    w = torch.where(split_live, torch.exp(m - big_m), torch.zeros_like(m))
    den = (w * l).sum(dim=-1)
    num = (w[..., None] * o).sum(dim=-2)
    return torch.where(den[..., None] > 0, num / torch.where(den > 0, den, 1.0)[..., None],
                       torch.zeros_like(num))


def _verify_split_reference(q, k_pages, v_pages, page_table, positions, scale,
                            split_keys: int = None):
    """K7's split-and-merge arithmetic (its tensor-core path) in plain
    PyTorch, for tests only (`_verify_reference` is the plain version the
    wrapper runs). Row s of sequence b sees keys j < count[b, s] =
    min(max(positions[b], 0) + s + 1, pps * ps); each sequence's keys
    [0, pps * ps) are cut into splits of `split_keys`, a split is live for a
    row when it starts below the row's count, and the live splits' partials
    merge as in K5. q [B, S, H, D] -> o [B, S, H, D]."""
    split_keys = split_keys or VERIFY_SPLIT_KEYS
    B, S, H, D = q.shape
    KVH, _, page_size, _ = k_pages.shape
    g = H // KVH
    ctx = page_table.shape[1] * page_size
    table = page_table.long()
    kg = k_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    vg = v_pages[:, table].transpose(0, 1).reshape(B, KVH, ctx, D).float()
    s = torch.einsum("bscgd,bctd->bscgt", q.reshape(B, S, KVH, g, D).float(), kg) * scale
    count = (positions.long().clamp(min=0)[:, None] + 1
             + torch.arange(S, device=q.device)[None, :]).clamp(max=ctx)  # [B, S]
    live = torch.arange(ctx, device=q.device)[None, None, :] < count[:, :, None]
    out = _split_merge(s, live[:, :, None, None, :], vg, -(-ctx // split_keys), split_keys,
                       "bscgnt,bcntd->bscgnd")
    return out.reshape(B, S, H, D).to(q.dtype)


def _chunk_reference(q, k_pages, v_pages, page_table, start, total, scale):
    """Plain version of K6 for ONE sequence's chunk. q [C,H,D] -> o [C,H,D];
    key j visible to query row c iff j <= start + c and j < total. start
    and total: ints or one-element int tensors on q's device."""
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
    qpos = start + torch.arange(C, device=q.device)  # a tensor start broadcasts
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
    pps = page_table.shape[1]
    o = torch.empty_like(q)
    if B == 0:
        return o
    # the splits' f32 partials (O, then m and l); the host knows their
    # number without reading lengths, which stay on the card. Inside a
    # captured decode program (serve/programs.py) the workspace comes from
    # the graph's memory pool and keeps its address at every replay.
    n_split = -(-pps * ps // DECODE_SPLIT_KEYS)
    ws = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32, device=q.device)
    dispatch.launch(
        "paged_attention_decode", "rtt_paged_attention_decode", q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), ws.data_ptr(), ws.numel(),
        B, H, KVH, D, P, ps, pps, float(scale), dispatch.dtype_code(q))
    return o


def _chunk_meta(start, total, device: torch.device) -> torch.Tensor:
    """K6's [start, total] as two int32 on `device`, as the reference
    stacks its traced scalars into `meta`: ints are copied there (one small
    host-to-card copy); one-element int32 tensors on the device are joined
    there without a host read, or read in place when they already lie side
    by side (meta[:1] and meta[1:] of one [2] tensor, as PagedModel.chunk
    passes them to every layer)."""
    if not isinstance(start, torch.Tensor) and not isinstance(total, torch.Tensor):
        if int(start) < 0:
            raise ValueError("paged_attention_chunk: start must be >= 0")
        return torch.tensor([int(start), int(total)], dtype=torch.int32, device=device)
    parts = []
    for name, x in (("start", start), ("total", total)):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor([int(x)], dtype=torch.int32, device=device)
        elif x.dtype != torch.int32 or x.numel() != 1 or x.device != device:
            raise ValueError(f"paged_attention_chunk: {name} must be an int or a one-element "
                             f"int32 tensor on {device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        parts.append(x.reshape(1))
    if parts[1].data_ptr() == parts[0].data_ptr() + 4:
        return parts[0]  # the kernel reads both int32 from start's address
    return torch.cat(parts)


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          page_table: torch.Tensor, start, total,
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
      start: the chunk's first token position, >= 0.
      total: visibility cap, usually start + C.
      start and total are ints or one-element int32 tensors on q's device;
      the kernel reads them on the card, so a captured chunk program takes
      them as tensors and serves every chunk of a prompt.
    Returns [C, H, D].
    """
    C, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if not dispatch.use_kernel(q, k_pages, v_pages, page_table):
        return _chunk_reference(q, k_pages, v_pages, page_table, start, total, scale)
    _check_pools("paged_attention_chunk", q, k_pages, v_pages, page_table, H)
    if page_table.dim() != 1:
        raise ValueError("paged_attention_chunk: page_table must be [pages_per_seq]")
    meta = _chunk_meta(start, total, q.device)
    KVH, P, ps, _ = k_pages.shape
    o = torch.empty_like(q)
    if C == 0:
        return o
    dispatch.launch(
        "paged_attention_chunk", "rtt_paged_attention_chunk", q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        meta.data_ptr(), o.data_ptr(), C, H, KVH, D, P, ps, page_table.shape[0],
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
    pps = page_table.shape[1]
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    ws = None
    if _tensor_core(q.dtype, D):  # split-KV: the splits' f32 partials (O, then m and l),
        # from the graph's memory pool inside a captured verify program
        n_split = -(-pps * ps // VERIFY_SPLIT_KEYS)
        ws = torch.empty(B * S * H * n_split * (D + 2), dtype=torch.float32, device=q.device)
    dispatch.launch(
        "paged_attention_verify", "rtt_paged_attention_verify", q.device,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), o.data_ptr(), None if ws is None else ws.data_ptr(),
        0 if ws is None else ws.numel(),
        B, S, H, KVH, D, P, ps, pps, float(scale), dispatch.dtype_code(q))
    return o
