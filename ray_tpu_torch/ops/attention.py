"""Causal flash attention: forward (kernel K2, csrc/flash_attention.cu) and
backward (kernels K3/K4, csrc/flash_attention_bwd.cu).

Counterpart of ray_tpu/ops/attention.py. Public layout is the model's
[B, T, H, D] with grouped-query attention (kv head = h // g). The kernels
read their inputs through strides, take any T, and keep softmax statistics
and gradient sums in f32.

When a gradient is needed (grad mode on and an input requires grad) the
op runs as `_FlashAttention`, an autograd Function: its forward also writes
the logsumexp residual lse [B, H, T] (K2 with lse), and its backward forms
delta = rowsum(dO * O) - dlse in plain PyTorch, as the reference does in
XLA, then launches K3 (dq) and K4 (dk, dv). On the CPU the same Function
runs the kernels' plain versions (`_fwd_reference_with_lse`,
`_dq_reference`, `_dkv_reference`), which compute the flash-2 formulas
directly, not through autograd of `mha_reference`.

On the card K2, K3 and K4 run on the tensor cores (wgmma) for bf16 with
head_dim 64 or 128 and on the FMA pipes otherwise; `kernel_symbol` names
the kernel a call launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import dispatch

_NEG_INF = -2.0e30
_MAX_HEAD_DIM = 128  # csrc/attention_tile.cuh kTileMaxD
_TENSOR_CORE_HEAD_DIMS = (64, 128)  # the bf16 head dims K2-K4, K6 and K7 run on wgmma


def _scores(q, k, causal, scale):
    """f32 scores [B, KVH, g, Tq, Tk] with masked entries at _NEG_INF."""
    B, Tq, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    qh = q.reshape(B, Tq, KVH, H // KVH, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    if causal:
        mask = torch.arange(Tq, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K2: O(T^2) attention, [B, T, H, D], f32 scores and
    products, output in q's dtype."""
    B, Tq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Tq, H, D).to(q.dtype)


def _fwd_reference_with_lse(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Plain version of K2 with lse: (o [B, T, H, D] in q's dtype, lse
    [B, H, T] f32 = m + log(l), l == 0 counting as 1, as the reference)."""
    B, Tq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float()).reshape(B, Tq, H, D)
    return o.to(q.dtype), (m + torch.log(l)).reshape(B, H, Tq)


def _attention_delta(o, do, dlse=None) -> torch.Tensor:
    """delta [B, H, Tq] f32 = rowsum(dO * O) - dlse: an lse cotangent folds
    into the backward as a shift of delta, since d lse_i / d s_ij = p_ij."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _probs_and_dscores(q, k, v, do, lse, delta, causal, scale):
    """The flash-2 backward's P = exp(S - lse) and dS = P (dP - delta) scale,
    [B, KVH, g, Tq, Tk] f32, with q and dO grouped as [B, Tq, KVH, g, D]."""
    B, Tq, H, D = q.shape
    KVH = k.shape[2]
    g = H // KVH
    p = torch.exp(_scores(q, k, causal, scale) - lse.reshape(B, KVH, g, Tq, 1).float())
    doh = do.reshape(B, Tq, KVH, g, D).float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", doh, v.float())
    ds = p * (dp - delta.reshape(B, KVH, g, Tq, 1).float()) * scale
    return p, ds, doh


def _dq_reference(q, k, v, do, lse, delta, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3: dQ = dS K, in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _p, ds, _doh = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(q.shape).to(q.dtype)


def _dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                   scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: dK = dS^T Q, dV = P^T dO, per q head in f32 and
    summed over the GQA group, in k's and v's dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, ds, doh = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    B, Tq, H, D = q.shape
    qh = q.reshape(B, Tq, k.shape[2], H // k.shape[2], D).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qh)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, doh)
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_reference(q, k, v, o, lse, do, dlse=None, causal: bool = True,
                   scale: Optional[float] = None):
    """Plain versions of K3 and K4 together: (dq, dk, dv) of attention with
    forward output o and residual lse, given the cotangents do (and dlse)."""
    delta = _attention_delta(o, do, dlse)
    return (_dq_reference(q, k, v, do, lse, delta, causal, scale),
            *_dkv_reference(q, k, v, do, lse, delta, causal, scale))


# ------------------------------------------------------------- the kernels


def _check_gqa(name, q, k, v) -> None:
    """What every attention kernel refuses: raises before a launch."""
    B, Tq, H, D = q.shape
    KVH = k.shape[2]
    if H % KVH or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form a GQA problem")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim <= {_MAX_HEAD_DIM}, got {D}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k and v must share one dtype")
    if q.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError(f"{name}: the kernel takes a unit stride on D and k, v of equal "
                         "strides")
    dispatch.check_kv_layout(name, k, v)


def _check_rows(name, q, t, what) -> None:
    """lse / delta: [B, H, Tq] f32, contiguous."""
    B, Tq, H, _ = q.shape
    if t.shape != (B, H, Tq) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous float32 [{B}, {H}, {Tq}], got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _flash_fwd(q, k, v, causal: bool, scale: float, with_lse: bool):
    """K2 on the card -> (o [B, Tq, H, D], lse [B, H, Tq] f32 or None)."""
    B, Tq, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    _check_gqa("flash_attention", q, k, v)
    dispatch.check_kv_layout("flash_attention", q)  # the bf16 tile copies q in 16-byte chunks
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return o, lse
    dispatch.launch(
        "flash_attention", "rtt_flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        B, Tq, Tk, H, KVH, D, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2), int(bool(causal)), float(scale),
        dispatch.dtype_code(q), also="flash_attention_lse" if with_lse else "")
    return o, lse


def kernel_symbol(op: str, dtype: torch.dtype, head_dim: int) -> str:
    """Name of the CUDA kernel that `op`'s C entry point launches for inputs
    of this dtype and head_dim, as a profiler shows it: the tensor-core tile
    (wgmma) for bf16 with head_dim 64 or 128, the FMA tile otherwise
    (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu). `op` is
    "flash_attention" (K2, with or without lse), "flash_attention_bwd_dq"
    (K3) or "flash_attention_bwd_dkv" (K4)."""
    stem = {"flash_attention": "flash_fwd", "flash_attention_bwd_dq": "flash_bwd_dq",
            "flash_attention_bwd_dkv": "flash_bwd_dkv"}[op]
    tile = ("wgmma" if dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_HEAD_DIMS
            else "fma")
    return f"{stem}_{tile}_kernel"


def _bwd_operands(name, q, k, v, do, lse, delta):
    """Checks shared by K3 and K4; returns q and do with one set of strides
    (the kernels read both through it)."""
    _check_gqa(name, q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q, got {do.dtype} {tuple(do.shape)}")
    _check_rows(name, q, lse, "lse")
    _check_rows(name, q, delta, "delta")
    if do.stride() != q.stride():
        q, do = q.contiguous(), do.contiguous()
    dispatch.check_kv_layout(name, q, do)
    return q, do


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dQ of attention (K3 on the card, `_dq_reference` on the CPU) from the
    forward's lse and delta = rowsum(dO * O) - dlse, both [B, H, Tq] f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not dispatch.use_kernel(q, k, v, do, lse, delta):
        return _dq_reference(q, k, v, do, lse, delta, causal, scale)
    q, do = _bwd_operands("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    dispatch.launch(
        "flash_attention_bwd_dq", "rtt_flash_attention_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, Tq, Tk, H, KVH, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        int(bool(causal)), float(scale), dispatch.dtype_code(q))
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of attention, summed over each GQA group (K4 on the card,
    `_dkv_reference` on the CPU); inputs as `flash_attention_bwd_dq`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not dispatch.use_kernel(q, k, v, do, lse, delta):
        return _dkv_reference(q, k, v, do, lse, delta, causal, scale)
    q, do = _bwd_operands("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk, KVH = k.shape[1], k.shape[2]
    dk = torch.empty((B, Tk, KVH, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0 or Tq == 0:  # no queries: no gradient
        return dk.zero_(), dv.zero_()
    dispatch.launch(
        "flash_attention_bwd_dkv", "rtt_flash_attention_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KVH, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        int(bool(causal)), float(scale), dispatch.dtype_code(q))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) = attention(q, k, v) with the flash-2 backward (K2 + K3/K4)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if dispatch.use_kernel(q, k, v):
            o, lse = _flash_fwd(q, k, v, causal, scale, with_lse=True)
        else:
            o, lse = _fwd_reference_with_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = _attention_delta(o, do, dlse)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head / grouped-query attention, differentiable.

    Args:
      q: [B, T, H, D]; k, v: [B, T, KVH, D] with H % KVH == 0 (GQA).
      causal: apply the causal mask (query t sees keys <= t).
      scale: score scale, default 1/sqrt(D).
    Returns [B, T, H, D] in q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)[0]
    if not dispatch.use_kernel(q, k, v):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return _flash_fwd(q, k, v, causal, scale, with_lse=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True,
                             scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention returning (o [B, T, H, D], lse [B, H, T] f32), the per-row
    logsumexp. Both outputs are differentiable: an lse cotangent (ring
    attention merges blocks through lse) folds into the backward's delta."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    if not dispatch.use_kernel(q, k, v):
        return _fwd_reference_with_lse(q, k, v, causal, scale)
    return _flash_fwd(q, k, v, causal, scale, with_lse=True)
