"""RMSNorm (kernel K1, csrc/rms_norm.cu) and LayerNorm (plain PyTorch).

Counterpart of ray_tpu/ops/norm.py. `rms_norm` launches K1's forward for
tensors on the card and runs `rms_norm_reference` for tensors on the CPU.
When a gradient is needed it runs as `_RMSNorm`, an autograd Function whose
backward calls `rms_norm_bwd`: K1's backward kernel on the card (the
reference's closed form, which it leaves to XLA, as one kernel), `_rms_bwd`
on the CPU. LayerNorm has no kernel in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dispatch

# rows of f32 dw partials the backward's workspace holds: its kernel runs at
# most this many CTAs, each writing one partial row (csrc/rms_norm.cu)
BWD_MAX_PARTIALS = 2048


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K1: f32 statistics, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def _rms_bwd(x, w, g, eps):
    """Closed-form (dx, dw) of x * rsqrt(mean(x^2) + eps) * w, f32 inside:
    the plain version of K1's backward."""
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = gf * wf
    dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g, ctx.eps)  # looked up at call time
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, differentiable. w: [D] scale."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _rms_forward(x, w, eps)


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> int:
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"{name}: w must be [{D}], got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous x and w")
    return D


def kernel_symbol(op: str, *tensors: torch.Tensor) -> str:
    """The kernel that op ("rms_norm" or "rms_norm_bwd") launches for these
    inputs, as its C entry point picks it: the 16-byte vector kernel when
    every base is 16-byte aligned and a row of the first tensor is a multiple
    of 16 bytes, the scalar kernel otherwise (outputs come from the caching
    allocator, aligned)."""
    x = tensors[0]
    vec = (x.shape[-1] * x.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    stem = "rms_norm_fwd" if op == "rms_norm" else "rms_norm_bwd"
    return f"{stem}_{'vec' if vec else 'scalar'}_kernel"


def _rms_forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """K1 on the card, the plain version on the CPU."""
    if not dispatch.use_kernel(x, w):
        return rms_norm_reference(x, w, eps)
    D = _check("rms_norm", x, w)
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    dispatch.launch("rms_norm", "rtt_rms_norm", x.device,
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, float(eps),
                    dispatch.dtype_code(x), dispatch.dtype_code(w))
    return y


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float):
    """(dx, dw) of rms_norm(x, w, eps) under the output cotangent g: K1's
    backward on the card (one count, its two launches), `_rms_bwd` on the
    CPU. dx in x's dtype, dw in w's dtype; dw is summed in a fixed order, so
    two calls on the same inputs give the same bits."""
    if not dispatch.use_kernel(x, w, g):
        return _rms_bwd(x, w, g, eps)
    D = _check("rms_norm_bwd", x, w)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd: g must match x ({tuple(x.shape)}, {x.dtype}), "
                         f"got {tuple(g.shape)}, {g.dtype}")
    g = g.contiguous()  # autograd may hand over a strided or expanded cotangent
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    rows = x.numel() // D
    if rows == 0:
        return dx, dw.zero_()
    parts = torch.empty((min(rows, BWD_MAX_PARTIALS), D), dtype=torch.float32, device=x.device)
    dispatch.launch("rms_norm_bwd", "rtt_rms_norm_bwd", x.device,
                    x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                    parts.data_ptr(), parts.shape[0], rows, D, float(eps),
                    dispatch.dtype_code(x), dispatch.dtype_code(w))
    return dx, dw


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
