"""RMSNorm (kernel K1, csrc/rms_norm.cu) and LayerNorm (plain PyTorch).

Counterpart of ray_tpu/ops/norm.py. `rms_norm` launches the CUDA kernel
for tensors on the card and runs `rms_norm_reference` for tensors on the
CPU. When a gradient is needed it runs as `_RMSNorm`, an autograd Function
whose backward is the reference's closed form (`_rms_bwd`) in plain
PyTorch: the reference has no backward kernel for it either. LayerNorm has
no kernel in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dispatch


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K1: f32 statistics, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def _rms_bwd(x, w, g, eps):
    """Closed-form (dx, dw) of x * rsqrt(mean(x^2) + eps) * w, f32 inside."""
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
        dx, dw = _rms_bwd(x, w, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, differentiable. w: [D] scale."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _rms_forward(x, w, eps)


def _rms_forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """K1 on the card, the plain version on the CPU."""
    if not dispatch.use_kernel(x, w):
        return rms_norm_reference(x, w, eps)
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rms_norm: w must be [{D}], got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm: the kernel takes contiguous x and w")
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    dispatch.launch("rms_norm", "rtt_rms_norm", x.device,
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, float(eps),
                    dispatch.dtype_code(x), dispatch.dtype_code(w))
    return y


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
