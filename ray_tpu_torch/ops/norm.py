"""RMSNorm (kernel K1, csrc/rms_norm.cu) and LayerNorm (plain PyTorch).

Counterpart of ray_tpu/ops/norm.py. `rms_norm` launches the CUDA kernel
for tensors on the card and runs `rms_norm_reference` for tensors on the
CPU. LayerNorm has no kernel in the reference either.
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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. w: [D] scale."""
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
