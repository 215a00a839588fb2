"""Mixture-of-experts routing primitives.

Counterpart of ray_tpu/parallel/moe.py: Switch/Mixtral-style top-k gating
with a static per-expert capacity (tokens past it are dropped and the
residual stream carries them), the dense dispatch/combine masks and the
Switch load-balance loss. The reference's `moe_layer_local`, the per-rank
body that routes tokens to expert-owning ranks with two all_to_alls over
an `ep` mesh axis, waits for the port's meshes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k_gating(router_logits: torch.Tensor,
                 num_selected: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """router_logits [..., E] -> (weights [..., k], expert_ids [..., k]).
    Weights are softmaxed over the selected k (Mixtral convention). The k
    largest come in descending order, the lower index first on ties, as
    jax.lax.top_k gives them (a stable descending sort)."""
    vals, ids = torch.sort(router_logits, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[..., :num_selected], ids[..., :num_selected]
    return torch.softmax(gate_vals, dim=-1), expert_ids


def expert_one_hot(ids: torch.Tensor, num_experts: int, dtype=torch.int64) -> torch.Tensor:
    """ids [...] -> [..., num_experts] one-hot, by comparison: no read of
    the ids' maximum, so nothing waits for the card."""
    return (ids[..., None] == torch.arange(num_experts, device=ids.device)).to(dtype)


def expert_slots(flat_ids: torch.Tensor, num_experts: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_ids [..., T*k] token-major assignments -> (my_pos, keep)
    [..., T*k]: each assignment's place in its expert's queue, from a
    cumsum over the row, and whether it is under capacity."""
    onehot = expert_one_hot(flat_ids, num_experts)  # [..., T*k, E]
    my_pos = ((onehot.cumsum(dim=-2) - 1) * onehot).sum(dim=-1)
    return my_pos, my_pos < capacity


def _dispatch_mask(expert_ids: torch.Tensor, weights: torch.Tensor, num_experts: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert_ids / weights [..., T, k] -> (dispatch [..., T, E, C],
    combine [..., T, E, C]) f32. Slots follow a cumsum over each row's
    token-major [T*k] assignments; an assignment past its expert's
    capacity is dropped (no slot)."""
    *lead, T, k = expert_ids.shape
    flat_ids = expert_ids.reshape(*lead, T * k)
    my_pos, keep = expert_slots(flat_ids, num_experts, capacity)
    slot = torch.where(keep, my_pos, capacity)  # the overflow slot is cut off
    disp = (expert_one_hot(flat_ids, num_experts, torch.float32)[..., None]
            * expert_one_hot(slot, capacity + 1, torch.float32)[..., None, :capacity])
    combine = disp * weights.reshape(*lead, T * k).float()[..., None, None]
    disp = disp.reshape(*lead, T, k, num_experts, capacity).sum(dim=-3)
    combine = combine.reshape(*lead, T, k, num_experts, capacity).sum(dim=-3)
    return disp, combine


def aux_load_balance_loss(router_logits: torch.Tensor, expert_ids: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-transformer load-balance loss: E * sum over experts of (the
    share of tokens whose first choice it is) * (its mean router
    probability). router_logits [T, E], expert_ids [T, k]."""
    probs = torch.softmax(router_logits, dim=-1)
    frac_tokens = expert_one_hot(expert_ids[:, 0], num_experts, probs.dtype).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return num_experts * (frac_tokens * frac_probs).sum()
