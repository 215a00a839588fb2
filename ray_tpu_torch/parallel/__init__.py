"""ray_tpu_torch.parallel — parallel building blocks (so far MoE routing)."""

from .moe import aux_load_balance_loss, top_k_gating  # noqa: F401
