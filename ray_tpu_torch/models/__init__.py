"""ray_tpu_torch.models — model configs and the decoder (dense and MoE) in PyTorch."""

from .config import ModelConfig, get_config, list_configs, register  # noqa: F401
from .generate import generate, sample_token  # noqa: F401
from .transformer import (  # noqa: F401
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    loss_fn,
    loss_from_logits,
    params_from_numpy,
    params_to_numpy,
    prefill,
)
