"""ray_tpu_torch.models — model configs and the dense decoder in PyTorch."""

from .config import ModelConfig, get_config, list_configs, register  # noqa: F401
from .transformer import forward, init_params, params_from_numpy, prefill  # noqa: F401
