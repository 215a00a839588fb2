"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package `ray_tpu`, which stays the
reference the port is held against; it imports `torch`, numpy and the
stdlib, never `jax` and nothing of `ray_tpu`. This slice serves the dense
Llama-family decoder through the continuous-batching engine, with the four
kernels of that path (RMSNorm, flash-attention forward, paged decode and
paged chunk attention) hand-written in CUDA C++ for sm_90a
(ray_tpu_torch/csrc). Entry points run on the card unless the caller
passes device="cpu"; on the CPU every kernel takes its plain version.
"""

from .models import get_config, init_params, params_from_numpy  # noqa: F401
from .serve import EngineConfig, InferenceEngine, LLMServer  # noqa: F401

__all__ = ["EngineConfig", "InferenceEngine", "LLMServer", "get_config", "init_params",
           "params_from_numpy"]
