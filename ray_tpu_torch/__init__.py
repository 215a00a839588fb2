"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package `ray_tpu`, which stays the
reference the port is held against; it imports `torch`, numpy and the
stdlib, never `jax` and nothing of `ray_tpu`. It serves the
Llama-family decoder, dense or mixture-of-experts, through the
continuous-batching engine, with speculative decoding (n-gram or
draft-model proposers), KV migration between engines, live weight
updates and the reference's metrics and SLO digests (ray_tpu_torch.core,
ray_tpu_torch.util), and trains it on one device
(`ray_tpu_torch.train`: AdamW or adafactor with the reference's optax
semantics, f32 or bf16 parameters, activation checkpointing). The kernels of both paths are
hand-written in CUDA C++ for sm_90a (ray_tpu_torch/csrc): RMSNorm, the
flash-attention forward (with the logsumexp residual) and its dq and dk/dv
backward kernels, paged decode, paged chunk and paged verify attention.
Entry points run
on the card unless the caller passes device="cpu"; on the CPU every kernel
takes its plain version.
"""

from .models import get_config, init_params, params_from_numpy  # noqa: F401
from .serve import EngineConfig, InferenceEngine, LLMServer, SpeculationConfig  # noqa: F401
from .train import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    synthetic_batch,
)

__all__ = ["EngineConfig", "InferenceEngine", "LLMServer", "SpeculationConfig", "get_config",
           "init_params", "init_train_state", "make_eval_step", "make_optimizer",
           "make_train_step", "params_from_numpy", "synthetic_batch"]
