"""Model configs for the built-in decoder-only transformer families.

A copy of ray_tpu/models/config.py (same names, fields and registry), kept
here so the PyTorch port imports nothing of the JAX package. Covers the
BASELINE.md workload set: GPT-2 125M, Llama-3 8B, Mixtral 8x7B, plus tiny
variants for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    n_kv_heads: Optional[int] = None  # None -> MHA
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    max_seq_len: int = 2048
    # architecture family knobs
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu
    positional: str = "rope"  # rope | learned
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE (0 experts -> dense)
    num_experts: int = 0
    num_selected_experts: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # training numerics
    dtype: str = "bfloat16"
    remat: bool = True
    logits_softcap: Optional[float] = None
    # attention implementation: "flash" (Pallas/XLA blockwise, seq gathered)
    # or "ring" (sequence-parallel ring attention over the sp mesh axis)
    attn_impl: str = "flash"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once if tied)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        H, KVH, hd = self.n_heads, self.kv_heads, self.hdim
        attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
        if self.activation == "swiglu":
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F + F + D  # gelu mlp with biases
        if self.is_moe:
            ffn = self.num_experts * ffn + D * self.num_experts
        norms = 2 * D * (2 if self.norm == "layernorm" else 1)
        emb = V * D * (1 if self.tie_embeddings else 2)
        pos = self.max_seq_len * D if self.positional == "learned" else 0
        return L * (attn + ffn + norms) + emb + pos + D


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_configs():
    return sorted(_REGISTRY)


# --- BASELINE.md workload configs -----------------------------------------

register(ModelConfig(
    name="gpt2-125m",
    vocab_size=50257,
    d_model=768, n_layers=12, n_heads=12, d_ff=3072,
    max_seq_len=1024,
    norm="layernorm", activation="gelu", positional="learned",
    tie_embeddings=True,
))

register(ModelConfig(
    name="llama3-8b",
    vocab_size=128256,
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
    max_seq_len=8192,
    norm="rmsnorm", activation="swiglu", positional="rope",
    rope_theta=500000.0, norm_eps=1e-5,
))

register(ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32000,
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
    max_seq_len=8192,
    norm="rmsnorm", activation="swiglu", positional="rope",
    rope_theta=1000000.0,
    num_experts=8, num_selected_experts=2,
))

register(ModelConfig(
    name="llama-600m",
    # Llama-3 family member sized so f32 master params + Adam moments fit a
    # single 16GB v5e chip — the single-chip bench/flagship-entry config.
    vocab_size=32000,
    d_model=1536, n_layers=16, n_heads=12, n_kv_heads=4,
    head_dim=128, d_ff=6144,
    max_seq_len=4096,
    norm="rmsnorm", activation="swiglu", positional="rope",
    rope_theta=500000.0,
))

register(ModelConfig(
    name="moe-1b",
    # Single-chip MoE bench config (BASELINE.md workload #3's measurable
    # stand-in for mixtral-8x7b): llama-600m's attention backbone, 8
    # experts top-2 — ~1.3B total params, ~0.45B active per token. With
    # factored optimizer + bf16 params it fits one 16GB v5e chip, so the
    # expert-dispatch path (capacity-factor einsums -> all_to_all on ep
    # meshes) gets a real tokens/s + overhead%% gate.
    vocab_size=32000,
    d_model=1536, n_layers=8, n_heads=12, n_kv_heads=4,
    head_dim=128, d_ff=4096,
    max_seq_len=4096,
    num_experts=8, num_selected_experts=2,
    norm="rmsnorm", activation="swiglu", positional="rope",
    rope_theta=500000.0,
))

register(ModelConfig(
    name="llama-2b",
    # ~2B Llama-3 family member: the single-chip scale stepping stone
    # toward llama3-8b (BASELINE.md workload #2). remat (on by default)
    # plus a FACTORED optimizer (train.lm.make_optimizer(factored=True),
    # adafactor second moments) is what fits f32 master state + grads in
    # one 16GB v5e chip — adamw moments alone would be 2x params.
    vocab_size=32000,
    d_model=2560, n_layers=24, n_heads=20, n_kv_heads=5,
    head_dim=128, d_ff=6912,
    max_seq_len=4096,
    norm="rmsnorm", activation="swiglu", positional="rope",
    rope_theta=500000.0,
))

# tiny variants for tests / CPU-mesh dry runs
register(ModelConfig(
    name="tiny-llama",
    vocab_size=512,
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq_len=128, dtype="float32", remat=False,
))

register(ModelConfig(
    name="tiny-gpt2",
    vocab_size=512,
    d_model=64, n_layers=2, n_heads=4, d_ff=128,
    max_seq_len=128,
    norm="layernorm", activation="gelu", positional="learned",
    tie_embeddings=True, dtype="float32", remat=False,
))

register(ModelConfig(
    name="tiny-moe",
    vocab_size=512,
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
    max_seq_len=128,
    num_experts=4, num_selected_experts=2, dtype="float32", remat=False,
))
