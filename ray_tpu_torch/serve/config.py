"""Serve config schema of the port: deployment options and autoscaling
bounds, speculative decoding, and the defaults that the reference keeps
in its global config (ray_tpu/core/config.py).

Counterpart of ray_tpu/serve/config.py's AutoscalingConfig,
DeploymentConfig and SpeculationConfig, as this package's own copy (the
port imports nothing of ray_tpu). DisaggConfig waits for disaggregated
serving (ROADMAP A6b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

# What `overlap=None` means: dispatch the next round's propose right after
# a round's commit readback (the reference's `spec_overlap` default).
SPEC_OVERLAP_DEFAULT = True

# The layout of streamed KV-migration frames when a request does not name
# one (`Request.kv_frame_layout`; the reference's `kv_frame_layout`):
# "layer" (wire v2: each frame a slab of consecutive layers over a token
# range, so the stream starts while later layers are still being copied
# and the importer stages slabs as they land) or "token" (wire v1: every
# layer in each frame).
KV_FRAME_LAYOUT_DEFAULT = "layer"


@dataclasses.dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    # smoothing on the observed load before comparing against target
    metrics_interval_s: float = 1.0


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 10.0
    health_check_timeout_s: float = 30.0
    # how long a replica that is being stopped may take to finish its
    # requests and run its class's shutdown() (ServeReplica.
    # prepare_for_shutdown) before it is killed
    graceful_shutdown_timeout_s: float = 10.0
    # STARTING budget: a replica whose __init__ never completes within
    # this window is replaced. Generous by default — LLM replicas
    # legitimately spend minutes loading weights and warming compiles
    # (reference serve's initialization deadline is likewise long).
    startup_timeout_s: float = 600.0


@dataclasses.dataclass
class SpeculationConfig:
    """Speculative decoding for the inference engine (serve/spec_decode.py).

    mode:
      "off"   — one token per decode step (the classic path).
      "ngram" — drafts come from a suffix-match lookup over the request's
                own prompt+output (no extra model).
      "draft" — drafts come from a small draft transformer sharing the
                tokenizer, with its own paged KV pool. draft_model names a
                models/ registry entry; None self-speculates with the
                target's own weights (plumbing smoke / upper bound — a
                deployment should always name a real draft).
    """

    mode: str = "off"
    # draft tokens proposed per decode step; each verify forward scores
    # num_speculative_tokens + 1 positions per slot
    num_speculative_tokens: int = 4
    # n-gram proposer: longest suffix of length in [ngram_min, ngram_max]
    # matched against earlier context, most recent occurrence wins
    ngram_max: int = 4
    ngram_min: int = 1
    draft_model: Optional[str] = None
    draft_model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # draft mode: dispatch round N+1's propose right after round N's commit
    # readback so the draft forward overlaps the engine's host bookkeeping
    # (spec_decode.DraftModelProposer.prefetch). None follows
    # SPEC_OVERLAP_DEFAULT; False forces serial propose -> verify.
    overlap: Optional[bool] = None

    MODES = ("off", "ngram", "draft")

    def __post_init__(self) -> None:
        if self.mode not in self.MODES:
            raise ValueError(
                f"speculation mode must be one of {self.MODES}, got {self.mode!r}")
        if not 1 <= int(self.num_speculative_tokens) <= 64:
            raise ValueError(
                "num_speculative_tokens must be in [1, 64], got "
                f"{self.num_speculative_tokens}")
        if not 1 <= int(self.ngram_min) <= int(self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"ngram_min={self.ngram_min} ngram_max={self.ngram_max}")
        if self.mode != "draft" and self.draft_model is not None:
            raise ValueError(
                "draft_model is only meaningful with mode='draft', got "
                f"mode={self.mode!r}")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @classmethod
    def parse(cls, value) -> "SpeculationConfig":
        """Normalize a YAML/JSON dict (or an existing instance), rejecting
        unknown keys with a clear error instead of silently ignoring a
        typo'd knob."""
        if isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            raise ValueError(
                f"speculation must be a mapping, got {type(value).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(value) - known
        if unknown:
            raise ValueError(
                f"unknown speculation option(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(**value)
