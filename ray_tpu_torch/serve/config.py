"""Serve config schema of the port: deployment options and autoscaling
bounds, speculative decoding and disaggregation. The serving knobs of the
global registry (`spec_overlap`, `kv_frame_layout`) live in core/config.py
as in the reference.

Counterpart of ray_tpu/serve/config.py's AutoscalingConfig,
DeploymentConfig, SpeculationConfig and DisaggConfig, as this package's
own copy (the port imports nothing of ray_tpu).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


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
    # config.spec_overlap; False forces serial propose -> verify.
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


@dataclasses.dataclass
class DisaggConfig:
    """Disaggregated prefill/decode serving (serve/disagg.py).

    Requests prefill on dedicated prefill-role replicas, then their paged
    KV migrates to a decode-role replica that streams the remaining
    tokens — the two phases stop contending for the same chips.

    kv_transfer:
      "object"  — the prefill replica puts the KV blob into the object
                  store (api.put); the decode replica gets it from there. Blobs at or under
                  small_blob_bytes ride a DistChannel instead when the
                  decode replica advertises one (the object plane's
                  per-object bookkeeping isn't worth it for small KV).
      "channel" — every blob moves over a consumer-homed DistChannel to
                  the decode replica (lowest latency; no spill/replay).
      "stream"  — the default: KV frames stream to the decode replica's
                  DistChannel AS PREFILL COMMITS PAGES (page-window
                  slices, coalesced per destination), and the decode
                  engine ingests them eagerly via begin/ingest/finish
                  _kv_import — migration overlaps prefill compute
                  instead of starting after the first token.
    """

    prefill_replicas: int = 1
    decode_replicas: int = 1
    kv_transfer: str = "stream"
    # object mode: blobs at or under this many bytes fall back to the
    # decode replica's DistChannel when one is available
    small_blob_bytes: int = 262144
    # place every replica (prefill AND decode) on a distinct host via a
    # STRICT_SPREAD placement group; falls back to default placement when
    # the cluster has too few hosts (one host: both roles on its card)
    strict_spread: bool = True
    # stream mode: tokens per KV frame (smaller = earlier overlap, more
    # frames), frames coalesced per destination up to this many bytes
    # per channel put, per-frame idle timeout before the importer aborts
    # (a dead prefill must fail the request, never hang it), and how
    # long the decode inbox parks unclaimed frames before sweeping them
    kv_stream_tokens: int = 256
    kv_coalesce_bytes: int = 1 << 20
    kv_stream_idle_s: float = 30.0
    kv_inbox_ttl_s: float = 120.0
    # stream-mode frame layout forwarded to the prefill engines: "layer"
    # (wire v2 — per-layer-group slabs, the stream starts during the
    # first layers of the device->host pull), "token" (wire v1 — full
    # layer stack per frame), or "" to follow config.kv_frame_layout
    kv_frame_layout: str = ""
    # prefix-aware role routing: a request whose leading prompt pages
    # are warm on a decode replica (per its PrefixCache digest, gossiped
    # every prefix_gossip_s) runs there directly — no prefill hop, no
    # migration — once at least prefix_route_min_tokens are warm
    prefix_routing: bool = True
    prefix_route_min_tokens: int = 32
    prefix_gossip_s: float = 2.0
    # live request resume: a decode replica dying
    # mid-stream re-runs the request's remaining tokens on a healthy peer
    # (prompt + committed tokens replayed as the continuation prompt) and
    # the client stream continues from the last committed token — a
    # latency blip, never a failed request. resume_max_attempts bounds
    # how many distinct replica deaths ONE stream survives.
    live_resume: bool = True
    resume_max_attempts: int = 2
    # adapter-residency gossip: how often the coordinator refreshes each
    # decode replica's loaded-LoRA set for adapter-aware routing
    adapter_gossip_s: float = 5.0
    # graceful scale-down: a replica removed from membership keeps
    # serving its in-flight streams for up to this long before the
    # coordinator drops its routing state
    drain_grace_s: float = 30.0

    TRANSFERS = ("object", "channel", "stream")

    def __post_init__(self) -> None:
        if self.kv_transfer not in self.TRANSFERS:
            raise ValueError(
                f"kv_transfer must be one of {self.TRANSFERS}, "
                f"got {self.kv_transfer!r}")
        if int(self.prefill_replicas) < 1 or int(self.decode_replicas) < 1:
            raise ValueError(
                "disagg needs at least one replica per role, got "
                f"prefill_replicas={self.prefill_replicas} "
                f"decode_replicas={self.decode_replicas}")
        if int(self.small_blob_bytes) < 0:
            raise ValueError(
                f"small_blob_bytes must be >= 0, got {self.small_blob_bytes}")
        if int(self.kv_stream_tokens) < 1:
            raise ValueError(
                f"kv_stream_tokens must be >= 1, got {self.kv_stream_tokens}")
        if self.kv_frame_layout not in ("", "layer", "token"):
            raise ValueError(
                "kv_frame_layout must be '', 'layer' or 'token', "
                f"got {self.kv_frame_layout!r}")
        if int(self.kv_coalesce_bytes) < 0:
            raise ValueError(
                f"kv_coalesce_bytes must be >= 0, "
                f"got {self.kv_coalesce_bytes}")
        if float(self.kv_stream_idle_s) <= 0:
            raise ValueError(
                f"kv_stream_idle_s must be > 0, got {self.kv_stream_idle_s}")
        if float(self.kv_inbox_ttl_s) <= 0:
            raise ValueError(
                f"kv_inbox_ttl_s must be > 0, got {self.kv_inbox_ttl_s}")
        if int(self.prefix_route_min_tokens) < 1:
            raise ValueError(
                f"prefix_route_min_tokens must be >= 1, "
                f"got {self.prefix_route_min_tokens}")
        if float(self.prefix_gossip_s) < 0:
            raise ValueError(
                f"prefix_gossip_s must be >= 0, got {self.prefix_gossip_s}")
        if int(self.resume_max_attempts) < 0:
            raise ValueError(
                f"resume_max_attempts must be >= 0, "
                f"got {self.resume_max_attempts}")
        if float(self.adapter_gossip_s) < 0:
            raise ValueError(
                f"adapter_gossip_s must be >= 0, got {self.adapter_gossip_s}")
        if float(self.drain_grace_s) < 0:
            raise ValueError(
                f"drain_grace_s must be >= 0, got {self.drain_grace_s}")

    @classmethod
    def parse(cls, value) -> "DisaggConfig":
        """Normalize a YAML/JSON dict (or an existing instance), rejecting
        unknown keys with a clear error instead of silently ignoring a
        typo'd knob."""
        if isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            raise ValueError(
                f"disagg must be a mapping, got {type(value).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(value) - known
        if unknown:
            raise ValueError(
                f"unknown disagg option(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        return cls(**value)
