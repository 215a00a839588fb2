"""LLMServer: the serving deployment over one InferenceEngine.

Counterpart of ray_tpu/serve/llm.py's LLMServer in the colocated role:
`serve.run(LLMServer.bind(...))` starts its replicas, each one engine on
the card, and serve's router spreads requests over them while each engine
batches continuously. `LLMServer._target(...)` builds the plain class,
outside any replica (the runtime can also host that as a GPU actor). It
swaps its weights live (`update_weights`, from a tree in hand or an
object-plane ref) and exposes the engine's weights version and
prefix-cache digest. The disaggregated roles, LoRA adapters and the
methods that stand on them (prefill_request, decode_request,
decode_stream, kv_ingest) wait for ROADMAP A6b.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..models import get_config, init_params
from ..ops.dispatch import resolve_device
from .deployment import deployment
from .engine import EngineConfig, InferenceEngine


@deployment(name="llm", max_ongoing_requests=32)
class LLMServer:
    """Token-level LLM server.

    Request: {"prompt_ids": [int], "max_tokens": int, "temperature": float,
              "top_p": float, "top_k": int, "stop_token_ids": [[int]]}
    Response: {"token_ids": [...], "logprobs": [...], "finish_reason": ...,
               "ttft_s": ..., "latency_s": ..., ...}

    engine_config: EngineConfig's fields; "speculation" (a dict, see
    serve/config.py) turns on speculative decoding.
    speculation: shorthand for engine_config["speculation"]; the two must
    not both be set.
    params_fn: optional () -> (params, model_cfg) to load real weights;
    default builds random weights for the named config from `seed`,
    straight into the model dtype on the device (no f32 master copy).
    draft_params_fn: optional () -> params of the speculation's named draft
    model (mode "draft" with `draft_model`); default: random weights of
    the named draft config from seed 0.
    device: the card unless the caller names another.
    """

    role = "colocated"

    def __init__(self, model_name: str = "tiny-llama",
                 engine_config: Optional[Dict[str, Any]] = None, params_fn=None,
                 model_overrides: Optional[Dict[str, Any]] = None, device=None,
                 seed: int = 0, draft_params_fn=None, speculation: Any = None):
        engine_config = dict(engine_config or {})
        if speculation is not None:
            if engine_config.get("speculation") is not None:
                raise ValueError("pass speculation either as the LLMServer kwarg or "
                                 "inside engine_config, not both")
            engine_config["speculation"] = speculation
        device = resolve_device(device)
        if params_fn is not None:
            params, cfg = params_fn()
        else:
            cfg = get_config(model_name, **(model_overrides or {}))
            params = init_params(cfg, seed=seed, device=device, dtype=cfg.dtype)
        draft_params = draft_params_fn() if draft_params_fn is not None else None
        self.engine = InferenceEngine(params, cfg, EngineConfig(**engine_config),
                                      device=device, draft_params=draft_params)
        # the SLO digests group by serving role
        self.engine.slo_role = self.role
        # capture every device program (prefill, chunks, decode spans and
        # speculation) at init, and so build the kernels, rather than under
        # the first requests
        self.engine.warmup()

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.generate(**_generate_args(request))

    def stream(self, request: Dict[str, Any]):
        """Token iterator: the first token arrives at TTFT, not completion."""
        return self.engine.generate_stream(**_generate_args(request))

    def cancel(self, request: Dict[str, Any]) -> bool:
        return self.engine.cancel(request["request_id"])

    def update_weights(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Swap the engine's weights live, without draining:
        {"weights"|"ref", "version"?: int, "timeout_s"?: float} ->
        {"weights_version", "role"} (InferenceEngine.update_params: any
        array form, written in place into the tensors the engine was built
        over). An ObjectRef resolves through the object plane's `get`
        within timeout_s (default 60); a tree of CUDA tensors comes back by
        reference, without a host copy."""
        from .. import api  # here: a server that takes no ref never loads the runtime

        weights = request.get("weights")
        if weights is None and request.get("ref") is not None:
            weights = api.get(request["ref"], timeout=float(request.get("timeout_s", 60.0)))
        if weights is None:
            raise ValueError("update_weights needs 'weights' or 'ref'")
        v = self.engine.update_params(weights, version=request.get("version"))
        return {"weights_version": v, "role": self.role}

    def weights_version(self, _request: Any = None) -> int:
        return self.engine.weights_version

    def prefix_digest(self, _request: Any = None) -> Dict[str, Any]:
        """The engine's prefix-cache fingerprint, for prefix-aware routing."""
        return self.engine.prefix_digest()

    def stats(self, _request: Any = None) -> Dict[str, Any]:
        out = self.engine.stats()
        out["role"] = self.role
        # what warm-up took: programs captured, seconds, graph pool bytes
        out["capture"] = dict(self.engine.capture_stats)
        return out

    def check_health(self) -> None:
        pass

    def shutdown(self) -> None:
        """Stop the engine's threads (a serve replica calls this when it
        retires: ServeReplica.prepare_for_shutdown)."""
        self.engine.stop()


def _generate_args(request: Dict[str, Any]) -> Dict[str, Any]:
    return dict(
        prompt=list(request["prompt_ids"]),
        max_tokens=int(request.get("max_tokens", 32)),
        temperature=float(request.get("temperature", 0.0)),
        top_p=float(request.get("top_p", 1.0)),
        top_k=int(request.get("top_k", 0)),
        stop=request.get("stop_token_ids"),
        request_id=request.get("request_id"),
    )
