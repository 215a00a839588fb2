"""LLMServer: the serving deployment over one InferenceEngine.

Counterpart of ray_tpu/serve/llm.py's LLMServer:
`serve.run(LLMServer.bind(...))` starts its replicas, each one engine on
the card, and serve's router spreads requests over them while each engine
batches continuously. `LLMServer._target(...)` builds the plain class,
outside any replica (the runtime can also host that as a GPU actor). It
swaps its weights live (`update_weights`, from a tree in hand or an
object-plane ref) and exposes the engine's weights version and
prefix-cache digest.

`role="prefill"` / `"decode"` serve disaggregated (serve/disagg.py): the
coordinator addresses the role methods (prefill_request, decode_request,
decode_stream, generate_request, generate_stream, kv_ingest) on the
replica directly. The engine is the same in every role, and every role
captures every program at init, decode spans on a prefill replica
included. LoRA adapters are residency bookkeeping only, as in the
reference: the engine applies none.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

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
    role: "colocated" (default: one replica does both phases), or
    "prefill"/"decode" for disaggregated serving (serve/disagg.py):
    prefill replicas run prompt-only passes and export KV, decode
    replicas import KV and stream tokens.
    """

    ROLES = ("colocated", "prefill", "decode")

    def __init__(self, model_name: str = "tiny-llama",
                 engine_config: Optional[Dict[str, Any]] = None, params_fn=None,
                 model_overrides: Optional[Dict[str, Any]] = None, device=None,
                 seed: int = 0, draft_params_fn=None, speculation: Any = None,
                 role: str = "colocated"):
        t_build = time.monotonic()
        if role not in self.ROLES:
            raise ValueError(f"role must be one of {self.ROLES}, got {role!r}")
        self.role = role
        self._kv_inbox = None  # decode role: created on first kv_ingest
        self._kv_inbox_lock = threading.Lock()
        # resident adapters, a small LRU (move-to-end on touch, evict the
        # oldest past capacity); a request naming a non-resident adapter
        # pulls it through its adapter_ref
        self._adapters: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._adapter_capacity = 8
        self._adapter_lock = threading.Lock()
        self._adapter_hits: Dict[str, int] = {}
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
        self._build_s = time.monotonic() - t_build

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.generate(**_generate_args(request))

    def stream(self, request: Dict[str, Any]):
        """Token iterator: the first token arrives at TTFT, not completion."""
        return self.engine.generate_stream(**_generate_args(request))

    # ---------------------------------------------------------- disagg
    # Thin delegations to serve/disagg.py's replica helpers; the
    # coordinator addresses these on the replica actor directly (not via
    # a DeploymentHandle) so channel KV lands where the decode runs.

    def prefill_request(self, request: Dict[str, Any]) -> Dict[str, Any]:
        from .disagg import replica_prefill

        return replica_prefill(self.engine, request)

    def decode_request(self, request: Dict[str, Any]) -> Dict[str, Any]:
        from .disagg import replica_decode

        self._ensure_adapter(request)
        return replica_decode(self.engine, request, self._kv_inbox)

    def decode_stream(self, request: Dict[str, Any]):
        from .disagg import replica_decode_stream

        self._ensure_adapter(request)
        return replica_decode_stream(self.engine, request, self._kv_inbox)

    def generate_request(self, request: Dict[str, Any]) -> Dict[str, Any]:
        from .disagg import replica_generate

        self._ensure_adapter(request)
        return replica_generate(self.engine, request)

    def generate_stream(self, request: Dict[str, Any]):
        from .disagg import replica_generate_stream

        self._ensure_adapter(request)
        return replica_generate_stream(self.engine, request)

    def kv_ingest(self, request: Any = None):
        """Create this replica's KV inbox on first use and return its
        DistChannel (picklable: prefill replicas put into it)."""
        from .disagg import KvInbox

        # concurrent first requests race here (replicas dispatch
        # handle_request from many threads): under the lock they share one
        # inbox instead of orphaning the channels no drainer reads
        with self._kv_inbox_lock:
            if self._kv_inbox is None:
                ttl = (float(request.get("kv_inbox_ttl_s", 120.0))
                       if isinstance(request, dict) else 120.0)
                self._kv_inbox = KvInbox(ttl_s=ttl)
            return self._kv_inbox.channel

    def cancel(self, request: Dict[str, Any]) -> bool:
        hit = self.engine.cancel(request["request_id"])
        if self._kv_inbox is not None:
            self._kv_inbox.cancel(request["request_id"])
        return hit

    # ------------------------------------------------------ adapters

    def load_adapter(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Pin an adapter resident: {"adapter_id", "weights"|"ref"}. An
        ObjectRef resolves through the object store."""
        from .. import api

        adapter_id = str(request["adapter_id"])
        weights = request.get("weights")
        if weights is None and request.get("ref") is not None:
            weights = api.get(request["ref"], timeout=float(request.get("timeout_s", 60.0)))
        with self._adapter_lock:
            self._adapters[adapter_id] = weights
            self._adapters.move_to_end(adapter_id)
            evicted = []
            while len(self._adapters) > self._adapter_capacity:
                old, _w = self._adapters.popitem(last=False)
                self._adapter_hits.pop(old, None)
                evicted.append(old)
        return {"adapter_id": adapter_id, "resident": True, "evicted": evicted}

    def list_adapters(self, _request: Any = None) -> List[str]:
        with self._adapter_lock:
            return sorted(self._adapters)

    def _ensure_adapter(self, request: Dict[str, Any]) -> None:
        adapter_id = request.get("adapter_id")
        if not adapter_id:
            return
        with self._adapter_lock:
            if adapter_id in self._adapters:
                self._adapters.move_to_end(adapter_id)
                self._adapter_hits[adapter_id] = self._adapter_hits.get(adapter_id, 0) + 1
                return
        if request.get("adapter_ref") is None:
            raise ValueError(f"adapter {adapter_id!r} not resident and the request "
                             f"carries no adapter_ref to pull it from")
        self.load_adapter({"adapter_id": adapter_id, "ref": request["adapter_ref"],
                           "timeout_s": request.get("timeout_s", 60.0)})
        with self._adapter_lock:
            self._adapter_hits[adapter_id] = self._adapter_hits.get(adapter_id, 0) + 1

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

    def admits(self, request: Optional[Dict[str, Any]] = None) -> int:
        """Legs of the request's "role" (default: this replica's) that the
        engine runs at once (EngineConfig.admits): the coordinator's
        backlog() reads it."""
        return self.engine.ecfg.admits((request or {}).get("role", self.role))

    def build_s(self, _request: Any = None) -> float:
        """Seconds this replica's __init__ took: weights, engine, captures."""
        return self._build_s

    def prefix_digest(self, _request: Any = None) -> Dict[str, Any]:
        """The engine's prefix-cache fingerprint, for prefix-aware routing."""
        return self.engine.prefix_digest()

    def stats(self, _request: Any = None) -> Dict[str, Any]:
        out = self.engine.stats()
        out["role"] = self.role
        with self._adapter_lock:
            out["adapters"] = sorted(self._adapters)
            out["adapter_requests"] = dict(self._adapter_hits)
        # what warm-up took: programs captured, seconds, graph pool bytes
        out["capture"] = dict(self.engine.capture_stats)
        return out

    def check_health(self) -> None:
        pass

    def shutdown(self) -> None:
        """Stop the engine's threads, then fail the requests still live
        with an error (a serve replica calls this when it retires:
        ServeReplica.prepare_for_shutdown). A stream failed here resumes
        on a peer under a disaggregated coordinator; left live, it would
        wait for tokens that never come."""
        self.engine.stop()
        self.engine._fail_all("the replica shut down")


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
