"""Continuously-batched LLM inference engine with a paged KV cache, in
PyTorch.

Counterpart of ray_tpu/serve/engine.py. Requests join and leave the
running decode batch every step (continuous batching); KV lives in
fixed-size pages addressed by per-sequence page tables, in one pool
[L, KVH, P, page_size, hd] per K and V; prompts prefill either at bucketed
lengths (short prompts, kernel K2) or chunk by chunk straight into their
pages (long prompts and prefix-cache hits, kernel K6); every decode step
attends over the pages (kernel K5). The decode batch is a fixed-size slot
array: inactive slots write to the reserved trash page 0 and have length 0,
for which the decode kernel returns zeros. With `EngineConfig.speculation`
a decode iteration becomes a speculative round (serve/spec_decode.py): a
proposer drafts up to k tokens per slot and one verify forward over the
pages (kernel K7) commits between 1 and k+1 of them.

The host side (slots, page allocator, prefix cache, request lifecycle,
stop sequences, the two threads) is the reference's, adapted. The device
programs are PyTorch around the kernels (serve/programs.py holds the
per-layer code they share). Like the reference's jitted programs, each is
captured as a CUDA graph per shape and replayed as one launch
(programs.CapturedProgram), with its inputs copied into static buffers:
- decode span (decode thread): n steps of the whole batch with on-device
  sampling, the tokens staying on the card from step to step, and ONE
  [span, B] readback of tokens and logprobs per span; one program per
  (n_steps, sample, advanced);
- chunked prefill (decode thread: it writes the shared pool in place); one
  program per chunk length C, the chunk's start an input on the card;
- bucketed prefill (prefill thread): one program per (bucket, padded
  batch); it writes each row's KV straight into the row's pages and
  returns only the logits at each row's last prompt token;
- with speculation, the verify per width and sampler mode, the draft
  propose and the draft's chunk (decode thread; serve/spec_decode.py).
Every program is captured before the engine's threads start (`warmup`, or
else the first request), never later: a key that was not captured raises.
The prefill thread's programs replay from a graph memory pool of their
own, the decode thread's from another (`_capture_programs` says why).
Both threads replay on PyTorch's default stream, as the reference runs its
programs in one queue, so the card runs their work in the order it was
issued: a prefill's page writes, the decode thread's spans, a cancel's
freed pages and the chunks that reuse them never race.

KV migration, the engine's half of disaggregated serving: a request with
`prefill_only` prefills as usual but takes no decode slot. Its prompt's KV
leaves as one host blob (`export_kv_pages`) or, with a `kv_sink`, as a
stream of frames while prefill commits it (`_stream_kv_frames`: wire v2,
layer-major slabs, by default; v1, every layer in each frame, with layout
"token"). Another engine takes it in (`import_kv_pages`, or
`begin_kv_import` / `ingest_kv_chunk` / `finish_kv_import` for a stream),
at its own page size, and the request goes on as if prefilled there. Pages
move by plain tensor indexing (`_gather_pages`, `_scatter_pages`), as the
reference's XLA gathers do, always eagerly between graph replays: an
export gathers after the prefill's replay; an import stages on the host
and the decode thread scatters it into the pool in place (the graphs read
the pool at its captured address) before the slot goes live. numpy has no
bf16, so the wire carries the bf16 KV widened to float32, which is exact.

Live weights (`update_params`): the programs read the parameters at their
captured addresses, so an update copies the new values into the live
tensors in place (and refreshes the f32 head copy), never rebinding them
and never recapturing a program. The copy runs under the replay lock that
both threads hold while they enqueue a program, so every program runs
wholly on the weights before an update or wholly on those after it, and a
request's weights_version is read where its first token's program is
enqueued.

Telemetry, with the reference's names, buckets and tags: the Prometheus
metrics below (core/metrics.py, the port's own registry), the SLO digests
serve_ttft_seconds, serve_tbt_seconds and serve_e2e_seconds by role
(util/slo.py), and an "engine.generate" span around `generate` under an
active trace (util/tracing.py). The hot path adds host-side counter
updates only: no sync with the card and no work inside a program.

Not ported yet: tensor-parallel meshes.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.config import config
from ..core.metrics import Counter, Gauge, Histogram
from ..models.config import ModelConfig
from ..models.transformer import _require_flash, torch_dtype
from ..ops.dispatch import resolve_device
from ..util import slo, tracing
from .config import SpeculationConfig
from .programs import (_CAPTURE_LOCK, SAMPLER_MODES, CapturedProgram, PagedModel, _categorical,
                       host_tensor, read_back)
from .spec_decode import SpecDecoder

logger = logging.getLogger("ray_tpu_torch.serve.engine")

# The Prometheus plane, as the reference's engine exports it (its
# counterpart of serve's ongoing-request metrics and vLLM's engine stats).
_m_requests = Counter("serve_requests_finished",
                      "Engine requests finished, by finish_reason.")
_m_running = Gauge("serve_requests_running",
                   "Requests currently admitted to decode slots.")
_m_tokens = Counter("serve_tokens_generated", "Tokens emitted by the engine.")
_m_prefix_hit_tokens = Counter(
    "serve_prefix_cache_hit_tokens",
    "Prompt tokens served from the prefix cache instead of prefilled.")
_m_ttft = Histogram(
    "serve_ttft_seconds", "Time to first token.",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
# Per-phase decode-step breakdown: every step() iteration with active slots
# observes each phase once, tagged {phase, mode}; mode is "spec" when a
# speculative round drives the step, "plain" for the span. "verify" is the
# dispatch (the enqueue of the span or verify replay), "sample" the
# blocking readback, "cache_bookkeeping" the host commit loop; speculative
# rounds split "propose" into "propose_wait" (a prefetched draft) and
# "propose_compute". The streamed export observes "kv_framing" (mode
# "export"): the host time slicing KV into frames and pushing them to the
# sink.
_m_step_phase = Histogram(
    "serve_decode_step_phase_seconds",
    "Decode step wall time by phase (propose/propose_wait/propose_compute/"
    "verify/sample/cache_bookkeeping/cancellation_check; kv_framing on "
    "the export path).",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 1.0, 5.0),
)
_m_tokens_per_step = Gauge(
    "serve_tokens_per_decode_step",
    "Cumulative committed tokens per slot-step of decode participation.")
_m_weights_version = Gauge(
    "serve_weights_version",
    "Monotonic generation stamp of the weights an engine is serving "
    "(bumped by update_params live swaps), by role.")


@dataclasses.dataclass
class EngineConfig:
    max_batch_size: int = 8
    page_size: int = 16
    max_pages: int = 512  # total pages in the cache pool (incl. trash page)
    max_seq_len: int = 1024
    prefill_buckets: tuple = (64, 128, 256, 512, 1024)
    # >1: queued prompts prefill together in padded batches
    prefill_batch_size: int = 1
    # burst tiers: padded batch sizes {1, K, 2K, 4K, ...} up to this cap;
    # the prefill thread drains the whole queue into one dispatch at the
    # smallest covering tier. 0 disables tiering (K stays the cap).
    prefill_max_batch: int = 32
    # prompts longer than prefill_chunk prefill in chunks ON THE DECODE
    # THREAD, one chunk per engine iteration with decode spans between;
    # their KV lands straight in their pages. Must be a multiple of
    # page_size.
    chunked_prefill: bool = True
    prefill_chunk: int = 256
    eos_token_id: Optional[int] = None
    cache_dtype: str = "bfloat16"
    # decode steps per span (sampling stays on the card; one readback per
    # span); while prefill work is pending, spans shrink to busy_span so
    # first tokens are not held behind a long span
    decode_span: int = 16
    busy_span: int = 4
    adaptive_span: bool = True
    # automatic prefix caching: full prompt pages are content-addressed by
    # a chained hash of their token prefix and reused by later prompts
    # sharing the prefix (requires chunked_prefill)
    prefix_caching: bool = True
    # speculative decoding: a SpeculationConfig or its dict form
    # (serve/config.py); None or mode "off" decodes one token per step
    speculation: Optional[Any] = None

    def __post_init__(self) -> None:
        if (self.chunked_prefill or self.prefix_caching) and (
                self.prefill_chunk % self.page_size != 0):
            raise ValueError(
                "prefill_chunk must be a multiple of page_size when "
                "chunked prefill or prefix caching is enabled (chunk KV "
                "lands directly in pages and cache hits are chunk-aligned): "
                f"prefill_chunk={self.prefill_chunk} "
                f"page_size={self.page_size}")
        if self.speculation is not None:
            self.speculation = SpeculationConfig.parse(self.speculation)

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def prefill_tiers(self) -> List[int]:
        """Padded-batch sizes: {1, K, 2K, 4K, ...} capped at
        prefill_max_batch; prefill_batch_size=1 means batching is off."""
        K = max(1, self.prefill_batch_size)
        if K == 1:
            return [1]
        cap = max(K, self.prefill_max_batch) if self.prefill_max_batch else K
        tiers = {1, K}
        t = K
        while t < cap:
            t *= 2
            tiers.add(min(t, cap))
        return sorted(tiers)

    def admits(self, role: str) -> int:
        """Legs of `role` an engine runs at once: a prefill replica's
        prefill thread takes one padded batch of at most the largest tier
        (one prompt unless prefill_batch_size > 1; a chunked prompt
        prefills alone, a chunk an iteration), any other role its decode
        slots."""
        return self.prefill_tiers()[-1] if role == "prefill" else self.max_batch_size


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: List[int]
    max_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0   # nucleus sampling mass (1.0 = off)
    top_k: int = 0       # rank cut (0 = off)
    # stop sequences as TOKEN-ID lists; a matched suffix finishes the
    # request ("stop") and is stripped from the final output. A flat
    # [int, ...] normalizes to one single-token stop per id at admission.
    stop: Optional[List[List[int]]] = None
    # stream hold-back: with stops configured, the newest max(stop)-1
    # tokens wait here so a matched stop never leaks to stream consumers
    _held: List[int] = dataclasses.field(default_factory=list)
    # prompt page chain hashes, computed at admission, reused at install
    _page_hashes: Optional[List[bytes]] = None
    output: List[int] = dataclasses.field(default_factory=list)
    # log-softmax of the raw (unscaled) logits at each OUTPUT token,
    # aligned 1:1 with `output`
    output_logprobs: List[Optional[float]] = dataclasses.field(default_factory=list)
    weights_version: Optional[int] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: Optional[str] = None
    finish_reason: Optional[str] = None  # "stop" | "length" | "cancelled"
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # streaming consumers: tokens pushed as generated, None terminates
    stream_q: Optional["queue.Queue"] = None
    cancelled: threading.Event = dataclasses.field(default_factory=threading.Event)
    # disaggregated serving: a prefill_only request prefills as usual but
    # never takes a decode slot; its prompt's KV leaves as a host blob
    # (export_kv_pages) or, with kv_sink, as frames, and it finishes with
    # finish_reason "prefill_done". It holds pages for its prompt only.
    prefill_only: bool = False
    _kv_export: Optional[Dict[str, Any]] = None
    # streamed export: frames go to this callable, on the engine's threads,
    # as prefill commits the KV (see _stream_kv_frames); it must not block
    # for long, and a sink that raises fails its request alone
    kv_sink: Optional[Callable[[Dict[str, Any]], None]] = None
    kv_window: int = 256  # tokens per streamed frame
    # "layer" (wire v2: each frame a slab of consecutive layers), "token"
    # (wire v1: every layer in each frame), "" for config.kv_frame_layout
    kv_frame_layout: str = ""

    def _emit(self, tok: Optional[int]) -> None:
        if self.stream_q is not None:
            self.stream_q.put(tok)


class _ChunkState:
    """One long prompt mid-chunked-prefill."""

    __slots__ = ("request", "pages", "table", "true_len", "next_chunk", "emitted_upto",
                 "sink_seq")

    def __init__(self, request: Request, pages: List[int], table, true_len: int):
        self.request = request
        self.pages = pages
        self.table = table  # np [pages_per_seq]
        self.true_len = true_len
        self.next_chunk = 0
        # streamed export: tokens already sent to kv_sink (page-aligned
        # until the final frame) and the next frame's seq
        self.emitted_upto = 0
        self.sink_seq = 0


class _Slot:
    __slots__ = ("request", "pages", "position", "generated")

    def __init__(self):
        self.request: Optional[Request] = None
        self.pages: List[int] = []
        self.position = 0  # next write position (== current length)
        self.generated = 0


class PrefixCache:
    """Content-addressed prompt pages. Page i of a prompt is keyed by the
    CHAIN hash of pages 0..i (its KV is a pure function of that prefix).
    Shared pages are refcounted; zero-ref pages sit in an LRU the allocator
    can reclaim. All calls run under the engine's _alloc_lock. Only FULL
    prompt pages are registered, and lookups stop below the last prompt
    token, so every sequence prefills >= 1 token and decode never writes
    into a shared page."""

    def __init__(self, page_size: int):
        self.ps = page_size
        self.by_hash: Dict[bytes, int] = {}
        self.by_page: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # zero-ref pages

    def page_hashes(self, prompt, n_pages: int) -> List[bytes]:
        """Chain hashes for the first n_pages full pages of `prompt`."""
        out, h = [], b""
        for i in range(n_pages):
            chunk = np.asarray(
                prompt[i * self.ps:(i + 1) * self.ps], np.int32).tobytes()
            h = hashlib.sha1(h + chunk).digest()
            out.append(h)
        return out

    def lookup_acquire(self, prompt, align_tokens: int,
                       hashes: Optional[List[bytes]] = None) -> List[int]:
        """Longest cached page run for `prompt`, refs bumped; capped below
        the last token and aligned down to `align_tokens`."""
        T = len(prompt)
        max_pages = (T - 1) // self.ps  # never the page holding token T-1
        align_pages = max(1, align_tokens // self.ps)
        if hashes is None:
            hashes = self.page_hashes(prompt, max_pages)
        hashes = hashes[:max_pages]
        n = 0
        for h in hashes:
            if self.by_hash.get(h) is None:
                break
            n += 1
        n = (n // align_pages) * align_pages
        pages = []
        for h in hashes[:n]:
            pid = self.by_hash[h]
            self.refs[pid] = self.refs.get(pid, 0) + 1
            self.lru.pop(pid, None)
            pages.append(pid)
        return pages

    def register(self, prompt, pages: List[int],
                 hashes: Optional[List[bytes]] = None) -> None:
        """Offer a prefilled request's full prompt pages to the cache; first
        writer wins per hash. Registered pages get one ref on behalf of this
        request (dropped via release_and_filter)."""
        n_pages = min(len(prompt) // self.ps, len(pages))
        if hashes is None:
            hashes = self.page_hashes(prompt, n_pages)
        for h, pid in zip(hashes[:n_pages], pages[:n_pages]):
            if pid in self.by_page:
                continue  # already cached (this request's shared prefix)
            if h in self.by_hash:
                continue  # another page already serves this prefix
            self.by_hash[h] = pid
            self.by_page[pid] = h
            self.refs[pid] = self.refs.get(pid, 0) + 1

    def release_and_filter(self, pages: List[int]) -> List[int]:
        """Drop one ref per cached page in `pages`; -> the pages the caller
        still owns (uncached ones) to return to the allocator."""
        mine = []
        for pid in pages:
            if pid in self.by_page:
                self.refs[pid] -= 1
                if self.refs[pid] <= 0:
                    del self.refs[pid]
                    self.lru[pid] = None
                    self.lru.move_to_end(pid)
            else:
                mine.append(pid)
        return mine

    def evict(self, n: int) -> List[int]:
        """Reclaim up to n zero-ref cached pages, LRU first."""
        out = []
        while self.lru and len(out) < n:
            pid, _ = self.lru.popitem(last=False)
            del self.by_hash[self.by_page.pop(pid)]
            out.append(pid)
        return out

    def stats(self) -> Dict[str, int]:
        return {"cached_pages": len(self.by_page),
                "reusable_pages": len(self.lru)}


class PageAllocator:
    """Free-list over page ids; page 0 is the reserved trash page that
    inactive decode slots write into."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, 0, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)

    @property
    def num_free(self) -> int:
        return len(self._free)


class InferenceEngine:
    def __init__(self, params, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 device=None, draft_params=None):
        """params: the model's parameter dict (models.init_params or
        params_from_numpy). device: the card unless the caller names
        another; with no card and no device this raises. draft_params: the
        parameters of a named speculation draft model (default: random
        from seed 0)."""
        t_build = time.monotonic()
        _require_flash(model_cfg)
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        B = engine_cfg.max_batch_size
        L, KVH, hd = model_cfg.n_layers, model_cfg.kv_heads, model_cfg.hdim
        P, ps = engine_cfg.max_pages, engine_cfg.page_size
        pool = dict(dtype=torch_dtype(engine_cfg.cache_dtype), device=self.device)
        self.k_pages = torch.zeros((L, KVH, P, ps, hd), **pool)
        self.v_pages = torch.zeros((L, KVH, P, ps, hd), **pool)
        # the device programs over this pool, with the per-layer parameter
        # views, the f32 head and the rope tables every program reuses
        self._model = PagedModel(self.params, model_cfg, ps, self.k_pages, self.v_pages)
        self.allocator = PageAllocator(P)
        self.prefix = (PrefixCache(ps)
                       if engine_cfg.prefix_caching and engine_cfg.chunked_prefill
                       else None)
        self.slots = [_Slot() for _ in range(B)]
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._step_count = 0
        self.weights_version = 0
        # fresh sampling stream per engine instance (a fixed seed would
        # replay identical temperature>0 outputs across restarts)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
        # first tokens are sampled on the host, from their own stream
        self._host_gen = torch.Generator()
        self._host_gen.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
        # the device programs the threads replay, by key ("decode",
        # n_steps, sample, advanced), ("chunk", C), ("prefill", bucket,
        # Bp), ("verify", S, sample, advanced), ("propose",),
        # ("draft_chunk", C); on the card, one graph memory pool for the
        # prefill thread's programs and one for the decode thread's
        # (_capture_programs says why)
        self._programs: Dict[tuple, CapturedProgram] = {}
        card = self.device.type == "cuda"
        self._graph_pool = torch.cuda.graph_pool_handle() if card else None
        self._prefill_pool = torch.cuda.graph_pool_handle() if card else None
        # what capture took: programs, seconds, and on the card the bytes
        # the captures added to the reserved memory (graph pools + static
        # buffers); the prefill_* keys give the prefill programs' share
        self.capture_stats: Dict[str, float] = {}
        # reentrant: warmup captures under it, and so does _ensure_loop,
        # holding it while it starts the threads
        self._lock = threading.RLock()
        # held by every program replay for its enqueue (input copies and
        # graph launch, not the readback) and by update_params' swap: a
        # program runs wholly on the weights before a swap or after it
        self._replay_lock = threading.Lock()
        # the last update_params: host seconds of staging, of the wait for
        # the replay lock and of the swap under it, and the bytes staged
        self.update_stats: Dict[str, float] = {}
        self._alloc_lock = threading.Lock()  # allocator: prefill + decode threads
        # prefilled, awaiting a decode slot (or, prefill_only, an export):
        # (request, pages, prompt length, staged KV); the staged KV is an
        # import's host (k, v) that the install scatters into the pages,
        # None where prefill wrote the pages
        self._ready: "list" = []
        self._ready_lock = threading.Lock()
        self._waiting: "list[Request]" = []  # admitted but no pages free yet
        self._loop_thread: Optional[threading.Thread] = None
        self._prefill_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # decode-thread wake signal: set whenever new work appears; the loop
        # clears-then-rechecks before waiting, so a wake is never lost
        self._work = threading.Event()
        self._prefill_inflight = 0  # prefill batches executing (GIL-atomic int)
        self._tps_committed = 0
        self._tps_steps = 0
        # SLO latency digests (util/slo.py). The serving layer stamps
        # slo_role after construction (LLMServer: its role), so the digest
        # handles resolve at first observation; the switch resolves here
        self.slo_role = "engine"
        self._slo_on = slo.enabled()
        self._slo: Dict[str, slo.Digest] = {}
        self._last_commit_t = 0.0
        # when the last decode span's replay was enqueued (decode thread):
        # the step's "verify" phase ends here and its "sample" begins
        self._span_enqueued = 0.0
        # long-prompt chunk states, consumed one chunk per step() by the
        # DECODE thread (chunks write the page pool the decode span writes)
        self._chunk_queue: "list[_ChunkState]" = []
        self._chunk_lock = threading.Lock()
        self._requests: Dict[str, Request] = {}  # live (uncompleted) ids
        self._req_lock = threading.Lock()
        # streamed KV imports staged between begin_kv_import and
        # finish_kv_import, by request id: {"req", "pages", "T", "k", "v"}
        self._importing: Dict[str, Dict[str, Any]] = {}
        self._import_lock = threading.Lock()
        scfg = engine_cfg.speculation
        self._spec: Optional[SpecDecoder] = None
        if scfg is not None and scfg.enabled:
            if draft_params is not None:
                draft_params = _to_device(draft_params, self.device)
            self._spec = SpecDecoder(self, scfg, draft_params=draft_params)
        self._init_s = time.monotonic() - t_build

    @property
    def build_s(self) -> float:
        """Seconds this engine took to build: its __init__ (weights onto the
        device, the page pool) and its captures so far (warmup)."""
        return self._init_s + float(self.capture_stats.get("seconds", 0.0))

    # ------------------------------------------------------------ programs

    def _tensor(self, array, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

    def _decode_step(self, toks, pos, tables, temps, top_ps, top_ks,
                     sample: bool, advanced: bool):
        """One token for every slot. toks/pos [B] int32 on the card; tables
        [B, pps] int32. Writes each slot's KV at `pos`, attends over its
        pages (kernel K5), samples on the card -> (tokens [B] int32, logprob
        of each token under the raw softmax [B] f32). Inactive slots all
        write page 0 slot 0, the trash page."""
        logits = self._model.logits(self._model.decode(toks, pos, tables))
        new = _device_sample(logits, temps, top_ps, top_ks, self._gen, sample, advanced)
        logps = torch.log_softmax(logits, dim=-1).gather(1, new.long()[:, None])[:, 0]
        return new, logps

    def _decode_span_body(self, toks, pos, tables, temps, top_ps, top_ks, *, n_steps: int,
                          sample: bool, advanced: bool):
        """The decode span program: n_steps decode steps, each feeding its
        sampled tokens to the next on the card -> (tokens, logprobs) [n, B]."""
        seq, logps = [], []
        for _ in range(n_steps):
            toks, lp = self._decode_step(toks, pos, tables, temps, top_ps, top_ks, sample,
                                         advanced)
            seq.append(toks)
            logps.append(lp)
            pos = pos + 1
        return torch.stack(seq), torch.stack(logps)

    def _decode_span(self, n_steps: int, tokens, positions, tables, temps, top_ps,
                     top_ks, advanced: bool):
        """n_steps decode steps: one replay of the captured span program
        for (n_steps, sample, advanced); host arrays in, (tokens, logprobs)
        [n, B] numpy out, one readback."""
        sample = bool(np.any(np.asarray(temps) > 0))
        (seq, logps), _ = self._replay(
            ("decode", n_steps, sample, advanced and sample),
            host_tensor(tokens, torch.int32), host_tensor(positions, torch.int32),
            host_tensor(tables, torch.int32), host_tensor(temps, torch.float32),
            host_tensor(top_ps, torch.float32), host_tensor(top_ks, torch.int32))
        self._span_enqueued = time.monotonic()
        # copies on either device: the outputs are the program's buffers
        seq, logps = read_back(seq, logps)
        return seq.numpy(), logps.numpy()

    def _program(self, key: tuple) -> CapturedProgram:
        program = self._programs.get(key)
        if program is None:
            raise RuntimeError(
                f"device program {key} was not captured: the engine captures every "
                "program its step loop can pick before its threads start, never later")
        return program

    def _replay(self, key: tuple, *args: torch.Tensor):
        """One replay of the program for `key` on `args` -> (its outputs,
        the weights_version it runs on). The enqueue holds the replay lock,
        as update_params' swap does, so the program runs wholly on the
        weights before a swap or wholly on those after it; the caller reads
        the outputs back after the lock is released."""
        program = self._program(key)
        with self._replay_lock:
            return program(*args), self.weights_version

    def _program_specs(self, spans):
        """(key, body, example inputs, generators) of every program the
        threads can pick: the decode span per length in `spans` and sampler
        mode, the speculation programs, the chunk (with chunked prefill) and
        the bucketed prefill per bucket and prefill tier. The example inputs
        (positions and chunk starts 0, all-zero page tables) write only the
        trash page."""
        B, pps = self.ecfg.max_batch_size, self.ecfg.pages_per_seq
        dev = self.device
        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        tables = torch.zeros((B, pps), dtype=torch.int32, device=dev)
        ones = torch.ones((B,), device=dev)
        for span in spans:
            for sample, advanced in SAMPLER_MODES:
                yield (("decode", span, sample, advanced),
                       functools.partial(self._decode_span_body, n_steps=span, sample=sample,
                                         advanced=advanced),
                       (zeros, zeros, tables, ones * float(sample), ones, zeros), (self._gen,))
        if self._spec is not None:
            yield from self._spec.program_specs()
        one = torch.zeros((1,), dtype=torch.int32, device=dev)
        if self.ecfg.chunked_prefill:
            C = self.ecfg.prefill_chunk
            yield (("chunk", C), self._chunk_body,
                   (torch.zeros((C,), dtype=torch.int32, device=dev), one, tables[0],
                    one + C - 1), ())
        for bucket in self.ecfg.prefill_buckets:
            for Bp in self.ecfg.prefill_tiers():
                yield (("prefill", bucket, Bp), self._prefill_body,
                       (torch.ones((Bp, bucket), dtype=torch.int32, device=dev),
                        torch.ones((Bp,), dtype=torch.int32, device=dev),
                        torch.zeros((Bp, pps), dtype=torch.int32, device=dev)), ())

    def _capture_programs(self, spans=None) -> None:
        """Capture every program the threads can pick that is not captured
        yet. spans: the decode span lengths (default: decode_span and, with
        the adaptive policy, busy_span). Raises while the engine's threads
        run: a capture beside the other thread's launches on the same
        stream would record them or fail.

        Two graph memory pools: the bucketed prefill programs, which the
        prefill thread replays, draw from one, and every program the decode
        thread replays (spans, chunk, verify, propose, draft chunk) from the
        other. A graph's scratch may hold the outputs of a program captured
        later into its pool, so a replay may overwrite them; in one pool
        shared by both threads, a prefill replay could land between a span's
        replay and its readback. With a pool per thread, sharing within a
        pool is safe because (1) every program's static inputs and outputs
        stay referenced for the engine's life, so no capture reuses them,
        (2) one thread replays a pool's programs, on one stream, so no two
        of them run at once, and (3) that thread consumes a program's
        outputs before it replays another program of the pool: spans,
        verify, chunks and prefills are read back at once, the draft
        chunk's only outputs are its KV writes, and the drafts a propose
        leaves for the next round are copied out (spec_decode.py)."""
        with self._lock:
            if spans is None:
                spans = {max(1, self.ecfg.decode_span)}
                if self.ecfg.adaptive_span:
                    spans.add(max(1, self.ecfg.busy_span))
            todo = [spec for spec in self._program_specs(sorted(spans))
                    if spec[0] not in self._programs]
            if not todo:
                return
            if any(t is not None and t.is_alive()
                   for t in (self._loop_thread, self._prefill_thread)):
                raise RuntimeError("device programs are captured before the engine's "
                                   "threads start, never while they run")
            # the decode thread's pool, then the prefill thread's, each
            # measured on its own: totals, and the prefill_* share
            stats = dict(self.capture_stats)
            for names, pool, specs in (
                    (("",), self._graph_pool, [t for t in todo if t[0][0] != "prefill"]),
                    (("", "prefill_"), self._prefill_pool,
                     [t for t in todo if t[0][0] == "prefill"])):
                n, seconds, nbytes = len(specs), *self._capture(specs, pool)
                for name in names:
                    for key, x in (("programs", n), ("seconds", seconds),
                                   ("pool_bytes", nbytes)):
                        if x is not None:
                            stats[name + key] = stats.get(name + key, 0) + x
            self.capture_stats = stats
            if self.device.type == "cuda":
                # each program's readback takes its pinned host blocks now,
                # which PyTorch's host allocator keeps: no request allocates one
                for key, *_ in todo:
                    outputs = self._programs[key].outputs
                    if outputs:
                        read_back(*outputs)

    def _capture(self, specs, pool):
        """Capture `specs` into `pool` -> (seconds, bytes the captures added
        to the reserved memory on the card, else None). The measure's
        device-wide synchronize and empty_cache run under the process's
        capture lock with the captures: beside another engine's capture
        (two replicas building at once) either would invalidate it, and
        fail here too (ROADMAP C17)."""
        card = self.device.type == "cuda"
        t0 = time.monotonic()
        with _CAPTURE_LOCK:
            if card:
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
            for key, body, inputs, generators in specs:
                self._programs[key] = CapturedProgram(body, inputs, pool=pool,
                                                      generators=generators)
            if not card:
                return time.monotonic() - t0, None
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            return time.monotonic() - t0, torch.cuda.memory_reserved(self.device) - reserved

    def _chunk_body(self, toks, start, table, last_idx):
        """The chunk program: one C-token prefill chunk of one sequence
        (PagedModel.chunk, kernel K6) -> (f32 logits [1, V] at chunk row
        last_idx,). toks [C], start / last_idx [1], table [pps] int32."""
        x = self._model.chunk(toks, start, table)
        return (self._model.logits(x.index_select(0, last_idx.long())),)

    def _chunk_step(self, tokens, start: int, table, last_idx: int):
        """One replay of the chunk program on host arrays: writes the
        chunk's KV into the sequence's pages -> (f32 logits [V] at chunk
        row last_idx, read back; the weights_version the chunk ran on).
        Decode thread only."""
        (logits,), version = self._replay(
            ("chunk", len(tokens)),
            host_tensor(tokens, torch.int32), host_tensor([start], torch.int32),
            host_tensor(table, torch.int32), host_tensor([last_idx], torch.int32))
        return read_back(logits)[0].numpy()[0], version

    def _prefill_body(self, toks, true_lens, tables):
        """The bucketed prefill program (PagedModel.prefill, kernel K2)."""
        return (self._model.prefill(toks, true_lens, tables),)

    def _prefill(self, tokens: np.ndarray, true_lens: np.ndarray,
                 tables: np.ndarray):
        """Bucketed prefill of a padded batch: one replay of the program for
        (bucket, Bp) on host arrays tokens [Bp, bucket], true_lens [Bp],
        tables [Bp, pps]. Writes each row's KV into its pages -> (f32
        logits [Bp, V] at each row's last prompt token, read back; the
        weights_version the prefill ran on). Prefill thread."""
        Bp, bucket = tokens.shape
        (logits,), version = self._replay(
            ("prefill", bucket, Bp), host_tensor(tokens, torch.int32),
            host_tensor(true_lens, torch.int32), host_tensor(tables, torch.int32))
        return read_back(logits)[0].numpy(), version

    def warmup(self, buckets=None, batch_sizes=None) -> None:
        """Capture every program the threads can pick (`_capture_programs`)
        off the request path, which also builds the kernels: the decode
        spans the adaptive policy can pick in every sampler mode, the chunk,
        the bucketed prefill per (bucket, prefill tier), and with
        speculation the verify widths, the draft propose and the draft's
        chunk. buckets / batch_sizes keep the reference's signature, where
        they pick the prefill shapes to compile; the port captures the
        configured set regardless, since a program that was not captured
        raises where the reference would compile it. Example inputs write
        only the trash page. Call before admitting traffic; an engine that
        was not warmed up captures at its first request, before its threads
        start."""
        self._capture_programs()

    # ------------------------------------------------ KV export and import

    def _gather_kv(self, pages: List[int], t: int):
        """The KV of the first t tokens that `pages` hold, in order -> host
        float32 numpy (k, v), each [L, t, KVH, hd]: one gather on the card
        (eager, between graph replays; on the stream after the prefill
        that wrote the pages) and one copy to the host in the pool's dtype.
        A bf16 pool widens to float32 on the host, exactly (numpy has no
        bf16), so the copy moves half the bytes of a float32 one."""
        k, v = _gather_pages(self.k_pages, self.v_pages, pages[:-(-t // self.ecfg.page_size)])
        return k[:, :t].cpu().float().numpy(), v[:, :t].cpu().float().numpy()

    def _export_blob(self, req: Request, pages: List[int], T: int) -> Dict[str, Any]:
        """A prefill_only request's KV as a token-contiguous host blob
        [L, T, KVH, hd], gathered from its pages (decode thread, between
        replays: the port keeps no row cache, its bucketed prefill writes
        the pages straight away)."""
        k, v = self._gather_kv(pages, T)
        return {
            "k": k,
            "v": v,
            "true_len": T,
            "first_token": int(req.output[-1]),
            "first_logprob": req.output_logprobs[-1] if req.output_logprobs else None,
            "layers": int(k.shape[0]),
            "kv_heads": int(k.shape[2]),
            "head_dim": int(k.shape[3]),
            "dtype": str(k.dtype),
        }

    def export_kv_pages(self, req: Request, timeout_s: float = 600.0) -> Dict[str, Any]:
        """Block until a prefill_only request finishes and return its KV
        blob (_export_blob). The blob is engine-agnostic: it imports into a
        pool of another page_size or max_pages, in this package or the
        reference's."""
        if not req.done.wait(timeout_s):
            self.cancel(req.request_id)
            raise TimeoutError(f"request {req.request_id} timed out")
        if req.error:
            raise ValueError(req.error)
        blob, req._kv_export = req._kv_export, None
        if blob is None:
            raise ValueError(
                f"request {req.request_id} has no KV export (prefill_only="
                f"{req.prefill_only}, finish_reason={req.finish_reason!r})")
        return blob

    def _kv_layout(self, req: Request) -> str:
        """A request's streamed-frame layout: its own, else the
        config.kv_frame_layout knob; anything unknown is "layer" (wire v2)."""
        lay = req.kv_frame_layout or str(config.kv_frame_layout)
        return lay if lay in ("layer", "token") else "layer"

    def _stream_kv_frames(self, req: Request, k, v, start: int, *, true_len: int, last: bool,
                          seq0: int = 0, layer0: int = 0,
                          n_layers: Optional[int] = None) -> int:
        """Push host KV k / v ([Ln, t, KVH, hd], prompt tokens [start,
        start + t)) to req.kv_sink in kv_window-token frames -> the next
        frame's seq. A frame is

          {"request_id", "seq", "start", "k", "v", "last"}

        with the blob's metadata (true_len, layers, kv_heads, head_dim,
        dtype) on seq 0, all that begin_kv_import needs, and "first_token"
        and "first_logprob" on the last frame, for finish_kv_import.

        Wire v1 (token-major): each frame carries every layer for its token
        range. Wire v2 (layer-major): k / v are a slab of Ln consecutive
        layers from `layer0`; each frame gains "layer0", and seq 0 carries
        "kv_wire": 2 ("layers" stays the model's total). `last` is set only
        on the final window of the final slab of the stream. A sink that
        raises propagates to the caller, which fails the request."""
        t0 = time.monotonic()
        win = max(int(req.kv_window), self.ecfg.page_size)
        L_total = int(n_layers) if n_layers is not None else int(k.shape[0])
        layered = layer0 > 0 or int(k.shape[0]) != L_total
        t = k.shape[1]
        seq, off = seq0, 0
        while True:
            end = min(off + win, t)
            frame = {"request_id": req.request_id, "seq": seq, "start": start + off,
                     "k": k[:, off:end], "v": v[:, off:end], "last": False}
            if layered:
                frame["layer0"] = int(layer0)
            if seq == 0:
                frame.update(true_len=int(true_len), layers=L_total, kv_heads=int(k.shape[2]),
                             head_dim=int(k.shape[3]), dtype=str(k.dtype))
                if layered:
                    frame["kv_wire"] = 2
            tail = end >= t
            if tail and last:
                frame.update(last=True, true_len=int(true_len), first_token=int(req.output[-1]),
                             first_logprob=(req.output_logprobs[-1] if req.output_logprobs
                                            else None))
            req.kv_sink(frame)
            seq += 1
            off = end
            if tail:
                _m_step_phase.observe(time.monotonic() - t0,
                                      tags={"phase": "kv_framing", "mode": "export"})
                return seq

    def _stream_kv(self, req: Request, k, v, start: int, true_len: int, last: bool,
                   seq0: int = 0) -> int:
        """Frames of host KV k / v [L, t, KVH, hd] (tokens [start, start +
        t)) in the request's layout: one slab per layer group
        (_kv_layer_groups), or every layer at once -> the next seq."""
        if self._kv_layout(req) != "layer":
            return self._stream_kv_frames(req, k, v, start, true_len=true_len, last=last,
                                          seq0=seq0)
        L = int(k.shape[0])
        groups = _kv_layer_groups(L)
        seq = seq0
        for gi, (l0, l1) in enumerate(groups):
            seq = self._stream_kv_frames(req, k[l0:l1], v[l0:l1], start, true_len=true_len,
                                         last=last and gi == len(groups) - 1, seq0=seq,
                                         layer0=l0, n_layers=L)
        return seq

    def _stream_group_kv(self, group: List[tuple], streamed: List[int]) -> None:
        """Streamed-export leg of a bucketed prefill group (prefill thread,
        after the group's replay wrote the rows' KV into their pages; the
        gathers follow it on the stream, and wait behind any decode span
        issued before them). Per streamed row: one gather and host copy,
        then its frames; its pages free and it finishes "prefill_done". A
        failure fails that row alone."""
        for i in streamed:
            req, pages, T = group[i][:3]
            try:
                k, v = self._gather_kv(pages, T)
                self._stream_kv(req, k, v, 0, T, last=True)
            except Exception as e:  # noqa: BLE001 — fail this request only
                logger.warning("kv stream failed for %s", req.request_id, exc_info=True)
                self._free_pages_and_revive(pages)
                self._fail_request(req, f"kv stream failed: {e!r}")
                continue
            self._free_pages_and_revive(pages)
            self._finish_request(req, "prefill_done")

    def _stream_chunk_frames(self, st: _ChunkState, upto: int, last: bool) -> None:
        """Chunked-prefill streamed export (decode thread, after the chunk's
        replay): send the KV committed since the last frame, gathered from
        the pages (a prefix-cache hit's shared pages included). Non-final
        frames stop at a page boundary, so migration overlaps the remaining
        chunks instead of waiting for the first token."""
        ps = self.ecfg.page_size
        if not last:
            upto = (upto // ps) * ps
        if upto <= st.emitted_upto:
            return
        p0 = st.emitted_upto // ps  # page-aligned until the final frame
        k, v = self._gather_kv(st.pages[p0:], upto - p0 * ps)
        st.sink_seq = self._stream_kv(st.request, k, v, st.emitted_upto, st.true_len, last,
                                      st.sink_seq)
        st.emitted_upto = upto

    def begin_kv_import(self, req: Request, true_len: int, meta: Dict[str, Any],
                        timeout_s: float = 60.0) -> bool:
        """Start a streamed KV import: check the request and the frame-0
        header `meta` (layers, kv_heads, head_dim; a wire version above 2 is
        refused) against this model and engine, take pages for prompt +
        max_tokens (waiting at most timeout_s for them), and stage a host
        buffer in the pool's dtype that ingest_kv_chunk fills. Returns
        False if the request failed instead (req.error and done set, as
        import_kv_pages fails). The staged KV reaches the card only at
        install, on the decode thread."""
        try:
            req.stop = _normalize_stops(req.stop)
            self._check_prompt(req.prompt)
        except ValueError as e:
            self._finish_request(req, error=str(e))
            return False
        try:
            T = int(true_len)
            Lb, KVHb, hdb = int(meta["layers"]), int(meta["kv_heads"]), int(meta["head_dim"])
        except (KeyError, TypeError, ValueError) as e:
            self._finish_request(req, error=f"malformed kv blob: {e!r}")
            return False
        # v1 token-major frames carry no marker, v2 adds layer-major slabs;
        # anything newer is refused rather than staged wrongly
        wire = int(meta.get("kv_wire", 1))
        if wire > 2:
            self._finish_request(req, error=(
                f"unsupported kv wire format v{wire} (this engine speaks <= v2)"))
            return False
        L, KVH, hd = self.cfg.n_layers, self.cfg.kv_heads, self.cfg.hdim
        if (Lb, KVHb, hdb) != (L, KVH, hd):
            self._finish_request(req, error=(
                f"kv blob shape {(Lb, T, KVHb, hdb)} does not match model "
                f"[layers={L}, true_len={T}, kv_heads={KVH}, head_dim={hd}]"))
            return False
        if len(req.prompt) != T:
            self._finish_request(req, error=(
                f"kv blob covers {T} tokens but the prompt has {len(req.prompt)}"))
            return False
        total = T + req.max_tokens
        if total > self.ecfg.max_seq_len:
            self._finish_request(req, error=(
                f"prompt+max_tokens {T}+{req.max_tokens} exceeds "
                f"max_seq_len {self.ecfg.max_seq_len}"))
            return False
        ps = self.ecfg.page_size
        n_pages = -(-total // ps)
        if n_pages > self.ecfg.max_pages - 1:
            self._finish_request(req, error=(
                f"request needs {n_pages} pages but the pool only has "
                f"{self.ecfg.max_pages - 1}; raise EngineConfig.max_pages"))
            return False
        if self.prefix is not None:
            req._page_hashes = self.prefix.page_hashes(req.prompt, T // ps)
        with self._req_lock:
            self._requests[req.request_id] = req
        # pages inline, with a bounded wait, not parked in _waiting: a
        # revival re-queues to the prefill thread, which would prefill
        # the prompt again
        deadline = time.monotonic() + timeout_s
        while True:
            with self._alloc_lock:
                if req.cancelled.is_set():
                    pages = None
                    break
                pages = self._alloc_with_reclaim(n_pages)
            if pages is not None:
                break
            if time.monotonic() >= deadline:
                self._finish_request(req, error=(
                    f"no pages free for KV import within {timeout_s}s"))
                return False
            time.sleep(0.005)
        if pages is None:
            self._finish_request(req, "cancelled")
            return False
        Tpad = -(-T // ps) * ps
        staged = dict(req=req, pages=pages, T=T,
                      k=torch.zeros((L, Tpad, KVH, hd), dtype=self.k_pages.dtype),
                      v=torch.zeros((L, Tpad, KVH, hd), dtype=self.v_pages.dtype))
        with self._import_lock:
            # _fail_all may have failed the request during the page wait;
            # it finishes requests before it sweeps the staged imports, so
            # a request that is not done here is swept if it fails later
            done = req.done.is_set()
            if not done:
                self._importing[req.request_id] = staged
        if done:
            self._free_pages_and_revive(pages)
            return False
        return True

    def _staged_import(self, req: Request, pop: bool = False) -> Optional[Dict[str, Any]]:
        """The request's staged import (taken out of the registry with
        `pop`), or None where there is none: never begun, or already
        finished, aborted, cancelled or failed."""
        with self._import_lock:
            st = self._importing.get(req.request_id)
            if st is None or st["req"] is not req:
                return None
            if pop:
                del self._importing[req.request_id]
            return st

    def ingest_kv_chunk(self, req: Request, frame: Dict[str, Any]) -> None:
        """Copy one streamed frame into the staging buffer (any order;
        writing a frame twice is harmless). Token-major (v1) frames cover
        every layer; layer-major (v2) frames a slab at frame["layer0"] (a
        missing key is v1's layer0 = 0). Any float array is taken through
        float32, an ml_dtypes bfloat16 one too, and cast to the pool's
        dtype. Raises ValueError on a malformed frame (the caller aborts
        the import) or where no import is staged."""
        st = self._staged_import(req)
        if st is None:
            raise ValueError(f"request {req.request_id} has no staged kv import")
        s, l0 = int(frame["start"]), int(frame.get("layer0", 0))
        k = np.array(frame["k"], dtype=np.float32)
        v = np.array(frame["v"], dtype=np.float32)
        ln, t = int(k.shape[0]), int(k.shape[1])
        Ls, Tpad = st["k"].shape[:2]
        if s < 0 or s + t > Tpad:
            raise ValueError(f"kv frame [{s}:{s + t}) outside the staged {Tpad} tokens")
        if l0 < 0 or l0 + ln > Ls:
            raise ValueError(f"kv frame layers [{l0}:{l0 + ln}) outside the staged {Ls} layers")
        if k.shape[2:] != tuple(st["k"].shape[2:]) or v.shape != k.shape:
            raise ValueError(f"kv frame k {k.shape} / v {v.shape} do not match the staged "
                             f"[kv_heads, head_dim] {tuple(st['k'].shape[2:])}")
        st["k"][l0:l0 + ln, s:s + t] = torch.from_numpy(k)
        st["v"][l0:l0 + ln, s:s + t] = torch.from_numpy(v)

    def finish_kv_import(self, req: Request, first_token: int,
                         first_logprob: Optional[float] = None) -> Request:
        """Finish a streamed import: seed the first token (sampled on the
        exporting engine; its logprob rides the last frame) as a prefill
        would, and publish the request with its staged KV to the decode
        thread, whose install scatters the KV into the pages before the
        slot goes live. A request whose import was cancelled or failed
        meanwhile is returned as it is."""
        st = self._staged_import(req, pop=True)
        if st is None:
            return req
        if req.done.is_set() or req.cancelled.is_set():  # failed or cancelled meanwhile
            self._free_pages_and_revive(st["pages"])
            self._finish_request(req, "cancelled")
            return req
        if not req.output:
            # sampled, and its TTFT observed, on the exporting engine
            self._commit_first(req, int(first_token),
                               float(first_logprob) if first_logprob is not None else None,
                               time.monotonic(), self.weights_version)
        with self._ready_lock:
            self._ready.append((req, st["pages"], st["T"], (st["k"], st["v"])))
        self._work.set()
        self._ensure_loop()
        return req

    def abort_kv_import(self, req: Request, error: Optional[str] = None) -> None:
        """Tear down a partial import (the stream died, or the caller gave
        up): free the staged pages and finish the request, with `error` or
        as cancelled."""
        st = self._staged_import(req, pop=True)
        if st is not None:
            self._free_pages_and_revive(st["pages"])
        if error is not None:
            self._fail_request(req, error)
        else:
            self._finish_request(req, "cancelled")

    def import_kv_pages(self, req: Request, blob: Dict[str, Any],
                        timeout_s: float = 60.0) -> Request:
        """Admit `req` straight into decode from an exported KV blob (its
        prefill ran on another engine, of this package or the reference's).
        The blob is re-paginated for this engine's page_size; the request
        then behaves as if prefilled here (stops, stream hold-back, prefix
        registration and speculation all apply). The one-shot form of
        begin / ingest / finish_kv_import. Failures land on the request
        (req.error and done set), as add_request's do."""
        try:
            k, v = blob["k"], blob["v"]
            T = int(blob["true_len"])
            first = int(blob["first_token"])
        except (KeyError, TypeError, ValueError) as e:
            self._finish_request(req, error=f"malformed kv blob: {e!r}")
            return req
        L, KVH, hd = self.cfg.n_layers, self.cfg.kv_heads, self.cfg.hdim
        if tuple(np.shape(k)) != (L, T, KVH, hd) or tuple(np.shape(v)) != tuple(np.shape(k)):
            self._finish_request(req, error=(
                f"kv blob shape {tuple(np.shape(k))} does not match model "
                f"[layers={L}, true_len={T}, kv_heads={KVH}, head_dim={hd}]"))
            return req
        meta = {"layers": L, "kv_heads": KVH, "head_dim": hd}
        if not self.begin_kv_import(req, T, meta, timeout_s=timeout_s):
            return req
        try:
            self.ingest_kv_chunk(req, {"start": 0, "k": k, "v": v})
        except Exception as e:  # noqa: BLE001 — fail just this request
            self.abort_kv_import(req, f"kv ingest failed: {e!r}")
            return req
        return self.finish_kv_import(req, first, first_logprob=blob.get("first_logprob"))

    # ------------------------------------------------------------ requests

    def _check_prompt(self, prompt) -> None:
        """Raise ValueError for a token id outside [0, vocab_size),
        negative ids included. A deliberate difference: the reference
        clamps such an id (JAX's gather) and serves the request from row
        V-1, and wraps a negative one; here the embedding's index would
        fail the request's whole prefill batch, and on the card end the
        process's CUDA context, so the request fails alone."""
        V = self.cfg.vocab_size
        bad = next((t for t in prompt if not 0 <= t < V), None)
        if bad is not None:
            raise ValueError(f"prompt token id {bad} is outside the vocabulary [0, {V})")

    def add_request(self, req: Request) -> None:
        try:
            req.stop = _normalize_stops(req.stop)
            self._check_prompt(req.prompt)
        except ValueError as e:
            self._finish_request(req, error=str(e))
            return
        # a prefill_only request never decodes here: it holds pages for its
        # prompt only, so capacity leaves max_tokens out
        total = len(req.prompt) + (0 if req.prefill_only else req.max_tokens)
        if total > self.ecfg.max_seq_len:
            self._finish_request(req, error=(
                f"prompt+max_tokens {len(req.prompt)}+{req.max_tokens} exceeds "
                f"max_seq_len {self.ecfg.max_seq_len}"))
            return
        # reject at admission anything the pool can never satisfy (page 0 is
        # the trash page) — otherwise admission would re-queue it forever
        n_pages = -(-total // self.ecfg.page_size)
        if n_pages > self.ecfg.max_pages - 1:
            self._finish_request(req, error=(
                f"request needs {n_pages} pages but the pool only has "
                f"{self.ecfg.max_pages - 1}; raise EngineConfig.max_pages"))
            return
        with self._req_lock:
            self._requests[req.request_id] = req
        self.pending.put(req)
        self._ensure_loop()

    def cancel(self, request_id: str) -> bool:
        """Cancel a live request: wherever it is (pending, parked for pages,
        mid-chunked-prefill, awaiting install, decoding) it finishes with
        finish_reason="cancelled" at its next scheduling point and its pages
        free. Returns False for unknown/finished ids."""
        with self._req_lock:
            req = self._requests.get(request_id)
        if req is None or req.done.is_set():
            return False
        req.cancelled.set()
        # chunk states and active slots belong to the DECODE thread (it
        # checks the flag at every chunk/step boundary); only the stations
        # no thread is driving are swept here
        with self._ready_lock:
            for item in list(self._ready):
                if item[0] is req:
                    self._ready.remove(item)
                    self._free_pages_and_revive(item[1])
                    self._finish_request(req, "cancelled")
        with self._alloc_lock:
            parked = req in self._waiting
            if parked:
                self._waiting.remove(req)
        if parked:
            self._finish_request(req, "cancelled")
        st = self._staged_import(req, pop=True)  # a streamed import not yet finished
        if st is not None:
            self._free_pages_and_revive(st["pages"])
            self._finish_request(req, "cancelled")
        self._work.set()  # decode thread sweeps chunks/slots promptly
        return True

    def _finish_request(self, req: Request, reason: Optional[str] = None,
                        error: Optional[str] = None) -> None:
        """The one request-completion path (finish/fail/cancel): stamp,
        count, unregister, signal, terminate the stream."""
        if req.done.is_set():
            return
        if error is not None:
            req.error = error
        else:
            req.finish_reason = reason
            _m_requests.inc(tags={"finish_reason": reason})
        req.finished_at = time.monotonic()
        if self._slo_on and error is None and reason != "cancelled":
            self._slo_digest("serve_e2e_seconds").add(req.finished_at - req.submitted_at)
        with self._req_lock:
            self._requests.pop(req.request_id, None)
        for tok in req._held:  # flush the stream hold-back (post-strip)
            req._emit(tok)
        req._held.clear()
        req.done.set()
        req._emit(None)

    def _ensure_loop(self):
        with self._lock:
            if not all(t is not None and t.is_alive()
                       for t in (self._loop_thread, self._prefill_thread)):
                # capture first: no program is captured once the threads run
                self._capture_programs()
            if self._loop_thread is None or not self._loop_thread.is_alive():
                self._stop.clear()
                self._loop_thread = threading.Thread(
                    target=self._loop, daemon=True, name="engine-decode")
                self._loop_thread.start()
            if self._prefill_thread is None or not self._prefill_thread.is_alive():
                self._prefill_thread = threading.Thread(
                    target=self._prefill_loop, daemon=True, name="engine-prefill")
                self._prefill_thread.start()

    def _active(self) -> List[_Slot]:
        return [s for s in self.slots if s.request is not None]

    def _has_work(self) -> bool:
        with self._ready_lock:
            if self._ready:
                return True
        with self._chunk_lock:
            if self._chunk_queue:
                return True
        return any(s.request is not None for s in self.slots)

    def _loop(self):
        """Decode thread. Runs until stop(); when idle it blocks on the
        _work event (clear -> recheck -> wait). A device program that raises
        fails every live request instead of leaving them to time out."""
        while not self._stop.is_set():
            try:
                progressed = self.step()
            except Exception as e:  # noqa: BLE001 — report, then stop serving
                logger.exception("engine step failed")
                self._fail_all(f"engine step failed: {e!r}")
                return
            if progressed:
                continue
            self._work.clear()
            if self._has_work() or self._stop.is_set():
                continue
            self._work.wait(timeout=0.5)

    def _fail_all(self, msg: str) -> None:
        """After a step exception: stop both threads, fail every live
        request with `msg`, and leave nothing behind. The chunk queue, the
        prefills awaiting install, the parked and pending requests, the
        slots and the staged imports are emptied and all their pages
        freed, so a later request restarts the threads on a clean engine.
        (A prefill that the prefill thread publishes after this point finds
        its request done, and install or admission frees its pages.)"""
        self._stop.set()
        with self._chunk_lock:
            chunks, self._chunk_queue = self._chunk_queue, []
        with self._ready_lock:
            ready, self._ready = self._ready, []
        with self._alloc_lock:
            self._waiting = []
        held = [st.pages for st in chunks] + [item[1] for item in ready]
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                held.append(slot.pages)
                if self._spec is not None:
                    self._spec.on_evict(i)
            slot.request, slot.pages, slot.position, slot.generated = None, [], 0, 0
        for pages in held:
            self._free_pages_and_revive(pages)
        while True:
            try:
                self.pending.get_nowait()
            except queue.Empty:
                break
        with self._req_lock:
            live = list(self._requests.values())
        for req in live:
            self._finish_request(req, error=msg)
        # staged imports last: a begin_kv_import that stages after this
        # sweep finds its request done and frees the pages itself
        with self._import_lock:
            staged, self._importing = self._importing, {}
        for st in staged.values():
            self._free_pages_and_revive(st["pages"])

    def _fail_request(self, req: Request, msg: str) -> None:
        self._finish_request(req, error=msg)

    # ------------------------------------------------------------- prefill

    def _prefill_loop(self):
        """Prefill thread. Runs until stop(); queued prompts coalesce into
        padded batches up to the largest tier."""
        while not self._stop.is_set():
            try:
                req = self.pending.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [req]
            drain_cap = self.ecfg.prefill_tiers()[-1]
            while len(batch) < drain_cap:
                try:
                    batch.append(self.pending.get_nowait())
                except queue.Empty:
                    break
            # _prefill_batch settles every request's outcome itself
            self._prefill_inflight += 1
            try:
                self._prefill_batch(batch)
            finally:
                self._prefill_inflight -= 1

    def _free_pages_and_revive(self, pages: List[int]) -> None:
        """Free pages AND re-queue page-starved parked requests. Cached
        pages only drop a ref (the prefix cache owns them)."""
        with self._alloc_lock:
            if self.prefix is not None:
                pages = self.prefix.release_and_filter(pages)
            self.allocator.free(pages)
            waiting, self._waiting = self._waiting, []
        for w in waiting:
            self.pending.put(w)

    def _alloc_with_reclaim(self, n: int) -> Optional[List[int]]:
        """allocator.alloc, reclaiming zero-ref cached pages on a miss.
        Caller holds _alloc_lock."""
        pages = self.allocator.alloc(n)
        if pages is None and self.prefix is not None:
            reclaimed = self.prefix.evict(n - self.allocator.num_free)
            if reclaimed:
                self.allocator.free(reclaimed)
                pages = self.allocator.alloc(n)
        return pages

    def _admit_for_prefill(self, req: Request):
        """-> (pages, T, bucket, cached_len); bucket None = chunked path,
        cached_len = tokens served by the prefix cache (chunk-aligned).
        Or None (deferred to _waiting / errored)."""
        T = len(req.prompt)
        n_pages = -(-(T + (0 if req.prefill_only else req.max_tokens)) // self.ecfg.page_size)
        C = self.ecfg.prefill_chunk
        hashes: List[bytes] = []
        if self.prefix is not None:
            # hash OUTSIDE the lock; install-time register() reuses it
            hashes = self.prefix.page_hashes(req.prompt, T // self.ecfg.page_size)
            req._page_hashes = hashes
        with self._alloc_lock:
            shared: List[int] = []
            if self.prefix is not None:
                shared = self.prefix.lookup_acquire(req.prompt, C, hashes=hashes)
            pages = self._alloc_with_reclaim(n_pages - len(shared))
            if pages is None:
                if shared:  # drop the refs just taken
                    self.prefix.release_and_filter(shared)
                # cancelled while admitting? park nothing (cancel()'s sweep
                # takes this same lock, so one of us sees the other)
                if not req.cancelled.is_set():
                    self._waiting.append(req)  # revived on page frees
                    return None
                cancelled = True
            else:
                cancelled = False
                pages = shared + pages
        if cancelled:
            self._finish_request(req, "cancelled")
            return None
        cached_len = len(shared) * self.ecfg.page_size
        if cached_len:
            _m_prefix_hit_tokens.inc(cached_len)
        if shared or (self.ecfg.chunked_prefill and T > C):
            # long prompt (or cached prefix): chunk on the decode thread
            return pages, T, None, cached_len
        bucket = next((b for b in self.ecfg.prefill_buckets if b >= T),
                      self.ecfg.prefill_buckets[-1])
        if T > bucket:
            self._free_pages_and_revive(pages)
            self._finish_request(req, error=(
                f"prompt length {T} exceeds largest bucket {bucket} "
                "(enable chunked_prefill to serve longer prompts)"))
            return None
        return pages, T, bucket, 0

    def _prefill_batch(self, reqs: List[Request]) -> None:
        """Admit + prefill a drained batch. Never raises: each request ends
        deferred (_waiting), published (_ready / chunk queue), or failed
        (error set, pages freed) — independently of its batch-mates."""
        admitted: List[tuple] = []
        for req in reqs:
            # cancelled while queued, or failed by _fail_all
            if req.cancelled.is_set() or req.done.is_set():
                self._finish_request(req, "cancelled")
                continue
            try:
                out = self._admit_for_prefill(req)
            except Exception as e:  # noqa: BLE001 — fail just this request
                logger.warning("admission failed for %s", req.request_id, exc_info=True)
                self._finish_request(req, error=f"prefill admission failed: {e!r}")
                continue
            if out is not None:
                admitted.append((req, *out))
        chunked = [it for it in admitted if it[3] is None]
        admitted = [it for it in admitted if it[3] is not None]
        if chunked:
            pps, C = self.ecfg.pages_per_seq, self.ecfg.prefill_chunk
            with self._chunk_lock:
                for req, pages, T, _b, cached_len in chunked:
                    table = np.zeros((pps,), np.int32)
                    table[: len(pages)] = pages
                    st = _ChunkState(req, pages, table, T)
                    st.next_chunk = cached_len // C  # resume past the hits
                    self._chunk_queue.append(st)
            self._work.set()  # the decode thread runs the chunks
        by_bucket: Dict[int, List[tuple]] = {}
        for item in admitted:
            by_bucket.setdefault(item[3], []).append(item)
        tiers = self.ecfg.prefill_tiers()
        for bucket, group in sorted(by_bucket.items()):
            try:
                self._prefill_group(bucket, group, tiers)
            except Exception as e:  # noqa: BLE001 — fail this group only
                logger.warning("prefill failed for bucket %d", bucket, exc_info=True)
                for req, pages, _T, _b, _cl in group:
                    self._free_pages_and_revive(pages)
                    if not req.done.is_set():
                        self._finish_request(req, error=f"prefill failed: {e!r}")

    def _prefill_group(self, bucket: int, group: List[tuple], tiers: List[int]) -> None:
        B = len(group)
        # smallest tier covering the group; oversize groups split
        Bpad = next((t for t in tiers if t >= B), tiers[-1])
        if B > Bpad:
            self._prefill_group(bucket, group[:Bpad], tiers)
            self._prefill_group(bucket, group[Bpad:], tiers)
            return
        padded = np.zeros((Bpad, bucket), np.int32)
        lens = np.ones((Bpad,), np.int32)  # dummy rows: true_len 1
        tables = np.zeros((Bpad, self.ecfg.pages_per_seq), np.int32)  # dummy rows: trash
        for i, (req, pages, T, _b, _cl) in enumerate(group):
            padded[i, :T] = req.prompt
            lens[i] = T
            tables[i, :len(pages)] = pages
        # the program writes each row's KV into its pages; the rows' first
        # tokens are stamped with the weights it ran on
        logits_host, version = self._prefill(padded, lens, tables)
        # sample every row BEFORE publishing anything: if this raises, the
        # caller can still free every page (nothing is in _ready yet)
        firsts = [_sample_host(logits_host[i], req.temperature, req.top_p, req.top_k,
                               self._host_gen)
                  for i, (req, _p, _T, _b, _cl) in enumerate(group)]
        first_lps = [_host_logprob(logits_host[i], firsts[i]) for i in range(B)]
        now = time.monotonic()
        # streamed exports leave from here, and never wait in _ready
        streamed = [i for i, it in enumerate(group)
                    if it[0].prefill_only and it[0].kv_sink is not None]
        with self._ready_lock:
            for i, (req, pages, T, _b, _cl) in enumerate(group):
                self._observe_first(req, now)
                self._commit_first(req, firsts[i], first_lps[i], now, version)
                if i not in streamed:
                    self._ready.append((req, pages, T, None))
        self._work.set()  # revive the decode thread if it is idle-waiting
        if streamed:
            self._stream_group_kv(group, streamed)

    def _observe_first(self, req: Request, now: float) -> None:
        """Count a first token sampled here, and its time to first token."""
        _m_ttft.observe(now - req.submitted_at)
        if self._slo_on:
            self._slo_digest("serve_ttft_seconds").add(now - req.submitted_at)
        _m_tokens.inc()

    def _commit_first(self, req: Request, first: int, logprob: float, now: float,
                      version: int) -> None:
        """Seed the request's output with its first token; `version`: the
        weights_version of the program that computed it."""
        req.first_token_at = now
        req.output.append(int(first))
        req.output_logprobs.append(logprob)
        req.weights_version = version
        eos = self.ecfg.eos_token_id
        if eos is not None and int(first) == eos:
            pass  # eos is control
        elif req.stop:
            req._held.append(int(first))  # hold-back from token 1
        else:
            req._emit(int(first))

    def _install_ready(self) -> bool:
        """Decode thread: move finished prefills into free decode slots.
        Their KV is in their pages, except an import's, which is scattered
        into them here, in place, before the slot goes live. A prefill_only
        request takes no slot, so it is served even while every slot is
        busy: its KV is exported to a host blob and its pages freed."""
        installed = False
        while True:
            free_slots = [s for s in self.slots if s.request is None]
            with self._ready_lock:
                if not self._ready:
                    return installed
                if free_slots:
                    idx = 0
                else:
                    idx = next((j for j, it in enumerate(self._ready) if it[0].prefill_only),
                               None)
                    if idx is None:
                        return installed
                req, pages, T, staged = self._ready.pop(idx)
            # cancelled between prefill and install, or failed by _fail_all
            if req.cancelled.is_set() or req.done.is_set():
                self._free_pages_and_revive(pages)
                self._finish_request(req, "cancelled")
                installed = True
                continue
            if req.prefill_only:
                try:
                    blob = self._export_blob(req, pages, T)
                except Exception as e:  # noqa: BLE001 — fail this request only
                    logger.warning("kv export failed for %s", req.request_id, exc_info=True)
                    self._free_pages_and_revive(pages)
                    self._fail_request(req, f"kv export failed: {e!r}")
                    installed = True
                    continue
                if self.prefix is not None:
                    # a prefill engine still gains from prefix hits
                    with self._alloc_lock:
                        self.prefix.register(req.prompt, pages, hashes=req._page_hashes)
                req._kv_export = blob
                self._free_pages_and_revive(pages)
                self._finish_request(req, "prefill_done")
                installed = True
                continue
            if staged is not None:
                _scatter_pages(self.k_pages, self.v_pages, staged[0], staged[1],
                               pages[:-(-T // self.ecfg.page_size)])
            if self.prefix is not None:
                # the prompt's full pages are valid now: offer them
                with self._alloc_lock:
                    self.prefix.register(req.prompt, pages, hashes=req._page_hashes)
            slot = free_slots[0]
            slot.request = req
            slot.pages = pages
            slot.position = T  # the sampled token is written at T
            slot.generated = 1
            if self._spec is not None:
                # draft proposer: prefill the prompt into the slot's draft
                # pages (decode thread: the draft pool is only ever touched
                # here and in run_step)
                self._spec.on_install(self.slots.index(slot), req)
            self._maybe_finish(slot, req.output[-1])
            installed = True
            _m_running.set(len(self._active()))

    # ------------------------------------------------------------ stepping

    def _advance_chunk(self) -> bool:
        """Run ONE prefill chunk of the oldest chunked request (decode
        thread only: chunks write the page pool). The next decode span
        runs right after, so a long prompt and the running batch
        interleave at chunk granularity."""
        with self._chunk_lock:
            if not self._chunk_queue:
                return False
            st = self._chunk_queue[0]
            # cancelled between chunks, or failed by _fail_all
            if st.request.cancelled.is_set() or st.request.done.is_set():
                self._chunk_queue.pop(0)
                self._free_pages_and_revive(st.pages)
                self._finish_request(st.request, "cancelled")
                return True
        C = self.ecfg.prefill_chunk
        req = st.request
        start = st.next_chunk * C
        toks = req.prompt[start:start + C]
        padded = np.zeros((C,), np.int32)
        padded[: len(toks)] = toks
        is_last = start + C >= st.true_len
        last_idx = (st.true_len - 1 - start) if is_last else C - 1
        logits, version = self._chunk_step(padded, start, st.table, last_idx)
        st.next_chunk += 1
        streaming = req.prefill_only and req.kv_sink is not None
        if not is_last:
            if streaming:
                # the pages up to this chunk's end are committed: send them
                # now, so migration overlaps the remaining chunks
                try:
                    self._stream_chunk_frames(st, start + C, last=False)
                except Exception as e:  # noqa: BLE001 — fail this request only
                    logger.warning("kv stream failed for %s", req.request_id, exc_info=True)
                    with self._chunk_lock:
                        if st in self._chunk_queue:
                            self._chunk_queue.remove(st)
                    self._free_pages_and_revive(st.pages)
                    self._fail_request(req, f"kv stream failed: {e!r}")
            return True
        with self._chunk_lock:
            self._chunk_queue.pop(0)
        first = _sample_host(logits, req.temperature, req.top_p, req.top_k, self._host_gen)
        now = time.monotonic()
        self._observe_first(req, now)
        self._commit_first(req, first, _host_logprob(logits, first), now, version)
        if streaming:
            # the last frame carries the first token; the pages free at once
            try:
                self._stream_chunk_frames(st, st.true_len, last=True)
            except Exception as e:  # noqa: BLE001 — fail this request only
                logger.warning("kv stream failed for %s", req.request_id, exc_info=True)
                self._free_pages_and_revive(st.pages)
                self._fail_request(req, f"kv stream failed: {e!r}")
                return True
            self._free_pages_and_revive(st.pages)
            self._finish_request(req, "prefill_done")
            return True
        with self._ready_lock:
            self._ready.append((req, st.pages, st.true_len, None))
        return True

    def step(self) -> bool:
        """One engine iteration: advance at most one prefill CHUNK, install
        finished prefills, then a span of decode steps for the whole active
        batch (decode_span, or busy_span under prefill pressure). A slot
        that finishes mid-span keeps decoding to span end; its extra tokens
        are dropped by the host loop and its extra KV writes land in its own
        still-allocated pages or the trash page (pages free only after the
        span's readback). Returns True if work happened.

        Every iteration with active slots observes each phase of the
        per-phase histogram (serve_decode_step_phase_seconds) once."""
        chunked = self._advance_chunk()
        installed = self._install_ready()
        # a request cancelled mid-decode frees its slot at this boundary
        t0 = time.monotonic()
        for s in self.slots:
            if s.request is not None and s.request.cancelled.is_set():
                self._maybe_finish(s, -1)
        t_cancel = time.monotonic() - t0
        active = self._active()
        if not active:
            return installed or chunked
        mode = "spec" if self._spec is not None else "plain"
        _m_step_phase.observe(t_cancel, tags={"phase": "cancellation_check", "mode": mode})
        B, pps = self.ecfg.max_batch_size, self.ecfg.pages_per_seq
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, pps), np.int32)  # page 0 = trash
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        advanced = False
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            tokens[i] = s.request.output[-1]
            positions[i] = s.position
            tables[i, : len(s.pages)] = s.pages
            temps[i] = s.request.temperature
            top_ps[i] = s.request.top_p
            top_ks[i] = s.request.top_k
            if s.request.temperature > 0 and (s.request.top_p < 1.0 or s.request.top_k > 0):
                advanced = True  # the sort-based sampler runs
        self._step_count += 1
        if self._spec is not None:
            if self._step_spec(tokens, positions, tables, temps, top_ps, top_ks, advanced,
                               len(active)):
                return True
            # zero-draft fallback: the (cheap) proposer found nothing to
            # draft anywhere in the batch this round — the plain span below
            # commits span tokens per slot where the S-wide verify would
            # commit exactly one
        # adaptive span: while prefill work is queued or running, or a
        # streamed KV import is staged (its request waits for a slot), yield
        # the card sooner so arriving requests get their first token
        if self.ecfg.adaptive_span and (
            self._prefill_inflight > 0
            or not self.pending.empty()
            or self._chunk_queue  # racy reads are fine: pressure hints only
            or self._importing
        ):
            span = max(1, self.ecfg.busy_span)
        else:
            span = max(1, self.ecfg.decode_span)
        t0 = time.monotonic()
        seq, logps = self._decode_span(span, tokens, positions, tables, temps,
                                       top_ps, top_ks, advanced)
        t1, t2 = self._span_enqueued, time.monotonic()
        committed = 0
        for t in range(span):
            for i, s in enumerate(self.slots):
                if s.request is None:
                    continue  # finished earlier in this span (or empty slot)
                s.position += 1
                tok = int(seq[t, i])
                if s.generated < s.request.max_tokens and not s.request.done.is_set():
                    s.request.output.append(tok)
                    s.request.output_logprobs.append(float(logps[t, i]))
                    s.generated += 1
                    committed += 1
                    _m_tokens.inc()
                    eos = self.ecfg.eos_token_id
                    if eos is not None and tok == eos:
                        pass  # eos is control, not content
                    elif s.request.stop:
                        # hold back: _maybe_finish drains tokens that can no
                        # longer start a stop match and strips matched tails
                        s.request._held.append(tok)
                    else:
                        s.request._emit(tok)
                self._maybe_finish(s, tok)
        t3 = time.monotonic()
        for phase, dt in (("verify", t1 - t0), ("sample", t2 - t1),
                          ("cache_bookkeeping", t3 - t2)):
            _m_step_phase.observe(dt, tags={"phase": phase, "mode": "plain"})
        self._note_tokens_per_step(committed, span * len(active))
        return True

    def _step_spec(self, tokens, positions, tables, temps, top_ps, top_ks, advanced,
                   n_active) -> bool:
        """One speculative round for the built batch arrays: propose up to
        k drafts per slot (capped to the slot's remaining token budget and
        sequence room so no verify write can land past its allocation),
        verify them in one span forward, commit the accepted prefix plus
        the bonus token through the same budget/eos/stop/finish path the
        plain loop uses. Returns False when the proposer declined the
        round (zero drafts batch-wide) — the caller runs a plain span."""
        spec, ecfg = self._spec, self.ecfg
        caps = np.zeros((ecfg.max_batch_size,), np.int32)
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            caps[i] = max(0, min(spec.k, s.request.max_tokens - s.generated - 1,
                                 ecfg.max_seq_len - 1 - s.position))
        committed, n_comm, n_draft, times = spec.run_step(
            tokens, positions, tables, caps, temps, top_ps, top_ks, advanced)
        spec.note_times(times)
        if committed is None:
            for phase in ("propose", "propose_wait", "propose_compute"):
                _m_step_phase.observe(times[phase], tags={"phase": phase, "mode": "spec"})
            return False
        t0 = time.monotonic()
        proposed = accepted = n_tokens = 0
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            proposed += int(n_draft[i])
            accepted += int(n_comm[i]) - 1
            for t in range(int(n_comm[i])):
                if s.request is None:
                    break  # finished on an earlier committed token
                s.position += 1
                tok = int(committed[i, t])
                if s.generated < s.request.max_tokens and not s.request.done.is_set():
                    s.request.output.append(tok)
                    # the verify forward does not surface per-token logits
                    # to the host; speculative commits carry no logprob
                    # (callers needing them serve without speculation)
                    s.request.output_logprobs.append(None)
                    s.generated += 1
                    n_tokens += 1
                    _m_tokens.inc()
                    eos = ecfg.eos_token_id
                    if eos is not None and tok == eos:
                        pass  # eos is control, not content
                    elif s.request.stop:
                        s.request._held.append(tok)
                    else:
                        s.request._emit(tok)
                self._maybe_finish(s, tok)
        t1 = time.monotonic()
        spec.record(proposed, accepted)
        spec.note_times({"cache_bookkeeping": t1 - t0, "rounds": 1})
        for phase in ("propose", "propose_wait", "propose_compute", "verify", "sample"):
            _m_step_phase.observe(times[phase], tags={"phase": phase, "mode": "spec"})
        _m_step_phase.observe(t1 - t0, tags={"phase": "cache_bookkeeping", "mode": "spec"})
        self._note_tokens_per_step(n_tokens, n_active)
        return True

    def _slo_digest(self, name: str) -> slo.Digest:
        d = self._slo.get(name)
        if d is None:
            d = slo.digest(name, {"role": self.slo_role})
            self._slo[name] = d
        return d

    def _note_tokens_per_step(self, committed: int, participations: int) -> None:
        self._tps_committed += committed
        self._tps_steps += participations
        if self._tps_steps:
            _m_tokens_per_step.set(self._tps_committed / self._tps_steps)
        if committed and self._slo_on:
            # time between tokens, count-weighted once per decode step (a
            # per-token add would pay the digest span times per span for
            # the same quantile information)
            now = time.monotonic()
            last = self._last_commit_t
            # the gap bound keeps idle time between bursts out of the sketch
            if last and now - last < 10.0:
                self._slo_digest("serve_tbt_seconds").add((now - last) / committed, n=committed)
            self._last_commit_t = now

    def _maybe_finish(self, slot: _Slot, last_tok: int) -> None:
        req = slot.request
        if req is None:
            return
        eos = self.ecfg.eos_token_id
        stopped = eos is not None and last_tok == eos
        stop_len = 0 if stopped else _match_stop(req.output, req.stop)
        stopped = stopped or stop_len > 0
        cancelled = req.cancelled.is_set()
        if not (slot.generated >= req.max_tokens or stopped or cancelled):
            if req._held:
                # no match now: tokens older than the longest possible stop
                # suffix can safely reach the stream
                hold = max(len(x) for x in req.stop) - 1
                while len(req._held) > hold:
                    req._emit(req._held.pop(0))
            return
        reason = "cancelled" if cancelled else "stop" if stopped else "length"
        if eos is not None and req.output and req.output[-1] == eos:
            req.output.pop()
            if req.output_logprobs:
                req.output_logprobs.pop()
        elif stop_len:
            # the stop sequence is control: strip it from the result AND
            # from the stream hold-back
            del req.output[-stop_len:]
            if req.output_logprobs:
                del req.output_logprobs[-min(stop_len, len(req.output_logprobs)):]
            if req._held:
                del req._held[-min(stop_len, len(req._held)):]
        # free BEFORE signalling completion: a caller returning from
        # generate() must see this request's pages released in stats()
        self._free_pages_and_revive(slot.pages)
        if self._spec is not None:
            # proposer hygiene: drop the slot's ngram context / invalidate
            # any prefetched draft row so the next occupant can never see
            # this request's state
            self._spec.on_evict(self.slots.index(slot))
        slot.request = None
        slot.pages = []
        slot.position = 0
        slot.generated = 0
        _m_running.set(len(self._active()))
        self._finish_request(req, reason)

    # ------------------------------------------------------------ blocking

    def generate(self, prompt: List[int], max_tokens: int = 32, temperature: float = 0.0,
                 request_id: Optional[str] = None, timeout_s: float = 600.0,
                 top_p: float = 1.0, top_k: int = 0,
                 stop: Optional[List[List[int]]] = None) -> Dict[str, Any]:
        req = Request(request_id=request_id or uuid.uuid4().hex, prompt=list(prompt),
                      max_tokens=max_tokens, temperature=temperature, top_p=top_p,
                      top_k=top_k, stop=stop)
        with tracing.span_if_traced("engine.generate", {"request_id": req.request_id}):
            self.add_request(req)
            if not req.done.wait(timeout_s):
                # the caller is gone: cancel so the slot and pages free
                self.cancel(req.request_id)
                raise TimeoutError(f"request {req.request_id} timed out")
        if req.error:
            raise ValueError(req.error)
        return {
            "request_id": req.request_id,
            "token_ids": list(req.output),
            "logprobs": list(req.output_logprobs),
            "weights_version": req.weights_version,
            "finish_reason": req.finish_reason,
            "ttft_s": (req.first_token_at or 0) - req.submitted_at,
            "latency_s": (req.finished_at or 0) - req.submitted_at,
        }

    def open_stream(self, prompt: List[int], max_tokens: int = 32, temperature: float = 0.0,
                    request_id: Optional[str] = None, timeout_s: float = 600.0,
                    top_p: float = 1.0, top_k: int = 0,
                    stop: Optional[List[List[int]]] = None):
        """-> (Request, token generator). The request object exposes
        finish_reason/error/timing after the generator is exhausted."""
        req = Request(request_id=request_id or uuid.uuid4().hex, prompt=list(prompt),
                      max_tokens=max_tokens, temperature=temperature, top_p=top_p,
                      top_k=top_k, stop=stop, stream_q=queue.Queue())
        self.add_request(req)

        def gen():
            while True:
                tok = req.stream_q.get(timeout=timeout_s)
                if tok is None:
                    break
                yield tok
            if req.error:
                raise ValueError(req.error)

        return req, gen()

    def generate_stream(self, prompt: List[int], max_tokens: int = 32,
                        temperature: float = 0.0, request_id: Optional[str] = None,
                        timeout_s: float = 600.0, top_p: float = 1.0, top_k: int = 0,
                        stop: Optional[List[List[int]]] = None):
        """Yield token ids as they are generated (first at TTFT, not at
        completion). Raises the request's error, if any, after the stream."""
        _, gen = self.open_stream(prompt, max_tokens=max_tokens, temperature=temperature,
                                  request_id=request_id, timeout_s=timeout_s,
                                  top_p=top_p, top_k=top_k, stop=stop)
        return gen

    def update_params(self, params, version: Optional[int] = None) -> int:
        """Live weight swap without draining: the reference's update_params,
        which rebinds a new device tree. Here the captured programs read
        the parameters at their addresses, so the new values are copied
        into the live tensors in place; the tensors, their per-layer views
        and the f32 head copy are never rebound and no program is
        recaptured.

        1. Validate: `params` must have this engine's keys and shapes, or
           ValueError is raised before a byte is copied.
        2. Stage: a leaf already on the engine's device in the live leaf's
           dtype is used as it is. Any other (a numpy array, an ml_dtypes
           bfloat16 one too, a CPU tensor, another dtype) is copied to the
           card on a side stream, through reused pinned buffers
           (_HostStager), and cast to the live leaf's dtype there; the
           update then waits for that stream (the reference's
           block_until_ready) while decode spans go on running. On the
           CPU the same steps run without streams.
        3. Swap: under the replay lock, which every program replay holds
           while it is enqueued, and on the default stream, copy every leaf
           into the live tensors, refresh the f32 head copy from the new
           head, and bump weights_version (or set it to `version`) and the
           serve_weights_version gauge. A program enqueued before the swap
           runs wholly on the old weights and one enqueued after it wholly
           on the new ones, as the reference's in-flight dispatches keep
           their tree; a request's weights_version is the one its first
           token's program ran on.

        The engine writes through the tensors it was built over: a caller
        that passed tensors on the card, a second engine built over the
        same tensors and a self-speculation draft all see the new weights
        (no second copy of the model is made). A distinct draft model's
        weights are not touched. update_stats holds the update's host
        seconds of staging, of the wait for the replay lock and of the
        swap, and the bytes staged. Returns the new weights_version."""
        t0 = time.monotonic()
        live = _leaves(self.params)
        new = _leaves(params)
        missing, extra = sorted(set(live) - set(new)), sorted(set(new) - set(live))
        if missing or extra:
            raise ValueError(f"update_params: the new weights lack {missing} and add {extra}")
        for name, t in live.items():
            if tuple(np.shape(new[name])) != tuple(t.shape):
                raise ValueError(f"update_params: {name} has shape "
                                 f"{tuple(np.shape(new[name]))}, the engine's {tuple(t.shape)}")
        dst = list(live.values())
        staged, nbytes = self._stage([new[name] for name in live], dst)
        t1 = time.monotonic()
        # the engine lock keeps out a capture (the threads run only after it)
        with self._lock, self._replay_lock:
            t2 = time.monotonic()
            self._copy_into_live(dst, staged)
            self._model.refresh_head()
            self.weights_version = (int(version) if version is not None
                                    else self.weights_version + 1)
            v = self.weights_version
            _m_weights_version.set(float(v), tags={"role": self.slo_role})
            t3 = time.monotonic()
        self.update_stats = {"stage_s": t1 - t0, "wait_s": t2 - t1, "swap_s": t3 - t2,
                             "staged_bytes": nbytes}
        return v

    def _stage(self, new: list, live: List[torch.Tensor]):
        """The new leaves on the engine's device in the live leaves' dtypes
        -> (tensors, bytes copied from the host). A leaf already there in
        that dtype is used as it is; on the card the others are staged on
        a side stream (_HostStager), which this waits for."""
        card = self.device.type == "cuda"
        out, nbytes, stager = [], 0, None
        for x, t in zip(new, live):
            if isinstance(x, torch.Tensor) and x.device == t.device and x.dtype == t.dtype:
                out.append(x)
                continue
            x = x if isinstance(x, torch.Tensor) else _host_leaf(x)
            if not card:
                out.append(x.to(t.dtype))
                continue
            if stager is None:
                stager = _HostStager(self.device)
            if x.device.type == "cpu":
                nbytes += x.numel() * x.element_size()
            out.append(stager.stage(x, t.dtype))
        if stager is not None:
            stager.side.synchronize()
        return out, nbytes

    def _copy_into_live(self, live: List[torch.Tensor], staged: List[torch.Tensor]) -> None:
        """The swap's copies, in stream order (under the replay lock): one
        device-to-device copy a leaf, which ran closer to the byte bound
        on the H100 than one torch._foreach_copy_ (PERF.md, live weights)."""
        for dst, src in zip(live, staged):
            dst.copy_(src)

    def prefix_digest(self) -> Dict[str, Any]:
        """Compact prefix-cache fingerprint for router gossip: the first 8
        bytes, in hex, of the chain hash of every cached full prompt page.
        A router matches prompt_page_fingerprints(prompt, page_size)
        against this set to count a prompt's warm leading pages per
        replica."""
        if self.prefix is None:
            return {"page_size": self.ecfg.page_size, "hashes": []}
        with self._alloc_lock:
            hashes = [h[:8].hex() for h in self.prefix.by_hash]
        return {"page_size": self.ecfg.page_size, "hashes": hashes}

    def stats(self) -> Dict[str, Any]:
        with self._ready_lock:
            ready = len(self._ready)
        with self._alloc_lock:
            waiting = len(self._waiting)
            free_pages = self.allocator.num_free
            prefix = self.prefix.stats() if self.prefix is not None else {}
        spec = self._spec.stats() if self._spec is not None else {}
        # zero-ref cached pages are reclaimed on demand: they count as free
        return {
            "active": len(self._active()),
            "pending": self.pending.qsize(),
            "ready": ready,
            "waiting_for_pages": waiting,
            "free_pages": free_pages + prefix.get("reusable_pages", 0),
            **prefix,
            "steps": self._step_count,
            "weights_version": self.weights_version,
            "tokens_per_decode_step": (self._tps_committed / self._tps_steps
                                       if self._tps_steps else 0.0),
            **spec,
        }

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop both threads and wait for them (an in-flight device program
        finishes first)."""
        self._stop.set()
        self._work.set()  # wake the decode thread so it observes _stop
        with self._lock:
            threads = [t for t in (self._loop_thread, self._prefill_thread) if t is not None]
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout_s)


def _kv_layer_groups(L: int, groups: int = 4) -> List[tuple]:
    """Near-even [l0, l1) layer slabs for layer-major KV frames: four
    (the reference's measured choice), or one layer each under four
    layers."""
    G = max(1, min(int(L), int(groups)))
    base, rem = divmod(int(L), G)
    out, l0 = [], 0
    for gi in range(G):
        ln = base + (1 if gi < rem else 0)
        out.append((l0, l0 + ln))
        l0 += ln
    return out


def _gather_pages(k_pages: torch.Tensor, v_pages: torch.Tensor, pages):
    """pool[:, :, pages] -> token-contiguous (k, v), each [L, n * ps, KVH,
    hd] for n = len(pages), on the pool's device: the reference's
    _gather_pages_jit, as tensor indexing (eager, never in a capture)."""
    L, KVH, _P, ps, hd = k_pages.shape
    idx = torch.as_tensor(pages, dtype=torch.long).to(k_pages.device)

    def gather(pool):
        return pool[:, :, idx].permute(0, 2, 3, 1, 4).reshape(L, len(pages) * ps, KVH, hd)

    return gather(k_pages), gather(v_pages)


def _scatter_pages(k_pages: torch.Tensor, v_pages: torch.Tensor, k, v, pages) -> None:
    """Write token-contiguous k / v [L, t, KVH, hd] (any device and dtype)
    into the pool's pages `pages`, n = len(pages) = ceil(t / ps): every
    page the tokens touch, a partial last page padded with zeros (the
    reference's _scatter_pages_jit). In place: the captured graphs read
    the pool at its address, so it is never rebound."""
    L, KVH, _P, ps, hd = k_pages.shape
    n = len(pages)
    idx = torch.as_tensor(pages, dtype=torch.long).to(k_pages.device)

    def scatter(pool, x):
        x = x.to(device=pool.device, dtype=pool.dtype)
        if x.shape[1] < n * ps:
            x = torch.cat([x, x.new_zeros((L, n * ps - x.shape[1], KVH, hd))], dim=1)
        pool[:, :, idx] = x.reshape(L, n, ps, KVH, hd).permute(0, 3, 1, 2, 4)

    scatter(k_pages, k)
    scatter(v_pages, v)


def prompt_page_fingerprints(prompt, page_size: int) -> List[str]:
    """The truncated chain-hash fingerprints of every full page of
    `prompt` (the first 8 bytes of PrefixCache's hash, in hex): what a
    router matches against an engine's cached pages to count a prompt's
    warm leading pages (the reference's prefix-aware role routing)."""
    n = len(prompt) // page_size
    if n <= 0:
        return []
    return [h[:8].hex() for h in PrefixCache(page_size).page_hashes(prompt, n)]


def _leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """A parameter tree's leaves by path ("layers.wq"), in the tree's order."""
    if not isinstance(tree, dict):
        raise ValueError(f"update_params: {prefix or 'the weights'} is a "
                         f"{type(tree).__name__}, not a dict of arrays")
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path + "."))
        else:
            out[path] = v
    return out


# bytes of one host-to-card copy when update_params stages a host leaf
STAGE_CHUNK_BYTES = 32 << 20


class _HostStager:
    """update_params' staging on the card, on a side stream. A host leaf
    goes through two reused pinned buffers of STAGE_CHUNK_BYTES in turns:
    the host fills one (a single-threaded copy, leaving the other cores to
    the engine's threads) while the other's copy to the card runs. So no
    pinned allocation is the size of a leaf, and no copy holds the card's
    copy engine for long while the decode thread's input copies wait
    behind it. The cast to the live dtype runs on the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.main = torch.cuda.current_stream(device)
        self.bufs = [torch.empty(STAGE_CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def stage(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (host, or on the card in another dtype) on the card in dtype,
        enqueued on the side stream; read on the default stream."""
        if x.device.type != "cpu":  # a cast, after what the caller enqueued
            self.side.wait_stream(self.main)
            with torch.cuda.stream(self.side):
                y = x.to(dtype)
        else:
            src = x.contiguous().reshape(-1).view(torch.uint8).numpy()
            with torch.cuda.stream(self.side):
                dev = torch.empty(src.size, dtype=torch.uint8, device=self.device)
            for off in range(0, src.size, STAGE_CHUNK_BYTES):
                n = min(STAGE_CHUNK_BYTES, src.size - off)
                buf, done = self.bufs[self.turn], self.copied[self.turn]
                if done is not None:
                    done.synchronize()  # the buffer's last copy has left it
                np.copyto(buf.numpy()[:n], src[off:off + n])
                with torch.cuda.stream(self.side):
                    dev[off:off + n].copy_(buf[:n], non_blocking=True)
                    self.copied[self.turn] = torch.cuda.Event()
                    self.copied[self.turn].record(self.side)
                self.turn ^= 1
            with torch.cuda.stream(self.side):
                y = dev.view(x.dtype).view(x.shape).to(dtype)
        y.record_stream(self.main)  # read by the swap, on the default stream
        return y


def _host_leaf(x) -> torch.Tensor:
    """An array-like on the host as a CPU tensor of its dtype; an ml_dtypes
    bfloat16 array by its bits (numpy knows no bfloat16)."""
    a = np.ascontiguousarray(x)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.view(np.uint16)
    if not a.flags.writeable:  # torch.from_numpy wants a writable array
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _normalize_stops(stop) -> Optional[List[List[int]]]:
    """Accept [[ids...]...] or the flat [id...] form (each id a stop on its
    own); reject anything else with a clear error."""
    if stop is None:
        return None
    if not isinstance(stop, (list, tuple)):
        raise ValueError(f"stop must be a list, got {type(stop).__name__}")
    out: List[List[int]] = []
    for s in stop:
        if isinstance(s, (int, np.integer)):
            out.append([int(s)])
        elif isinstance(s, (list, tuple)) and s and all(
                isinstance(t, (int, np.integer)) for t in s):
            out.append([int(t) for t in s])
        else:
            raise ValueError("stop entries must be token ids or non-empty token-id "
                             f"lists, got {s!r}")
    return out or None


def _match_stop(output: List[int], stops: Optional[List[List[int]]]) -> int:
    """Length of the stop sequence `output` currently ends with, or 0."""
    if not stops:
        return 0
    for s in stops:
        n = len(s)
        if n and len(output) >= n and output[-n:] == list(s):
            return n
    return 0


def _device_sample(logits, temps, top_ps, top_ks, gen, sample: bool, advanced: bool):
    """Per-row sampling on the card: temp <= 0 is greedy. `sample` (any
    temp > 0 in the batch, known on the host) skips the draw for all-greedy
    batches; `advanced` runs the top-k/top-p sampler."""
    greedy = logits.argmax(dim=-1)
    if not sample:
        return greedy.int()
    if advanced:
        return _device_sample_topk_topp(logits, temps, top_ps, top_ks, gen)
    sampled = _categorical(logits / temps.clamp(min=1e-6)[:, None], gen)
    return torch.where(temps > 0, sampled, greedy).int()


def _device_sample_topk_topp(logits, temps, top_ps, top_ks, gen):
    """Per-row temperature + top-k + nucleus (top-p) sampling on the card.
    top_k <= 0 disables the rank cut; top_p >= 1 the nucleus cut; temp <= 0
    is greedy. One descending sort serves both filters."""
    greedy = logits.argmax(dim=-1)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = probs.cumsum(dim=-1)
    ranks = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    # nucleus keeps every token whose preceding mass is under top_p (the
    # first token crossing the boundary stays in)
    keep = (cum - probs) < top_ps[:, None]
    keep &= torch.where(top_ks[:, None] > 0, ranks < top_ks[:, None], True)
    keep[:, 0] = True  # never mask everything
    masked = sorted_logits.masked_fill(~keep, float("-inf"))
    choice = _categorical(masked, gen)
    sampled = order.gather(1, choice[:, None])[:, 0]
    return torch.where(temps > 0, sampled, greedy).int()


def _host_logprob(logits: np.ndarray, tok: int) -> float:
    """log P(tok) under the raw (temperature-free) softmax of `logits` —
    the quantity the decode span reports, so prefill-site and decode-site
    logprobs compare directly."""
    x = np.asarray(logits, np.float64)
    m = float(x.max())
    return float(x[tok] - m - np.log(np.exp(x - m).sum()))


def _sample_host(logits: np.ndarray, temperature: float, top_p: float = 1.0,
                 top_k: int = 0, gen: Optional[torch.Generator] = None) -> int:
    """One first token from f32 logits on the host (temperature <= 0 is
    greedy); draws come from `gen`, a CPU torch.Generator."""
    if temperature <= 0:
        return int(np.argmax(logits))
    logits = logits / temperature
    logits -= logits.max()
    p = np.exp(logits)
    p /= p.sum()
    if top_k > 0 or top_p < 1.0:
        order = np.argsort(-p)
        sp = p[order]
        cum = np.cumsum(sp)
        keep = (cum - sp) < top_p
        if top_k > 0:
            keep &= np.arange(len(sp)) < top_k
        keep[0] = True
        sp = np.where(keep, sp, 0.0)
        sp /= sp.sum()
        return int(order[_draw(sp, gen)])
    return _draw(p, gen)


def _draw(p: np.ndarray, gen: Optional[torch.Generator]) -> int:
    """An index drawn with probabilities p."""
    return int(torch.multinomial(torch.from_numpy(p), 1, generator=gen))
