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

Not ported yet: KV export/import and streaming, tensor-parallel meshes,
live weight updates, and the Prometheus/SLO telemetry (this module logs
through stdlib `logging`; speculation's totals are in `stats()`).
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
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import _require_flash, torch_dtype
from ..ops.dispatch import resolve_device
from .config import SpeculationConfig
from .programs import SAMPLER_MODES, CapturedProgram, PagedModel, _categorical, host_tensor
from .spec_decode import SpecDecoder

logger = logging.getLogger("ray_tpu_torch.serve.engine")


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

    def _emit(self, tok: Optional[int]) -> None:
        if self.stream_q is not None:
            self.stream_q.put(tok)


class _ChunkState:
    """One long prompt mid-chunked-prefill."""

    __slots__ = ("request", "pages", "table", "true_len", "next_chunk")

    def __init__(self, request: Request, pages: List[int], table, true_len: int):
        self.request = request
        self.pages = pages
        self.table = table  # np [pages_per_seq]
        self.true_len = true_len
        self.next_chunk = 0


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
        self._alloc_lock = threading.Lock()  # allocator: prefill + decode threads
        # prefilled (KV in their pages), awaiting a decode slot:
        # (request, pages, prompt length)
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
        # long-prompt chunk states, consumed one chunk per step() by the
        # DECODE thread (chunks write the page pool the decode span writes)
        self._chunk_queue: "list[_ChunkState]" = []
        self._chunk_lock = threading.Lock()
        self._requests: Dict[str, Request] = {}  # live (uncompleted) ids
        self._req_lock = threading.Lock()
        scfg = engine_cfg.speculation
        self._spec: Optional[SpecDecoder] = None
        if scfg is not None and scfg.enabled:
            if draft_params is not None:
                draft_params = _to_device(draft_params, self.device)
            self._spec = SpecDecoder(self, scfg, draft_params=draft_params)

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
        program = self._program(("decode", n_steps, sample, advanced and sample))
        seq, logps = program(
            host_tensor(tokens, torch.int32), host_tensor(positions, torch.int32),
            host_tensor(tables, torch.int32), host_tensor(temps, torch.float32),
            host_tensor(top_ps, torch.float32), host_tensor(top_ks, torch.int32))
        # copies on either device: the outputs are the program's buffers
        return seq.to("cpu", copy=True).numpy(), logps.to("cpu", copy=True).numpy()

    def _program(self, key: tuple) -> CapturedProgram:
        program = self._programs.get(key)
        if program is None:
            raise RuntimeError(
                f"device program {key} was not captured: the engine captures every "
                "program its step loop can pick before its threads start, never later")
        return program

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

    def _capture(self, specs, pool):
        """Capture `specs` into `pool` -> (seconds, bytes the captures added
        to the reserved memory on the card, else None)."""
        card = self.device.type == "cuda"
        t0 = time.monotonic()
        if card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        for key, body, inputs, generators in specs:
            self._programs[key] = CapturedProgram(body, inputs, pool=pool, generators=generators)
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

    def _chunk_step(self, tokens, start: int, table, last_idx: int) -> np.ndarray:
        """One replay of the chunk program on host arrays: writes the
        chunk's KV into the sequence's pages -> f32 logits [V] at chunk row
        last_idx, read back. Decode thread only."""
        (logits,) = self._program(("chunk", len(tokens)))(
            host_tensor(tokens, torch.int32), host_tensor([start], torch.int32),
            host_tensor(table, torch.int32), host_tensor([last_idx], torch.int32))
        return logits.to("cpu", copy=True).numpy()[0]

    def _prefill_body(self, toks, true_lens, tables):
        """The bucketed prefill program (PagedModel.prefill, kernel K2)."""
        return (self._model.prefill(toks, true_lens, tables),)

    def _prefill(self, tokens: np.ndarray, true_lens: np.ndarray,
                 tables: np.ndarray) -> np.ndarray:
        """Bucketed prefill of a padded batch: one replay of the program for
        (bucket, Bp) on host arrays tokens [Bp, bucket], true_lens [Bp],
        tables [Bp, pps]. Writes each row's KV into its pages -> f32 logits
        [Bp, V] at each row's last prompt token, read back. Prefill thread."""
        Bp, bucket = tokens.shape
        (logits,) = self._program(("prefill", bucket, Bp))(
            host_tensor(tokens, torch.int32), host_tensor(true_lens, torch.int32),
            host_tensor(tables, torch.int32))
        return logits.to("cpu", copy=True).numpy()

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

    # ------------------------------------------------------------ requests

    def add_request(self, req: Request) -> None:
        try:
            req.stop = _normalize_stops(req.stop)
        except ValueError as e:
            self._finish_request(req, error=str(e))
            return
        total = len(req.prompt) + req.max_tokens
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
        self._work.set()  # decode thread sweeps chunks/slots promptly
        return True

    def _finish_request(self, req: Request, reason: Optional[str] = None,
                        error: Optional[str] = None) -> None:
        """The one request-completion path (finish/fail/cancel): stamp,
        unregister, signal, terminate the stream."""
        if req.done.is_set():
            return
        if error is not None:
            req.error = error
        else:
            req.finish_reason = reason
        req.finished_at = time.monotonic()
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
        self._stop.set()
        with self._req_lock:
            live = list(self._requests.values())
        for req in live:
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
        n_pages = -(-(T + req.max_tokens) // self.ecfg.page_size)
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
            if req.cancelled.is_set():  # cancelled while queued
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
        # the program writes each row's KV into its pages
        logits_host = self._prefill(padded, lens, tables)
        # sample every row BEFORE publishing anything: if this raises, the
        # caller can still free every page (nothing is in _ready yet)
        firsts = [_sample_host(logits_host[i], req.temperature, req.top_p, req.top_k,
                               self._host_gen)
                  for i, (req, _p, _T, _b, _cl) in enumerate(group)]
        first_lps = [_host_logprob(logits_host[i], firsts[i]) for i in range(B)]
        now = time.monotonic()
        with self._ready_lock:
            for i, (req, pages, T, _b, _cl) in enumerate(group):
                self._commit_first(req, firsts[i], first_lps[i], now)
                self._ready.append((req, pages, T))
        self._work.set()  # revive the decode thread if it is idle-waiting

    def _commit_first(self, req: Request, first: int, logprob: float, now: float) -> None:
        req.first_token_at = now
        req.output.append(int(first))
        req.output_logprobs.append(logprob)
        req.weights_version = self.weights_version
        eos = self.ecfg.eos_token_id
        if eos is not None and int(first) == eos:
            pass  # eos is control
        elif req.stop:
            req._held.append(int(first))  # hold-back from token 1
        else:
            req._emit(int(first))

    def _install_ready(self) -> bool:
        """Decode thread: move finished prefills, whose KV is already in
        their pages, into free decode slots (slot bookkeeping only)."""
        installed = False
        while True:
            free_slots = [s for s in self.slots if s.request is None]
            with self._ready_lock:
                if not self._ready or not free_slots:
                    return installed
                req, pages, T = self._ready.pop(0)
            if req.cancelled.is_set():  # cancelled between prefill/install
                self._free_pages_and_revive(pages)
                self._finish_request(req, "cancelled")
                installed = True
                continue
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
            if st.request.cancelled.is_set():  # cancelled between chunks
                self._chunk_queue.pop(0)
                self._free_pages_and_revive(st.pages)
                self._finish_request(st.request, "cancelled")
                return True
        C = self.ecfg.prefill_chunk
        start = st.next_chunk * C
        toks = st.request.prompt[start:start + C]
        padded = np.zeros((C,), np.int32)
        padded[: len(toks)] = toks
        is_last = start + C >= st.true_len
        last_idx = (st.true_len - 1 - start) if is_last else C - 1
        logits = self._chunk_step(padded, start, st.table, last_idx)
        st.next_chunk += 1
        if not is_last:
            return True
        with self._chunk_lock:
            self._chunk_queue.pop(0)
        req = st.request
        first = _sample_host(logits, req.temperature, req.top_p, req.top_k, self._host_gen)
        self._commit_first(req, first, _host_logprob(logits, first), time.monotonic())
        with self._ready_lock:
            self._ready.append((req, st.pages, st.true_len))
        return True

    def step(self) -> bool:
        """One engine iteration: advance at most one prefill CHUNK, install
        finished prefills, then a span of decode steps for the whole active
        batch (decode_span, or busy_span under prefill pressure). A slot
        that finishes mid-span keeps decoding to span end; its extra tokens
        are dropped by the host loop and its extra KV writes land in its own
        still-allocated pages or the trash page (pages free only after the
        span's readback). Returns True if work happened."""
        chunked = self._advance_chunk()
        installed = self._install_ready()
        # a request cancelled mid-decode frees its slot at this boundary
        for s in self.slots:
            if s.request is not None and s.request.cancelled.is_set():
                self._maybe_finish(s, -1)
        active = self._active()
        if not active:
            return installed or chunked
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
        # adaptive span: while prefill work is queued or running, yield the
        # card sooner so arriving requests get their first token
        if self.ecfg.adaptive_span and (
            self._prefill_inflight > 0
            or not self.pending.empty()
            or self._chunk_queue  # racy read is fine: pressure hint only
        ):
            span = max(1, self.ecfg.busy_span)
        else:
            span = max(1, self.ecfg.decode_span)
        seq, logps = self._decode_span(span, tokens, positions, tables, temps,
                                       top_ps, top_ks, advanced)
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
        self._tps_committed += committed
        self._tps_steps += span * len(active)
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
                    eos = ecfg.eos_token_id
                    if eos is not None and tok == eos:
                        pass  # eos is control, not content
                    elif s.request.stop:
                        s.request._held.append(tok)
                    else:
                        s.request._emit(tok)
                self._maybe_finish(s, tok)
        spec.record(proposed, accepted)
        spec.note_times({"cache_bookkeeping": time.monotonic() - t0, "rounds": 1})
        self._tps_committed += n_tokens
        self._tps_steps += n_active
        return True

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
        self._finish_request(req, reason)

    # ------------------------------------------------------------ blocking

    def generate(self, prompt: List[int], max_tokens: int = 32, temperature: float = 0.0,
                 request_id: Optional[str] = None, timeout_s: float = 600.0,
                 top_p: float = 1.0, top_k: int = 0,
                 stop: Optional[List[List[int]]] = None) -> Dict[str, Any]:
        req = Request(request_id=request_id or uuid.uuid4().hex, prompt=list(prompt),
                      max_tokens=max_tokens, temperature=temperature, top_p=top_p,
                      top_k=top_k, stop=stop)
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
