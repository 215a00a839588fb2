"""The serving engine's device programs: one model over one paged KV pool,
and the captured form the engine runs them in.

`PagedModel` binds a parameter dict to a pool [L, KVH, P, page_size, hd]
per K and V and runs the four programs that write KV into pages: a padded
batch of prompts at one bucket length (attention over the rows
themselves, kernel K2), one decode token per sequence (K5), one prefill
chunk of one sequence (K6), and one speculative span of S rows per
sequence (K7); the last three attend over the pages. The engine owns one
for the target model; the draft-model proposer of serve/spec_decode.py
owns another over its own pool, sharing the target's parameter tensors
when it self-speculates. The programs differ only in which positions they
write and how they attend, so the layer loop is written once
(`_run_layers`); MoE layers route each row b of the program's [B, T]
batch on its own at that T, as the reference's programs do: the bucketed
prefill [Bp, bucket], decode [B, 1], the chunk [1, C] and the span
[B, S]. They update the pools in place and return hidden states
(the bucketed prefill its f32 logits at each row's last prompt token);
the caller applies `logits` to the rows it needs.

`CapturedProgram` is the port's counterpart of one of the reference's
jitted programs (ray_tpu/serve/engine.py:662 `for_span`, :772
`for_chunk`, :853 `_prefill_fn`, ray_tpu/serve/spec_decode.py:503 and
:711): a body over static input buffers that a CUDA graph captures once
and replays as one launch. The engine captures every device program of
its step loop and its prefill thread this way: the decode spans, the
verify widths, the draft propose, the chunk of the engine and of the
draft, and the bucketed prefill per (bucket, padded batch). Positions,
lengths and chunk starts are inputs on the card, so one graph serves
every request.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import (
    _embed_lookup,
    _ffn,
    _lm_head,
    _norm,
    _out_proj,
    _qkv,
    layer_views,
    lm_head_weight,
    torch_dtype,
)
from ..ops import (
    dispatch,
    flash_attention,
    paged_attention_chunk,
    paged_attention_decode,
    paged_attention_verify,
    rope_frequencies,
)

# the sampler modes a program is captured for, (sample, advanced): greedy
# (no temperature > 0 in the batch: no draws), sampled, and sampled with
# the top-k/top-p filter (one vocabulary sort per row). The host picks the
# mode per dispatch from the batch's settings, as the reference picks
# `advanced` per jitted program.
SAMPLER_MODES = ((False, False), (True, False), (True, True))


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick (as
    jax.random.categorical): argmax(logits - log E), E ~ Exp(1). Stays on
    the card, no host sync."""
    e = torch.empty_like(logits).exponential_(generator=gen)
    return (logits - e.log()).argmax(dim=-1)


class PagedModel:
    def __init__(self, params, cfg: ModelConfig, page_size: int, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, layers: Optional[list] = None,
                 head32: Optional[torch.Tensor] = None, rope=None):
        """layers / head32 / rope: per-layer parameter views, the f32 head
        and the rope tables of another PagedModel over the same parameters,
        to share instead of building again."""
        self.params = params
        self.cfg = cfg
        self.ps = page_size
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.dtype = torch_dtype(cfg.dtype)
        self.layers = layers if layers is not None else layer_views(params["layers"])
        # one f32 copy of the head: logits are f32 (a bf16 product flips
        # greedy tokens against the reference) and casting the head every
        # step would re-read and re-write it each time
        self.head32 = (head32 if head32 is not None
                       else lm_head_weight(params, cfg).float())
        if rope is None and cfg.positional == "rope":
            rope = rope_frequencies(cfg.hdim, cfg.max_seq_len, cfg.rope_theta,
                                    device=k_pages.device)
        self.rope = rope

    def refresh_head(self) -> None:
        """Rewrite the f32 head copy in place from the parameters' head
        (after a live weight update; the programs read it at its address)."""
        self.head32.copy_(lm_head_weight(self.params, self.cfg))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + f32 head over hidden rows [..., D] -> [..., V]."""
        return _lm_head(x, self.params, self.cfg, self.head32)

    def _embed(self, toks: torch.Tensor, rope_pos: torch.Tensor) -> torch.Tensor:
        x = _embed_lookup(self.params["embed"], toks, self.dtype)
        if self.cfg.positional == "learned":
            x = x + self.params["pos_emb"][rope_pos].to(self.dtype)
        return x

    def _run_layers(self, x, rope_pos, page_idx, slot_idx, attend) -> torch.Tensor:
        """x [B, T, D]; rope_pos [B or 1, T], page_idx / slot_idx [B, T]
        long. Each layer writes its K/V rows at (page, slot) and calls
        attend(q [B,T,H,hd], k, v [B,T,KVH,hd], k_pages, v_pages of the
        layer) -> [B,T,H,hd]."""
        cfg = self.cfg
        for l, lp in enumerate(self.layers):
            h = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg)
            q, k, v = _qkv(h, lp, cfg, self.rope, rope_pos)
            kp, vp = self.k_pages[l], self.v_pages[l]
            # [B, T, KVH, hd] -> [KVH, B, T, hd] at (page, slot) of each row;
            # rows routed to page 0, the trash page, may collide there
            kp[:, page_idx, slot_idx] = k.permute(2, 0, 1, 3).to(kp.dtype)
            vp[:, page_idx, slot_idx] = v.permute(2, 0, 1, 3).to(vp.dtype)
            x = x + _out_proj(attend(q, k, v, kp, vp), lp)
            h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg)
            x = x + _ffn(h, lp, cfg)[0]
        return x

    # The reference's gathers clamp out-of-range indices where PyTorch on
    # the card raises a device-side assert: a slot that finished mid-span
    # rides out the span past its last position, a span's rows past a
    # slot's draft count and the draft proposer's lookahead run past
    # max_seq_len. Positions are clamped to the rope table and page lookups
    # to the table's last entry, as there.

    def prefill(self, toks, true_lens, tables) -> torch.Tensor:
        """Bucketed prefill of a padded batch. toks [Bp, bucket] int32,
        true_lens [Bp] int32, tables [Bp, pages] int32. Writes each row's
        K/V at positions 0..bucket-1 into the row's pages and attends
        causally over the row itself (kernel K2) -> f32 logits [Bp, V] at
        position true_len - 1. Positions past a row's allocated pages (the
        table's zero tail; every position of a dummy row's all-zero table)
        write the trash page 0. Pad positions >= true_len inside real pages
        write pad KV, as the reference's page scatter does; decode
        overwrites it before any query reads it (position bound)."""
        ps, (Bp, T), pps = self.ps, toks.shape, tables.shape[1]
        positions = torch.arange(T, device=toks.device)
        rope_pos = positions.clamp(max=self.cfg.max_seq_len - 1)[None]
        x = self._embed(toks, rope_pos)
        page_of = (positions // ps)[None].expand(Bp, T)
        page_idx = tables.gather(1, page_of.clamp(max=pps - 1)).long()
        page_idx = torch.where(page_of < pps, page_idx, 0)
        slot_idx = (positions % ps)[None].expand(Bp, T)

        def attend(q, k, v, kp, vp):
            return flash_attention(q, k, v, causal=True)

        x = self._run_layers(x, rope_pos, page_idx, slot_idx, attend)
        last = x[torch.arange(Bp, device=x.device), true_lens.long() - 1]
        return self.logits(last)

    def decode(self, toks, pos, tables) -> torch.Tensor:
        """One token for every sequence. toks/pos [B] int32, tables
        [B, pages] int32 on the pool's device. Writes each sequence's KV at
        `pos` and attends over its first pos + 1 keys (kernel K5) ->
        hidden [B, D]."""
        ps = self.ps
        rope_pos = pos.clamp(max=self.cfg.max_seq_len - 1).long()[:, None]
        x = self._embed(toks[:, None], rope_pos)
        page_idx = tables.gather(
            1, (pos // ps).clamp(max=tables.shape[1] - 1).long()[:, None]).long()
        slot_idx = (pos % ps).long()[:, None]
        lengths = pos + 1

        def attend(q, k, v, kp, vp):
            return paged_attention_decode(q[:, 0], kp, vp, tables, lengths)[:, None]

        return self._run_layers(x, rope_pos, page_idx, slot_idx, attend)[:, 0]

    def chunk(self, toks, start, table) -> torch.Tensor:
        """One C-token prefill chunk of one sequence. toks [C] int32, start
        [1] int32 (the chunk's first position, on the pool's device: one
        captured program serves every chunk), table [pages] int32. Writes
        the chunk's KV into the sequence's pages and attends over the paged
        prefix (kernel K6, which reads [start, start + C] on the card) ->
        hidden [C, D]. Pad rows past the prompt write KV too, but no later
        query sees them before decode overwrites them (position bound)."""
        ps, C = self.ps, toks.shape[0]
        positions = start.long() + torch.arange(C, device=toks.device)
        rope_pos = positions.clamp(max=self.cfg.max_seq_len - 1)[None]
        x = self._embed(toks[None], rope_pos)
        page_idx = table[(positions // ps).clamp(max=table.shape[0] - 1)].long()[None]
        slot_idx = (positions % ps)[None]
        meta = torch.cat([start, start + C])  # [start, total], which K6 reads in place

        def attend(q, k, v, kp, vp):
            return paged_attention_chunk(q[0], kp, vp, table, meta[:1], meta[1:])[None]

        return self._run_layers(x, rope_pos, page_idx, slot_idx, attend)[0]

    def _span_indices(self, positions, S: int, tables, n_draft):
        """Where a span's rows go: row s of sequence b sits at position
        positions[b] + s -> (rope_pos, page_idx, slot_idx), each [B, S]
        long. Rows past a sequence's draft count write the trash page."""
        steps = torch.arange(S, device=positions.device)
        pos2d = positions.long()[:, None] + steps[None, :]
        rope_pos = pos2d.clamp(max=self.cfg.max_seq_len - 1)
        page_idx = tables.gather(1, (pos2d // self.ps).clamp(max=tables.shape[1] - 1)).long()
        page_idx = torch.where(steps[None, :] <= n_draft[:, None], page_idx, 0)
        return rope_pos, page_idx, pos2d % self.ps

    def span(self, toks, positions, tables, n_draft) -> torch.Tensor:
        """The speculative verify forward. toks [B, S] int32 = [last
        committed, d_1..d_{S-1}]; positions / n_draft [B] int32; tables
        [B, pages] int32. Writes the span's KV at positions p..p+n_draft
        and attends row s over keys 0..p+s (kernel K7) -> hidden
        [B, S, D]."""
        rope_pos, page_idx, slot_idx = self._span_indices(positions, toks.shape[1], tables,
                                                          n_draft)
        x = self._embed(toks, rope_pos)

        def attend(q, k, v, kp, vp):
            return paged_attention_verify(q, kp, vp, tables, positions)

        return self._run_layers(x, rope_pos, page_idx, slot_idx, attend)


# eager runs of a program's body before its capture: one makes the first
# launches, library handles and workspaces; a second changed no served token
# or logprob and doubled the Python work of an engine build (llama3-8b on the
# H100: 8.8-12.6 s to build with two, 5.6-6.1 s with one; chip_smoke.py
# --fleet --build-profile)
WARM_RUNS = 1
# one graph capture at a time in this process (CapturedProgram), and no
# device-wide synchronize or empty_cache beside one (InferenceEngine._capture
# holds it around its own): either, from another thread, invalidates the
# capture running (ROADMAP C17). Reentrant, as the engine takes it around
# the programs it captures.
_CAPTURE_LOCK = threading.RLock()
# the side stream every capture's warm runs take, one per device
_WARM_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _warm_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream on which every CapturedProgram's warm runs go
    on `device` (callers hold _CAPTURE_LOCK), made at first use. cuBLAS
    keeps a workspace (32 MiB on the H100) per (handle, stream) for the
    life of the process; a fresh stream from torch's pool for each capture
    gave every engine build new pairs, a dozen workspaces that outlived
    the engine, until each handle had met all of the pool's streams
    (ROADMAP C10)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _WARM_STREAMS.get(index)
    if stream is None:
        stream = _WARM_STREAMS[index] = torch.cuda.Stream(device)
    return stream


def host_tensor(array, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of `dtype`, to copy into a program's
    static input (one host-to-device copy on the card)."""
    return torch.as_tensor(np.asarray(array), dtype=dtype)


def read_back(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Host copies of device tensors (a program's outputs). On the card
    each is copied into pinned memory without blocking and the host then
    waits on an event: a copy into pageable memory holds the stream while
    it waits, and blocks every other thread's enqueue on it (a replay's
    copies, a live weight swap's) until the card has run all the work
    before it."""
    if tensors[0].device.type != "cuda":
        return tuple(t.to("cpu", copy=True) for t in tensors)
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                 for t in tensors)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


class CapturedProgram:
    """One device program over static buffers: `fn(*inputs)` returns a
    tuple of tensors.

    On a CUDA device it is a CUDA graph. `fn` first runs eagerly
    WARM_RUNS time(s) on a side stream, so that first launches, library
    handles and workspaces happen outside the capture; then once under
    `torch.cuda.graph`. A failed capture raises; nothing falls back to
    eager launches. A call copies its arguments into the static inputs
    (`copy_`, in stream order), replays the graph (one cudaGraphLaunch on
    the current stream) and adds the kernel launches the capture recorded
    to `dispatch.LAUNCHES`. Tensors the body allocates (the K5/K7 split
    workspaces, every activation) come from the graph's memory pool at
    capture and keep their addresses at every replay.

    On the CPU there is no graph: a call runs `fn` on the static inputs
    and copies the results into the static outputs (the first call's
    results), so that the aliasing below holds there too.

    The outputs are the static buffers, the same tensors at every call,
    and the next call overwrites them. So does, on the card, any other
    program of the same memory pool: a later capture may place its tensors
    in memory an earlier graph uses as scratch. A caller therefore copies
    what it keeps (on the card a readback to the host is a copy; on the
    CPU `.cpu()` is not), or consumes it in stream order before any
    program of the pool replays again.

    generators: the torch.Generators `fn` draws from. Each is registered
    with the graph, so that every replay draws fresh numbers from the
    generator's advancing state (unregistered, each replay would repeat
    the capture's draws).
    """

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Sequence[torch.Tensor], pool=None,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.inputs = tuple(t.clone() for t in inputs)
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.graph = None
        # kernel launches of one replay, by kernel (dispatch.KERNELS)
        self.launches: dict = {}
        device = self.inputs[0].device
        if device.type != "cuda":
            return
        # One program at a time in the process, warm runs and capture
        # together: several engines may build at once (the replicas of a
        # deployment), and the warm runs' stream and the capture stream
        # come from torch's shared pool of streams, so another engine's
        # warm runs could land on the very stream that captures. No garbage
        # collection during the capture: a collection could destroy another
        # engine's dropped graphs, and destroying a graph while a stream
        # captures invalidates the capture. "thread_local": other threads'
        # CUDA calls (another engine allocating or serving on its own
        # streams) go on meanwhile, and only this thread's unsafe calls fail
        # the capture.
        with _CAPTURE_LOCK:
            side = _warm_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARM_RUNS):
                    self.fn(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with dispatch.recording_launches() as launches:
                    with torch.cuda.graph(graph, pool=pool,
                                          capture_error_mode="thread_local"):
                        outputs = self.fn(*self.inputs)
            finally:
                if collecting:
                    gc.enable()
        self.graph, self.outputs, self.launches = graph, _as_outputs(outputs), launches

    def __call__(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if len(args) != len(self.inputs):
            raise ValueError(f"the program takes {len(self.inputs)} inputs, got {len(args)}")
        for static, new in zip(self.inputs, args):
            if new.shape != static.shape:
                raise ValueError(f"input of shape {tuple(new.shape)} for a static buffer "
                                 f"of shape {tuple(static.shape)}")
            static.copy_(new)
        if self.graph is not None:
            self.graph.replay()
            dispatch.add_launches(self.launches)
            return self.outputs
        outputs = _as_outputs(self.fn(*self.inputs))
        if self.outputs is None:
            self.outputs = outputs
        else:
            for static, new in zip(self.outputs, outputs):
                static.copy_(new)
        return self.outputs


def _as_outputs(outputs) -> Tuple[torch.Tensor, ...]:
    if not (isinstance(outputs, tuple) and all(isinstance(t, torch.Tensor) for t in outputs)):
        raise TypeError("a captured program's body returns a tuple of tensors")
    return outputs
