"""Speculative decoding for the serving engine: propose-k, verify-once.

Counterpart of ray_tpu/serve/spec_decode.py. A decode step normally yields
one token per sequence per forward. Here a cheap PROPOSER guesses k
continuation tokens per slot, and ONE batched verify forward scores all
k+1 positions against the paged KV cache (ops.paged_attention_verify,
kernel K7). The longest accepted draft prefix commits, plus one "bonus"
token sampled from the first non-accepted position, so every round commits
between 1 and k+1 tokens and never fewer than the plain path. What a verify
round costs against a decode step on the card is measured by chip_smoke.py
and written down in PERF.md.

Correctness contract (the greedy-equivalence tests pin it): both proposers
are DETERMINISTIC (point-mass proposals), which makes exact rejection
sampling simple —

- greedy rows (temp<=0): draft d at row s accepts iff
  argmax(verify_logits[s]) == d, and the bonus is that argmax, so in f32 on
  the CPU the committed stream is identical to speculation-off greedy
  decode.
- sampling rows (temp>0): d accepts with probability p(d) under the
  temperature/top-k/top-p-filtered verify distribution; on rejection the
  bonus is drawn from that distribution with d zeroed out and
  renormalized. For a point-mass proposal this is exactly Leviathan-style
  speculative sampling: the output distribution equals the target's.

Two proposers behind one duck-typed interface
(on_install/on_evict/propose/program_specs):

- NGramProposer: suffix-match lookup over the request's own prompt+output,
  on the host in numpy, vectorized across the whole continuous batch over
  a persistent [B, max_seq_len] context buffer. When NO slot has a draft,
  run_step signals the engine to fall back to a plain decode span for that
  iteration.
- DraftModelProposer: a small transformer from models/ sharing the
  tokenizer, with its OWN paged KV pool mirroring each slot's positions
  (fixed per-slot page runs — no allocator). Prompts chunk-prefill into the
  draft pool at install (kernel K6), one replay of the captured draft
  chunk program per chunk; each round runs one catch-up decode
  step for the token at position-1 (on a fully-accepted round the last
  draft token was never fed, which would leave a KV hole) and then k greedy
  draft-decode steps (kernel K5), one captured program replayed without a
  host sync (serve/programs.py CapturedProgram; so is the verify, one
  program per span width and sampler mode). With overlap
  (the default), the NEXT round's propose is enqueued at the end of
  run_step — right after the commit readback — so the draft forward runs
  on the card while the host does its commit loop. Per-slot (request_id,
  position) stamps invalidate a prefetched row whenever the slot was
  evicted, reused, or cancelled in between: a stale row simply proposes
  nothing (n_draft=0 commits exactly the plain token).

KV bookkeeping: the verify forward writes span KV at positions
p..p+n_draft per slot (rows past a slot's draft count are routed to the
trash page). After committing a drafts + bonus, the slot advances a+1;
the bonus token's KV is written by the NEXT round's row 0, and stale
rejected-draft KV above the new position is invisible (attention is
position-bounded) until overwritten.

A round has ONE readback (committed tokens and counts); everything else on
the card is enqueued without waiting. Draft pools are touched only by
on_install and run_step, both on the engine's decode thread. MoE targets
and drafts route through the same PagedModel programs; a verify routes
its [B, S] span, so the width S sets its capacity, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import config
from ..core.metrics import Counter, Gauge
from ..models import get_config, init_params
from .config import SpeculationConfig
from .programs import SAMPLER_MODES, PagedModel, _categorical, host_tensor, read_back

_m_spec_proposed = Counter(
    "serve_spec_proposed_tokens",
    "Draft tokens proposed to the verify forward.")
_m_spec_accepted = Counter(
    "serve_spec_accepted_tokens",
    "Draft tokens accepted by the verify forward.")
_m_spec_accept_rate = Gauge(
    "serve_spec_acceptance_rate",
    "Cumulative accepted/proposed draft-token ratio.")


# ---------------------------------------------------------------------------
# Device-side accept + commit
# ---------------------------------------------------------------------------


def _topk_topp_keep(scaled, top_ps, top_ks):
    """Per-row keep mask in TOKEN space for the temperature-scaled logits,
    matching engine._device_sample_topk_topp's sorted-domain semantics
    (first token crossing the nucleus boundary stays; top-1 always kept).
    The sort is stable, so tied logits rank by token id as the reference's
    argsort ranks them."""
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = probs.cumsum(dim=-1)
    ranks = torch.arange(scaled.shape[-1], device=scaled.device)[None, :]
    keep = (cum - probs) < top_ps[:, None]
    keep &= (top_ks[:, None] <= 0) | (ranks < top_ks[:, None])
    keep[:, 0] = True
    return torch.zeros_like(keep).scatter_(1, order, keep)  # back to token order


def _accept_commit(logits, tokens, n_draft, temps, top_ps, top_ks, gen, advanced,
                   sample: bool = True):
    """logits [B,S,V] f32 (verify forward, row s scores position p+s+1);
    tokens [B,S] = [last committed, d_1..d_K]; n_draft [B] valid drafts;
    gen: the torch.Generator the uniform and the bonus draws come from.
    `sample` (any temp > 0 in the batch, known on the host) skips the
    draws for all-greedy batches. -> (committed [B,S] int32, n_committed
    [B] int32). Columns past n_committed are padding the host ignores."""
    B, S, V = logits.shape
    K = S - 1
    dev = logits.device
    greedy = logits.argmax(dim=-1)  # [B,S] == plain greedy decode
    drafts = tokens[:, 1:].long()  # [B,K]
    ok = greedy[:, :K] == drafts
    if sample:
        scaled = logits / temps.clamp(min=1e-6)[:, None, None]
        if advanced:
            flat = scaled.reshape(B * S, V)
            keep = _topk_topp_keep(flat, top_ps.repeat_interleave(S),
                                   top_ks.repeat_interleave(S))
            scaled = flat.masked_fill(~keep, float("-inf")).reshape(B, S, V)
        probs = torch.softmax(scaled, dim=-1)
        p_draft = probs[:, :K].gather(2, drafts[:, :, None])[..., 0]
        u = torch.rand((B, K), generator=gen, device=dev)
        # point-mass proposal (q(d)=1): accept w.p. min(1, p(d)/q(d)) = p(d)
        ok = torch.where(temps[:, None] > 0, u < p_draft, ok)
    ok = ok & (torch.arange(K, device=dev)[None, :] < n_draft[:, None])
    a = ok.long().cumprod(dim=1).sum(dim=1)  # [B] accepted drafts, <= K
    # bonus from row a: greedy rows reuse the raw-logit argmax (exact
    # equality with the plain path); sampling rows draw from the residual
    # (filtered distribution with the rejected draft zeroed out)
    bonus = greedy.gather(1, a[:, None])[:, 0]
    if sample:
        row_a = scaled.gather(1, a[:, None, None].expand(B, 1, V))[:, 0]
        rejected = a < n_draft
        rej_tok = drafts.gather(1, a.clamp(max=K - 1)[:, None])[:, 0]
        vocab = torch.arange(V, device=dev)[None, :]
        resid = row_a.masked_fill(rejected[:, None] & (vocab == rej_tok[:, None]),
                                  float("-inf"))
        bonus = torch.where(temps > 0, _categorical(resid, gen), bonus)
    cols = torch.arange(S, device=dev)[None, :]
    drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
    committed = torch.where(cols < a[:, None], drafts_pad,
                            torch.where(cols == a[:, None], bonus[:, None], 0))
    return committed.int(), (a + 1).int()


# ---------------------------------------------------------------------------
# Proposers
# ---------------------------------------------------------------------------


def _ngram_lookup(ctx: np.ndarray, nmin: int, nmax: int, k: int) -> np.ndarray:
    """Longest suffix of length in [nmin, nmax] matched against earlier
    context; the continuation after the MOST RECENT match is the draft."""
    T = int(ctx.shape[0])
    for n in range(min(nmax, T - 1), nmin - 1, -1):
        suffix = ctx[T - n:]
        win = np.lib.stride_tricks.sliding_window_view(ctx[:T - 1], n)
        hits = np.flatnonzero((win == suffix).all(axis=1))
        if hits.size:
            j = int(hits[-1])
            return ctx[j + n: j + n + k]
    return np.empty((0,), np.int32)


def _batch_ngram_lookup(ctx: np.ndarray, lens: np.ndarray, active: np.ndarray, nmin: int,
                        nmax: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """`_ngram_lookup` for the whole batch: one sliding-window pass per
    suffix length n (at most nmax-nmin+1 passes, each a single vectorized
    comparison over [rows, windows, n]) instead of a per-request Python
    loop. Row semantics are identical to `_ngram_lookup(ctx[i, :lens[i]])`:
    longest suffix length wins, most recent match wins, continuation
    truncated at the row's real length."""
    B = ctx.shape[0]
    drafts = np.zeros((B, k), np.int32)
    n_out = np.zeros((B,), np.int32)
    unresolved = active.copy()
    for n in range(nmax, nmin - 1, -1):
        rows = np.flatnonzero(unresolved & (lens >= n + 1))
        if rows.size == 0:
            continue
        sub = ctx[rows]
        L = lens[rows].astype(np.int64)
        idx = (L[:, None] - n) + np.arange(n)[None, :]
        suffix = np.take_along_axis(sub, idx, axis=1)
        win = np.lib.stride_tricks.sliding_window_view(sub, n, axis=1)
        hit = (win == suffix[:, None, :]).all(axis=2)
        # window j matches real context only if a continuation exists
        # inside the row's live tokens: j + n < L (window fully inside
        # ctx[:L-1], exactly the scalar lookup's search range)
        hit &= (np.arange(hit.shape[1])[None, :] + n) < L[:, None]
        got = hit.any(axis=1)
        if not got.any():
            continue
        last_j = hit.shape[1] - 1 - np.argmax(hit[:, ::-1], axis=1)
        for ri in np.flatnonzero(got):
            r = int(rows[ri])
            j = int(last_j[ri])
            m = min(k, int(L[ri]) - (j + n))
            drafts[r, :m] = ctx[r, j + n: j + n + m]
            n_out[r] = m
            unresolved[r] = False
    return drafts, n_out


class NGramProposer:
    """Draft tokens from the request's own prompt+output (no model).

    Keeps a persistent [B, max_seq_len] context buffer mirroring each
    slot's prompt+output, appended incrementally per step (only the new
    committed tokens copy), and runs ONE vectorized suffix lookup across
    the batch. A request_id stamp per row means a reused slot can never
    see its predecessor's context."""

    name = "ngram"
    cheap = True  # host-side: a zero-draft round should fall back to plain
    supports_prefetch = False

    def __init__(self, spec: SpeculationConfig):
        self.k = spec.num_speculative_tokens
        self.nmin = spec.ngram_min
        self.nmax = spec.ngram_max
        self._ctx: Optional[np.ndarray] = None  # [B, max_seq_len] int32
        self._len: Optional[np.ndarray] = None  # [B] live tokens per row
        self._rid: list = []

    def _ensure(self, engine) -> None:
        if self._ctx is None:
            B = engine.ecfg.max_batch_size
            self._ctx = np.zeros((B, engine.ecfg.max_seq_len), np.int32)
            self._len = np.zeros((B,), np.int64)
            self._rid = [None] * B

    def on_install(self, engine, slot_idx: int, request) -> None:
        self._ensure(engine)
        seq = request.prompt + request.output
        m = min(len(seq), self._ctx.shape[1])
        self._ctx[slot_idx, :m] = seq[:m]
        self._len[slot_idx] = m
        self._rid[slot_idx] = request.request_id

    def on_evict(self, engine, slot_idx: int) -> None:
        if self._ctx is not None:
            self._len[slot_idx] = 0
            self._rid[slot_idx] = None

    def program_specs(self, engine):
        return ()  # host code: nothing on the card

    def propose(self, engine, tokens, positions) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure(engine)
        B = engine.ecfg.max_batch_size
        active = np.zeros((B,), bool)
        cap = self._ctx.shape[1]
        for i, s in enumerate(engine.slots):
            req = s.request
            if req is None:
                continue
            if self._rid[i] != req.request_id:
                self.on_install(engine, i, req)
            else:
                P = len(req.prompt)
                total = min(P + len(req.output), cap)
                have = int(self._len[i])
                if total > have:
                    self._ctx[i, have:total] = req.output[have - P: total - P]
                    self._len[i] = total
            active[i] = True
        return _batch_ngram_lookup(self._ctx, self._len, active, self.nmin, self.nmax, self.k)


class DraftModelProposer:
    """Draft tokens from a small transformer with its own paged KV pool.

    The draft pool mirrors the target's position bookkeeping exactly
    (draft position == slot.position at every propose), with FIXED
    per-slot page runs — pages_per_seq plus a small spill margin so the
    k-step lookahead near max_seq_len never writes into a neighbour's
    pages. Prompts chunk-prefill into the pool at install time; per round
    one catch-up step and k greedy draft-decode steps run for the whole
    batch as one captured program, with the tokens staying on the card.
    """

    name = "draft"
    cheap = False  # zero-draft rounds keep current behavior (verify span)
    supports_prefetch = True

    def __init__(self, engine, spec: SpeculationConfig, draft_params=None):
        # next-round propose enqueued at the end of run_step (overlap
        # mode): {"drafts" device [B,K], "pos" np [B], "rids" list} —
        # consumed (or discarded on any per-row stamp mismatch) by the
        # next take_prefetch
        self._pf: Optional[Dict[str, Any]] = None

        self.k = spec.num_speculative_tokens
        ecfg = engine.ecfg
        target = engine._model
        B, ps = ecfg.max_batch_size, ecfg.page_size
        self.chunk = ecfg.prefill_chunk
        # spill pages: propose positions reach max_seq_len - 1 + k
        self.pps = ecfg.pages_per_seq + (-(-self.k // ps))
        shared = {}
        if spec.draft_model is None:
            # self-speculation: share the target's weight tensors, its
            # per-layer views and its f32 head (no second copy), so after
            # engine.update_params it drafts with the new weights (the
            # reference's draft keeps the tree it was built with; greedy
            # commits come from the target's verify in both). Acceptance
            # is high by construction — an upper-bound plumbing smoke, not
            # a deployment config (name a real small model for that).
            cfg, params = engine.cfg, engine.params
            shared = dict(layers=target.layers, head32=target.head32, rope=target.rope)
        else:
            cfg = get_config(spec.draft_model, **dict(spec.draft_model_overrides or {}))
            if cfg.vocab_size != engine.cfg.vocab_size:
                raise ValueError("draft model must share the target tokenizer: vocab "
                                 f"{cfg.vocab_size} != {engine.cfg.vocab_size}")
            if cfg.max_seq_len < ecfg.max_seq_len:
                cfg = dataclasses.replace(cfg, max_seq_len=ecfg.max_seq_len)
            params = (draft_params if draft_params is not None
                      else init_params(cfg, seed=0, device=engine.device, dtype=cfg.dtype))
        self.cfg = cfg
        # table length additionally covers padded chunk rows at install
        # (entries past the real run are 0 — the draft pool's trash page)
        tbl_len = max(self.pps, -(-(ecfg.max_seq_len + self.chunk) // ps))
        tables = np.zeros((B, tbl_len), np.int32)
        for i in range(B):
            tables[i, : self.pps] = 1 + i * self.pps + np.arange(self.pps)
        self._tables = engine._tensor(tables, torch.int32)
        L, KVH, hd = cfg.n_layers, cfg.kv_heads, cfg.hdim
        pool = dict(dtype=engine.k_pages.dtype, device=engine.device)
        self.model = PagedModel(params, cfg, ps,
                                torch.zeros((L, KVH, 1 + B * self.pps, ps, hd), **pool),
                                torch.zeros((L, KVH, 1 + B * self.pps, ps, hd), **pool),
                                **shared)

    # --------------------------------------------------------- programs

    def _propose_body(self, prev_tokens, tokens, positions):
        """The propose program, captured once: k greedy decode steps over
        the draft pool; [B] int32 tensors in, (drafts [B, K] int32,) out,
        no host sync (the reference's jitted scan,
        ray_tpu/serve/spec_decode.py:503).

        Catch-up first: on a fully-accepted round the token now at
        position-1 (the last draft) was never FED to the draft model, so
        its KV is a hole that poisons every later step's attention. One
        extra decode step (without the head) writes it; when the hole does
        not exist this rewrites identical KV. Inactive rows clamp to
        position 0 (their writes land in the slot's own pages at positions
        no live request can see before on_install rebuilds them)."""
        model, tables = self.model, self._tables
        model.decode(prev_tokens, (positions - 1).clamp(min=0), tables)
        toks, pos, seq = tokens, positions, []
        for _ in range(self.k):
            toks = model.logits(model.decode(toks, pos, tables)).argmax(dim=-1).int()
            seq.append(toks)
            pos = pos + 1
        return (torch.stack(seq, dim=1),)

    def _chunk_body(self, toks, start, table):
        """The draft chunk program: one C-token chunk into the draft pool
        (PagedModel.chunk, kernel K6), without the head: only its KV writes
        matter, so it has no outputs. toks [C], start [1], table [tbl_len]
        int32."""
        self.model.chunk(toks, start, table)
        return ()

    def program_specs(self, engine):
        B, C = engine.ecfg.max_batch_size, self.chunk
        zeros = torch.zeros((B,), dtype=torch.int32, device=engine.device)
        yield ("propose",), self._propose_body, (zeros, zeros, zeros), ()
        # the draft pool's trash page 0 at start 0
        yield (("draft_chunk", C), self._chunk_body,
               (torch.zeros((C,), dtype=torch.int32, device=engine.device), zeros[:1],
                torch.zeros_like(self._tables[0])), ())

    # -------------------------------------------------------- interface

    def on_install(self, engine, slot_idx: int, request) -> None:
        """Chunk-prefill the prompt into the slot's draft pages, one replay
        of the draft chunk program per chunk (the target's pages may have
        come from the prefix cache or chunked prefill — the draft pool
        always rebuilds from the tokens)."""
        T, C = len(request.prompt), self.chunk
        table = self._tables[slot_idx]
        for c0 in range(0, T, C):
            toks = request.prompt[c0:c0 + C]
            padded = np.zeros((C,), np.int32)
            padded[: len(toks)] = toks
            engine._replay(("draft_chunk", C), host_tensor(padded, torch.int32),
                           host_tensor([c0], torch.int32), table)

    def on_evict(self, engine, slot_idx: int) -> None:
        # a prefetched row computed for the evicted request must never
        # surface for the slot's next occupant
        if self._pf is not None:
            self._pf["rids"][slot_idx] = None

    def _prev_tokens(self, engine, tokens) -> np.ndarray:
        """The token at position-1 per slot (catch-up feed)."""
        prev = np.asarray(tokens, np.int32).copy()
        for i, s in enumerate(engine.slots):
            req = s.request
            if req is None:
                continue
            if len(req.output) >= 2:
                prev[i] = req.output[-2]
            elif req.prompt:
                prev[i] = req.prompt[-1]
        return prev

    def _dispatch(self, engine, prev, tokens, positions) -> torch.Tensor:
        """One replay of the propose program on host arrays -> drafts [B, K]
        on the card: the program's static output, which its next replay
        overwrites. `propose` leaves it to run_step, which concatenates the
        drafts into the verify's input before any other replay; `prefetch`
        keeps a copy."""
        (drafts,), _ = engine._replay(("propose",), host_tensor(prev, torch.int32),
                                      host_tensor(tokens, torch.int32),
                                      host_tensor(positions, torch.int32))
        return drafts

    def propose(self, engine, tokens, positions) -> Tuple[torch.Tensor, np.ndarray]:
        drafts = self._dispatch(engine, self._prev_tokens(engine, tokens), tokens, positions)
        n = np.full((engine.ecfg.max_batch_size,), self.k, np.int32)
        return drafts, n  # drafts stay on the card: verify concatenates there

    def prefetch(self, engine, tokens, positions, committed, n_comm) -> None:
        """Enqueue the NEXT round's propose right after this round's commit
        readback: the inputs (next fed token, next position, the catch-up
        token) are pure functions of the committed tokens, so the draft
        forward runs on the card while the engine does its host-side
        commit loop. Stamped per row with (request_id, position);
        take_prefetch drops any row whose stamp no longer matches."""
        B = engine.ecfg.max_batch_size
        rows = np.arange(B)
        nc = np.asarray(n_comm, np.int64)
        tokens = np.asarray(tokens, np.int32)
        last = committed[rows, np.maximum(nc - 1, 0)]
        next_tok = np.where(nc > 0, last, tokens).astype(np.int32)
        prev_tok = np.where(nc >= 2, committed[rows, np.maximum(nc - 2, 0)],
                            tokens).astype(np.int32)
        next_pos = (np.asarray(positions, np.int64) + nc).astype(np.int32)
        # a copy: before the next round's verify reads them, that round's
        # chunk and install replay other programs of this pool, and a
        # program's scratch may hold the outputs of one captured after it
        drafts = self._dispatch(engine, prev_tok, next_tok, next_pos).clone()
        rids = [s.request.request_id if s.request is not None else None
                for s in engine.slots]
        self._pf = {"drafts": drafts, "pos": next_pos, "rids": rids}

    def take_prefetch(self, engine, positions) -> Optional[Tuple[torch.Tensor, np.ndarray]]:
        pf, self._pf = self._pf, None
        if pf is None:
            return None
        B = engine.ecfg.max_batch_size
        n = np.zeros((B,), np.int32)
        for i, s in enumerate(engine.slots):
            req = s.request
            if (req is not None and pf["rids"][i] == req.request_id
                    and int(pf["pos"][i]) == int(positions[i])):
                n[i] = self.k
        return pf["drafts"], n


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


class SpecDecoder:
    """Owns the proposer, the verify forward (accept/commit on the card —
    the readback is [B,S] committed tokens + [B] counts), and the
    acceptance accounting. The engine drives it from step()."""

    def __init__(self, engine, spec: SpeculationConfig, draft_params=None):
        self.engine = engine
        self.spec = spec
        self.k = spec.num_speculative_tokens
        if spec.mode == "ngram":
            self.proposer = NGramProposer(spec)
        elif spec.mode == "draft":
            self.proposer = DraftModelProposer(engine, spec, draft_params)
        else:
            raise ValueError(f"speculation mode {spec.mode!r} is not a proposer mode")
        overlap = spec.overlap if spec.overlap is not None else bool(config.spec_overlap)
        self.overlap = overlap and self.proposer.supports_prefetch
        self.proposed_total = 0
        self.accepted_total = 0
        # host wall seconds by phase, summed over rounds, and "rounds", the
        # number of verify rounds (the reference's per-phase histograms wait
        # for the telemetry port)
        self.phase_seconds: Dict[str, float] = {}

    def _verify_body(self, toks_bs, positions, tables, n_draft, temps, top_ps, top_ks, *,
                     sample: bool, advanced: bool):
        """The verify program: the span forward plus accept/commit, one
        program per (S, sample, advanced) as the reference jits one per
        `advanced` (ray_tpu/serve/spec_decode.py:711). Embeds the S = m+1
        fed tokens, writes their KV at positions p..p+n_draft (rows past a
        slot's draft count go to the trash page), attends with the span
        kernel, f32 head over all S rows, accept/commit -> (committed
        [B,S], n_committed [B])."""
        eng = self.engine
        model = eng._model
        logits = model.logits(model.span(toks_bs, positions, tables, n_draft))
        return _accept_commit(logits, toks_bs, n_draft, temps, top_ps, top_ks, eng._gen,
                              advanced, sample)

    def _verify(self, toks_bs, positions, tables, n_draft, temps, top_ps, top_ks,
                advanced: bool, sample: bool):
        """One replay of the verify program for the tokens' width S: run_step
        narrows the span to the round's picked draft count + 1, so a round
        where every slot drafted short never pays the full k+1-wide
        forward. Tensors in (host or card), (committed [B,S], n_committed
        [B]) out: the program's static outputs, read back at once."""
        return self.engine._replay(("verify", toks_bs.shape[1], sample, advanced and sample),
                                   toks_bs, positions, tables, n_draft, temps, top_ps,
                                   top_ks)[0]

    def program_specs(self):
        """(key, body, example inputs, generators) of the verify programs,
        every width S = 2..k+1 that run_step can pick in every sampler
        mode, then the proposer's."""
        eng = self.engine
        B, pps = eng.ecfg.max_batch_size, eng.ecfg.pages_per_seq
        zeros = torch.zeros((B,), dtype=torch.int32, device=eng.device)
        tables = torch.zeros((B, pps), dtype=torch.int32, device=eng.device)
        ones = torch.ones((B,), device=eng.device)
        for S in range(2, self.k + 2):
            toks = torch.zeros((B, S), dtype=torch.int32, device=eng.device)
            for sample, advanced in SAMPLER_MODES:
                yield (("verify", S, sample, advanced),
                       functools.partial(self._verify_body, sample=sample, advanced=advanced),
                       (toks, zeros, tables, zeros, ones * float(sample), ones, zeros),
                       (eng._gen,))
        yield from self.proposer.program_specs(eng)

    # -------------------------------------------------------- engine API

    def on_install(self, slot_idx: int, request) -> None:
        self.proposer.on_install(self.engine, slot_idx, request)

    def on_evict(self, slot_idx: int) -> None:
        self.proposer.on_evict(self.engine, slot_idx)

    # verify cost model: one S-wide forward ~ ALPHA + S in single-row
    # units (ALPHA covers what a forward costs at any width: reading the
    # weights, and dispatch). Used by _pick_span to trade truncating the
    # deepest rows' drafts against running a narrower program for the
    # whole batch. Fit by chip_smoke.round_vs_step from graph-replay device
    # times at llama3-8b, B = 8, on an NVIDIA H100 80GB HBM3 at 700 W:
    # ms = 9.889 + 0.164 S over S = 1 (a decode step) .. 5 (verify), so
    # ALPHA = 60.3; the reference's TPU value was 1.0. A wider verify
    # costs next to nothing more, so the picker keeps the full width.
    _SPAN_ALPHA = 60.0

    def _pick_span(self, n_draft, caps) -> int:
        """Choose how many draft rows the verify forward should carry.

        One slot with k drafts would force the full k+1-wide program on
        the whole batch even when every other slot drafted 0-1 tokens —
        and a draft only pays off while its acceptance holds up. Using
        the proposer's measured acceptance rate `a`, a row with d drafts
        verified at width w expects (a - a^(min(d,w)+1)) / (1-a) + 1
        committed tokens; pick the w maximizing expected commits per
        unit verify cost (ALPHA + w + 1). Rows deeper than w are simply
        truncated — their tail drafts were the least likely to commit."""
        m = int(n_draft.max())
        if m <= 1:
            return m
        a = (self.accepted_total / self.proposed_total
             if self.proposed_total >= 256 else 0.8)
        a = min(max(a, 0.05), 0.98)
        nd = n_draft[np.asarray(caps) > 0].astype(np.float64)
        best_w, best_v = m, -1.0
        for w in range(1, m + 1):
            run = np.minimum(nd, w)
            exp_commits = np.sum((a - a ** (run + 1)) / (1.0 - a) + 1.0)
            v = exp_commits / (self._SPAN_ALPHA + w + 1)
            if v > best_v:
                best_w, best_v = w, v
        return best_w

    def run_step(self, tokens, positions, tables, caps, temps, top_ps, top_ks, advanced):
        """One speculative round over the built batch arrays (host numpy).
        caps [B] is the per-slot draft cap (min of k, remaining budget - 1,
        sequence room; 0 for inactive slots). Returns committed [B,S] np,
        n_committed [B] np, n_draft [B] np, and per-phase wall times on the
        host's clock: propose split into the wait-on-prefetch and compute
        (enqueue) shares, verify = enqueueing the span forward, sample =
        the wait for the round's one readback, which is where the card's
        time shows.

        Fallback: a CHEAP proposer (ngram) with zero drafts everywhere
        returns (None, None, n_draft, times) — the engine should run a
        plain decode span instead, which commits span tokens at plain
        cost where the S-wide verify would commit exactly one."""
        eng = self.engine
        t0 = time.monotonic()
        wait = compute = 0.0
        pf = self.proposer.take_prefetch(eng, positions) if self.overlap else None
        if pf is not None:
            drafts, n_prop = pf
            wait = time.monotonic() - t0
        else:
            drafts, n_prop = self.proposer.propose(eng, tokens, positions)
            compute = time.monotonic() - t0
        n_draft = np.minimum(n_prop, caps).astype(np.int32)
        if self.proposer.cheap and not n_draft.any():
            return None, None, n_draft, {
                "propose_wait": wait, "propose_compute": compute,
                "propose": wait + compute}
        # adaptive span: the verify forward only needs max(n_draft)+1
        # rows. Floor of 1 draft row: K=0 would make the accept op's
        # rejected-draft gather degenerate (an all-zero-cap round still
        # verifies one draft row it then ignores via n_draft=0)
        m = max(1, self._pick_span(n_draft, caps))
        n_draft = np.minimum(n_draft, m)
        if isinstance(drafts, np.ndarray):
            toks_bs = host_tensor(np.concatenate([tokens[:, None], drafts[:, :m]], axis=1),
                                  torch.int32)
        else:  # draft mode: the drafts never left the card; the concatenation
            # consumes the propose program's output before anything replays
            toks_bs = torch.cat([eng._tensor(tokens, torch.int32)[:, None], drafts[:, :m]],
                                dim=1)
        t1 = time.monotonic()
        committed, n_comm = self._verify(
            toks_bs, host_tensor(positions, torch.int32), host_tensor(tables, torch.int32),
            host_tensor(n_draft, torch.int32), host_tensor(temps, torch.float32),
            host_tensor(top_ps, torch.float32), host_tensor(top_ks, torch.int32),
            advanced, bool(np.any(temps > 0)))
        t2 = time.monotonic()
        # the round's one readback: [B, S + 1] = committed | n_committed
        out = read_back(torch.cat([committed, n_comm[:, None]], dim=1))[0].numpy()
        committed, n_comm = out[:, :-1], out[:, -1]
        t3 = time.monotonic()
        if self.overlap:
            # enqueue next round's propose NOW: it executes on the card
            # while the engine runs its host-side commit loop
            self.proposer.prefetch(eng, tokens, positions, committed, n_comm)
            compute += time.monotonic() - t3
        return committed, n_comm, n_draft, {
            "propose_wait": wait, "propose_compute": compute,
            "propose": wait + compute,
            "verify": t2 - t1, "sample": t3 - t2}

    def note_times(self, times: Dict[str, float]) -> None:
        for phase, dt in times.items():
            self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) + dt

    def record(self, proposed: int, accepted: int) -> None:
        self.proposed_total += int(proposed)
        self.accepted_total += int(accepted)
        if proposed:
            _m_spec_proposed.inc(proposed)
            if accepted:
                _m_spec_accepted.inc(accepted)
        if self.proposed_total:
            _m_spec_accept_rate.set(self.accepted_total / self.proposed_total)

    def stats(self) -> Dict[str, Any]:
        return {
            "spec_mode": self.spec.mode,
            "spec_num_speculative_tokens": self.k,
            "spec_proposed_tokens": self.proposed_total,
            "spec_accepted_tokens": self.accepted_total,
            "spec_acceptance_rate": (
                self.accepted_total / self.proposed_total
                if self.proposed_total else 0.0),
        }
