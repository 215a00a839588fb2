"""The serving engine's device programs: one model over one paged KV pool.

`PagedModel` binds a parameter dict to a pool [L, KVH, P, page_size, hd]
per K and V and runs the three eager programs that write KV into pages and
attend over them: one decode token per sequence (kernel K5), one prefill
chunk of one sequence (K6), and one speculative span of S rows per
sequence (K7). The engine owns one for the target model; the draft-model
proposer of serve/spec_decode.py owns another over its own pool, sharing
the target's parameter tensors when it self-speculates. The programs
differ only in which positions they write and which kernel attends, so the
layer loop is written once (`_run_layers`).

The programs update the pools in place and return hidden states; the
caller applies `logits` to the rows it needs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.transformer import (
    _dense_ffn,
    _embed_lookup,
    _lm_head,
    _norm,
    _out_proj,
    _qkv,
    layer_views,
    lm_head_weight,
    torch_dtype,
)
from ..ops import (
    paged_attention_chunk,
    paged_attention_decode,
    paged_attention_verify,
    rope_frequencies,
)


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

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + f32 head over hidden rows [..., D] -> [..., V]."""
        return _lm_head(x, self.params, self.cfg, self.head32)

    def _embed(self, toks: torch.Tensor, rope_pos: torch.Tensor) -> torch.Tensor:
        x = _embed_lookup(self.params["embed"], toks, self.dtype)
        if self.cfg.positional == "learned":
            x = x + self.params["pos_emb"][rope_pos].to(self.dtype)
        return x

    def _run_layers(self, x, rope_pos, page_idx, slot_idx, attend) -> torch.Tensor:
        """x [B, T, D]; rope_pos / page_idx / slot_idx [B, T] long. Each
        layer writes its K/V rows at (page, slot) and calls
        attend(q [B,T,H,hd], k_pages, v_pages of the layer) -> [B,T,H,hd]."""
        cfg = self.cfg
        for l, lp in enumerate(self.layers):
            h = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg)
            q, k, v = _qkv(h, lp, cfg, self.rope, rope_pos)
            kp, vp = self.k_pages[l], self.v_pages[l]
            # [B, T, KVH, hd] -> [KVH, B, T, hd] at (page, slot) of each row;
            # rows routed to page 0, the trash page, may collide there
            kp[:, page_idx, slot_idx] = k.permute(2, 0, 1, 3).to(kp.dtype)
            vp[:, page_idx, slot_idx] = v.permute(2, 0, 1, 3).to(vp.dtype)
            x = x + _out_proj(attend(q, kp, vp), lp)
            h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg)
            x = x + _dense_ffn(h, lp, cfg)
        return x

    # The reference's gathers clamp out-of-range indices where PyTorch on
    # the card raises a device-side assert: a slot that finished mid-span
    # rides out the span past its last position, a span's rows past a
    # slot's draft count and the draft proposer's lookahead run past
    # max_seq_len. Positions are clamped to the rope table and page lookups
    # to the table's last entry, as there.

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

        def attend(q, kp, vp):
            return paged_attention_decode(q[:, 0], kp, vp, tables, lengths)[:, None]

        return self._run_layers(x, rope_pos, page_idx, slot_idx, attend)[:, 0]

    def chunk(self, toks, start: int, table) -> torch.Tensor:
        """One C-token prefill chunk of one sequence. toks [C] int32, table
        [pages] int32. Writes the chunk's KV into the sequence's pages and
        attends over the paged prefix (kernel K6) -> hidden [C, D]. Pad
        rows past the prompt write KV too, but no later query sees them
        before decode overwrites them (position bound)."""
        ps, C = self.ps, toks.shape[0]
        positions = start + torch.arange(C, device=toks.device)
        rope_pos = positions.clamp(max=self.cfg.max_seq_len - 1)[None]
        x = self._embed(toks[None], rope_pos)
        page_idx = table[(positions // ps).clamp(max=table.shape[0] - 1)].long()[None]
        slot_idx = (positions % ps)[None]

        def attend(q, kp, vp):
            return paged_attention_chunk(q[0], kp, vp, table, start, start + C)[None]

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

        def attend(q, kp, vp):
            return paged_attention_verify(q, kp, vp, tables, positions)

        return self._run_layers(x, rope_pos, page_idx, slot_idx, attend)
