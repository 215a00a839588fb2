"""Decoder-only transformer in PyTorch: dense and mixture-of-experts FFNs.

Counterpart of ray_tpu/models/transformer.py. Parameters keep the
reference's plain dict with layers STACKED on a leading axis (`wq
[L, D, H, hd]`, `wo [L, H, hd, D]`, ...), so `params_from_numpy` turns the
JAX package's parameters into this package's and both compute the same
thing. The forward is a Python loop over the layers. Weights are cast to
the model dtype at each use site (a no-op when they already are), softmax,
norms and logits run in f32. Attention is ops.flash_attention and norms
ops.rms_norm: CUDA kernels on the card, plain PyTorch on the CPU, both
differentiable (autograd Functions whose backward is K3/K4 for attention).
With `cfg.remat` and grad enabled, each layer runs under activation
checkpointing, as the reference's `run_layers` runs `jax.checkpoint`.
MoE layers route each row of a [B, T, D] batch on its own, with the
reference's capacity per expert (from T), its slot order and its drops;
the expert products are batched matmuls, as the reference's are einsums
(it has no Pallas kernel for MoE). The sequence-parallel attention is not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import apply_rope, flash_attention, layer_norm, rms_norm, rope_frequencies
from ..ops.dispatch import resolve_device
from ..parallel.moe import _dispatch_mask, aux_load_balance_loss, expert_slots, top_k_gating
from .config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the kernels' two types


def torch_dtype(name) -> torch.dtype:
    """torch dtype of a config's dtype name (or a torch dtype itself)."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def _require_flash(cfg: ModelConfig) -> None:
    if cfg.attn_impl != "flash":
        raise NotImplementedError(f"{cfg.name}: attn_impl {cfg.attn_impl!r} is not ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Any = torch.float32) -> Params:
    """Random-init parameters from `seed`, straight into `dtype` on `device`
    (the card unless the caller names another). The reference keeps an f32
    master copy and casts at use; a server passes its model dtype here so an
    8B model never holds an f32 copy on the card."""
    _require_flash(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.hdim
    out_scale = 0.02 / (2 * L) ** 0.5

    def dense(shape, scale=0.02):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt).mul_(scale)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    layers = {
        "ln1": ones((L, D)),
        "wq": dense((L, D, H, hd)),
        "wk": dense((L, D, KVH, hd)),
        "wv": dense((L, D, KVH, hd)),
        "wo": dense((L, H, hd, D), out_scale),
        "ln2": ones((L, D)),
    }
    if cfg.norm == "layernorm":
        layers["ln1_b"] = zeros((L, D))
        layers["ln2_b"] = zeros((L, D))
    if cfg.is_moe:  # the reference's layout: experts after the layer axis
        E = cfg.num_experts
        layers["router"] = dense((L, D, E))
        layers["w_in"] = dense((L, E, D, Fd))
        layers["w_gate"] = dense((L, E, D, Fd))
        layers["w_out"] = dense((L, E, Fd, D), out_scale)
    else:
        layers["w_in"] = dense((L, D, Fd))
        layers["w_out"] = dense((L, Fd, D), out_scale)
        if cfg.activation == "swiglu":
            layers["w_gate"] = dense((L, D, Fd))
        else:
            layers["b_in"] = zeros((L, Fd))
            layers["b_out"] = zeros((L, D))
    params: Params = {"embed": dense((V, D)), "layers": layers, "final_norm": ones((D,))}
    if cfg.norm == "layernorm":
        params["final_norm_b"] = zeros((D,))
    if cfg.positional == "learned":
        params["pos_emb"] = dense((cfg.max_seq_len, D), 0.01)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, V))
    return params


def params_from_numpy(tree, device=None, dtype: Any = None) -> Params:
    """The JAX package's parameters as numpy arrays
    (`jax.tree.map(np.asarray, params)`) -> this package's, on `device` (the
    card unless named) in `dtype` (None keeps each array's dtype)."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = torch.tensor(np.asarray(node), device=dev)
        return t if dt is None else t.to(dt)

    return convert(tree)


def params_to_numpy(tree) -> dict:
    """The inverse of params_from_numpy: this package's parameters (any
    device; bf16 leaves widened to float32, exactly) -> numpy arrays in the
    reference's layout, for `ray_tpu`'s models and engine."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = node.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    return convert(tree)


def layer_views(layers: Params) -> list:
    """Every layer's parameters as views into the stacked [L, ...] tensors,
    one dict per layer. One unbind per tensor: under autograd the layers'
    gradients reach each stacked tensor through a single stack, where
    indexing layer by layer would zero-fill and add a full [L, ...]
    gradient once per layer."""
    names = list(layers)
    return [dict(zip(names, ts)) for ts in zip(*(layers[n].unbind(0) for n in names))]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _norm(x, w, b, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, w, b, eps=cfg.norm_eps)
    return rms_norm(x, w, eps=cfg.norm_eps)


def _project(x, w):
    """x [..., D] @ w [D, ...] in x's dtype -> [..., *w.shape[1:]]."""
    D = w.shape[0]
    out = x.reshape(-1, D) @ w.reshape(D, -1).to(x.dtype)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _qkv(h, lp, cfg, rope_tables, positions=None):
    """Projections of h [B, T, D] -> q [B,T,H,hd], k/v [B,T,KVH,hd], rope
    applied at `positions` (default arange(T))."""
    q = _project(h, lp["wq"])
    k = _project(h, lp["wk"])
    v = _project(h, lp["wv"])
    if cfg.positional == "rope":
        cos, sin = rope_tables
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    return q, k, v


def _out_proj(o, lp):
    """Attention output o [..., H, hd] @ wo [H, hd, D] -> [..., D]."""
    H, hd, D = lp["wo"].shape
    out = o.reshape(-1, H * hd) @ lp["wo"].reshape(H * hd, D).to(o.dtype)
    return out.reshape(*o.shape[:-2], D)


def _attention(x, lp, cfg, rope_tables, positions=None):
    q, k, v = _qkv(x, lp, cfg, rope_tables, positions)
    return _out_proj(flash_attention(q, k, v, causal=True), lp)


def _dense_ffn(x, lp, cfg):
    h = _project(x, lp["w_in"])
    if cfg.activation == "swiglu":
        h = F.silu(_project(x, lp["w_gate"])) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h + lp["b_in"].to(x.dtype), approximate="tanh")
    out = _project(h, lp["w_out"])
    if cfg.activation != "swiglu":
        out = out + lp["b_out"].to(x.dtype)
    return out


def _moe_route(x, router_w, cfg):
    """The routing both MoE forms share (ray_tpu/models/transformer.py:199):
    f32 router logits, top-k gating, and each assignment's slot in its
    expert from a cumsum over the row's [T*k] token-major assignments,
    kept while under capacity. Capacity is ceil(cf * T * k / E) rounded
    up to a multiple of 4, at least 4 and at most T * k: it depends on T,
    so the same tokens drop only when they are routed at the same shape.
    x [B, T, D] -> (logits [B,T,E], weights [B,T,k], expert_ids [B,T,k],
    flat_ids [B,T*k], my_pos [B,T*k], keep [B,T*k], capacity)."""
    B, T, _ = x.shape
    E, k = cfg.num_experts, cfg.num_selected_experts
    logits = x.float() @ router_w.float()
    weights, expert_ids = top_k_gating(logits, k)
    raw = -int(-cfg.capacity_factor * T * k // E)  # ceil
    capacity = min(max((raw + 3) // 4 * 4, 4), T * k)
    flat_ids = expert_ids.reshape(B, T * k)
    my_pos, keep = expert_slots(flat_ids, E, capacity)
    return logits, weights, expert_ids, flat_ids, my_pos, keep, capacity


def _moe_aux(logits, expert_ids, num_experts):
    """Switch-style load-balance loss over every token of [B, T]."""
    return aux_load_balance_loss(logits.flatten(0, 1), expert_ids.flatten(0, 1), num_experts)


def _moe_dispatch(x, router_w, cfg):
    """x [B,T,D] -> (dispatch [B,T,E,C] f32, combine [B,T,E,C] f32, aux):
    the masks of each row b by `_dispatch_mask`, at the capacity and from
    the gating of the shared routing."""
    logits, weights, expert_ids, *_, capacity = _moe_route(x, router_w, cfg)
    disp, combine = _dispatch_mask(expert_ids, weights, cfg.num_experts, capacity)
    return disp, combine, _moe_aux(logits, expert_ids, cfg.num_experts)


def _experts(expert_in, lp):
    """Every expert's SwiGLU over its slots: [B, E, C, D] -> [B, E, C, D],
    as three batched matmuls over the expert axis."""
    B, E, C, D = expert_in.shape
    dt = expert_in.dtype
    xe = expert_in.transpose(0, 1).reshape(E, B * C, D)
    h = torch.bmm(xe, lp["w_in"].to(dt))
    g = torch.bmm(xe, lp["w_gate"].to(dt))
    y = torch.bmm(F.silu(g) * h, lp["w_out"].to(dt))
    return y.reshape(E, B, C, D).transpose(0, 1)


def _moe_ffn_dense(x, lp, cfg):
    """The dispatch/combine form (the reference's on meshes that shard
    tokens or experts): one-hot [B,T,E,C] masks contracted with x and
    with the experts' outputs -> (y [B,T,D], aux)."""
    dtype = x.dtype
    disp, combine, aux = _moe_dispatch(x, lp["router"], cfg)
    expert_in = torch.einsum("btd,btec->becd", x, disp.to(dtype))
    y = _experts(expert_in, lp)
    return torch.einsum("becd,btec->btd", y, combine.to(dtype)), aux


def _moe_ffn_gather(x, lp, cfg):
    """The gather form (the reference's without a mesh, and so the port's):
    slot tables from the shared routing, expert inputs a row gather, and
    each token's output gathered back from its <= k kept slots
    (`_moe_combine`). All shapes are static and nothing reads a value back
    to the host. -> (y [B,T,D], the router's load-balance loss)."""
    dtype = x.dtype
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.num_selected_experts
    logits, weights, expert_ids, flat_ids, my_pos, keep, C = _moe_route(x, lp["router"], cfg)
    # slot tables [B, E, C]: the token a slot holds and whether it holds
    # one; dropped assignments all write the overflow slot C, cut off
    at = flat_ids * (C + 1) + torch.where(keep, my_pos, C)
    tok = (torch.arange(T * k, device=x.device) // k).expand(B, T * k)
    tok_of = torch.zeros((B, E * (C + 1)), dtype=torch.long, device=x.device)
    tok_of = tok_of.scatter_(1, at, tok).view(B, E, C + 1)[:, :, :C]
    valid = torch.zeros((B, E * (C + 1)), dtype=dtype, device=x.device)
    valid = valid.scatter_(1, at, torch.ones_like(tok, dtype=dtype)).view(B, E, C + 1)[:, :, :C]
    rows = tok_of.reshape(B, E * C, 1).expand(B, E * C, D)
    expert_in = torch.gather(x, 1, rows).view(B, E, C, D) * valid[..., None]
    y = _experts(expert_in, lp).reshape(B, E * C, D)
    slot_of = flat_ids * C + torch.where(keep, my_pos, 0)
    coef = (weights.reshape(B, T * k) * keep).to(dtype)
    return _moe_combine(y, slot_of, coef, k), _moe_aux(logits, expert_ids, E)


def _moe_combine(y, slot_of, coef, k: int):
    """y [B, E*C, D] the slots' outputs; slot_of / coef [B, T*k] each
    assignment's slot and weight (0 where dropped) -> [B, T, D]: each
    token sums its k slots' outputs times their weights, in choice order.
    The reference scatter-adds the slots' outputs into the tokens; this
    gather computes the same sums without atomics, so a graph replay and
    an eager run give the same bits."""
    B, Tk = slot_of.shape
    D = y.shape[-1]
    picked = torch.gather(y, 1, slot_of[..., None].expand(B, Tk, D))
    return (picked * coef[..., None]).view(B, Tk // k, k, D).sum(dim=2)


def _ffn(h, lp, cfg):
    """The block's FFN -> (y, aux). MoE layers take the gather form, as the
    reference's `_moe_ffn` does without a mesh (the port has none); a
    dense layer's aux is the constant 0.0, which launches nothing."""
    if cfg.is_moe:
        return _moe_ffn_gather(h, lp, cfg)
    return _dense_ffn(h, lp, cfg), 0.0


def _block(x, lp, cfg, rope_tables, positions=None):
    """One layer -> (x, the router's aux loss)."""
    h = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg)
    x = x + _attention(h, lp, cfg, rope_tables, positions)
    h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg)
    y, aux = _ffn(h, lp, cfg)
    return x + y, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding gather (the reference's one-hot form serves sharded
    tables, which this package does not have yet)."""
    return table[tokens.long()].to(dtype)


def _prologue(params, tokens, cfg, positions=None, rope_tables=None):
    """Shared embed + positional prologue -> (x [B,T,D], rope_tables)."""
    dtype = torch_dtype(cfg.dtype)
    T = tokens.shape[1]
    x = _embed_lookup(params["embed"], tokens, dtype)
    if cfg.positional == "learned":
        pos = positions if positions is not None else torch.arange(T, device=x.device)[None, :]
        return x + params["pos_emb"][pos].to(dtype), None
    if rope_tables is None:
        rope_tables = rope_frequencies(cfg.hdim, cfg.max_seq_len, cfg.rope_theta,
                                       device=x.device)
    return x, rope_tables


def lm_head_weight(params, cfg) -> torch.Tensor:
    """The [D, V] head (the embedding's transpose when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _lm_head(x, params, cfg, head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final norm + head -> f32 logits. `head`: an f32 [D, V] copy a caller
    keeps to avoid casting the head on every call."""
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg)
    if head is None:
        head = lm_head_weight(params, cfg)
    logits = x.float() @ head.float()
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (logits [B, T, V] f32, aux_loss scalar: the routers'
    load-balance loss summed over the layers, 0 for a dense model)."""
    _require_flash(cfg)
    x, rope_tables = _prologue(params, tokens, cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for lp in layer_views(params["layers"]):
        if remat:  # keep only each layer's input; recompute the rest in the backward
            x, layer_aux = checkpoint(_block, x, lp, cfg, rope_tables, positions,
                                      use_reentrant=False)
        else:
            x, layer_aux = _block(x, lp, cfg, rope_tables, positions)
        if cfg.is_moe:  # summed over layers, as the reference's run_layers
            aux = aux + layer_aux
    return _lm_head(x, params, cfg), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            z_loss_coef: float = 1e-4) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B, T], targets [B, T], optional mask [B, T]
    -> (loss, metrics)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    return loss_from_logits(logits, batch["targets"], batch.get("mask"), cfg, aux,
                            z_loss_coef=z_loss_coef)


def loss_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                     mask: Optional[torch.Tensor], cfg: ModelConfig, aux: torch.Tensor,
                     z_loss_coef: float = 1e-4) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy + z-loss (coef * mean lse^2) + the router's aux loss,
    over the tokens the mask keeps, given f32 logits [B, T, V]."""
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = ((lse - true_logit) * mask).sum() / denom
    z_loss = z_loss_coef * (lse * lse * mask).sum() / denom
    total = ce + z_loss + cfg.router_aux_coef * aux
    acc = ((logits.argmax(dim=-1) == targets).float() * mask).sum() / denom
    return total, {"loss": total, "ce_loss": ce, "aux_loss": aux, "z_loss": z_loss,
                   "accuracy": acc, "tokens": mask.sum()}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> Dict[str, torch.Tensor]:
    """A zero contiguous cache {"k", "v"} of [L, batch, max_len, KVH, hd]
    in `dtype` (default the model's) on `device` (the card unless named),
    for decode_step."""
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hdim)
    spec = dict(dtype=torch_dtype(dtype or cfg.dtype), device=resolve_device(device))
    return {"k": torch.zeros(shape, **spec), "v": torch.zeros(shape, **spec)}


def _decode_attention(q, k_cache, v_cache, lengths, cfg):
    """q [B,1,H,hd]; k/v_cache [B,S,KVH,hd]; lengths [B] = #valid keys.
    Plain PyTorch, as the reference's is plain einsums."""
    B, S, KVH, hd = k_cache.shape
    g = cfg.n_heads // KVH
    qf = q[:, 0].reshape(B, KVH, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) * (hd ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -2e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, cfg.n_heads, hd).to(q.dtype)


def decode_step(params: Params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                positions: torch.Tensor, rope_tables=None):
    """One token per sequence over the contiguous cache. tokens [B],
    positions [B] (0-based index of this token). Writes the cache in place
    and returns (logits [B,V] f32, cache)."""
    _require_flash(cfg)
    B = tokens.shape[0]
    pos2d = positions.long()[:, None]
    x, rope_tables = _prologue(params, tokens[:, None], cfg, positions=pos2d,
                               rope_tables=rope_tables)
    rows = torch.arange(B, device=x.device)
    for l, lp in enumerate(layer_views(params["layers"])):
        h = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg)
        q, k, v = _qkv(h, lp, cfg, rope_tables, pos2d)
        cache["k"][l, rows, pos2d[:, 0]] = k[:, 0]
        cache["v"][l, rows, pos2d[:, 0]] = v[:, 0]
        o = _decode_attention(q, cache["k"][l], cache["v"][l], pos2d[:, 0] + 1, cfg)
        x = x + _out_proj(o, lp)
        h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg)
        x = x + _ffn(h, lp, cfg)[0]
    return _lm_head(x[:, 0], params, cfg), cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
            last_index: Optional[torch.Tensor] = None, rope_tables=None,
            head: Optional[torch.Tensor] = None):
    """Run the full prompt, build a contiguous KV cache of size max_len.

    tokens [B, T]. last_index [B] (default T-1) selects the position whose
    logits are returned — pass true_len-1 when prompts are right-padded to
    a bucket. rope_tables / head: precomputed tables and f32 head a caller
    keeps across calls. Returns (last_logits [B,V] f32, cache dict with k/v
    [L, B, max_len, KVH, hd])."""
    _require_flash(cfg)
    dtype = torch_dtype(cfg.dtype)
    B, T = tokens.shape
    x, rope_tables = _prologue(params, tokens, cfg, rope_tables=rope_tables)
    L, KVH, hd = cfg.n_layers, cfg.kv_heads, cfg.hdim
    kc = torch.zeros((L, B, max_len, KVH, hd), dtype=dtype, device=x.device)
    vc = torch.zeros_like(kc)
    for l, lp in enumerate(layer_views(params["layers"])):
        h = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg)
        q, k, v = _qkv(h, lp, cfg, rope_tables)
        x = x + _out_proj(flash_attention(q, k, v, causal=True), lp)
        h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg)
        x = x + _ffn(h, lp, cfg)[0]
        kc[l, :, :T] = k
        vc[l, :, :T] = v
    if last_index is None:
        x_last = x[:, -1].contiguous()  # the norm kernel takes contiguous rows
    else:
        x_last = x[torch.arange(B, device=x.device), last_index.long()]
    return _lm_head(x_last, params, cfg, head), {"k": kc, "v": vc}
