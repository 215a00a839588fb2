"""Language-model training on one device: optimizer, state init, train and
eval steps.

Counterpart of ray_tpu/train/lm.py without the mesh: the JAX package
parallelises one step over a mesh by shardings; this package runs the
same step on one device (the card unless the caller passes
device="cpu"). Meshes and the pipeline trainer are later slices.

The optimizers reproduce the reference's optax chains to float rounding,
updating parameters and their state in place, one leaf at a time, so they
hold no second copy of the model. `AdamW` (the default) is
`clip_by_global_norm(grad_clip)` then `adamw(warmup_cosine_decay_schedule(
0, lr, warmup, total))`, with three properties that torch.optim's defaults
do not share: the schedule starts at 0, so the first update leaves the
parameters unchanged; weight decay applies to every leaf, norms and
embeddings included; the clip scales by max_norm / norm only when the norm
exceeds max_norm, with no epsilon. `Adafactor` (factored=True) is the same
clip then optax's `adafactor` as the reference configures it: factored
second moments, no momentum, no parameter scaling, no weight decay; its
state is a few rows and columns per leaf. Parameters may be bf16 (a caller
casts them after `init_train_state`, as the reference's bench does): the
step then computes its gradients and updates in bf16, as optax does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import init_params, loss_fn
from ..ops.dispatch import resolve_device

TrainState = Dict[str, Any]  # {"step", "params", "opt_state"}
_ADAM_EPS = 1e-8  # optax.adamw's default
# optax.adafactor's defaults, which the reference keeps
_FACTORED_DECAY = 0.8  # the second moments' decay is 1 - (count + 1) ** -0.8
_MIN_DIM_TO_FACTOR = 128
_FACTORED_EPS = 1e-30
_BLOCK_RMS_CLIP = 1.0


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (in sorted key order: a fixed order for
    sums such as the global norm) and lists (in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps)
    as count -> learning rate: linear from 0 over warmup_steps, then a cosine
    to 0 over decay_steps - warmup_steps (> 0), in optax's operation order."""
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.linear_schedule
            return (0.0 - peak) * (1.0 - count / warmup_steps) + peak
        c = min(count - warmup_steps, cos_steps)  # optax.cosine_decay_schedule
        return peak * (0.5 * (1.0 + math.cos(math.pi * c / cos_steps)))

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps=1e-8, weight_decay)), applied in place. opt_state = {"count": number
    of updates so far, "mu": first moments, "nu": second moments}, the
    moments shaped like the parameters (a tree of dicts and lists), in f32.
    At weight decay 0, no clip and a constant schedule it is optax.adam
    (rl.module.adam)."""

    schedule: Any
    b1: float
    b2: float
    weight_decay: float
    grad_clip: Optional[float]

    def init(self, params) -> Dict[str, Any]:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [zeros(v) for v in tree]
            return torch.zeros_like(tree, dtype=torch.float32)

        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def update(self, params, grads, opt_state) -> torch.Tensor:
        """One optimizer step: params and opt_state change in place. grads:
        one tensor per leaf of params, in `_leaves` order; the clip may
        scale them in place. Returns their global norm before the clip."""
        g_leaves = list(grads)
        norm = _clip_by_global_norm(g_leaves, self.grad_clip)
        count = opt_state["count"] + 1
        lr = self.schedule(opt_state["count"])
        bc1, bc2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        for p, g, mu, nu in zip(_leaves(params), g_leaves, _leaves(opt_state["mu"]),
                                _leaves(opt_state["nu"])):
            g = g.float()
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(_ADAM_EPS))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        opt_state["count"] = count
        return norm


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), in
    the tensors' dtype: each leaf's sum accumulates in f32 and is rounded
    to it, then the leaves' sums are added in it (bf16 for bf16 leaves)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _clip_by_global_norm(g_leaves, grad_clip: Optional[float]) -> torch.Tensor:
    """optax.clip_by_global_norm(grad_clip) in place: every leaf becomes
    g / norm * grad_clip when the global norm is not below grad_clip (no
    clip for None/0). Returns the norm before the clip."""
    norm = _global_norm(g_leaves)
    if grad_clip and not bool(norm < grad_clip):  # optax: where(norm < max, g, g / norm * max)
        for g in g_leaves:
            g.div_(norm.to(g.dtype)).mul_(grad_clip)
    return norm


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's rule: the axes of the second largest and the largest dims of
    a leaf of >= 2 dims, when the second largest is >= 128; else None (the
    leaf keeps a full second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """optax.chain(clip_by_global_norm(grad_clip), adafactor(schedule,
    weight_decay_rate=None, multiply_by_parameter_scale=False)), applied in
    place: the clip, then `scale_by_factored_rms(decay_rate=0.8,
    min_dim_size_to_factor=128, epsilon=1e-30)`, `clip_by_block_rms(1.0)`
    and the learning rate. opt_state = {"count", "v_row", "v_col", "v"},
    one entry per leaf in `_leaves` order: a factored leaf (_factored_dims
    (d1, d0)) keeps v_row (its shape without d0) and v_col (without d1), any
    other leaf v (its own shape); the unused entries are None where optax
    keeps a [1] placeholder. The statistics are created in f32 and take the
    parameter's dtype at each update, as optax's do (bf16 from the first
    step with bf16 parameters)."""

    schedule: Any
    grad_clip: Optional[float]

    def init(self, params) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for p in _leaves(params):
            dims = _factored_dims(tuple(p.shape))
            spec = dict(dtype=torch.float32, device=p.device)
            if dims is None:
                state["v_row"].append(None)
                state["v_col"].append(None)
                state["v"].append(torch.zeros(p.shape, **spec))
            else:
                d1, d0 = dims
                state["v_row"].append(torch.zeros(_without(p.shape, d0), **spec))
                state["v_col"].append(torch.zeros(_without(p.shape, d1), **spec))
                state["v"].append(None)
        return state

    @torch.no_grad()
    def update(self, params, grads, opt_state) -> torch.Tensor:
        """One optimizer step, as AdamW.update: params and opt_state change
        in place; returns the gradients' global norm before the clip."""
        g_leaves = list(grads)
        norm = _clip_by_global_norm(g_leaves, self.grad_clip)
        count = opt_state["count"]
        # the decay and its complement in f32, as optax computes them
        decay = np.float32(1.0) - np.float32(count + 1) ** np.float32(-_FACTORED_DECAY)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        lr = self.schedule(count)
        for i, (p, g) in enumerate(zip(_leaves(params), g_leaves)):
            dt = p.dtype
            g = g.to(dt)
            gsq = g * g + _FACTORED_EPS
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                v = (opt_state["v"][i].float() * keep + gsq.float() * take).to(dt)
                u = g * v.pow(-0.5)
                opt_state["v"][i] = v
            else:
                d1, d0 = dims
                vr = opt_state["v_row"][i].float() * keep + gsq.mean(dim=d0).float() * take
                vc = opt_state["v_col"][i].float() * keep + gsq.mean(dim=d1).float() * take
                vr, vc = vr.to(dt), vc.to(dt)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(dim=rd1, keepdim=True)).pow(-0.5)
                u = g * row.unsqueeze(d0) * vc.pow(-0.5).unsqueeze(d1)
                opt_state["v_row"][i], opt_state["v_col"][i] = vr, vc
            # clip_by_block_rms, then the learning rate in the leaf's dtype
            u = u / torch.clamp((u * u).mean().sqrt() / _BLOCK_RMS_CLIP, min=1.0)
            u.mul_(torch.tensor(lr, dtype=dt))
            p.sub_(u)
        opt_state["count"] = count + 1
        return norm


def _without(shape, dim: int) -> Tuple[int, ...]:
    return tuple(n for i, n in enumerate(shape) if i != dim)


def make_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: Optional[float] = 1.0,
    factored: bool = False,
) -> Union[AdamW, Adafactor]:
    """AdamW with global-norm clipping (grad_clip=None/0 drops the clip) and
    a warmup-cosine schedule from 0, as the reference's default.
    factored=True gives Adafactor under the same clip and schedule, as the
    reference's: it runs without momentum and without decay, so b1, b2 and
    weight_decay do not apply."""
    schedule = _warmup_cosine_decay(learning_rate, warmup_steps,
                                    max(total_steps, warmup_steps + 1))
    if factored:
        return Adafactor(schedule, grad_clip=grad_clip)
    return AdamW(schedule, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip)


def init_train_state(cfg: ModelConfig, optimizer, seed: int = 0, device=None,
                     params=None) -> TrainState:
    """{"step": 0, "params", "opt_state"} on `device` (the card unless the
    caller names another; raises without a card). The parameters are f32
    masters that require grad: random from `seed`, or `params` (a tree such
    as params_from_numpy gives) copied to f32 on the device."""
    dev = resolve_device(device)
    copy = params is not None  # never alias the caller's tensors
    if params is None:
        params = init_params(cfg, seed=seed, device=dev, dtype=torch.float32)

    def master(tree):
        if isinstance(tree, dict):
            return {k: master(v) for k, v in tree.items()}
        t = tree.detach().to(device=dev, dtype=torch.float32, copy=copy)
        return t.requires_grad_(True)

    params = master(params)
    return {"step": 0, "params": params, "opt_state": optimizer.init(params)}


def make_train_step(cfg: ModelConfig, optimizer):
    """Returns step(state, batch) -> (state, metrics). The state is updated
    in place and returned. The parameter leaves may be f32 masters or bf16
    tensors a caller cast after init_train_state; the gradients and the
    update take each leaf's dtype. metrics: those of loss_from_logits, grad_norm
    (the global norm before the clip) and step (the count before this
    update), as 0-d tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        leaves = _leaves(params)
        for t in leaves:  # leaves a caller cast after init (`.detach().to(bf16)`)
            if not t.requires_grad:
                t.requires_grad_(True)
        loss, metrics = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = optimizer.update(params, grads, state["opt_state"])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        metrics["step"] = torch.tensor(state["step"])
        state["step"] += 1
        return state, metrics

    return step


def make_eval_step(cfg: ModelConfig):
    """Returns step(params, batch) -> metrics, without gradients."""

    @torch.no_grad()
    def step(params, batch):
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return step


def synthetic_batch(cfg: ModelConfig, batch_size: int, seq_len: int, seed: int = 0,
                    device=None) -> Dict[str, torch.Tensor]:
    """Deterministic fake LM batch {"tokens", "targets"} [B, T] int64 from a
    seeded CPU torch.Generator, moved to `device` (the card unless named).
    Same seed, same tokens on every device; they are not the reference's
    tokens, since torch's and JAX's generators give different bits."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq_len + 1), generator=gen)
    toks = toks.to(dev)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
