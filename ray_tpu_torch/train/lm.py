"""Language-model training on one device: optimizer, state init, train and
eval steps.

Counterpart of ray_tpu/train/lm.py without the mesh: the JAX package
parallelises one step over a mesh by shardings; this package runs the
same step on one device (the card unless the caller passes
device="cpu"). Meshes and the pipeline trainer are later slices.

The optimizer reproduces the reference's optax chain
`clip_by_global_norm(grad_clip)` then `adamw(warmup_cosine_decay_schedule(
0, lr, warmup, total))` to float rounding, with three properties that
torch.optim's defaults do not share: the schedule starts at 0, so the first
update leaves the parameters unchanged; weight decay applies to every leaf,
norms and embeddings included; the clip scales by max_norm / norm only when
the norm exceeds max_norm, with no epsilon. It updates parameters and
moments in place, one leaf at a time, so it holds no second copy of the
model beyond its two moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from ..models.config import ModelConfig
from ..models.transformer import init_params, loss_fn
from ..ops.dispatch import resolve_device

TrainState = Dict[str, Any]  # {"step", "params", "opt_state"}
_ADAM_EPS = 1e-8  # optax.adamw's default


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order (a fixed order for
    sums such as the global norm)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
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
    moments shaped like the parameters, in f32."""

    schedule: Any
    b1: float
    b2: float
    weight_decay: float
    grad_clip: Optional[float]

    def init(self, params) -> Dict[str, Any]:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, dtype=torch.float32)

        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def update(self, params, grads, opt_state) -> torch.Tensor:
        """One optimizer step: params and opt_state change in place. grads:
        one tensor per leaf of params, in `_leaves` order; the clip may
        scale them in place. Returns their global norm before the clip."""
        g_leaves = list(grads)
        norm = _global_norm(g_leaves)
        if self.grad_clip:
            if not bool(norm < self.grad_clip):  # optax: where(norm < max, g, g / norm * max)
                for g in g_leaves:
                    g.div_(norm).mul_(self.grad_clip)
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
    """sqrt of the sum of squares of every element (optax.global_norm), f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def make_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: Optional[float] = 1.0,
    factored: bool = False,
) -> AdamW:
    """AdamW with global-norm clipping (grad_clip=None/0 drops the clip) and
    a warmup-cosine schedule from 0, as the reference's default. The
    reference's factored=True (adafactor) is not ported yet and raises."""
    if factored:
        raise NotImplementedError("make_optimizer(factored=True): adafactor is not ported yet")
    schedule = _warmup_cosine_decay(learning_rate, warmup_steps,
                                    max(total_steps, warmup_steps + 1))
    return AdamW(schedule, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip)


def init_train_state(cfg: ModelConfig, optimizer: AdamW, seed: int = 0, device=None,
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


def make_train_step(cfg: ModelConfig, optimizer: AdamW):
    """Returns step(state, batch) -> (state, metrics). The state is updated
    in place and returned. metrics: those of loss_from_logits, grad_norm
    (the global norm before the clip) and step (the count before this
    update), as 0-d tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        loss, metrics = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, _leaves(params))
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
