"""RLModule: the policy/value network (reference: `rllib/core/rl_module/`).

The port's counterpart of ray_tpu/rl/module.py: an MLP with a shared
torso, a categorical policy head and a value head, as a tree of tensors
({"layers": [{"w", "b"}, ...], "pi": {"w", "b"}, "vf": {"w", "b"}}, the
reference's tree), enough for the PPO/IMPALA-style algorithms; swap in
any (params, forward) pair with the same signature for custom models.

The reference draws its initial weights with jax.random, which torch
cannot reproduce: `init_mlp_module` draws the same shapes and scales
from a torch.Generator, and `module_from_numpy` carries a reference tree
across (the learners take it as `params=`). Beside them, the tree
helpers the learners share and `adam`, optax.adam(lr) as train.lm's
AdamW.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.dispatch import resolve_device
from ..train.lm import AdamW
from ..train.lm import _leaves as tree_leaves

__all__ = ["adam", "clone_tree", "init_mlp_module", "mlp_forward", "mlp_forward_np",
           "module_from_numpy", "tree_leaves", "tree_map", "tree_to_numpy"]


def tree_map(fn: Callable[[Any], Any], tree):
    """`tree` with every leaf replaced by fn(leaf), dicts and lists kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def clone_tree(tree):
    """A copy of a tensor tree that shares no storage with it: the
    reference aliases trees freely (`target = params`) because JAX arrays
    are immutable; the optimizers here update in place."""
    return tree_map(lambda t: t.detach().clone(), tree)


def tree_to_numpy(tree):
    """A tree of tensors (or arrays) as float numpy arrays on the host, for
    the rollout actors' numpy forward."""
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t), tree)


def module_from_numpy(tree, device=None):
    """A module tree of numpy arrays (the reference's, through
    jax.tree.map(np.asarray, params)) as float32 tensors on `device` (the
    card unless named), copied: the result shares nothing with `tree`."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), tree)


def _generator(gen: Union[torch.Generator, int, None]) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen or 0))


def init_mlp_module(
    gen: Union[torch.Generator, int],
    obs_size: int,
    num_actions: int,
    hidden: Sequence[int] = (64, 64),
    device=None,
) -> Dict[str, Any]:
    """The reference's shapes and scales (He-normal torso, pi head at 0.01,
    vf head at 1.0, zero biases), drawn on the host from `gen` (a CPU
    torch.Generator, or a seed), then placed on `device` (the card unless
    named)."""
    g = _generator(gen)
    dev = resolve_device(device)
    sizes = [obs_size, *hidden]

    def normal(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    params: Dict[str, Any] = {"layers": []}
    for i in range(len(sizes) - 1):
        params["layers"].append({"w": normal((sizes[i], sizes[i + 1]), (2.0 / sizes[i]) ** 0.5),
                                 "b": torch.zeros(sizes[i + 1], device=dev)})
    params["pi"] = {"w": normal((sizes[-1], num_actions), 0.01),
                    "b": torch.zeros(num_actions, device=dev)}
    params["vf"] = {"w": normal((sizes[-1], 1), 1.0), "b": torch.zeros(1, device=dev)}
    return params


def mlp_forward(params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_size] -> (logits [B, A], value [B])."""
    h = obs
    for layer in params["layers"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def mlp_forward_np(params, obs):
    """Numpy twin of mlp_forward for rollout actors: per-step policy eval
    on the host beats any device dispatch for these sizes (µs vs ms)."""
    h = obs
    for layer in params["layers"]:
        h = np.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def adam(lr: float) -> AdamW:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8), in place: train.lm's
    AdamW at weight decay 0, with no clip and a constant learning rate,
    over a tree of dicts and lists of tensors."""
    lr = float(lr)
    return AdamW(lambda count: lr, b1=0.9, b2=0.999, weight_decay=0.0, grad_clip=None)


def grad_step(optimizer, opt_state, params, loss_fn: Callable, *args) -> Tuple[Any, Any]:
    """loss_fn(params, *args) -> (loss, aux); its gradient with respect to
    every leaf of params (zero for a leaf the loss does not read, such as
    the value head of a Q-network, as jax.grad gives), then one optimizer
    step in place. Returns (loss detached, aux)."""
    leaves = tree_leaves(params)
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    loss, aux = loss_fn(params, *args)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    optimizer.update(params, grads, opt_state)
    return loss.detach(), aux


def as_tensor(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A batch column (numpy, list or tensor) as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    a = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)
