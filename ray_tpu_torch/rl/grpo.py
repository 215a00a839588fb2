"""GRPO: group-relative policy optimization for LLM RLHF.

The port's counterpart of ray_tpu/rl/grpo.py. Critic-free policy
gradient: per prompt, sample a group of completions, score with a reward
fn, advantage = group-standardized reward, maximize advantage-weighted
log-likelihood of the sampled tokens with a KL leash to the reference
policy. Rollouts use models.generate (sampling on the device); the
update is one LM step on the port's forward (K1 and K2 with its lse in
the forward, K1's backward, K3 and K4 in the backward on the card).

Three deliberate differences from the reference:
- the trainer owns its parameters: the constructor copies the tree it is
  given into f32 masters on `device` (the card unless named), and the
  optimizers update them in place, so no tree the caller holds (nor an
  engine built over it) moves before the caller syncs;
- the frozen reference policy is a real copy (the reference's
  `jax.tree.map(lambda x: x, params)` binds the same immutable arrays;
  here the in-place updates would train it too);
- train_step samples from a torch.Generator seeded from (seed, iteration)
  through numpy's SeedSequence, where the reference folds the iteration
  into PRNGKey(seed): the same seed draws other tokens in the two
  packages.
`optax.adam(lr)` is module.adam (train.lm's AdamW); `factored=True` is train.lm's Adafactor
at a constant learning rate with no clip (optax.adafactor as the
reference configures it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.logging import get_logger
from ..models import ModelConfig, forward, generate
from ..ops.dispatch import resolve_device
from ..train.lm import Adafactor
from .module import adam, as_tensor, grad_step, tree_map

logger = get_logger("rl.grpo")


@dataclasses.dataclass
class GRPOConfig:
    group_size: int = 8
    max_new_tokens: int = 16
    temperature: float = 1.0
    lr: float = 1e-5
    kl_coef: float = 0.02
    clip_eps: float = 0.2
    seed: int = 0
    # adafactor instead of adam: policy + frozen reference + adam moments
    # is ~4x params of resident f32 — factored second moments keep the
    # optimizer state to a few rows and columns per leaf (same trap notes
    # as train.lm.make_optimizer)
    factored: bool = False


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The sampling generator of one train_step: seeded from (seed,
    iteration) through numpy's SeedSequence, on `device`."""
    state = int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


class GRPO:
    """reward_fn(prompt_ids, completion_ids) -> float. params: an LM tree
    (models.init_params or params_from_numpy), copied."""

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        reward_fn: Callable[[List[int], List[int]], float],
        config: Optional[GRPOConfig] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        dev = self.device
        self.params = tree_map(
            lambda t: as_tensor(t, dev, torch.float32).detach().clone().requires_grad_(True),
            params)
        self.ref_params = tree_map(lambda t: t.detach().clone(), self.params)  # frozen reference
        self.cfg = model_cfg
        self.reward_fn = reward_fn
        self.gcfg = config or GRPOConfig()
        lr = float(self.gcfg.lr)
        if self.gcfg.factored:
            self.optimizer = Adafactor(lambda count: lr, grad_clip=None)
        else:
            self.optimizer = adam(lr)
        self.opt_state = self.optimizer.init(self.params)
        self.iteration = 0

    def _tokens(self, tokens) -> torch.Tensor:
        return as_tensor(tokens, self.device, torch.long)

    def _logp(self, params, tokens: torch.Tensor, prompt_len: int):
        """Per-token logp of the completion segment, tokens [G, T] ->
        (logp [G, T-1], mask [1, T-1] of the completion's targets: the
        reference's, whose sum, the divisor of the losses, counts one
        row's completion)."""
        logits, _ = forward(params, tokens[:, :-1], self.cfg)
        logp = torch.log_softmax(logits, dim=-1)
        lp = torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
        T = tokens.shape[1] - 1
        mask = torch.arange(T, device=tokens.device)[None, :] >= (prompt_len - 1)
        return lp, mask.float()

    def _seq_logp(self, params, tokens, prompt_len: int):
        """_logp without a gradient: the rollout-time and reference logps."""
        with torch.no_grad():
            return self._logp(params, self._tokens(tokens), int(prompt_len))

    def _loss(self, params, batch):
        g = self.gcfg
        lp, mask = self._logp(params, batch["tokens"], batch["prompt_len"])
        adv = batch["advantages"][:, None]  # [G,1]
        denom = torch.clamp(mask.sum(), min=1.0)
        ratio = torch.exp(lp - batch["logp_old"])
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - g.clip_eps, 1 + g.clip_eps) * adv
        pg = -torch.sum(torch.minimum(unclipped, clipped) * mask) / denom
        # k3 KL estimator (Schulman): E[r - 1 - log r], r = ref/cur
        r = torch.exp(batch["logp_ref"] - lp)
        kl = torch.sum((r - 1 - torch.log(r)) * mask) / denom
        return pg + g.kl_coef * kl, {"pg_loss": pg.detach(), "kl": kl.detach()}

    def _update(self, params, opt_state, batch):
        """One GRPO step: params and opt_state change in place and are
        returned, with {"pg_loss", "kl", "loss"} (0-d tensors). batch:
        tokens [G, T], prompt_len, logp_old and logp_ref [G, T-1],
        advantages [G] (numpy or tensors)."""
        dev = self.device
        b = {"tokens": self._tokens(batch["tokens"]), "prompt_len": int(batch["prompt_len"]),
             "logp_old": as_tensor(batch["logp_old"], dev, torch.float32).detach(),
             "logp_ref": as_tensor(batch["logp_ref"], dev, torch.float32).detach(),
             "advantages": as_tensor(batch["advantages"], dev, torch.float32)}
        loss, aux = grad_step(self.optimizer, opt_state, params, self._loss, b)
        aux["loss"] = loss
        return params, opt_state, aux

    def train_step(self, prompt_ids: List[int]) -> Dict[str, Any]:
        g = self.gcfg
        G = g.group_size
        prompt = torch.tensor([list(prompt_ids)] * G, dtype=torch.long, device=self.device)
        gen = step_generator(g.seed, self.iteration, self.device)
        completions = generate(
            self.params, self.cfg, prompt, gen,
            max_new_tokens=g.max_new_tokens, temperature=g.temperature,
        )  # [G, new]
        tokens = torch.cat([prompt, completions], dim=1)
        comp = completions.cpu().numpy()
        rewards = np.asarray([
            self.reward_fn(list(prompt_ids), [int(t) for t in comp[i]])
            for i in range(G)
        ], np.float32)
        adv = (rewards - rewards.mean()) / (rewards.std() + 1e-6)

        plen = len(prompt_ids)
        lp_old, _ = self._seq_logp(self.params, tokens, plen)
        lp_ref, _ = self._seq_logp(self.ref_params, tokens, plen)
        batch = {
            "tokens": tokens,
            "prompt_len": plen,
            "logp_old": lp_old,
            "logp_ref": lp_ref,
            "advantages": adv,
        }
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, batch
        )
        self.iteration += 1
        out = {k: float(v) for k, v in metrics.items()}
        out.update({
            "training_iteration": self.iteration,
            "reward_mean": float(rewards.mean()),
            "reward_std": float(rewards.std()),
        })
        return out
