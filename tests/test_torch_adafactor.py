"""ray_tpu_torch.train's Adafactor against optax on the CPU.

The reference's factored optimizer is optax's `adafactor` under its
global-norm clip (ray_tpu/train/lm.py:47-63). The same seeded numpy
parameters and gradients go through both for ten steps, on a tree where
some leaves factor (two dims >= 128, optax's `_factored_dims`) and others
keep a full second moment:
- f32: parameters and statistics within 1e-6 relative + 1e-7 absolute
  (f32 sums in another order; an f32 ulp of a 0.05-sized parameter is
  3.7e-9, and ten steps gather a few);
- bf16 parameters, cast after init as the reference's bench does (the
  statistics start f32 and take bf16 at the first update): without the
  global clip every parameter and statistic is bit-identical; with it,
  one flipped rounding of the bf16 global norm (f32 sums in another
  order) moves every clipped gradient by an ulp, so parameters are held
  within 4 bf16 ulps of their size + 1e-3 (10 steps of lr 1e-2).
Then the port's counterpart of tests/test_train.py:163: the factored
optimizer learns on tiny-llama.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

from ray_tpu.train import lm as jlm
from ray_tpu_torch import get_config
from ray_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from ray_tpu_torch.train import lm as tlm

SHAPES = {  # name -> shape: which factor, which do not
    "embed": (512, 128),           # factored: dims 0 and 1
    "w_in": (2, 4, 128, 256),      # factored: the two largest, not the last two
    "w_out": (2, 4, 256, 128),
    "wq": (2, 128, 4, 32),         # second largest 32 < 128: full
    "ln": (2, 128),                # full
    "final_norm": (128,),          # one dim: full
}
F32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_CLIPPED_TOL = dict(rtol=4 * 2.0 ** -7, atol=1e-3)


def _tree(seed, scale, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*s) * scale).astype(dtype) for k, s in SHAPES.items()}


@pytest.mark.parametrize("shape", list(SHAPES.values()) + [(7, 300, 129), (128, 128, 2)])
def test_factored_dims_match_optax(shape):
    assert tlm._factored_dims(shape) == factorized._factored_dims(shape, True, 128)


def _run(dtype, grad_clip):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    p32 = _tree(0, 0.05)
    jopt = jlm.make_optimizer(1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip,
                              factored=True)
    jstate = jopt.init({k: jnp.asarray(v) for k, v in p32.items()})  # f32 statistics
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in p32.items()}
    topt = make_optimizer(1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip,
                          factored=True)
    tstate = topt.init({k: torch.from_numpy(v) for k, v in p32.items()})
    tparams = {k: torch.from_numpy(v).to(dtype) for k, v in p32.items()}
    for i in range(10):
        g = _tree(100 + i, 0.05)
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.update(tparams, [torch.from_numpy(g[k]).to(dtype) for k in sorted(g)], tstate)
    return jparams, jstate, tparams, tstate


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _factored_state(jstate):
    found = jax.tree.leaves(jstate, is_leaf=lambda s: isinstance(s, factorized.FactoredState))
    return next(s for s in found if isinstance(s, factorized.FactoredState))


@pytest.mark.parametrize("dtype,grad_clip", [(torch.float32, 1.0), (torch.bfloat16, None),
                                             (torch.bfloat16, 1.0)],
                         ids=["f32", "bf16-unclipped", "bf16"])
def test_ten_steps_match_optax(dtype, grad_clip):
    jparams, jstate, tparams, tstate = _run(dtype, grad_clip)
    fs = _factored_state(jstate)
    names = sorted(SHAPES)
    exact = dtype == torch.bfloat16 and grad_clip is None
    tol = F32_TOL if dtype == torch.float32 else BF16_CLIPPED_TOL
    for i, name in enumerate(names):
        got = tparams[name].float().numpy()
        assert tparams[name].dtype == dtype
        if exact:
            np.testing.assert_array_equal(got, _np(jparams[name]), err_msg=name)
        else:
            np.testing.assert_allclose(got, _np(jparams[name]), **tol, err_msg=name)
        factored = tlm._factored_dims(SHAPES[name]) is not None
        assert (tstate["v"][i] is None) == factored
        pairs = ([(tstate["v_row"][i], fs.v_row[name]), (tstate["v_col"][i], fs.v_col[name])]
                 if factored else [(tstate["v"][i], fs.v[name])])
        for mine, theirs in pairs:
            assert mine.shape == theirs.shape and mine.dtype == dtype  # the leaf's dtype
            if exact:
                np.testing.assert_array_equal(mine.float().numpy(), _np(theirs), err_msg=name)
            elif dtype == torch.float32:
                np.testing.assert_allclose(mine.numpy(), _np(theirs), **F32_TOL, err_msg=name)
    assert tstate["count"] == int(fs.count) == 10


def test_state_is_factored_and_small():
    topt = make_optimizer(factored=True)
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    state = topt.init(params)
    held = sum(t.numel() for key in ("v_row", "v_col", "v") for t in state[key] if t is not None)
    # embed 512 + 128, w_in 2*4*128 + 2*4*256 (without dim 3, then 2),
    # w_out the same, the unfactored leaves whole
    want = (512 + 128) + 2 * (2 * 4 * 128 + 2 * 4 * 256) + 2 * 128 * 4 * 32 + 2 * 128 + 128
    assert held == want
    assert all(t.dtype == torch.float32 for key in ("v_row", "v_col", "v")
               for t in state[key] if t is not None)


def test_first_update_leaves_parameters_unchanged():
    """The schedule starts at 0: the first update moves nothing, in bf16 too
    (a zero gradient's update is 0 times a finite scale)."""
    topt = make_optimizer(1e-2, warmup_steps=2, factored=True)
    params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _tree(0, 0.05).items()}
    state = topt.init(params)
    before = {k: v.clone() for k, v in params.items()}
    grads = [torch.from_numpy(v).to(torch.bfloat16) for _, v in sorted(_tree(1, 0.05).items())]
    grads[0].zero_()
    topt.update(params, grads, state)
    for k in params:
        assert torch.equal(params[k], before[k]), k


def test_factored_optimizer_learns():
    """The port's counterpart of tests/test_train.py:163: make_optimizer(
    factored=True), the reference's llama-2b bench recipe, descends on
    tiny-llama under the default schedule (lr 3e-4, warmup 100)."""
    cfg = get_config("tiny-llama")
    opt = make_optimizer(total_steps=60, factored=True)
    state = init_train_state(cfg, opt, device="cpu")
    step = make_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    state, m0 = step(state, batch)
    for _ in range(39):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"]) - 0.3, (float(m0["loss"]), float(m["loss"]))
    assert state["step"] == 40
