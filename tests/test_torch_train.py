"""ray_tpu_torch's training slice against ray_tpu on the CPU.

The same numpy inputs (seeded) go through both packages:
- attention with lse, its gradients and the lse cotangent: the port's
  autograd Function (plain K2/K3/K4 on the CPU) against the JAX package's
  custom VJP with its Pallas kernels forced on in interpret mode
  (RAY_TPU_FORCE_PALLAS=1, as tests/test_ops.py runs them) at T = 256, and
  through its XLA backward at T = 200, which the Pallas kernels refuse;
  tolerance 5e-3 as tests/test_ops.py's gradient checks;
- rms_norm gradients against jax.grad, 1e-4;
- loss_fn metrics and ten AdamW train steps on tiny-llama and tiny-gpt2
  (tied embeddings) from the same weights and batches. The two packages
  sum in other orders in f32, so each step's metrics agree to about 1e-6
  relative; the tolerance is 1e-4 relative (LOSS_TOL), and the final
  parameters 1e-4 relative + 1e-5 absolute (PARAM_TOL): Adam divides by
  sqrt(nu), so an element whose gradient is near zero moves by a rounding-
  sensitive amount, bounded by the learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu import ops as jops
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops import attention as jattention
from ray_tpu.train import lm as jlm
from ray_tpu_torch import get_config, ops as tops
from ray_tpu_torch.models import loss_fn, params_from_numpy
from ray_tpu_torch.ops import attention as tattention
from ray_tpu_torch.train import (
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    synthetic_batch,
)

GRAD_TOL = dict(atol=5e-3, rtol=5e-3)
LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = ("loss", "ce_loss", "z_loss", "accuracy", "grad_norm")


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_PALLAS", "1")


def _np(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _leaf(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _attention_inputs(T, kvh, seed=0):
    H, D = 4, 128
    return (_np(1, T, H, D, seed=seed), _np(1, T, kvh, D, seed=seed + 1),
            _np(1, T, kvh, D, seed=seed + 2), _np(1, T, H, D, seed=seed + 3),
            _np(1, H, T, seed=seed + 4))


ATTN_CASES = [(256, kvh, causal) for kvh in (4, 1) for causal in (True, False)]
ATTN_CASES.append((200, 2, True))  # T % block != 0: the reference's XLA backward


class TestAttention:
    @pytest.mark.parametrize("T,kvh,causal", ATTN_CASES)
    def test_lse_forward_matches_reference(self, pallas, T, kvh, causal):
        q, k, v, _, _ = _attention_inputs(T, kvh)
        jo, jlse = jattention.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                                       jnp.asarray(v), causal=causal)
        to, tlse = tops.flash_attention_with_lse(_leaf(q), _leaf(k), _leaf(v), causal=causal)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("T,kvh,causal", ATTN_CASES)
    def test_grads_match_reference(self, pallas, T, kvh, causal):
        q, k, v, w_o, _ = _attention_inputs(T, kvh, seed=10)

        def jloss(q, k, v):
            return jnp.sum(jops.flash_attention(q, k, v, causal=causal) * w_o)

        want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v))
        tq, tk, tv = _leaf(q, True), _leaf(k, True), _leaf(v, True)
        (tops.flash_attention(tq, tk, tv, causal=causal) * _leaf(w_o)).sum().backward()
        for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)

    @pytest.mark.parametrize("T,kvh,causal", ATTN_CASES)
    def test_lse_cotangent_matches_reference(self, pallas, T, kvh, causal):
        q, k, v, w_o, w_l = _attention_inputs(T, kvh, seed=20)

        def jloss(q, k, v):
            o, lse = jattention.flash_attention_with_lse(q, k, v, causal=causal)
            return jnp.sum(o * w_o) + jnp.sum(lse * w_l)

        want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v))
        tq, tk, tv = _leaf(q, True), _leaf(k, True), _leaf(v, True)
        o, lse = tops.flash_attention_with_lse(tq, tk, tv, causal=causal)
        ((o * _leaf(w_o)).sum() + (lse * _leaf(w_l)).sum()).backward()
        for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)

    def test_plain_backward_matches_autograd_of_mha_reference(self):
        # _bwd_reference is the flash-2 formula; autograd of the O(T^2)
        # reference is an independent route to the same gradients
        q, k, v, w_o, _ = _attention_inputs(40, 2, seed=30)
        tq, tk, tv = _leaf(q, True), _leaf(k, True), _leaf(v, True)
        (tops.mha_reference(tq, tk, tv) * _leaf(w_o)).sum().backward()
        o, lse = tattention._fwd_reference_with_lse(_leaf(q), _leaf(k), _leaf(v))
        got = tattention._bwd_reference(_leaf(q), _leaf(k), _leaf(v), o, lse, _leaf(w_o))
        for g, ref in zip(got, (tq.grad, tk.grad, tv.grad)):
            torch.testing.assert_close(g, ref, atol=1e-5, rtol=1e-5)

    def test_no_grad_path_builds_no_graph(self):
        q, k, v, _, _ = _attention_inputs(16, 2)
        with torch.no_grad():
            o = tops.flash_attention(_leaf(q, True), _leaf(k, True), _leaf(v, True))
        assert o.grad_fn is None
        o = tops.flash_attention(_leaf(q, True), _leaf(k), _leaf(v))
        assert type(o.grad_fn).__name__.startswith("_FlashAttention")


def test_rms_norm_grads_match_reference():
    x, w, gy = _np(6, 128, seed=40), 1.0 + 0.1 * _np(128, seed=41), _np(6, 128, seed=42)
    want = jax.grad(lambda x, w: jnp.sum(jops.rms_norm(x, w, 1e-5) * gy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _leaf(x, True), _leaf(w, True)
    (tops.rms_norm(tx, tw, 1e-5) * _leaf(gy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want[1]), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ train steps


def _batches(cfg, n, B=2, T=24, seed=50):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
        mask = (rng.rand(B, T) > 0.2).astype(np.float32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask})
    return out


def _jax_model(name):
    cfg = jmodels.get_config(name)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_loss_fn_matches_reference(name):
    jcfg, jparams, tparams = _jax_model(name)
    batch = _batches(jcfg, 1)[0]
    _, want = jtransformer.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    _, got = loss_fn(tparams, _torch_batch(batch), get_config(name))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_ten_train_steps_match_reference(name):
    jcfg, jparams, tparams = _jax_model(name)
    jopt = jlm.make_optimizer(1e-2, warmup_steps=3, total_steps=10)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": jparams,
              "opt_state": jopt.init(jparams)}
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt))
    topt = make_optimizer(1e-2, warmup_steps=3, total_steps=10)
    tcfg = get_config(name)
    tstate = init_train_state(tcfg, topt, device="cpu", params=tparams)
    tstep = make_train_step(tcfg, topt)
    before = {k: v.detach().clone() for k, v in tstate["params"]["layers"].items()}
    for i, batch in enumerate(_batches(jcfg, 10)):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **LOSS_TOL,
                                       err_msg=f"step {i} {key}")
        assert int(tm["step"]) == int(jm["step"]) == i
        if i == 0:  # the schedule starts at 0: the first update moves nothing
            for k, v in tstate["params"]["layers"].items():
                assert torch.equal(v.detach(), before[k]), k
    assert tstate["step"] == int(jstate["step"]) == 10
    want = jax.tree.map(np.asarray, jstate["params"])

    def compare(got, ref, path=""):
        if isinstance(ref, dict):
            assert set(got) == set(ref)
            for k in ref:
                compare(got[k], ref[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(got.detach().numpy(), ref, **PARAM_TOL, err_msg=path)

    compare(tstate["params"], want)


def test_remat_gives_the_same_grads():
    tcfg = get_config("tiny-llama")
    batch = _torch_batch(_batches(tcfg, 1)[0])
    grads = []
    for remat in (False, True):
        cfg = tcfg.__class__(**{**tcfg.__dict__, "remat": remat})
        state = init_train_state(cfg, make_optimizer(), device="cpu", seed=1)
        leaves = [state["params"]["embed"], state["params"]["layers"]["wq"],
                  state["params"]["layers"]["ln1"]]
        loss, _ = loss_fn(state["params"], batch, cfg)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_eval_step_and_synthetic_batch():
    cfg = get_config("tiny-llama")
    state = init_train_state(cfg, make_optimizer(), device="cpu")
    batch = synthetic_batch(cfg, 2, 16, seed=3, device="cpu")
    assert torch.equal(batch["tokens"][:, 1:], batch["targets"][:, :-1])
    assert torch.equal(batch["tokens"], synthetic_batch(cfg, 2, 16, seed=3, device="cpu")["tokens"])
    metrics = make_eval_step(cfg)(state["params"], batch)
    assert metrics["loss"].grad_fn is None and metrics["tokens"] == 32
    _, train_metrics = make_train_step(cfg, make_optimizer())(state, batch)
    torch.testing.assert_close(train_metrics["loss"], metrics["loss"])


def test_factored_optimizer_is_adafactor():
    """factored=True gives the reference's adafactor under the same clip
    and schedule (tests/test_torch_adafactor.py holds it against optax)."""
    from ray_tpu_torch.train.lm import Adafactor

    opt = make_optimizer(1e-2, warmup_steps=3, total_steps=10, grad_clip=0.5, factored=True)
    assert isinstance(opt, Adafactor) and opt.grad_clip == 0.5
    ref = make_optimizer(1e-2, warmup_steps=3, total_steps=10)
    assert [opt.schedule(i) for i in range(12)] == [ref.schedule(i) for i in range(12)]


def test_init_train_state_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(get_config("tiny-llama"), make_optimizer())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batch(get_config("tiny-llama"), 1, 4)
