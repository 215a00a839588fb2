"""ray_tpu_torch's mixture-of-experts path against ray_tpu on the CPU.

The same numpy inputs (seeded) and the JAX package's tiny-moe weights
(through params_from_numpy) go through both packages; the reference runs
without a mesh, so its `_moe_ffn` takes the gather form, as the port's
does. Tolerances:
- routing (top-k ids, slots, keep masks, capacity) is exact; gate weights,
  dispatch/combine masks and the load-balance loss are f32 within 1e-6;
- the FFN forms, forward logits, prefill/decode logits and caches are f32
  sums in another order: 1e-4 (LOGIT_TOL, as tests/test_torch_serve.py);
- gradients against jax.grad: 1e-4 relative + 1e-6 absolute;
- the engines: greedy tokens identical, logprobs within 1e-4;
- ten factored (adafactor) train steps with bf16 parameters (f32 compute,
  as tiny-moe's dtype is): loss and ce_loss within 2e-3 relative, the
  router's aux loss 5e-2, and per leaf the final parameters' L2 gap at
  most 0.15 of the distance the reference's moved (MOVE_TOL). Both
  packages round every bf16 update the same way (tests/
  test_torch_adafactor.py holds them bit-identical without the clip);
  what differs is the order of the f32 sums behind the bf16 global norm,
  and one flipped rounding there moves every clipped gradient by an ulp,
  after which adafactor's normalised steps let the trajectories drift
  (measured: 0.005-0.091 of the distance moved, loss gaps <= 1e-3).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu.models import transformer as jtransformer
from ray_tpu.parallel import moe as jmoe
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu.train import lm as jlm
from ray_tpu_torch import EngineConfig, InferenceEngine, get_config
from ray_tpu_torch.models import (
    decode_step,
    forward,
    generate,
    init_kv_cache,
    init_params,
    loss_fn,
    params_from_numpy,
    prefill,
)
from ray_tpu_torch.models import transformer as ttransformer
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.serve.spec_decode import SpecDecoder
from ray_tpu_torch.train import init_train_state, make_optimizer, make_train_step

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
EXACT_F32 = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
MOVE_TOL = 0.15
TIMEOUT_S = 120
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16)
PROMPTS = [[5, 6, 7, 8, 9, 10], list(range(3, 15)), [(i * 7) % 60 + 1 for i in range(40)],
           [1, 2, 3, 4] * 5]
# tiny-moe widened so that some leaves have two dims >= 128 and adafactor
# factors them (tiny-moe's d_model 64 factors nothing)
WIDE = dict(d_model=128, d_ff=256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(**overrides):
    jcfg = jmodels.get_config("tiny-moe", **overrides)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("tiny-moe", **overrides), tparams


@pytest.fixture(scope="module")
def tiny_moe():
    return _both()


def _layer0(jparams, tparams):
    return (jax.tree.map(lambda a: a[0], jparams["layers"]),
            {k: v[0] for k, v in tparams["layers"].items()})


def _hidden(B, T, D, seed=1):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


# ------------------------------------------------------ parallel/moe.py


def test_top_k_gating_matches_reference_with_ties():
    logits = np.random.RandomState(0).randn(32, 8).astype(np.float32)
    logits[3] = 0.5                       # every expert tied
    logits[4, [1, 6]] = logits[4].max() + 1.0  # a tie for the first place
    for k in (1, 2, 3):
        w_want, id_want = jmoe.top_k_gating(jnp.asarray(logits), k)
        w_got, id_got = tmoe.top_k_gating(_t(logits), k)
        np.testing.assert_array_equal(id_got.numpy(), np.asarray(id_want))
        np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want), **EXACT_F32)
    assert id_got[3].tolist() == [0, 1, 2] and id_got[4, :2].tolist() == [1, 6]


@pytest.mark.parametrize("capacity", [4, 48])
def test_dispatch_mask_matches_reference(capacity):
    rs = np.random.RandomState(1)
    logits = rs.randn(24, 4).astype(np.float32)
    w, ids = jmoe.top_k_gating(jnp.asarray(logits), 2)
    d_want, c_want = jmoe._dispatch_mask(ids, w, 4, capacity)
    d_got, c_got = tmoe._dispatch_mask(_t(np.asarray(ids)).long(), _t(np.asarray(w)), 4,
                                       capacity)
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want, np.float32))
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_want), **EXACT_F32)
    kept = float(d_got.sum())
    assert (kept < 24 * 2) == (capacity == 4), kept  # 48 assignments: 4 slots drop some


def test_aux_load_balance_loss_matches_reference():
    rs = np.random.RandomState(2)
    logits = rs.randn(40, 8).astype(np.float32)
    ids = np.asarray(jmoe.top_k_gating(jnp.asarray(logits), 2)[1])
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids), 8)
    got = tmoe.aux_load_balance_loss(_t(logits), _t(ids).long(), 8)
    np.testing.assert_allclose(float(got), float(want), **EXACT_F32)


# ------------------------------------------------ models/transformer.py


@pytest.mark.parametrize("T", [1, 5, 40])
def test_moe_route_matches_reference(tiny_moe, T):
    jcfg, jparams, tcfg, tparams = tiny_moe
    jlp, tlp = _layer0(jparams, tparams)
    x = _hidden(3, T, jcfg.d_model)
    want = jtransformer._moe_route(jnp.asarray(x), jlp["router"], jcfg)
    got = ttransformer._moe_route(_t(x), tlp["router"], tcfg)
    assert got[-1] == want[-1]  # capacity
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **EXACT_F32)  # logits
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **EXACT_F32)  # weights
    for g, w in zip(got[2:6], want[2:6]):  # expert ids, flat ids, slots, keep
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if T == 40:  # capacity 28 of 80 assignments over 4 experts: some drop
        assert not bool(got[5].all())
    if T == 1:  # decode: capacity T * k, nothing drops
        assert got[-1] == 2 and bool(got[5].all())


@pytest.mark.parametrize("form", ["_moe_ffn_gather", "_moe_ffn_dense"])
def test_moe_ffn_forms_match_reference_with_drops(tiny_moe, form):
    jcfg, jparams, tcfg, tparams = tiny_moe
    jlp, tlp = _layer0(jparams, tparams)
    x = _hidden(2, 40, jcfg.d_model)
    y_want, aux_want = getattr(jtransformer, form)(jnp.asarray(x), jlp, jcfg)
    y_got, aux_got = getattr(ttransformer, form)(_t(x), tlp, tcfg)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux_got), float(aux_want), **EXACT_F32)
    keep = ttransformer._moe_route(_t(x), tlp["router"], tcfg)[5]
    assert not bool(keep.all()), "the case must drop tokens"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gather_equals_dense_in_the_port(tiny_moe, dtype):
    _jcfg, _jparams, tcfg, tparams = tiny_moe
    tlp = {k: v[1].to(dtype) for k, v in tparams["layers"].items()}
    x = _t(_hidden(3, 40, tcfg.d_model, seed=5)).to(dtype)
    y_g, aux_g = ttransformer._moe_ffn_gather(x, tlp, tcfg)
    y_d, aux_d = ttransformer._moe_ffn_dense(x, tlp, tcfg)
    # f32: the same products summed in another order; bf16: the dense
    # form's einsum also rounds the dispatched rows' products
    tol = dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(y_g, y_d, **tol)
    assert float(aux_g) == float(aux_d)


def test_init_params_moe_layout_and_params_from_numpy(tiny_moe):
    jcfg, jparams, tcfg, tparams = tiny_moe
    ours = init_params(tcfg, seed=0, device="cpu", dtype="bfloat16")
    ref = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == ref
    L, E, D, F = tcfg.n_layers, tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert ours["layers"]["w_in"].shape == (L, E, D, F)
    assert ours["layers"]["w_out"].shape == (L, E, F, D)
    assert ours["layers"]["router"].dtype == torch.bfloat16
    for name in ("router", "w_in", "w_gate", "w_out"):  # carried without change
        np.testing.assert_array_equal(tparams["layers"][name].numpy(),
                                      np.asarray(jparams["layers"][name]))


def test_forward_loss_and_grads_match_reference(tiny_moe):
    jcfg, jparams, tcfg, tparams = tiny_moe
    rs = np.random.RandomState(3)
    toks = rs.randint(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, waux = jtransformer.forward(jparams, jnp.asarray(batch["tokens"]), jcfg)
    got, gaux = forward(tparams, _t(batch["tokens"]), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **EXACT_F32)
    assert float(gaux) > 0

    def jloss(p):
        return jtransformer.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg)

    (_, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams["layers"].items()}
    params = dict(tparams, layers=leaves)
    loss, tm = loss_fn(params, {k: _t(v) for k, v in batch.items()}, tcfg)
    for key in jm:
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads["layers"][n]), **GRAD_TOL,
                                   err_msg=n)
    assert float(grads[names.index("router")].abs().max()) > 0


def _unrolled_reference_forward(params, tokens, cfg):
    """The reference's forward with its layer scan unrolled into a Python
    loop of its own `_block`s (the same math; each layer's routing is then a
    call of its own)."""
    x, rope_tables = jtransformer._prologue(params, tokens, cfg)
    aux = jnp.zeros((), jnp.float32)
    for layer in range(cfg.n_layers):
        x, layer_aux = jtransformer._block(
            x, jax.tree.map(lambda a: a[layer], params["layers"]), cfg, rope_tables, None)
        aux = aux + layer_aux
    return jtransformer._lm_head(x, params, cfg), aux


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bf16_compute_grads_match_reference_on_one_routing(monkeypatch, param_dtype):
    # tiny-moe computing in bf16, as moe-1b does, with f32 masters or with
    # parameters cast to bf16 (the bench recipe). The two packages round at
    # other places, and in bf16 that can flip a near-tied top-k choice and
    # open a gap no fault made, so the reference routes each layer on the
    # expert ids the port chose (its gate weights softmaxed over its own
    # logits at those ids, as top-k gives them where the ids agree).
    # Tolerances: the loss and metrics within 2e-2 relative; per leaf, the
    # relative L2 gap of the gradients within 2e-2 (bf16 rounding of
    # activations, ~4e-3 relative, summed differently).
    jcfg, jparams, tcfg, tparams = _both(dtype="bfloat16")
    if param_dtype == "bfloat16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        tparams = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()} if isinstance(v, dict)
                       else v.to(torch.bfloat16)) for k, v in tparams.items()}
    rs = np.random.RandomState(5)
    toks = rs.randint(0, jcfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    chosen = []

    def recording(logits, k):
        w, ids = tmoe.top_k_gating(logits, k)
        chosen.append(ids)
        return w, ids

    monkeypatch.setattr(ttransformer, "top_k_gating", recording)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams["layers"].items()}
    top = {k: v.clone().requires_grad_(True) for k, v in tparams.items() if k != "layers"}
    loss, tm = loss_fn(dict(top, layers=leaves), {k: _t(v) for k, v in batch.items()}, tcfg)
    names = sorted(top) + sorted(leaves)
    grads = torch.autograd.grad(loss, [top[n] for n in sorted(top)]
                                + [leaves[n] for n in sorted(leaves)])
    assert len(chosen) == tcfg.n_layers

    replay = iter([jnp.asarray(ids.numpy().astype(np.int32)) for ids in chosen])

    def replayed(logits, k):
        ids = next(replay)
        return jax.nn.softmax(jnp.take_along_axis(logits, ids, axis=-1), axis=-1), ids

    monkeypatch.setattr(jtransformer, "top_k_gating", replayed)

    def jloss(p):
        return jtransformer.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                                    forward_fn=_unrolled_reference_forward)

    (_, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    assert next(replay, None) is None  # the reference routed every layer once
    for key in ("loss", "ce_loss", "aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]), rtol=2e-2,
                                   err_msg=key)
    want = [jgrads[n] for n in sorted(top)] + [jgrads["layers"][n] for n in sorted(leaves)]
    for n, g, w in zip(names, grads, want):
        assert str(g.dtype) == f"torch.{param_dtype}", n
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.abs(w).max() > 0, n
        gap = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert gap <= 2e-2, (n, gap)


def test_remat_counts_the_aux_once_per_layer(tiny_moe):
    _jcfg, _jparams, tcfg, tparams = tiny_moe
    toks = _t(np.random.RandomState(4).randint(0, tcfg.vocab_size, (2, 25)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = {k: v.clone().requires_grad_(True) for k, v in tparams["layers"].items()}
        loss, m = loss_fn(dict(tparams, layers=leaves), batch, cfg)
        out.append((float(loss), float(m["aux_loss"]),
                    torch.autograd.grad(loss, [leaves["router"], leaves["w_in"]])))
    assert out[0][:2] == pytest.approx(out[1][:2], rel=1e-6)
    for a, b in zip(out[0][2], out[1][2]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)


def test_prefill_decode_step_and_generate_match_reference(tiny_moe):
    from ray_tpu.models.generate import generate as jgenerate

    jcfg, jparams, tcfg, tparams = tiny_moe
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    last = np.array([20, 9], np.int32)  # a right-padded row
    want_l, jcache = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks), 32, jnp.asarray(last))
    got_l, tcache = prefill(tparams, tcfg, _t(toks), 32, _t(last))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LOGIT_TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **LOGIT_TOL)
    # decode on a cache built the reference's way
    jc = jmodels.init_kv_cache(jcfg, 2, 32)
    tc = init_kv_cache(tcfg, 2, 32, device="cpu")
    assert tc["k"].shape == jc["k"].shape and tc["k"].dtype == torch.float32
    tc = {"k": tcache["k"].clone(), "v": tcache["v"].clone()}
    jc = jcache
    nxt, pos = np.array([5, 11], np.int32), np.array([21, 10], np.int32)
    for _ in range(3):
        want, jc = jtransformer.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
        got, tc = decode_step(tparams, tcfg, tc, _t(nxt), _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        nxt, pos = np.asarray(want).argmax(-1).astype(np.int32), pos + 1
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(toks), jax.random.PRNGKey(0),
                                max_new_tokens=10))
    got = generate(tparams, tcfg, _t(toks), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- the engines


def _serve(engine, concurrent):
    try:
        if not concurrent:
            return [engine.generate(p, max_tokens=10, timeout_s=TIMEOUT_S) for p in PROMPTS]
        results = [None] * len(PROMPTS)

        def work(i):
            results[i] = engine.generate(PROMPTS[i], max_tokens=10, timeout_s=TIMEOUT_S)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in threads), "a request did not finish"
        return results
    finally:
        engine.stop()


# name -> (EngineConfig overrides, submit concurrently). The prompts take
# bucket 16, bucket 16, chunked prefill (40 tokens in chunks of 16) and
# bucket 32; each engine routes each prefill at its bucket, decode at
# [B, 1], chunks at [1, 16] and verify spans at [B, S], so capacity drops
# the same tokens in both.
ENGINE_CASES = {
    "plain": ({}, False),
    "batched_prefill": (dict(prefill_batch_size=4), True),
    "ngram": (dict(speculation={"mode": "ngram", "num_speculative_tokens": 3}), False),
    "draft_self": (dict(speculation={"mode": "draft", "num_speculative_tokens": 3}), False),
    "draft_distinct": (dict(speculation={"mode": "draft", "num_speculative_tokens": 3,
                                         "draft_model": "tiny-moe",
                                         "draft_model_overrides": {"n_layers": 1}}), False),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_reference_engine(tiny_moe, monkeypatch, case):
    jcfg, jparams, tcfg, tparams = tiny_moe
    engine_kw, concurrent = ENGINE_CASES[case]
    kw = dict(ENGINE_KW, **engine_kw)
    # The span picker chooses the verify width S from its cost model, and
    # for MoE S sets the verify's capacity, so the committed tokens follow
    # it. The port's alpha (60, fitted to the H100's graphs) picks other
    # widths than the reference's (1.0): use the reference's here.
    monkeypatch.setattr(SpecDecoder, "_SPAN_ALPHA", 1.0)
    jdraft = tdraft = None
    spec = kw.get("speculation") or {}
    if spec.get("draft_model"):
        dcfg = jmodels.get_config(spec["draft_model"], **spec["draft_model_overrides"])
        jdraft = jmodels.init_params(dcfg, jax.random.PRNGKey(1))
        tdraft = params_from_numpy(jax.tree.map(np.asarray, jdraft), device="cpu")
    jeng = JInferenceEngine(jparams, jcfg, JEngineConfig(**kw), draft_params=jdraft)
    wants = _serve(jeng, concurrent)
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**kw), device="cpu", draft_params=tdraft)
    gots = _serve(teng, concurrent)
    for prompt, want, got in zip(PROMPTS, wants, gots):
        assert got["token_ids"] == want["token_ids"], (case, prompt)
        assert got["finish_reason"] == want["finish_reason"] == "length"
        if not spec:
            np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=1e-4)


# ------------------------------------------------------------- training


def _bf16(state):
    """The reference bench's cast after init: f32 leaves to bf16."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.detach().to(torch.bfloat16) if tree.dtype == torch.float32 else tree

    state["params"] = cast(state["params"])
    return state


@pytest.mark.parametrize("overrides", [{}, WIDE], ids=["tiny-moe", "tiny-moe-wide"])
def test_ten_factored_bf16_train_steps_match_reference(overrides):
    jcfg, jparams, tcfg, tparams = _both(**overrides)
    jopt = jlm.make_optimizer(1e-2, warmup_steps=3, total_steps=10, factored=True)
    jstate = {"step": jnp.zeros((), jnp.int32), "opt_state": jopt.init(jparams),
              "params": jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)}
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt))
    topt = make_optimizer(1e-2, warmup_steps=3, total_steps=10, factored=True)
    tstate = _bf16(init_train_state(tcfg, topt, device="cpu", params=tparams))
    tstep = make_train_step(tcfg, topt)
    rs = np.random.RandomState(7)
    for i in range(10):
        toks = rs.randint(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        before = [t.detach().clone() for t in jax.tree.leaves(tstate["params"])]
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        for key, rtol in (("loss", 2e-3), ("ce_loss", 2e-3), ("aux_loss", 5e-2)):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol,
                                       err_msg=f"step {i} {key}")
        if i == 0:  # learning rate 0: nothing moves
            for a, b in zip(jax.tree.leaves(tstate["params"]), before):
                assert torch.equal(a.detach(), b)
    got = jax.tree.leaves(tstate["params"])
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(jstate["params"])]
    start = [np.asarray(w, np.float32) for w in jax.tree.leaves(jparams)]
    assert all(t.dtype == torch.bfloat16 for t in got)
    for g, w, w0 in zip(got, want, start):
        gap = np.linalg.norm(g.detach().float().numpy() - w) / np.linalg.norm(w - w0)
        assert gap <= MOVE_TOL, (tuple(g.shape), gap)
    opt = tstate["opt_state"]
    factored = [v for v in opt["v_row"] if v is not None]
    assert bool(factored) == bool(overrides)  # the wide variant factors some leaves
    full = [v for v in opt["v"] if v is not None]
    assert all(v.dtype == torch.bfloat16 for v in factored + full)
