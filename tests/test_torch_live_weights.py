"""Live weight updates (InferenceEngine.update_params, LLMServer.update_weights)
against ray_tpu on the CPU.

The JAX package's tiny-model weights from PRNGKey(0) and PRNGKey(1) go
through both packages as numpy (params_from_numpy for the port's engines).
Both engines serve, both swap to the seed-1 weights, both serve again:
greedy tokens are identical between the packages and identical to fresh
engines built on seed 1, with the same version stamps. The port's swap
copies into the live tensors in place (the captured programs read them at
their addresses), refreshes the f32 head copy, refuses a mismatched tree
before it copies anything, and writes through tensors shared with the
caller, a second engine and the self-speculation draft (a deliberate
difference: the reference rebinds a new tree and mutates nothing).
"""

import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
import ray_tpu_torch
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu_torch import EngineConfig, InferenceEngine, LLMServer, get_config
from ray_tpu_torch.models import params_from_numpy

ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16)
TIMEOUT_S = 120


def _weights(name):
    cfg = jmodels.get_config(name)
    trees = [jax.tree.map(np.asarray, jmodels.init_params(cfg, jax.random.PRNGKey(s)))
             for s in (0, 1)]
    return {"jcfg": cfg, "tcfg": get_config(name), "np": trees}


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-moe"])
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def llama():
    return _weights("tiny-llama")


def _engines(w, seed=0, **kw):
    ecfg = dict(ENGINE_KW, **kw)
    jeng = JInferenceEngine(w["np"][seed], w["jcfg"], JEngineConfig(**ecfg))
    teng = InferenceEngine(params_from_numpy(w["np"][seed], device="cpu"), w["tcfg"],
                           EngineConfig(**ecfg), device="cpu")
    return jeng, teng


def _prompt(cfg, n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, cfg.vocab_size, size=n)]


def _serve(engine, prompts, max_tokens=8):
    return [engine.generate(p, max_tokens=max_tokens, timeout_s=TIMEOUT_S) for p in prompts]


def _checksums(engine):
    return {k: v.clone() for k, v in _flat(engine.params).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_update_matches_reference_and_a_fresh_engine(weights):
    cfg = weights["tcfg"]
    jeng, teng = _engines(weights)
    jfresh, tfresh = _engines(weights, seed=1)
    # a bucketed prompt, one of each bucket and a chunked one (3 chunks)
    before = [_prompt(cfg, n, s) for s, n in ((1, 6), (2, 20), (3, 40))]
    after = [_prompt(cfg, n, s) for s, n in ((4, 9), (5, 27), (6, 37))]
    try:
        for a, b in zip(_serve(jeng, before), _serve(teng, before)):
            assert a["token_ids"] == b["token_ids"]
            assert a["weights_version"] == b["weights_version"] == 0
        assert jeng.update_params(weights["np"][1]) == 1
        assert teng.update_params(weights["np"][1]) == 1
        want = _serve(jfresh, after)
        for engine in (jeng, teng, tfresh):
            got = _serve(engine, after)
            assert [r["token_ids"] for r in got] == [r["token_ids"] for r in want]
        for got, fresh in zip(_serve(teng, after[:1]), _serve(tfresh, after[:1])):
            np.testing.assert_allclose(got["logprobs"], fresh["logprobs"], atol=1e-5)
            assert got["weights_version"] == 1
        assert jeng.stats()["weights_version"] == teng.stats()["weights_version"] == 1
        # an explicit version, and the weights back to seed 0
        assert jeng.update_params(weights["np"][0], version=7) == 7
        assert teng.update_params(weights["np"][0], version=7) == 7
        jres, tres = _serve(jeng, [_prompt(cfg, 11, 7)]), _serve(teng, [_prompt(cfg, 11, 7)])
        assert jres[0]["token_ids"] == tres[0]["token_ids"]
        assert jres[0]["weights_version"] == tres[0]["weights_version"] == 7
        assert teng.stats()["weights_version"] == 7
    finally:
        for engine in (jeng, teng, jfresh, tfresh):
            engine.stop()


def test_stream_in_flight_across_an_update_stays_valid(llama):
    cfg = llama["tcfg"]
    engine = InferenceEngine(params_from_numpy(llama["np"][0], device="cpu"), cfg,
                             EngineConfig(**dict(ENGINE_KW, decode_span=1, adaptive_span=False)),
                             device="cpu")
    try:
        req, stream = engine.open_stream(_prompt(cfg, 10, 1), max_tokens=40,
                                         timeout_s=TIMEOUT_S)
        got = []
        for tok in stream:
            got.append(tok)
            if len(got) == 4:
                assert engine.update_params(llama["np"][1]) == 1
        assert req.error is None and req.finish_reason == "length"
        assert len(got) == 40 and all(0 <= t < cfg.vocab_size for t in got)
        assert req.weights_version == 0  # its first token ran on the old weights
        assert engine.generate(_prompt(cfg, 5, 2), max_tokens=3,
                               timeout_s=TIMEOUT_S)["weights_version"] == 1
    finally:
        engine.stop()


def test_updates_race_a_busy_engine(llama):
    """Four streams decode while eight updates land between their spans;
    a short sleep per span keeps them decoding. Every stream ends with all
    its tokens; every request's stamp is a version that existed."""
    cfg = llama["tcfg"]
    engine = InferenceEngine(params_from_numpy(llama["np"][0], device="cpu"), cfg,
                             EngineConfig(**dict(ENGINE_KW, decode_span=2)), device="cpu")
    span = engine._decode_span

    def slow_span(*args):
        threading.Event().wait(0.002)
        return span(*args)

    engine._decode_span = slow_span
    try:
        streams = [engine.open_stream(_prompt(cfg, 7 + i, i), max_tokens=50,
                                      timeout_s=TIMEOUT_S) for i in range(4)]
        for v in range(1, 9):
            engine.update_params(llama["np"][v % 2], version=v)
        outs = [list(s) for _req, s in streams]
        for (req, _s), out in zip(streams, outs):
            assert req.error is None and len(out) == 50
            assert all(0 <= t < cfg.vocab_size for t in out)
            assert req.weights_version in range(9)
    finally:
        engine.stop()


def test_cached_prefix_keeps_its_pre_update_kv_in_both_packages(llama):
    # the reference's update leaves the prefix cache alone, so a prompt
    # whose leading pages were cached under the old weights reuses their
    # KV after the update; the port keeps that behaviour
    cfg = llama["tcfg"]
    jeng, teng = _engines(llama)
    shared = _prompt(cfg, 32, 1)
    first, second = shared + [3, 4, 5], shared + [9, 8, 7, 6]
    try:
        for engine in (jeng, teng):
            engine.generate(first, max_tokens=4, timeout_s=TIMEOUT_S)
            engine.update_params(llama["np"][1])
        want = jeng.generate(second, max_tokens=8, timeout_s=TIMEOUT_S)
        got = teng.generate(second, max_tokens=8, timeout_s=TIMEOUT_S)
        assert got["token_ids"] == want["token_ids"]
        assert teng.stats()["cached_pages"] >= 4
    finally:
        jeng.stop()
        teng.stop()


def test_self_speculation_across_an_update_matches_reference(llama):
    # the port's self-draft shares the live tensors and drafts with the new
    # weights, the reference's keeps the old tree; greedy commits come from
    # the target's verify in both
    cfg = llama["tcfg"]
    jeng, teng = _engines(llama, speculation={"mode": "draft", "num_speculative_tokens": 3})
    prompts = [_prompt(cfg, n, s) for s, n in ((1, 12), (2, 30))]
    try:
        for a, b in zip(_serve(jeng, prompts[:1], 12), _serve(teng, prompts[:1], 12)):
            assert a["token_ids"] == b["token_ids"]
        jeng.update_params(llama["np"][1])
        teng.update_params(llama["np"][1])
        for a, b in zip(_serve(jeng, prompts, 12), _serve(teng, prompts, 12)):
            assert a["token_ids"] == b["token_ids"]
        assert teng._spec.proposer.model.params is teng.params
    finally:
        jeng.stop()
        teng.stop()


@pytest.mark.parametrize("fault", ["missing_key", "extra_key", "wrong_shape", "not_a_dict"])
def test_mismatched_tree_raises_before_any_copy(llama, fault):
    cfg = llama["tcfg"]
    engine = InferenceEngine(params_from_numpy(llama["np"][0], device="cpu"), cfg,
                             EngineConfig(**ENGINE_KW), device="cpu")
    try:
        want = engine.generate(_prompt(cfg, 9, 1), max_tokens=6, timeout_s=TIMEOUT_S)
        tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in llama["np"][1].items()}
        if fault == "missing_key":
            del tree["layers"]["wq"]
        elif fault == "extra_key":
            tree["layers"]["w_extra"] = tree["layers"]["wq"]
        elif fault == "wrong_shape":
            tree["layers"]["wo"] = tree["layers"]["wo"][:, :1]
        else:
            tree["layers"] = list(tree["layers"].values())
        before = _checksums(engine)
        head = engine._model.head32.clone()
        with pytest.raises(ValueError, match="update_params"):
            engine.update_params(tree)
        for name, t in _flat(engine.params).items():
            assert torch.equal(t, before[name]), name
        assert torch.equal(engine._model.head32, head)
        assert engine.weights_version == 0
        got = engine.generate(_prompt(cfg, 9, 1), max_tokens=6, timeout_s=TIMEOUT_S)
        assert got["token_ids"] == want["token_ids"]
    finally:
        engine.stop()


def test_input_forms_agree(llama):
    """numpy float32, CPU float32 tensors and ml_dtypes bfloat16 arrays give
    the same live weights, cast to the live leaves' dtype (bf16 here)."""
    cfg = llama["tcfg"]
    engine = InferenceEngine(params_from_numpy(llama["np"][0], device="cpu", dtype="bfloat16"),
                             cfg, EngineConfig(**ENGINE_KW), device="cpu")
    new = llama["np"][1]
    forms = {
        "numpy float32": new,
        "CPU tensors": jax.tree.map(torch.tensor, new),
        "ml_dtypes bfloat16": jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), new),
    }
    got = {}
    for name, tree in forms.items():
        engine.update_params(llama["np"][0])
        engine.update_params(tree)
        got[name] = _checksums(engine)
        assert all(t.dtype == torch.bfloat16 for t in got[name].values())
    base = got.pop("numpy float32")
    for name, leaves in got.items():
        for k, t in leaves.items():
            assert torch.equal(t, base[k]), (name, k)
    want = params_from_numpy(new, device="cpu", dtype="bfloat16")
    for k, t in _flat(want).items():
        assert torch.equal(base[k], t), k
    assert torch.equal(engine._model.head32, engine.params["embed"].T.float()
                       if cfg.tie_embeddings else engine.params["lm_head"].float())


def test_updates_write_through_shared_tensors(llama):
    # documented: the engine writes in place into the tensors it was built
    # over, so the caller's tree and a second engine over it see the update
    cfg = llama["tcfg"]
    shared = params_from_numpy(llama["np"][0], device="cpu")
    a = InferenceEngine(shared, cfg, EngineConfig(**ENGINE_KW), device="cpu")
    b = InferenceEngine(shared, cfg, EngineConfig(**ENGINE_KW), device="cpu")
    fresh = InferenceEngine(params_from_numpy(llama["np"][1], device="cpu"), cfg,
                            EngineConfig(**ENGINE_KW), device="cpu")
    try:
        a.update_params(llama["np"][1])
        assert torch.equal(shared["layers"]["wq"], torch.tensor(llama["np"][1]["layers"]["wq"]))
        assert b.params["embed"] is shared["embed"]
        prompt = _prompt(cfg, 13, 3)
        want = fresh.generate(prompt, max_tokens=8, timeout_s=TIMEOUT_S)["token_ids"]
        assert b.generate(prompt, max_tokens=8, timeout_s=TIMEOUT_S)["token_ids"] == want
        assert b.weights_version == 0  # b's own counter did not move
    finally:
        for engine in (a, b, fresh):
            engine.stop()


def test_llm_server_weight_methods(llama):
    cfg = llama["tcfg"]
    kw = dict(ENGINE_KW)
    server = LLMServer._target(params_fn=lambda: (params_from_numpy(llama["np"][0], device="cpu"),
                                                  cfg),
                               engine_config=kw, device="cpu")
    fresh = InferenceEngine(params_from_numpy(llama["np"][1], device="cpu"), cfg,
                            EngineConfig(**kw), device="cpu")
    try:
        assert server.engine.slo_role == "colocated"
        assert server.weights_version() == 0
        prompt = _prompt(cfg, 20, 4)
        server({"prompt_ids": prompt, "max_tokens": 4})
        digest = server.prefix_digest()
        assert digest == server.engine.prefix_digest()
        assert digest["page_size"] == 8 and len(digest["hashes"]) == 2
        assert server.update_weights({"weights": llama["np"][1], "version": 5}) == {
            "weights_version": 5, "role": "colocated"}
        assert server.weights_version() == 5 and server.stats()["weights_version"] == 5
        other = _prompt(cfg, 11, 5)
        got = server({"prompt_ids": other, "max_tokens": 6})
        assert got["weights_version"] == 5
        assert got["token_ids"] == fresh.generate(other, max_tokens=6,
                                                  timeout_s=TIMEOUT_S)["token_ids"]
        # a ref resolves through the port's object plane (ray_tpu_torch.get)
        ray_tpu_torch.init(num_cpus=2, system_config={"worker_processes": 0,
                                                      "actor_processes": False})
        try:
            ref = ray_tpu_torch.put(llama["np"][1])
            assert server.update_weights({"ref": ref, "version": 6, "timeout_s": 30}) == {
                "weights_version": 6, "role": "colocated"}
        finally:
            ray_tpu_torch.shutdown()
        assert server({"prompt_ids": other, "max_tokens": 6})["token_ids"] == got["token_ids"]
        with pytest.raises(ValueError, match="needs 'weights'"):
            server.update_weights({})
        assert server.weights_version() == 6
    finally:
        server.shutdown()
        fresh.stop()


def test_llm_server_speculation_kwarg(llama):
    cfg = llama["tcfg"]

    def params_fn():
        return params_from_numpy(llama["np"][0], device="cpu"), cfg

    spec = {"mode": "ngram", "num_speculative_tokens": 2}
    server = LLMServer._target(params_fn=params_fn, engine_config=dict(ENGINE_KW), device="cpu",
                               speculation=spec)
    try:
        assert server.stats()["spec_mode"] == "ngram"
        out = server({"prompt_ids": [1, 2, 3, 1, 2, 3, 1, 2], "max_tokens": 6})
        assert len(out["token_ids"]) == 6
    finally:
        server.shutdown()
    with pytest.raises(ValueError, match="either as the LLMServer kwarg or inside "
                                         "engine_config, not both"):
        LLMServer._target(params_fn=params_fn, engine_config=dict(ENGINE_KW, speculation=spec),
                          device="cpu", speculation=spec)
