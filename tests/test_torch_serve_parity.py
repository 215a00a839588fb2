"""The port's engine against the reference engine on engine options that
tests/test_torch_serve.py does not reach, on the CPU.

Each case runs the same tiny-llama weights (the JAX package's, through
params_from_numpy) through both engines with one EngineConfig and asks
for greedy outputs: tokens must be identical, logprobs within 1e-4 (f32,
sums in another order) and finish reasons the same. The cases: batched
prefill with concurrent submissions, no chunked prefill and no prefix
cache, one-step decode spans, an eos token, a flat stop list, and a
logits soft cap (whose forward logits are compared too). Every engine
call has a timeout and every engine is stopped in a finally.
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
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu_torch import EngineConfig, InferenceEngine, get_config
from ray_tpu_torch.models import forward, params_from_numpy

LOGPROB_TOL = dict(atol=1e-4, rtol=0)
TIMEOUT_S = 120
MAX_TOKENS = 8
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16)
# within the largest prefill bucket (32), so every case can take them;
# the third is longer than prefill_chunk and prefills in two chunks where
# chunking is on
PROMPTS = [[5, 6, 7, 8, 9, 10], list(range(3, 15)), [(i * 7) % 60 + 1 for i in range(30)],
           [9, 1, 3]]

# name -> (EngineConfig overrides, ModelConfig overrides, submit concurrently)
CASES = {
    "batched_prefill_concurrent": (dict(prefill_batch_size=4), {}, True),
    "no_chunked_prefill_no_prefix_cache": (dict(chunked_prefill=False,
                                                prefix_caching=False), {}, False),
    "one_step_spans": (dict(decode_span=1, adaptive_span=False), {}, False),
    "eos_token_id": ({}, {}, False),      # the eos token is taken from a plain run
    "flat_stop_list": ({}, {}, False),    # so are the stop tokens
    "logits_softcap": ({}, dict(logits_softcap=5.0), False),
}


@pytest.fixture(scope="module")
def weights():
    cfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, get_config("tiny-llama"), tparams


@pytest.fixture(scope="module")
def plain_outputs(weights):
    """The reference engine's greedy tokens for PROMPTS under ENGINE_KW."""
    jcfg, jparams, _tcfg, _tparams = weights
    eng = JInferenceEngine(jparams, jcfg, JEngineConfig(**ENGINE_KW))
    try:
        return [eng.generate(p, max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)["token_ids"]
                for p in PROMPTS]
    finally:
        eng.stop()


def _run(engine, request_kw, concurrent):
    if not concurrent:
        return [engine.generate(p, max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S, **request_kw)
                for p in PROMPTS]
    results = [None] * len(PROMPTS)

    def work(i):
        results[i] = engine.generate(PROMPTS[i], max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S,
                                     **request_kw)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a request did not finish"
    return results


@pytest.mark.parametrize("case", list(CASES))
def test_engine_option_matches_reference_engine(weights, plain_outputs, case):
    jcfg, jparams, tcfg, tparams = weights
    engine_kw, model_kw, concurrent = CASES[case]
    engine_kw, request_kw = dict(ENGINE_KW, **engine_kw), {}
    if case == "eos_token_id":  # a token of the first prompt's unstopped output
        engine_kw["eos_token_id"] = plain_outputs[0][3]
    if case == "flat_stop_list":  # flat: one single-token stop per id
        request_kw["stop"] = [plain_outputs[1][2], plain_outputs[2][5]]
    jcfg, tcfg = dataclasses.replace(jcfg, **model_kw), dataclasses.replace(tcfg, **model_kw)
    if model_kw:  # the forward logits under the changed model first
        toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
        want, _ = jtransformer.forward(jparams, jnp.asarray(toks), jcfg)
        got, _ = forward(tparams, torch.from_numpy(toks), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    jeng = JInferenceEngine(jparams, jcfg, JEngineConfig(**engine_kw))
    teng = None
    try:
        teng = InferenceEngine(tparams, tcfg, EngineConfig(**engine_kw), device="cpu")
        wants = _run(jeng, request_kw, concurrent)
        gots = _run(teng, request_kw, concurrent)
    finally:
        if teng is not None:
            teng.stop()
        jeng.stop()
    for prompt, want, got in zip(PROMPTS, wants, gots):
        assert got["token_ids"] == want["token_ids"], (case, prompt)
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], **LOGPROB_TOL)
        assert got["finish_reason"] == want["finish_reason"], (case, prompt)
    reasons = [w["finish_reason"] for w in wants]
    if case in ("eos_token_id", "flat_stop_list"):  # the option must have acted
        assert any(r != "length" for r in reasons), reasons
    else:
        assert reasons == ["length"] * len(PROMPTS)
