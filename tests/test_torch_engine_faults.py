"""The port's engine under faults, on the CPU: a prompt token id outside the
vocabulary, and an exception in a step of the decode thread.

A prompt id outside [0, vocab_size), too large or negative, fails its
request alone with a ValueError at admission (add_request, and for an
import begin_kv_import): its batch-mates in a batched prefill, or beside a
chunked prompt, stay token-identical to the reference engine, no page
stays taken, and the engine serves the next request. This is a deliberate
difference from the reference, which clamps such an id (JAX's gather) and
serves the request from row V-1.

A step exception on the decode thread fails every live request and leaves
nothing behind: no chunk queued, no prefill awaiting install, no slot
taken, no import staged, every page free; the next request restarts the
threads and is served as by a clean engine.
"""

import threading
import uuid

import jax
import numpy as np
import pytest

import ray_tpu.models as jmodels
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu_torch import EngineConfig, InferenceEngine, get_config
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve.engine import Request

TIMEOUT_S = 120
MAX_TOKENS = 8
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16, prefill_batch_size=4)
# batch-mates of the bad prompt: two bucketed, one chunked (40 tokens)
GOOD = [[5, 6, 7, 8, 9, 10], list(range(3, 15)), [(i * 7) % 60 + 1 for i in range(40)]]
BAD_IDS = {"past_the_vocabulary": 512, "negative": -1}  # tiny-llama: V = 512


@pytest.fixture(scope="module")
def weights():
    jcfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("tiny-llama"), tparams


def _reference(weights, prompts, **kw):
    """The reference engine's greedy tokens for `prompts`, one at a time."""
    jcfg, jparams, _tcfg, _tparams = weights
    eng = JInferenceEngine(jparams, jcfg, JEngineConfig(**dict(ENGINE_KW, **kw)))
    try:
        return [eng.generate(p, max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)["token_ids"]
                for p in prompts]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def reference_outputs(weights):
    return _reference(weights, GOOD)


def _concurrently(engine, prompts):
    """-> per prompt its generate() result or the exception it raised."""
    out = [None] * len(prompts)

    def run(i):
        try:
            out[i] = engine.generate(prompts[i], max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 — the test reads it
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a request did not finish"
    return out


def _engine(weights, **kw):
    _jcfg, _jparams, tcfg, tparams = weights
    return InferenceEngine(tparams, tcfg, EngineConfig(**dict(ENGINE_KW, **kw)), device="cpu")


def _all_free(engine) -> int:
    return engine.ecfg.max_pages - 1


@pytest.mark.parametrize("where", ["batched_prefill", "end_of_chunked_prompt"])
@pytest.mark.parametrize("bad", list(BAD_IDS))
def test_out_of_vocabulary_prompt_fails_alone(weights, reference_outputs, where, bad):
    """The bad prompt goes in at once with three good ones (batched
    prefill, prefill_batch_size=4): as a short prompt, or at the end of a
    40-token prompt that takes the chunked path. It alone fails, with a
    ValueError; the others equal the reference engine's tokens; the free
    pages return to their count; the engine serves the next request."""
    engine = _engine(weights)
    try:
        free = engine.stats()["free_pages"]
        assert free == _all_free(engine)
        bad_prompt = ([BAD_IDS[bad], 3] if where == "batched_prefill"
                      else GOOD[2][:39] + [BAD_IDS[bad]])
        results = _concurrently(engine, GOOD + [bad_prompt])
        assert isinstance(results[-1], ValueError), results[-1]
        assert f"prompt token id {BAD_IDS[bad]} is outside the vocabulary [0, 512)" in str(
            results[-1])
        for got, want in zip(results[:-1], reference_outputs):
            assert not isinstance(got, Exception), got
            assert got["token_ids"] == want
        assert engine.stats()["free_pages"] == free
        assert engine.generate(GOOD[1], max_tokens=MAX_TOKENS,
                               timeout_s=TIMEOUT_S)["token_ids"] == reference_outputs[1]
    finally:
        engine.stop()


@pytest.mark.parametrize("bad", list(BAD_IDS))
def test_out_of_vocabulary_import_rejected(weights, bad):
    """begin_kv_import, and through it import_kv_pages, refuse the same
    prompts before taking a page."""
    _jcfg, _jparams, cfg, _tparams = weights
    engine = _engine(weights)
    try:
        prompt = [4, BAD_IDS[bad], 6]
        shape = (cfg.n_layers, len(prompt), cfg.kv_heads, cfg.hdim)
        blob = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32),
                "true_len": len(prompt), "first_token": 1}
        req = Request(request_id=uuid.uuid4().hex, prompt=prompt, max_tokens=4)
        engine.import_kv_pages(req, blob)
        assert req.done.is_set() and "outside the vocabulary" in req.error
        assert engine.stats()["free_pages"] == _all_free(engine)
    finally:
        engine.stop()


def test_step_exception_leaves_engine_clean(weights):
    """With one decode slot: A decodes, B waits in _ready, C (40 tokens)
    waits in the chunk queue and D's streamed import is staged, when the
    decode span raises. Every one of them fails, the engine holds nothing,
    and the next request is served as the reference engine serves it."""
    _jcfg, _jparams, cfg, _tparams = weights
    engine = _engine(weights, max_batch_size=1)
    real_span = engine._decode_span

    def failing_span(*args):
        # the decode thread holds here until every station is occupied
        for _ in range(3000):
            if engine._ready and engine._chunk_queue and engine._importing:
                break
            threading.Event().wait(0.01)
        raise RuntimeError("injected step fault")

    engine._decode_span = failing_span
    try:
        a, _ = engine.open_stream(GOOD[0], max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)
        b, _ = engine.open_stream(GOOD[1], max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)
        c, _ = engine.open_stream(GOOD[2], max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)
        d = Request(request_id=uuid.uuid4().hex, prompt=[7, 8, 9], max_tokens=4)
        meta = {"layers": cfg.n_layers, "kv_heads": cfg.kv_heads, "head_dim": cfg.hdim}
        assert engine.begin_kv_import(d, 3, meta)
        for req in (a, b, c, d):
            assert req.done.wait(TIMEOUT_S)
            assert req.error and "injected step fault" in req.error, req.error
        engine._loop_thread.join(TIMEOUT_S)
        assert not engine._loop_thread.is_alive()
        assert engine._chunk_queue == [] and engine._ready == [] and engine._waiting == []
        assert engine._importing == {} and engine.pending.empty()
        assert all(s.request is None and s.pages == [] for s in engine.slots)
        assert engine.stats()["free_pages"] == _all_free(engine)

        engine._decode_span = real_span
        want = _reference(weights, [GOOD[2]], max_batch_size=1)[0]
        assert engine.generate(GOOD[2], max_tokens=MAX_TOKENS,
                               timeout_s=TIMEOUT_S)["token_ids"] == want
        assert engine.stats()["free_pages"] == _all_free(engine)
    finally:
        engine.stop()


def test_import_of_a_failed_request_stages_nothing(weights):
    """A failure that reaches a streamed import while it waits for pages,
    or between begin and finish, leaves nothing staged: begin_kv_import
    frees the pages it then takes and returns False, and finish_kv_import
    frees the staged pages and commits no token."""
    _jcfg, _jparams, cfg, _tparams = weights
    engine = _engine(weights)
    meta = {"layers": cfg.n_layers, "kv_heads": cfg.kv_heads, "head_dim": cfg.hdim}
    try:
        with engine._alloc_lock:  # every page taken: begin waits for pages
            held = engine._alloc_with_reclaim(_all_free(engine))
        d = Request(request_id=uuid.uuid4().hex, prompt=[7, 8, 9], max_tokens=4)
        began = []
        waiter = threading.Thread(
            target=lambda: began.append(engine.begin_kv_import(d, 3, meta, timeout_s=TIMEOUT_S)))
        waiter.start()
        for _ in range(3000):
            if d.request_id in engine._requests:
                break
            threading.Event().wait(0.01)
        engine._fail_all("injected failure")
        assert d.done.is_set() and d.error == "injected failure"
        engine._free_pages_and_revive(held)
        waiter.join(TIMEOUT_S)
        assert began == [False]
        assert engine._importing == {}
        assert engine.stats()["free_pages"] == _all_free(engine)

        e = Request(request_id=uuid.uuid4().hex, prompt=[7, 8, 9], max_tokens=4)
        assert engine.begin_kv_import(e, 3, meta)
        engine._fail_request(e, "failed elsewhere")
        assert engine.finish_kv_import(e, 1, 0.0) is e
        assert e.output == [] and e.error == "failed elsewhere"
        assert engine._importing == {} and engine._ready == []
        assert engine.stats()["free_pages"] == _all_free(engine)
        got = engine.generate(GOOD[0], max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)
        assert len(got["token_ids"]) == MAX_TOKENS
    finally:
        engine.stop()
