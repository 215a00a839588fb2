"""The serving engine's captured programs (serve/programs.py CapturedProgram)
on the CPU, where a program runs its body into its static buffers without
a graph, and the launch accounting that graph replays use on the card.

Shows: (a) two calls with different inputs return what two direct calls of
the body return; (b) a program's outputs are its static buffers, which the
next call overwrites, and every engine caller copies what it keeps; (c)
after warmup the engine's program table covers every key its step loop,
span picker, chunked prefill, draft install and prefill thread can pick,
an uncaptured key raises, and nothing is captured while the engine's
threads run; (d) `dispatch.recording_launches` takes a capture's launches
out of the counts and `add_launches` adds them once per replay, and
counts them apart from eager launches. Also `LLMServer(draft_params_fn=...)` against the reference server
given the same draft weights. Outputs of the same CPU arithmetic are
compared exactly; logprobs against the reference within 1e-4 (f32, sums in
another order).
"""

import threading
import types

import jax
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu.serve.llm import LLMServer as JLLMServer
from ray_tpu_torch import EngineConfig, InferenceEngine, LLMServer, get_config
from ray_tpu_torch.models import init_params, params_from_numpy
from ray_tpu_torch.ops import dispatch
from ray_tpu_torch.serve.programs import SAMPLER_MODES, CapturedProgram, read_back

TIMEOUT_S = 120
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16, decode_span=6, busy_span=2)
DRAFT4 = {"mode": "draft", "num_speculative_tokens": 4}


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny-llama")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(tiny, spec=None, **kw):
    cfg, params = tiny
    return InferenceEngine(params, cfg, EngineConfig(**{**ENGINE_KW, **kw}, speculation=spec),
                           device="cpu")


def _span_inputs(engine, seed, temp=0.0):
    """Host arrays of one decode span over the engine's batch: random
    tokens, positions and page tables (pages 1.. of the pool)."""
    ecfg = engine.ecfg
    B, pps = ecfg.max_batch_size, ecfg.pages_per_seq
    rs = np.random.RandomState(seed)
    tables = (1 + np.arange(B * pps, dtype=np.int32) % (ecfg.max_pages - 1)).reshape(B, pps)
    return (rs.randint(1, engine.cfg.vocab_size, B).astype(np.int32),
            rs.randint(0, 30, B).astype(np.int32), tables,
            np.full(B, temp, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32))


def _body(x, y):
    return x * 2 + y, (x * y).sum(dim=-1)


def test_two_calls_return_what_two_direct_calls_return(tiny):
    x1, y1, x2, y2 = (torch.randn(3, 5, generator=torch.Generator().manual_seed(i))
                      for i in range(4))
    program = CapturedProgram(_body, (torch.zeros(3, 5), torch.zeros(3, 5)))
    first = [t.clone() for t in program(x1, y1)]
    second = program(x2, y2)
    for got, want in zip(first + list(second), _body(x1, y1) + _body(x2, y2)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shape"):
        program(torch.zeros(5), y1)

    # the engine's decode span program against its body called directly on
    # a second engine with the same weights (the same KV writes), twice
    engine, direct = _engine(tiny), _engine(tiny)
    engine.warmup(buckets=[])
    for seed in (0, 1):
        args = _span_inputs(engine, seed)
        seq, logps = engine._decode_span(6, *args, advanced=False)
        want = direct._decode_span_body(
            *(torch.as_tensor(a) for a in args), n_steps=6, sample=False, advanced=False)
        assert np.array_equal(seq, want[0].numpy())
        assert np.array_equal(logps, want[1].numpy())


def test_outputs_are_static_buffers_and_engine_callers_copy(tiny):
    program = CapturedProgram(_body, (torch.zeros(2, 4), torch.zeros(2, 4)))
    held = program(torch.ones(2, 4), torch.ones(2, 4))[0]
    assert torch.equal(held, torch.full((2, 4), 3.0))
    again = program(torch.zeros(2, 4), torch.ones(2, 4))[0]
    assert again is held  # one static buffer: the second call overwrote it
    assert torch.equal(held, torch.ones(2, 4))

    # a decode span's readback is a copy: results held across another span
    engine = _engine(tiny)
    engine.warmup(buckets=[])
    seq, logps = engine._decode_span(6, *_span_inputs(engine, 0), advanced=False)
    kept = seq.copy(), logps.copy()
    seq2, _ = engine._decode_span(6, *_span_inputs(engine, 5), advanced=False)
    assert not np.array_equal(seq2, kept[0])
    assert np.array_equal(seq, kept[0]) and np.array_equal(logps, kept[1])

    # a speculative round: the committed tokens are a copy, and so are the
    # draft rows a prefetch leaves for the next round, which replays the
    # chunk and the draft chunk of the same pool before its verify reads them
    engine = _engine(tiny, dict(DRAFT4, overlap=True))
    engine.warmup(buckets=[])
    spec = engine._spec
    tokens, positions, tables, temps, top_ps, top_ks = _span_inputs(engine, 2)
    caps = np.full(engine.ecfg.max_batch_size, 4, np.int32)
    out = spec.run_step(tokens, positions, tables, caps, temps, top_ps, top_ks, False)
    kept = out[0].copy()
    drafts = spec.proposer._pf["drafts"]
    propose_out = engine._program(("propose",)).outputs[0]
    assert drafts is not propose_out and torch.equal(drafts, propose_out)
    held = drafts.clone()
    engine._chunk_step(np.arange(16, dtype=np.int32), 0, tables[0], 15)
    engine._program(("propose",))(*(torch.as_tensor(t + 1) for t in (tokens, tokens,
                                                                      positions)))
    assert torch.equal(drafts, held)
    spec.run_step(tokens + 1, positions, tables, caps, temps, top_ps, top_ks, False)
    assert np.array_equal(out[0], kept)


def test_read_back_copies_off_the_card():
    # on the CPU read_back is a plain copy of each tensor: the program's
    # static buffers may be overwritten by its next replay
    a, b = torch.arange(6.0).reshape(2, 3), torch.arange(4, dtype=torch.int32)
    ra, rb = read_back(a, b)
    assert torch.equal(ra, a) and torch.equal(rb, b) and rb.dtype == torch.int32
    assert ra.data_ptr() != a.data_ptr() and rb.data_ptr() != b.data_ptr()
    a.zero_()
    assert torch.equal(ra, torch.arange(6.0).reshape(2, 3))


def test_program_table_covers_every_key_the_step_loop_picks(tiny):
    engine = _engine(tiny, dict(DRAFT4))
    try:
        assert engine._programs == {}
        engine.warmup(buckets=[])
        k = engine._spec.k
        want = {("decode", n, *mode) for n in (6, 2) for mode in SAMPLER_MODES}
        want |= {("verify", S, *mode) for S in range(2, k + 2) for mode in SAMPLER_MODES}
        want |= {("propose",), ("draft_chunk", 16), ("chunk", 16)}
        # warmup's buckets=[] keeps the reference's signature; the port
        # captures every configured bucket at every prefill tier regardless
        want |= {("prefill", b, 1) for b in (16, 32)}
        assert set(engine._programs) == want
        assert engine.capture_stats["programs"] == len(want)
        assert engine.capture_stats["prefill_programs"] == 2
        # every width the span picker can choose, at any acceptance
        rs = np.random.RandomState(0)
        for accepted in (0, 300, 1000):
            engine._spec.proposed_total, engine._spec.accepted_total = 1000, accepted
            for _ in range(50):
                n_draft = rs.randint(0, k + 1, 4).astype(np.int32)
                caps = rs.randint(0, k + 1, 4).astype(np.int32)
                m = max(1, engine._spec._pick_span(np.minimum(n_draft, caps), caps))
                assert ("verify", m + 1, True, True) in engine._programs
        # a key that was not captured raises, in place of capturing lazily
        with pytest.raises(RuntimeError, match="not captured"):
            engine._decode_span(3, *_span_inputs(engine, 0), advanced=False)
        with pytest.raises(RuntimeError, match="not captured"):
            engine._program(("verify", k + 2, False, False))
        with pytest.raises(RuntimeError, match="not captured"):  # no tier 2
            engine._prefill(np.ones((2, 16), np.int32), np.ones(2, np.int32),
                            np.zeros((2, engine.ecfg.pages_per_seq), np.int32))
        with pytest.raises(RuntimeError, match="not captured"):  # no bucket 24
            engine._prefill(np.ones((1, 24), np.int32), np.ones(1, np.int32),
                            np.zeros((1, engine.ecfg.pages_per_seq), np.int32))
        # the threads run after the first request; no capture from then on
        out = engine.generate([1, 2, 3], max_tokens=4, timeout_s=TIMEOUT_S)
        assert len(out["token_ids"]) == 4
        with pytest.raises(RuntimeError, match="threads"):
            engine._capture_programs(spans=[3])
        assert ("decode", 3, False, False) not in engine._programs
    finally:
        engine.stop()
    engine._capture_programs(spans=[3])  # stopped: capture is allowed again
    assert ("decode", 3, False, False) in engine._programs


def test_an_engine_not_warmed_up_captures_before_its_threads_start(tiny):
    engine = _engine(tiny, {"mode": "ngram", "num_speculative_tokens": 3})
    try:
        out = engine.generate([4, 5, 4, 5, 4, 5], max_tokens=6, timeout_s=TIMEOUT_S)
        assert len(out["token_ids"]) == 6
        assert ("decode", 6, False, False) in engine._programs
        assert ("verify", 4, True, True) in engine._programs
        assert ("propose",) not in engine._programs  # the n-gram proposer is host code
    finally:
        engine.stop()


def test_capture_launches_are_added_once_per_replay(monkeypatch):
    # dispatch.launch with a stand-in library and stream: what it counts
    # inside recording_launches is taken back out and kept for the replays
    fake_lib = types.SimpleNamespace(rtt_rms_norm=lambda *args: 0)
    monkeypatch.setattr(dispatch, "_lib", fake_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda")
    before = dispatch.launch_counts()
    eager_before = dispatch.eager_launch_counts()
    dispatch.launch("rms_norm", "rtt_rms_norm", dev)  # an eager launch counts
    with dispatch.recording_launches() as recorded:
        for _ in range(3):
            dispatch.launch("rms_norm", "rtt_rms_norm", dev)
        dispatch.launch("flash_attention", "rtt_rms_norm", dev, also="flash_attention_lse")
    assert recorded == {"rms_norm": 3, "flash_attention": 1, "flash_attention_lse": 1}
    after_capture = dispatch.launch_counts()
    assert after_capture["rms_norm"] == before["rms_norm"] + 1
    assert after_capture["flash_attention"] == before["flash_attention"]
    for _ in range(2):  # two replays
        dispatch.add_launches(recorded)
    now = dispatch.launch_counts()
    assert now["rms_norm"] == before["rms_norm"] + 1 + 6
    assert now["flash_attention_lse"] == before["flash_attention_lse"] + 2
    assert now["paged_attention_decode"] == before["paged_attention_decode"]
    # the replays' launches are counted apart: the eager ones are the one
    # launch made outside the capture
    eager = dispatch.eager_launch_counts()
    assert eager["rms_norm"] == eager_before["rms_norm"] + 1
    assert eager["flash_attention"] == eager_before["flash_attention"]
    # a capture that raises leaves the counts as they were
    with pytest.raises(RuntimeError):
        with dispatch.recording_launches():
            dispatch.launch("rms_norm", "rtt_rms_norm", dev)
            raise RuntimeError("capture failed")
    assert dispatch.launch_counts() == now


def test_a_capture_records_only_its_own_threads_launches(monkeypatch):
    # two engines in one process (the replicas of a deployment): a launch on
    # another thread during a capture counts as an eager launch of its own
    # and stays out of the capture's recording
    fake_lib = types.SimpleNamespace(rtt_rms_norm=lambda *args: 0)
    monkeypatch.setattr(dispatch, "_lib", fake_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda")
    before = dispatch.launch_counts()
    other = threading.Thread(target=dispatch.launch, args=("rms_norm", "rtt_rms_norm", dev))
    with dispatch.recording_launches() as recorded:
        dispatch.launch("flash_attention", "rtt_rms_norm", dev)
        other.start()
        other.join(10)
    assert not other.is_alive()
    assert recorded == {"flash_attention": 1}
    after = dispatch.launch_counts()
    assert after["rms_norm"] == before["rms_norm"] + 1
    assert after["flash_attention"] == before["flash_attention"]


def test_llm_server_draft_params_fn_matches_reference_server():
    spec = {"mode": "draft", "num_speculative_tokens": 3, "draft_model": "tiny-llama",
            "draft_model_overrides": {"n_layers": 1}}
    ecfg = dict(ENGINE_KW, speculation=spec)
    jcfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = jmodels.init_params(jmodels.get_config("tiny-llama", n_layers=1),
                                 jax.random.PRNGKey(7))
    tcfg = get_config("tiny-llama")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    calls = []

    def draft_params_fn():
        calls.append(1)
        return params_from_numpy(jax.tree.map(np.asarray, jdraft), device="cpu")

    want_server = JLLMServer._target(params_fn=lambda: (jparams, jcfg),
                                     engine_config=dict(ecfg, speculation=dict(spec)),
                                     draft_params_fn=lambda: jdraft)
    server = LLMServer._target(params_fn=lambda: (tparams, tcfg), engine_config=ecfg, device="cpu",
                               draft_params_fn=draft_params_fn)
    try:
        assert calls == [1]
        draft = server.engine._spec.proposer.model.params
        assert torch.equal(draft["embed"], torch.as_tensor(np.array(jdraft["embed"])))
        for prompt in ([1, 2, 3, 4], [7, 5, 3, 9, 9]):
            req = {"prompt_ids": prompt, "max_tokens": 12}
            want, got = want_server(req), server(req)
            assert got["token_ids"] == want["token_ids"]
            np.testing.assert_allclose(got["logprobs"][0], want["logprobs"][0], atol=1e-4)
        assert server.stats()["spec_proposed_tokens"] > 0
    finally:
        server.shutdown()
        want_server.engine.stop()
