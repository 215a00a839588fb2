"""ray_tpu_torch speculative decoding against ray_tpu on the CPU.

The same numpy inputs (seeded) and the same weights (ray_tpu's tiny-model
parameters through params_from_numpy) go through both packages:

- paged_attention_verify: the port's plain version against the reference's
  gather version (1e-5) and its Pallas kernel in interpret mode
  (RAY_TPU_FORCE_PALLAS=1; 2e-3, the kernel sums in another order), at
  D = 128 in f32, at the reference tests' shapes;
- SpeculationConfig, the n-gram lookups and proposer: equal to the
  reference's;
- _topk_topp_keep: the same mask, ties included; _accept_commit: greedy
  rows equal exactly, sampling rows held to invariants (JAX's random bits
  cannot be matched);
- the slice as a whole: the port's engine with speculation is, token for
  token, the reference engine with the same speculation, the port's engine
  without speculation, and the port's models.generate (f32 on the CPU: no
  tolerance);
- decode_step / generate against the reference: logits within 1e-4, greedy
  tokens identical.

Every engine call has a timeout and every engine is stopped in a finally.
The CUDA kernel K7 itself is held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu import ops as jops
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops.paged_attention import _verify_reference as j_verify_reference
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu.serve import SpeculationConfig as JSpeculationConfig
from ray_tpu.serve import spec_decode as jspec
from ray_tpu_torch import EngineConfig, InferenceEngine, SpeculationConfig, get_config
from ray_tpu_torch import ops as tops
from ray_tpu_torch.models import decode_step, generate, params_from_numpy, prefill
from ray_tpu_torch.serve import spec_decode as tspec

D = 128
TIMEOUT_S = 120
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32))
PROMPTS = [[1, 2, 3, 4], [7, 5, 3], [2, 2, 9, 9, 4, 1]]


def _np(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- the op


@pytest.fixture(params=["xla", "pallas"])
def kernel_mode(request, monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_PALLAS", "1" if request.param == "pallas" else "0")
    return request.param


def _verify_inputs(B=2, S=5, H=4, KVH=2, ps=16, pps=8, positions=(10, 37)):
    q = _np(B, S, H, D, seed=0)
    kp, vp = _np(KVH, B * pps + 1, ps, D, seed=1), _np(KVH, B * pps + 1, ps, D, seed=2)
    table = (1 + np.arange(B * pps, dtype=np.int32)).reshape(B, pps)
    return q, kp, vp, table, np.asarray(positions[:B], np.int32)


VERIFY_SHAPES = [
    pytest.param(dict(), id="base"),
    pytest.param(dict(S=3), id="S3"),
    # span launched near the last page: keys past the table are never read
    pytest.param(dict(pps=4, positions=(4 * 16 - 5, 7)), id="near-table-end"),
    pytest.param(dict(S=1), id="S1"),
    pytest.param(dict(H=2, KVH=2, positions=(0, 0)), id="g1-positions0"),
]


class TestVerifyOp:
    @pytest.mark.parametrize("shape", VERIFY_SHAPES)
    def test_matches_reference(self, kernel_mode, shape):
        q, kp, vp, table, pos = _verify_inputs(**shape)
        got = tops.paged_attention_verify(_t(q), _t(kp), _t(vp), _t(table), _t(pos)).numpy()
        args = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
        want = np.asarray(jops.paged_attention_verify(*args))
        tol = 2e-3 if kernel_mode == "pallas" else 1e-5
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        plain = np.asarray(j_verify_reference(*args, D ** -0.5))
        np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("S", [1, 3])
    def test_row_equals_decode_at_that_length(self, S):
        # row s of the span is a decode step with length positions + s + 1
        q, kp, vp, table, pos = (_t(a) for a in _verify_inputs(S=S))
        out = tops.paged_attention_verify(q, kp, vp, table, pos)
        for s in range(S):
            dec = tops.paged_attention_decode(q[:, s].contiguous(), kp, vp, table,
                                              pos + s + 1)
            np.testing.assert_allclose(out[:, s].numpy(), dec.numpy(), atol=1e-5, rtol=1e-5)

    def test_inactive_slot_is_finite(self):
        # an inactive engine slot: position 0 and an all-zero table row
        q, kp, vp, table, pos = _verify_inputs()
        table[1] = 0
        pos[1] = 0
        out = tops.paged_attention_verify(_t(q), _t(kp), _t(vp), _t(table), _t(pos))
        assert torch.isfinite(out).all()

    def test_mixed_devices_raise(self):
        q, kp, vp, table, pos = (_t(a) for a in _verify_inputs())
        with pytest.raises(ValueError, match="mixed"):
            tops.paged_attention_verify(q, kp, vp, table, pos.to("meta"))


# ------------------------------------------------------------ the config


class TestSpeculationConfig:
    @pytest.mark.parametrize("kw", [
        dict(), dict(mode="ngram"), dict(mode="draft"),
        dict(mode="draft", draft_model="tiny-llama", draft_model_overrides={"n_layers": 1}),
        dict(mode="ngram", num_speculative_tokens=64, ngram_min=2, ngram_max=2),
        dict(mode="draft", overlap=False),
    ])
    def test_accepts_what_the_reference_accepts(self, kw):
        got, want = SpeculationConfig(**kw), JSpeculationConfig(**kw)
        assert got.enabled == want.enabled
        assert SpeculationConfig.parse(dict(kw)) == got
        for f in ("mode", "num_speculative_tokens", "ngram_max", "ngram_min", "draft_model",
                  "draft_model_overrides", "overlap"):
            assert getattr(got, f) == getattr(want, f), f
        assert SpeculationConfig.MODES == JSpeculationConfig.MODES

    @pytest.mark.parametrize("kw,match", [
        (dict(mode="medusa"), "mode"),
        (dict(mode="ngram", num_speculative_tokens=0), "num_speculative_tokens"),
        (dict(mode="ngram", num_speculative_tokens=65), "num_speculative_tokens"),
        (dict(mode="ngram", ngram_min=3, ngram_max=2), "ngram_min"),
        (dict(mode="ngram", draft_model="tiny-llama"), "draft_model"),
    ])
    def test_rejects_what_the_reference_rejects(self, kw, match):
        for cls in (SpeculationConfig, JSpeculationConfig):
            with pytest.raises(ValueError, match=match):
                cls(**kw)

    @pytest.mark.parametrize("value,match", [
        ({"mode": "ngram", "num_spec_tokens": 4}, "num_spec_tokens"),
        ("ngram", "mapping"),
    ])
    def test_parse_rejects(self, value, match):
        for cls in (SpeculationConfig, JSpeculationConfig):
            with pytest.raises(ValueError, match=match):
                cls.parse(value)

    def test_parse_passthrough(self):
        c = SpeculationConfig(mode="draft")
        assert SpeculationConfig.parse(c) is c
        assert EngineConfig(speculation={"mode": "ngram"}).speculation.mode == "ngram"


# --------------------------------------------------------- the proposers


class TestNGram:
    def test_lookups_match_reference_randomized(self):
        # small vocabulary: plenty of suffix collisions to exercise the
        # longest-n / most-recent / truncation tie-breaks
        rng = np.random.default_rng(0)
        B, cap, k = 8, 48, 4
        for trial in range(6):
            ctx = np.zeros((B, cap), np.int32)
            lens = np.zeros((B,), np.int64)
            active = np.ones((B,), bool)
            active[trial % B] = False
            for i in range(B):
                L = int(rng.integers(2, cap + 1))
                ctx[i, :L] = rng.integers(0, 6, size=L)
                lens[i] = L
            drafts, n = tspec._batch_ngram_lookup(ctx, lens, active, 1, 4, k)
            jdrafts, jn = jspec._batch_ngram_lookup(ctx, lens, active, 1, 4, k)
            np.testing.assert_array_equal(drafts, jdrafts)
            np.testing.assert_array_equal(n, jn)
            for i in range(B):
                got = tspec._ngram_lookup(ctx[i, : lens[i]], 1, 4, k)
                want = jspec._ngram_lookup(ctx[i, : lens[i]], 1, 4, k)
                assert got.tolist() == want.tolist()
                if active[i]:
                    assert drafts[i, : n[i]].tolist() == want.tolist()
                else:
                    assert n[i] == 0

    @pytest.mark.parametrize("ctx,nmin,nmax,k,want", [
        ([7, 8, 9, 1, 2, 5, 7, 8], 1, 3, 3, [9, 1, 2]),
        ([1, 3, 4, 2, 3, 6, 5, 3], 1, 1, 1, [6]),       # most recent match wins
        ([2, 3, 9, 3, 5, 2, 3], 1, 4, 1, [9]),          # longest suffix preferred
        ([1, 2, 3, 4, 5], 2, 4, 4, []),
        ([5], 1, 4, 4, []),
        ([1, 9, 9, 4, 4, 1], 1, 1, 4, [9, 9, 4, 4]),    # truncated at context end
    ])
    def test_scalar_lookup(self, ctx, nmin, nmax, k, want):
        assert tspec._ngram_lookup(np.array(ctx, np.int32), nmin, nmax, k).tolist() == want


class _StubEngine:
    """The engine surface NGramProposer touches: ecfg dims and the slots."""

    class _Ecfg:
        max_batch_size = 4
        max_seq_len = 64

    class _Slot:
        request = None

    class _Req:
        def __init__(self, rid, prompt):
            self.request_id = rid
            self.prompt = list(prompt)
            self.output = []

    def __init__(self):
        self.ecfg = self._Ecfg()
        self.slots = [self._Slot() for _ in range(4)]


class TestProposerHygiene:
    REPETITIVE = [7, 8, 7, 8, 7, 8, 7]   # guaranteed ngram match
    BLAND = [1, 2, 3]                     # guaranteed no match
    ZEROS = (np.zeros((4,), np.int32), np.zeros((4,), np.int32))

    def _proposer(self):
        return tspec.NGramProposer(SpeculationConfig(mode="ngram")), _StubEngine()

    def test_evicted_context_never_leaks_to_successor(self):
        prop, eng = self._proposer()
        eng.slots[0].request = _StubEngine._Req("req-A", self.REPETITIVE)
        _, n = prop.propose(eng, *self.ZEROS)
        assert n[0] > 0
        prop.on_evict(eng, 0)
        eng.slots[0].request = _StubEngine._Req("req-B", self.BLAND)
        drafts, n = prop.propose(eng, *self.ZEROS)
        assert n[0] == 0 and not drafts[0].any()

    def test_slot_reuse_without_evict_reseeds_by_request_id(self):
        prop, eng = self._proposer()
        eng.slots[0].request = _StubEngine._Req("req-A", self.REPETITIVE)
        assert prop.propose(eng, *self.ZEROS)[1][0] > 0
        eng.slots[0].request = _StubEngine._Req("req-B", self.BLAND)
        assert prop.propose(eng, *self.ZEROS)[1][0] == 0

    def test_incremental_append_tracks_output(self):
        prop, eng = self._proposer()
        req = _StubEngine._Req("req-A", self.BLAND)
        eng.slots[0].request = req
        assert prop.propose(eng, *self.ZEROS)[1][0] == 0
        req.output.extend([4, 5, 4, 5, 4])
        drafts, n = prop.propose(eng, *self.ZEROS)
        assert n[0] > 0 and drafts[0, 0] == 5
        # the reference's proposer, fed the same requests, drafts the same
        jprop = jspec.NGramProposer(JSpeculationConfig(mode="ngram"))
        jdrafts, jn = jprop.propose(eng, *self.ZEROS)
        np.testing.assert_array_equal(drafts, jdrafts)
        np.testing.assert_array_equal(n, jn)


# ------------------------------------------------------ accept and commit


def _tied_logits(rows, V, seed):
    """Logits on a coarse grid, so that rows hold many exact ties."""
    return (np.random.RandomState(seed).randint(-6, 7, (rows, V)) * 0.5).astype(np.float32)


class TestAcceptCommit:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_keep_mask_matches_reference_with_ties(self, seed):
        rows, V = 6, 40
        scaled = _tied_logits(rows, V, seed)
        top_ps = np.array([1.0, 0.9, 0.5, 0.2, 0.9, 1.0], np.float32)
        top_ks = np.array([0, 0, 0, 5, 3, 1], np.int32)
        want = np.asarray(jspec._topk_topp_keep(jnp.asarray(scaled), jnp.asarray(top_ps),
                                                jnp.asarray(top_ks)))
        got = tspec._topk_topp_keep(_t(scaled), _t(top_ps), _t(top_ks)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.any(axis=1).all()

    @pytest.mark.parametrize("sample", [False, True])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_greedy_rows_match_reference(self, seed, sample):
        B, S, V = 6, 5, 32
        rs = np.random.RandomState(seed)
        logits = rs.randn(B, S, V).astype(np.float32)
        greedy = logits.argmax(-1)
        tokens = rs.randint(0, V, (B, S)).astype(np.int32)
        # drafts agree with the verify argmax for a prefix of varying length
        for b in range(B):
            tokens[b, 1:1 + b % S] = greedy[b, : b % S]
        n_draft = np.array([4, 4, 1, 3, 0, 2], np.int32)
        temps = np.zeros((B,), np.float32)
        if sample:  # a sampling row beside them must not disturb the greedy rows
            temps[5] = 0.7
        ones, zeros = np.ones((B,), np.float32), np.zeros((B,), np.int32)
        jc, jn = jspec._accept_commit(*(jnp.asarray(a) for a in (
            logits, tokens, n_draft, temps, ones, zeros)), jax.random.PRNGKey(0), False)
        gen = torch.Generator().manual_seed(0)
        tc, tn = tspec._accept_commit(*(_t(a) for a in (
            logits, tokens, n_draft, temps, ones, zeros)), gen, False, sample)
        rows = temps == 0
        np.testing.assert_array_equal(tn.numpy()[rows], np.asarray(jn)[rows])
        np.testing.assert_array_equal(tc.numpy()[rows], np.asarray(jc)[rows])
        assert tc.dtype == tn.dtype == torch.int32
        assert (tn.numpy() <= n_draft + 1).all() and (tn.numpy() >= 1).all()

    @pytest.mark.parametrize("advanced", [False, True])
    def test_sampling_rows_keep_their_invariants(self, advanced):
        B, S, V = 8, 4, 24
        K = S - 1
        rs = np.random.RandomState(3)
        tokens = rs.randint(0, V, (B, S)).astype(np.int32)
        logits = rs.randn(B, S, V).astype(np.float32)
        # rows 0-3: all mass on the draft at every row (always accepted);
        # rows 4-7: the first draft has zero probability (always rejected)
        for b in range(4):
            for s in range(K):
                logits[b, s] = -1e4
                logits[b, s, tokens[b, s + 1]] = 10.0
        logits[4:, 0, :] = 0.0
        for b in range(4, B):
            logits[b, 0, tokens[b, 1]] = -1e9
        n_draft = np.array([3, 2, 1, 0, 3, 2, 1, 3], np.int32)
        args = [_t(a) for a in (logits, tokens, n_draft, np.full((B,), 0.8, np.float32),
                                np.full((B,), 0.9, np.float32), np.full((B,), 8, np.int32))]
        for seed in range(20):
            gen = torch.Generator().manual_seed(seed)
            committed, n_comm = (x.numpy() for x in tspec._accept_commit(*args, gen, advanced))
            np.testing.assert_array_equal(n_comm[:4], n_draft[:4] + 1)
            for b in range(4):
                assert committed[b, : n_draft[b]].tolist() == tokens[b, 1:1 + n_draft[b]].tolist()
            np.testing.assert_array_equal(n_comm[4:], 1)
            assert (committed[4:, 0] != tokens[4:, 1]).all()  # never the rejected token
            assert (n_comm <= n_draft + 1).all()
            assert (committed >= 0).all() and (committed < V).all()


# ------------------------------------------------- decode_step / generate


def _both(name):
    jcfg = jmodels.get_config(name)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config(name), tparams


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_decode_step_and_generate_match_reference(name):
    from ray_tpu.models.generate import generate as jgenerate

    jcfg, jparams, tcfg, tparams = _both(name)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    _, jcache = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks), 16)
    _, tcache = prefill(tparams, tcfg, _t(toks), 16)
    nxt, pos = np.array([5, 11], np.int32), np.array([9, 9], np.int32)
    for _ in range(3):
        want, jcache = jtransformer.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt),
                                                jnp.asarray(pos))
        got, tcache = decode_step(tparams, tcfg, tcache, _t(nxt), _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        nxt, pos = np.asarray(want).argmax(-1).astype(np.int32), pos + 1
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-4)
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(toks), jax.random.PRNGKey(0),
                                max_new_tokens=12))
    got = generate(tparams, tcfg, _t(toks), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)
    sampled = generate(tparams, tcfg, _t(toks), torch.Generator().manual_seed(0),
                       max_new_tokens=6, temperature=0.8, top_k=5)
    assert sampled.shape == (2, 6) and int(sampled.max()) < tcfg.vocab_size


# ------------------------------------------------------ the slice, whole


def _serve(engine, prompts, max_tokens, **kw):
    try:
        return [engine.generate(p, max_tokens=max_tokens, timeout_s=TIMEOUT_S, **kw)
                for p in prompts]
    finally:
        engine.stop()


def _tokens(results):
    return [r["token_ids"] for r in results]


def _engine(tcfg, tparams, spec=None, draft_params=None, **kw):
    return InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW, speculation=spec, **kw),
                           device="cpu", draft_params=draft_params)


SLICE_CASES = [
    pytest.param("tiny-llama", {"mode": "ngram", "num_speculative_tokens": 4}, 24, id="ngram"),
    pytest.param("tiny-llama", {"mode": "draft", "num_speculative_tokens": 4}, 24,
                 id="draft-self"),
    # a genuinely different draft (1 layer vs 2): drafts mostly reject and the
    # committed tokens must STILL be exactly the target's greedy stream
    pytest.param("tiny-llama", {"mode": "draft", "num_speculative_tokens": 3,
                                "draft_model": "tiny-llama",
                                "draft_model_overrides": {"n_layers": 1}}, 24,
                 id="draft-distinct"),
    # learned positions: the pos_emb branch of verify, draft prefill and propose
    pytest.param("tiny-gpt2", {"mode": "draft", "num_speculative_tokens": 3}, 16,
                 id="gpt2-draft-self"),
]


@pytest.mark.parametrize("name,spec,max_tokens", SLICE_CASES)
def test_speculative_engine_matches_reference_plain_and_generate(name, spec, max_tokens):
    jcfg, jparams, tcfg, tparams = _both(name)
    jdraft = tdraft = None
    if spec.get("draft_model"):
        dcfg = jmodels.get_config(spec["draft_model"], **spec["draft_model_overrides"])
        jdraft = jmodels.init_params(dcfg, jax.random.PRNGKey(1))
        tdraft = params_from_numpy(jax.tree.map(np.asarray, jdraft), device="cpu")
    jeng = JInferenceEngine(jparams, jcfg, JEngineConfig(**ENGINE_KW, speculation=dict(spec)),
                            draft_params=jdraft)
    want = _tokens(_serve(jeng, PROMPTS, max_tokens))
    eng = _engine(tcfg, tparams, dict(spec), tdraft)
    results = _serve(eng, PROMPTS, max_tokens)
    got = _tokens(results)
    assert got == want                                              # (a) the reference
    assert got == _tokens(_serve(_engine(tcfg, tparams), PROMPTS, max_tokens))  # (b) plain
    for p, out in zip(PROMPTS, got):                                # (c) generate
        oracle = generate(tparams, tcfg, torch.tensor([p]), max_new_tokens=max_tokens)
        assert out == oracle[0].tolist()
    for r in results:
        assert r["finish_reason"] == "length"
        # the prefill token carries its logprob, speculative commits None
        assert r["logprobs"][0] is not None and len(r["logprobs"]) == max_tokens
    stats = eng.stats()
    for key in ("spec_mode", "spec_num_speculative_tokens", "spec_proposed_tokens",
                "spec_accepted_tokens", "spec_acceptance_rate"):
        assert key in stats
    assert stats["spec_mode"] == spec["mode"]
    assert set(stats) <= set(jeng.stats()) | {"weights_version"}


@pytest.fixture(scope="module")
def tiny_llama():
    return _both("tiny-llama")[2:]


DRAFT4 = {"mode": "draft", "num_speculative_tokens": 4}


def test_stop_sequence_mid_speculation(tiny_llama):
    tcfg, tparams = tiny_llama
    ref = _tokens(_serve(_engine(tcfg, tparams), PROMPTS[:1], 24))[0]
    stop = [ref[7:9]]  # a 2-token stop hit mid-stream
    plain = _serve(_engine(tcfg, tparams), PROMPTS[:1], 24, stop=stop)[0]
    out = _serve(_engine(tcfg, tparams, DRAFT4), PROMPTS[:1], 24, stop=stop)[0]
    assert plain["finish_reason"] == out["finish_reason"] == "stop"
    assert out["token_ids"] == plain["token_ids"]
    assert len(out["logprobs"]) == len(out["token_ids"])


def test_cancellation_mid_speculation(tiny_llama):
    tcfg, tparams = tiny_llama
    eng = _engine(tcfg, tparams, DRAFT4)
    try:
        req, gen = eng.open_stream(PROMPTS[0], max_tokens=48, timeout_s=TIMEOUT_S)
        assert isinstance(next(gen), int)
        eng.cancel(req.request_id)
        list(gen)  # drain to termination
        assert req.finish_reason == "cancelled"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and eng.stats()["active"]:
            time.sleep(0.02)
        assert eng.stats()["active"] == 0
        # the slot is reusable and a prefetched row of the cancelled request
        # never surfaces: the next request decodes as the plain engine does
        after = eng.generate(PROMPTS[1], max_tokens=12, timeout_s=TIMEOUT_S)["token_ids"]
    finally:
        eng.stop()
    assert after == _tokens(_serve(_engine(tcfg, tparams), PROMPTS[1:2], 12))[0]


def test_zero_draft_cap_commits_one_token(tiny_llama):
    # max_tokens=2: after the prefill token only the bonus token fits, so
    # the round runs with zero drafts and must match plain decode
    tcfg, tparams = tiny_llama
    base = _tokens(_serve(_engine(tcfg, tparams), PROMPTS, 2))
    eng = _engine(tcfg, tparams, DRAFT4)
    assert _tokens(_serve(eng, PROMPTS, 2)) == base
    assert eng.stats()["spec_proposed_tokens"] == 0


def test_zero_draft_round_falls_back_to_plain_span(tiny_llama):
    # no repeated suffix anywhere: every ngram round proposes nothing, so the
    # engine decodes entirely through plain spans, logprobs and all
    tcfg, tparams = tiny_llama
    eng = _engine(tcfg, tparams, {"mode": "ngram", "num_speculative_tokens": 4})
    got = _serve(eng, PROMPTS[:1], 8)[0]
    want = _serve(_engine(tcfg, tparams), PROMPTS[:1], 8)[0]
    assert got["token_ids"] == want["token_ids"] and len(got["token_ids"]) == 8
    stats = eng.stats()
    assert stats["spec_proposed_tokens"] == 0 and stats["spec_acceptance_rate"] == 0.0
    assert all(lp is not None for lp in got["logprobs"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=1e-6)
    assert "rounds" not in eng._spec.phase_seconds  # no verify round ran


def test_draft_vocab_mismatch_rejected(tiny_llama):
    tcfg, tparams = tiny_llama
    with pytest.raises(ValueError, match="tokenizer"):
        _engine(tcfg, tparams, {"mode": "draft", "draft_model": "tiny-llama",
                                "draft_model_overrides": {"vocab_size": 300}})


def test_speculation_off_engine_has_no_spec(tiny_llama):
    tcfg, tparams = tiny_llama
    eng = _engine(tcfg, tparams, {"mode": "off"})
    try:
        assert eng._spec is None
        assert "spec_acceptance_rate" not in eng.stats()
    finally:
        eng.stop()


def test_self_speculation_accepts_and_commits_more_than_one(tiny_llama):
    tcfg, tparams = tiny_llama
    eng = _engine(tcfg, tparams, DRAFT4)
    _serve(eng, PROMPTS, 24)
    stats = eng.stats()
    assert stats["spec_proposed_tokens"] > 0
    assert stats["spec_acceptance_rate"] >= 0.9
    assert stats["tokens_per_decode_step"] > 1
    # the self-speculating draft shares the target's tensors: no second copy
    draft = eng._spec.proposer.model
    assert draft.layers is eng._model.layers and draft.head32 is eng._model.head32
    phases = eng._spec.phase_seconds
    assert phases["rounds"] >= 1
    for phase in ("propose", "propose_wait", "propose_compute", "verify", "sample",
                  "cache_bookkeeping"):
        assert phases[phase] >= 0.0


@pytest.mark.parametrize("overlap", [False, True])
def test_concurrent_sampled_and_greedy_requests(tiny_llama, overlap):
    # a sampled request (advanced verify) beside greedy ones, with and
    # without the overlapped propose: the greedy ones are unchanged by it
    import threading

    tcfg, tparams = tiny_llama
    solo = _tokens(_serve(_engine(tcfg, tparams), PROMPTS[:2], 16))
    eng = _engine(tcfg, tparams, dict(DRAFT4, overlap=overlap))
    results = [None] * 3
    jobs = [dict(prompt=PROMPTS[0], max_tokens=16), dict(prompt=PROMPTS[1], max_tokens=16),
            dict(prompt=PROMPTS[2], max_tokens=20, temperature=0.8, top_p=0.9, top_k=8)]

    def work(i):
        results[i] = eng.generate(timeout_s=TIMEOUT_S, **jobs[i])

    try:
        eng.warmup(buckets=[16])  # the speculation programs included
        threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
    assert [results[0]["token_ids"], results[1]["token_ids"]] == solo
    assert len(results[2]["token_ids"]) == 20 and results[2]["finish_reason"] == "length"
    assert all(0 <= t < tcfg.vocab_size for t in results[2]["token_ids"])
