"""The serving engine's prefill programs against the reference, on the CPU.

The bucketed prefill and the chunked prefill (the engine's and the draft
proposer's) run as captured programs (serve/programs.py CapturedProgram):
on the CPU a program runs its body into static buffers, so the hazard of a
graph's static outputs, overwritten by the next replay, shows here too.
The same numpy inputs (seeded) and the same weights (the JAX package's
tiny-model parameters through params_from_numpy) go through both packages:

- (a) PagedModel.prefill on tiny-llama and tiny-gpt2 returns the
  reference's `prefill` logits at true_len - 1 (1e-4: f32, sums in another
  order) and writes into the pages what the reference's `_scatter_pages_jit`
  writes (1e-5), with padded rows and a dummy row (all-zero table) in the
  batch;
- (b) paged_attention_chunk with start/total as int32 tensors gives
  exactly what the int form gives, and the reference's `_chunk_reference`
  within 1e-5, at start 0, mid-page, on a page edge and with total below
  start + C;
- (c) the port's engine is token-identical to the reference engine
  (logprobs within 1e-4) when several same-bucket prompts finish prefill
  before the decode thread installs the first (max_batch_size=1);
- (d) the same with prefill_batch_size=4 (padded tiers, dummy rows);
- (e) the same for the draft-mode speculative engine with a prompt longer
  than the chunk (the draft chunk program at install), whose
  self-speculation must accept at least 90 % of its drafts, as the
  reference's does.

Every engine call has a timeout and every engine is stopped in a finally.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops.paged_attention import _chunk_reference as j_chunk_reference
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu.serve.engine import _scatter_pages_jit
from ray_tpu_torch import EngineConfig, InferenceEngine, get_config
from ray_tpu_torch import ops as tops
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve.programs import PagedModel

TIMEOUT_S = 120
LOGPROB_TOL = dict(atol=1e-4, rtol=0)
ENGINE_KW = dict(page_size=8, max_pages=64, max_seq_len=64, prefill_buckets=(16, 32),
                 prefill_chunk=16)


def _both(name):
    jcfg = jmodels.get_config(name)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, get_config(name), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_paged_prefill_matches_reference_prefill_and_page_scatter(name):
    jcfg, jparams, tcfg, tparams = _both(name)
    L, KVH, hd = tcfg.n_layers, tcfg.kv_heads, tcfg.hdim
    ps, P, bucket = 8, 40, 32
    pps = tcfg.max_seq_len // ps
    rs = np.random.RandomState(0)
    # rows: a short prompt whose pages end inside the bucket (the rest of
    # its positions go to the trash page), a prompt with more pages than
    # the bucket covers, a full bucket, and a dummy row (all-zero table)
    lens = np.array([5, 17, 32, 1], np.int32)
    n_pages = [2, 5, 5, 0]
    toks = rs.randint(1, tcfg.vocab_size, (4, bucket)).astype(np.int32)
    toks[3] = 0
    for b, T in enumerate(lens):
        toks[b, T:] = 0
    free = list(rs.permutation(np.arange(1, P)))
    tables = np.zeros((4, pps), np.int32)
    for b, n in enumerate(n_pages):
        tables[b, :n], free = free[:n], free[n:]

    pools = [torch.zeros((L, KVH, P, ps, hd)) for _ in range(2)]
    model = PagedModel(tparams, tcfg, ps, *pools)
    logits = model.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                           torch.from_numpy(tables))

    want, cache = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks), bucket,
                                       jnp.asarray(lens - 1))
    assert logits.shape == (4, tcfg.vocab_size) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(want)[:3], atol=1e-4, rtol=1e-4)
    jk, jv = (jnp.zeros((L, KVH, P, ps, hd), jnp.float32) for _ in range(2))
    for b, n in enumerate(n_pages[:3]):
        n_full = min(n, bucket // ps)
        jk, jv = _scatter_pages_jit(jk, jv, cache["k"][:, b], cache["v"][:, b],
                                    jnp.asarray(tables[b, :n_full]), n_full, ps)
    # page 0 is the trash page: the dummy row and the positions past each
    # row's pages land there, in the reference nowhere
    for got, ref in zip(pools, (jk, jv)):
        np.testing.assert_allclose(got[:, :, 1:].numpy(), np.asarray(ref)[:, :, 1:],
                                   atol=1e-5, rtol=1e-5)
    untouched = np.setdiff1d(np.arange(1, P), tables[:, :4])
    assert not pools[0][:, :, untouched].any()


# ------------------------------------------------------------------ (b)

# name -> (C, start, total); pages of 16
CHUNK_CASES = {
    "start 0": (32, 0, 32),
    "mid-page": (24, 21, 45),
    "page edge": (16, 32, 48),
    "total below start + C": (24, 21, 30),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_with_tensor_start_equals_int_form_and_reference(case):
    C, start, total = CHUNK_CASES[case]
    H, KVH, D, ps, pps = 4, 2, 64, 16, 6
    rs = np.random.RandomState(1)
    q = rs.randn(C, H, D).astype(np.float32)
    kp, vp = (rs.randn(KVH, 20, ps, D).astype(np.float32) for _ in range(2))
    table = rs.permutation(np.arange(1, 20))[:pps].astype(np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table)]
    ints = tops.paged_attention_chunk(*args, start, total)
    meta = torch.tensor([start, total], dtype=torch.int32)
    forms = [[torch.tensor(x, dtype=torch.int32).reshape(shape) for x in (start, total)]
             for shape in ((1,), ())]  # [1] tensors apart, and scalars
    for form in forms + [[meta[:1], meta[1:]]]:  # and halves of one, as the programs pass them
        assert torch.equal(tops.paged_attention_chunk(*args, *form), ints)
    want = j_chunk_reference(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(table), start, total, D ** -0.5)
    np.testing.assert_allclose(ints.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ (c)-(e)

def _concurrent(engine, prompts, max_tokens):
    """Every prompt submitted at once, one thread each."""
    results = [None] * len(prompts)

    def work(i):
        results[i] = engine.generate(prompts[i], max_tokens=max_tokens, timeout_s=TIMEOUT_S)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a request did not finish"
    return results


def _against_reference(name, prompts, max_tokens, **engine_kw):
    """Both engines, one EngineConfig, the prompts served concurrently ->
    (port results, reference results, port engine stats, reference stats)."""
    jcfg, jparams, tcfg, tparams = _both(name)
    kw = dict(ENGINE_KW, **engine_kw)
    jeng = JInferenceEngine(jparams, jcfg, JEngineConfig(
        **{k: (dict(v) if k == "speculation" else v) for k, v in kw.items()}))
    teng = None
    try:
        want = _concurrent(jeng, prompts, max_tokens)
        teng = InferenceEngine(tparams, tcfg, EngineConfig(**kw), device="cpu")
        got = _concurrent(teng, prompts, max_tokens)
        return got, want, teng.stats(), jeng.stats()
    finally:
        if teng is not None:
            teng.stop()
        jeng.stop()


def _assert_same(got, want, logprobs=True):
    for g, w in zip(got, want):
        assert g["token_ids"] == w["token_ids"]
        assert g["finish_reason"] == w["finish_reason"] == "length"
        if logprobs:
            np.testing.assert_allclose(g["logprobs"], w["logprobs"], **LOGPROB_TOL)


# three prompts in bucket 16 (no chunking: each <= prefill_chunk)
SAME_BUCKET = [[5, 6, 7, 8, 9], list(range(3, 15)), [(i * 7) % 60 + 1 for i in range(16)]]


def test_same_bucket_prompts_waiting_for_one_slot_match_reference():
    # one decode slot: while the first request decodes, the other two
    # prefill with the same program and wait in the ready list together
    got, want, stats, _ = _against_reference("tiny-llama", SAME_BUCKET, 8, max_batch_size=1)
    _assert_same(got, want)
    assert stats["free_pages"] == ENGINE_KW["max_pages"] - 1


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_padded_prefill_tiers_match_reference(name):
    # prefill_batch_size=4: tiers 1, 4, 8, ...; five prompts of two buckets
    # drain into padded batches with dummy rows
    prompts = SAME_BUCKET + [[9, 1, 3], [(i * 5) % 50 + 2 for i in range(14)]]
    got, want, _, _ = _against_reference(name, prompts, 8, max_batch_size=2,
                                         prefill_batch_size=4)
    _assert_same(got, want)


def test_draft_speculation_with_a_long_prompt_matches_reference():
    # a 40-token prompt chunks on the target (16 a chunk) and, at install,
    # through the draft chunk program into the draft pool; with one decode
    # slot the short prompts wait for install too. Self-speculation in f32:
    # the same drafts are proposed and accepted as in the reference
    spec = {"mode": "draft", "num_speculative_tokens": 4}
    prompts = [[(i * 11) % 97 + 1 for i in range(40)], [5, 6, 7, 8, 9], list(range(3, 15))]
    got, want, stats, jstats = _against_reference("tiny-llama", prompts, 16,
                                                  max_batch_size=1, speculation=spec)
    _assert_same(got, want, logprobs=False)
    # the draft pool holds the prompts' KV: self-speculation accepts nearly
    # every draft, as in the reference (the counts differ with the span
    # picker's cost model, SpecDecoder._SPAN_ALPHA)
    assert stats["spec_proposed_tokens"] > 0 and jstats["spec_proposed_tokens"] > 0
    assert stats["spec_acceptance_rate"] >= 0.9 and jstats["spec_acceptance_rate"] >= 0.9
