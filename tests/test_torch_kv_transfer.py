"""KV export, import and streamed migration in the port's engine
(ray_tpu_torch/serve/engine.py), held against the reference engine on the
CPU.

The port's counterparts of tests/test_disagg.py's TestKvRoundTrip and
TestLayerMajorFraming run on tiny-llama: a blob and a frame stream exported
at page size 8 import at page size 4, on the bucketed and the chunked
prefill path, and the continuation is token-identical to an uninterrupted
engine; then the prefix-cache variant, a mismatched prompt, the wire
version guard, a frame outside the staged layers or tokens, an abort
mid-stream on both sides, a cancel of a staged import, an import into an
ngram-speculation engine, and an export while every decode slot is busy.

Across the packages, on tiny-llama and tiny-moe, bucketed and chunked: a
blob and a layer-major frame stream exported by the reference engine
import into the port's engine, and those of the port into the reference's,
each from page size 8 to 4, and both continue token-identically to an
uninterrupted engine. The two packages' exported KV agree within KV_TOL.

Every engine is built once per module (the JAX engines compile once per
shape) and stopped at the module's end; every wait has a timeout.
"""

import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu.serve import engine as jengine
from ray_tpu.serve.engine import EngineConfig as JEngineConfig
from ray_tpu.serve.engine import InferenceEngine as JInferenceEngine
from ray_tpu.serve.engine import Request as JRequest
from ray_tpu_torch import EngineConfig, InferenceEngine, get_config
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.serve.engine import Request
from ray_tpu_torch.serve.spec_decode import SpecDecoder

pytestmark = pytest.mark.disagg

TIMEOUT_S = 120
MAX_TOKENS = 8
# the reference test's engine; no prefix cache on the shared engines, so
# that every export of a case runs the path the case names
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=96,
                 prefill_buckets=(16, 32), prefill_chunk=16, prefix_caching=False)
DST_KW = dict(ENGINE_KW, page_size=4, max_pages=128)
# prompt lengths: within prefill_chunk (bucketed prefill, K2 on the card)
# and over it (three chunks of 16, K6)
LENGTHS = {"bucketed": 13, "chunked": 40}
# both packages' KV is bf16 in the pool, computed in f32 along the two
# packages' own operation orders: one bf16 rounding step (2^-8 relative)
# apart at most, where a value lies near a rounding boundary
KV_TOL = dict(rtol=2 ** -7, atol=1e-6)


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, cfg.vocab_size, size=n)]


def _fleet(name):
    """The reference's and the port's engines over one set of weights:
    port src (page 8), dst (page 4) and ref (page 8, uninterrupted); JAX
    jsrc (page 8) and jdst (page 4)."""
    jcfg = jmodels.get_config(name)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config(name)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    f = {"cfg": tcfg, "params": tparams,
         "src": InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW), device="cpu"),
         "dst": InferenceEngine(tparams, tcfg, EngineConfig(**DST_KW), device="cpu"),
         "ref": InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW), device="cpu"),
         "jsrc": JInferenceEngine(jparams, jcfg, JEngineConfig(**ENGINE_KW)),
         "jdst": JInferenceEngine(jparams, jcfg, JEngineConfig(**DST_KW))}
    return f


def _stop(fleet):
    for key in ("src", "dst", "ref", "jsrc", "jdst"):
        fleet[key].stop()


@pytest.fixture(scope="module")
def llama():
    f = _fleet("tiny-llama")
    yield f
    _stop(f)


@pytest.fixture(scope="module")
def moe():
    f = _fleet("tiny-moe")
    yield f
    _stop(f)


def _fleet_of(request, model):
    return request.getfixturevalue({"tiny-llama": "llama", "tiny-moe": "moe"}[model])


def _want(fleet, prompt):
    return fleet["ref"].generate(prompt, max_tokens=MAX_TOKENS, timeout_s=TIMEOUT_S)["token_ids"]


def _export_blob(src, prompt, request_cls=Request):
    req = request_cls(request_id=uuid.uuid4().hex, prompt=list(prompt), max_tokens=MAX_TOKENS,
                      prefill_only=True)
    src.add_request(req)
    blob = src.export_kv_pages(req, timeout_s=TIMEOUT_S)
    assert req.finish_reason == "prefill_done"
    return blob


def _export_frames(src, prompt, layout="layer", request_cls=Request):
    frames = []
    req = request_cls(request_id=uuid.uuid4().hex, prompt=list(prompt), max_tokens=MAX_TOKENS,
                      prefill_only=True, kv_sink=frames.append, kv_window=8,
                      kv_frame_layout=layout)
    src.add_request(req)
    assert req.done.wait(TIMEOUT_S)
    assert req.error is None, req.error
    assert req.finish_reason == "prefill_done"
    return frames


def _import_blob(dst, prompt, blob, request_cls=Request):
    req = request_cls(request_id=uuid.uuid4().hex, prompt=list(prompt), max_tokens=MAX_TOKENS)
    dst.import_kv_pages(req, blob)
    assert req.done.wait(TIMEOUT_S)
    assert req.error is None, req.error
    return req


def _import_frames(dst, prompt, frames, request_cls=Request):
    meta = next(f for f in frames if f["seq"] == 0)
    last = next(f for f in frames if f["last"])
    req = request_cls(request_id=uuid.uuid4().hex, prompt=list(prompt), max_tokens=MAX_TOKENS)
    assert dst.begin_kv_import(req, meta["true_len"], meta)
    for f in frames:
        dst.ingest_kv_chunk(req, f)
    dst.finish_kv_import(req, last["first_token"], last.get("first_logprob"))
    assert req.done.wait(TIMEOUT_S)
    assert req.error is None, req.error
    return req


def _wait_free(engine, want):
    """Free pages return to `want` (page frees trail the request's
    completion on the decode thread only by a step)."""
    for _ in range(400):
        if engine.stats()["free_pages"] == want:
            return
        threading.Event().wait(0.025)
    assert engine.stats()["free_pages"] == want


# ------------------------------------------------------------ module helpers


def test_page_helpers_match_reference():
    """_gather_pages / _scatter_pages against the reference's jitted forms,
    a partial last page included; _kv_layer_groups and
    prompt_page_fingerprints equal the reference's."""
    rng = np.random.default_rng(0)
    L, KVH, P, ps, hd = 3, 2, 9, 4, 8
    pool_k = rng.standard_normal((L, KVH, P, ps, hd)).astype(np.float32)
    pool_v = rng.standard_normal((L, KVH, P, ps, hd)).astype(np.float32)
    pages = [5, 2, 7]
    jk, jv = jengine._gather_pages_jit(pool_k, pool_v, np.asarray(pages, np.int32))
    tk, tv = tengine._gather_pages(torch.from_numpy(pool_k), torch.from_numpy(pool_v), pages)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    T = 10  # three pages, the last holding 2 tokens
    k = rng.standard_normal((L, T, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((L, T, KVH, hd)).astype(np.float32)
    pad = np.zeros((L, 12 - T, KVH, hd), np.float32)
    want_k, want_v = jengine._scatter_pages_jit(
        pool_k.copy(), pool_v.copy(), np.concatenate([k, pad], 1), np.concatenate([v, pad], 1),
        np.asarray(pages, np.int32), 3, ps)
    got_k, got_v = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    ptr = got_k.data_ptr()
    tengine._scatter_pages(got_k, got_v, torch.from_numpy(k), torch.from_numpy(v), pages)
    assert got_k.data_ptr() == ptr  # in place
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    for n in range(1, 10):
        assert tengine._kv_layer_groups(n) == jengine._kv_layer_groups(n)
    prompt = _prompt(get_config("tiny-llama"), 37, seed=1)
    for page_size in (4, 8, 16):
        assert (tengine.prompt_page_fingerprints(prompt, page_size)
                == jengine.prompt_page_fingerprints(prompt, page_size))


# ----------------------------------------------- the port to the port (8 -> 4)


@pytest.mark.parametrize("path", list(LENGTHS))
def test_import_into_smaller_pages_token_exact(llama, path):
    """A blob exported at page size 8 imports at page size 4 and continues
    token-identically; the import scatters into the pool in place."""
    prompt = _prompt(llama["cfg"], LENGTHS[path], seed=11)
    want = _want(llama, prompt)
    blob = _export_blob(llama["src"], prompt)
    assert blob["k"].dtype == np.float32 and blob["dtype"] == "float32"
    assert blob["k"].shape == (llama["cfg"].n_layers, len(prompt), llama["cfg"].kv_heads,
                               llama["cfg"].hdim)
    ptr = llama["dst"].k_pages.data_ptr()
    req = _import_blob(llama["dst"], prompt, blob)
    assert req.output == want
    assert req.finish_reason == "length"
    assert llama["dst"].k_pages.data_ptr() == ptr


@pytest.mark.parametrize("layout,path", [("layer", "bucketed"), ("layer", "chunked"),
                                         ("token", "bucketed"), ("token", "chunked")])
def test_frames_token_exact_mismatched_pages(llama, layout, path):
    """A streamed export, layer-major (wire v2) or token-major (v1), imports
    at page size 4 token-identically; the frames are the reference's wire
    format, and chunked frames before the last end on a page boundary."""
    cfg = llama["cfg"]
    prompt = _prompt(cfg, LENGTHS[path], seed=31)
    want = _want(llama, prompt)
    frames = _export_frames(llama["src"], prompt, layout)
    meta = next(f for f in frames if f["seq"] == 0)
    assert [f["seq"] for f in frames] == list(range(len(frames)))
    assert sum(f["last"] for f in frames) == 1 and frames[-1]["last"]
    assert meta["layers"] == cfg.n_layers and meta["true_len"] == len(prompt)
    assert (meta["kv_heads"], meta["head_dim"], meta["dtype"]) == (cfg.kv_heads, cfg.hdim,
                                                                   "float32")
    if layout == "layer":
        assert meta["kv_wire"] == 2
        assert all("layer0" in f for f in frames)
        assert any(f["layer0"] > 0 for f in frames)
        assert all(f["k"].shape[0] < cfg.n_layers for f in frames)
    else:
        assert "kv_wire" not in meta
        assert all("layer0" not in f for f in frames)
        assert all(f["k"].shape[0] == cfg.n_layers for f in frames)
    if path == "chunked":  # frames sent before the last chunk end on a page boundary
        ends = {f["start"] + f["k"].shape[1] for f in frames}
        assert min(ends) % 8 == 0 and max(ends) == len(prompt)
    req = _import_frames(llama["dst"], prompt, frames)
    assert req.output == want


def test_prefix_cache_variant(llama):
    """A prefill_only request registers its prompt's pages in the prefix
    cache, and a shared-prefix export after it starts past the cached
    pages and stays token-exact."""
    cfg = llama["cfg"]
    src = InferenceEngine(llama["params"], cfg, EngineConfig(**dict(ENGINE_KW,
                                                                    prefix_caching=True)),
                          device="cpu")
    starts = []
    chunk_step = src._chunk_step

    def recorded(tokens, start, table, last_idx):
        starts.append(start)
        return chunk_step(tokens, start, table, last_idx)

    src._chunk_step = recorded
    try:
        rng = np.random.default_rng(3)
        shared = [int(t) for t in rng.integers(1, cfg.vocab_size, size=16)]
        a = shared + [int(t) for t in rng.integers(1, cfg.vocab_size, size=5)]
        b = shared + [int(t) for t in rng.integers(1, cfg.vocab_size, size=9)]
        for prompt in (a, b):
            want = _want(llama, prompt)
            blob = _export_blob(src, prompt)
            assert _import_blob(llama["dst"], prompt, blob).output == want
        assert src.stats()["cached_pages"] >= 2
        # a: chunks at 0 and 16; b: the cached 16 tokens skipped
        assert starts == [0, 16, 16]
    finally:
        src.stop()


def test_import_rejects_mismatched_prompt(llama):
    prompt = _prompt(llama["cfg"], 9, seed=4)
    blob = _export_blob(llama["src"], prompt)
    free = llama["dst"].stats()["free_pages"]
    bad = Request(request_id=uuid.uuid4().hex, prompt=prompt + [1, 2], max_tokens=4)
    llama["dst"].import_kv_pages(bad, blob)
    assert bad.done.wait(30)
    assert "covers 9 tokens but the prompt has 11" in bad.error
    assert llama["dst"].stats()["free_pages"] == free


def test_wire_version_guard_rejects_future_format(llama):
    cfg = llama["cfg"]
    req = Request(request_id=uuid.uuid4().hex, prompt=[1, 2, 3], max_tokens=4)
    meta = {"layers": cfg.n_layers, "kv_heads": cfg.kv_heads, "head_dim": cfg.hdim,
            "dtype": "bfloat16", "kv_wire": 3}
    assert not llama["dst"].begin_kv_import(req, 3, meta)
    assert req.done.is_set()
    assert "kv wire format v3" in req.error


@pytest.mark.parametrize("bad", ["layers", "tokens", "heads"])
def test_frame_outside_staged_import_rejected(llama, bad):
    """A frame past the staged layers or tokens, or of another head shape,
    raises; abort then frees the staged pages and fails the request."""
    cfg, dst = llama["cfg"], llama["dst"]
    prompt = [1, 2, 3, 4, 5]
    free = dst.stats()["free_pages"]
    req = Request(request_id=uuid.uuid4().hex, prompt=prompt, max_tokens=4)
    meta = {"layers": cfg.n_layers, "kv_heads": cfg.kv_heads, "head_dim": cfg.hdim,
            "dtype": "float32", "kv_wire": 2}
    assert dst.begin_kv_import(req, len(prompt), meta)
    shape, frame = (1, 5, cfg.kv_heads, cfg.hdim), {"start": 0, "layer0": 0}
    if bad == "layers":
        frame["layer0"] = cfg.n_layers  # one past the last layer
    elif bad == "tokens":
        frame["start"] = 4  # 5 tokens from 4 run past the staged 8 (two pages of 4)
    else:
        shape = (1, 5, cfg.kv_heads + 1, cfg.hdim)
    frame.update(k=np.zeros(shape, np.float32), v=np.zeros(shape, np.float32))
    with pytest.raises(ValueError, match={"layers": "layers", "tokens": "tokens",
                                          "heads": "do not match"}[bad]):
        dst.ingest_kv_chunk(req, frame)
    dst.abort_kv_import(req, error="bad frame")
    assert req.done.is_set() and req.error == "bad frame"
    assert dst.stats()["free_pages"] == free


def test_abort_mid_stream_frees_pages_both_sides(llama):
    """A sink that dies mid-stream fails its prefill request and returns
    its pages; a decode side tearing down a half-staged layer-major import
    frees the staged pages too."""
    src, dst = llama["src"], llama["dst"]
    prompt = _prompt(llama["cfg"], 40, seed=33)
    frames = _export_frames(src, prompt, "layer")
    assert len(frames) >= 3
    src_free = src.stats()["free_pages"]
    calls = [0]

    def dying_sink(frame):
        calls[0] += 1
        if calls[0] > 2:
            raise RuntimeError("decode replica died mid-slab")

    req = Request(request_id=uuid.uuid4().hex, prompt=prompt, max_tokens=8, prefill_only=True,
                  kv_sink=dying_sink, kv_window=8, kv_frame_layout="layer")
    src.add_request(req)
    assert req.done.wait(60), "prefill hung on a dead sink"
    assert req.error and "kv stream failed" in req.error
    _wait_free(src, src_free)

    dst_free = dst.stats()["free_pages"]
    meta = frames[0]
    dreq = Request(request_id=uuid.uuid4().hex, prompt=prompt, max_tokens=8)
    assert dst.begin_kv_import(dreq, meta["true_len"], meta)
    assert dst.stats()["free_pages"] < dst_free
    for f in frames[:2]:
        dst.ingest_kv_chunk(dreq, f)
    dst.abort_kv_import(dreq, error="prefill replica died")
    assert dreq.done.is_set() and "prefill replica died" in dreq.error
    assert dst.stats()["free_pages"] == dst_free


def test_cancel_sweeps_staged_import(llama):
    """cancel() of a request whose streamed import is staged frees its
    pages and finishes it; later frames and the finish find nothing."""
    cfg, dst = llama["cfg"], llama["dst"]
    prompt = _prompt(cfg, 12, seed=5)
    frames = _export_frames(llama["src"], prompt)
    free = dst.stats()["free_pages"]
    req = Request(request_id=uuid.uuid4().hex, prompt=prompt, max_tokens=8)
    assert dst.begin_kv_import(req, len(prompt), frames[0])
    assert dst.cancel(req.request_id)
    assert req.done.is_set() and req.finish_reason == "cancelled"
    assert dst.stats()["free_pages"] == free
    with pytest.raises(ValueError, match="no staged kv import"):
        dst.ingest_kv_chunk(req, frames[1])
    assert dst.finish_kv_import(req, frames[-1]["first_token"]) is req
    assert req.output == []


def _planted_prompt(fleet, n):
    """A prompt of n tokens with the first token the engine generates for
    it planted in its middle, where the edit leaves that token as it was."""
    for seed in range(20):
        prompt = _prompt(fleet["cfg"], n, seed=100 + seed)
        first = fleet["ref"].generate(prompt, max_tokens=1, timeout_s=TIMEOUT_S)["token_ids"][0]
        for at in range(n // 3, 2 * n // 3):
            planted = prompt[:at] + [first] + prompt[at + 1:]
            if fleet["ref"].generate(planted, max_tokens=1,
                                     timeout_s=TIMEOUT_S)["token_ids"][0] == first:
                return planted
    raise AssertionError("no prompt kept its first output token under the edit")


def test_import_into_ngram_speculation_engine(llama, monkeypatch):
    """An imported request decodes under ngram speculation (the proposer
    sees the imported prompt at install) token-identically to plain
    decoding, and drafts were verified."""
    cfg = llama["cfg"]
    # the span picker's cost model fitted to the card's graphs (alpha 60)
    # prices a verify on the CPU out; the reference's alpha lets it verify
    monkeypatch.setattr(SpecDecoder, "_SPAN_ALPHA", 1.0)
    dst = InferenceEngine(llama["params"], cfg, EngineConfig(**dict(
        DST_KW, speculation={"mode": "ngram", "num_speculative_tokens": 3})), device="cpu")
    try:
        # a 30-token (chunked) prompt holding its own first output token in
        # its middle, so that the proposer finds an n-gram to draft from
        prompt = _planted_prompt(llama, 30)
        want = _want(llama, prompt)
        req = _import_blob(dst, prompt, _export_blob(llama["src"], prompt))
        assert req.output == want
        assert dst.stats()["spec_proposed_tokens"] > 0
    finally:
        dst.stop()


def test_prefill_only_export_while_every_slot_is_busy(llama):
    """A prefill_only request takes no decode slot: its export completes
    while the engine's only slot is still decoding another request, and
    that request's output is unchanged."""
    cfg = llama["cfg"]
    src = InferenceEngine(llama["params"], cfg, EngineConfig(**dict(
        ENGINE_KW, max_batch_size=1, decode_span=1, adaptive_span=False)), device="cpu")
    span = src._decode_span

    def slow_span(*args):
        threading.Event().wait(0.005)  # keep the busy request decoding for a while
        return span(*args)

    src._decode_span = slow_span
    try:
        busy_prompt = _prompt(cfg, 10, seed=7)
        busy_want = llama["ref"].generate(busy_prompt, max_tokens=60,
                                          timeout_s=TIMEOUT_S)["token_ids"]
        busy, tokens = src.open_stream(busy_prompt, max_tokens=60, timeout_s=TIMEOUT_S)
        next(tokens)  # the busy request holds the slot now
        prompt = _prompt(cfg, 14, seed=8)
        blob = _export_blob(src, prompt)
        assert not busy.done.is_set(), "the busy request ended before the export"
        assert _import_blob(llama["dst"], prompt, blob).output == _want(llama, prompt)
        assert busy.done.wait(TIMEOUT_S) and busy.output == busy_want
    finally:
        src.stop()


# ----------------------------------------------------- across the packages

CROSS = [(model, path, direction) for model in ("tiny-llama", "tiny-moe")
         for path in LENGTHS for direction in ("reference_to_port", "port_to_reference")]


def _ends(fleet, direction):
    """(exporting engine, its Request class, importing engine, its Request class)."""
    if direction == "reference_to_port":
        return fleet["jsrc"], JRequest, fleet["dst"], Request
    return fleet["src"], Request, fleet["jdst"], JRequest


@pytest.mark.parametrize("model,path,direction", CROSS)
def test_blob_crosses_packages(request, model, path, direction):
    """A blob exported at page size 8 by one package's engine imports at
    page size 4 into the other's and continues token-identically to an
    uninterrupted engine."""
    fleet = _fleet_of(request, model)
    prompt = _prompt(fleet["cfg"], LENGTHS[path], seed=41)
    want = _want(fleet, prompt)
    src, src_req, dst, dst_req = _ends(fleet, direction)
    blob = _export_blob(src, prompt, src_req)
    assert list(_import_blob(dst, prompt, blob, dst_req).output) == want


@pytest.mark.parametrize("model,path,direction", CROSS)
def test_frames_cross_packages(request, model, path, direction):
    """The same with a layer-major (wire v2) frame stream."""
    fleet = _fleet_of(request, model)
    prompt = _prompt(fleet["cfg"], LENGTHS[path], seed=43)
    want = _want(fleet, prompt)
    src, src_req, dst, dst_req = _ends(fleet, direction)
    frames = _export_frames(src, prompt, "layer", src_req)
    assert frames[0]["kv_wire"] == 2
    assert list(_import_frames(dst, prompt, frames, dst_req).output) == want


@pytest.mark.parametrize("model,path", [(m, p) for m in ("tiny-llama", "tiny-moe")
                                        for p in LENGTHS])
def test_exported_kv_agrees_across_packages(request, model, path):
    """The two packages export the same KV for the same prompt within
    KV_TOL (the reference's blob is bf16, the port's float32 holding bf16
    values), and the same first token and logprob."""
    fleet = _fleet_of(request, model)
    prompt = _prompt(fleet["cfg"], LENGTHS[path], seed=47)
    got = _export_blob(fleet["src"], prompt)
    ref = _export_blob(fleet["jsrc"], prompt, JRequest)
    for key in ("k", "v"):
        want = np.asarray(ref[key], np.float32)
        assert got[key].shape == want.shape
        # bf16 values: widening to float32 is exact, so the port's equal bf16 numbers
        np.testing.assert_array_equal(got[key], got[key].astype(jnp.bfloat16).astype(np.float32))
        np.testing.assert_allclose(got[key], want, **KV_TOL)
    assert got["first_token"] == ref["first_token"]
    np.testing.assert_allclose(got["first_logprob"], ref["first_logprob"], atol=1e-4)
