"""The port's telemetry against ray_tpu's on the CPU.

The modules the port copies (core/metrics.py, util/slo.py, util/tracing.py,
the flags of core/config.py) give the reference's outputs on the same
inputs: metric values, Prometheus text, digest quantiles and snapshots
(byte-equal as JSON), the SLO switch and the tracing API. Then both
engines serve one greedy request set and every count the reference's
engine exports must come out equal: counters, histogram counts, digest
counts, tokens per decode step and the prefix digest. Times differ between
the packages; counts must not. The engines run with adaptive_span off, so
that the number of decode spans does not depend on when the prefill
thread finishes.
"""

import json
import uuid

import jax
import numpy as np
import pytest

import ray_tpu.models as jmodels
from ray_tpu.core import metrics as jmetrics
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu.serve.engine import Request as JRequest
from ray_tpu.util import slo as jslo
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch import EngineConfig, InferenceEngine, get_config
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.core import metrics as tmetrics
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve.engine import Request as TRequest
from ray_tpu_torch.serve.spec_decode import SpecDecoder
from ray_tpu_torch.util import slo as tslo
from ray_tpu_torch.util import tracing as ttracing

ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16, decode_span=4,
                 adaptive_span=False)
TIMEOUT_S = 120
PACKAGES = {"reference": (jmetrics, jslo, jtracing), "port": (tmetrics, tslo, ttracing)}


# ------------------------------------------------------------ the copies

def _exercise_metrics(m, reg):
    c = m.Counter("t_requests", "Requests.", registry_=reg)
    g = m.Gauge("t_running", "Running.", registry_=reg)
    h = m.Histogram("t_latency", "Latency.", buckets=(0.01, 0.1, 1.0), registry_=reg)
    mh = m.Histogram("t_micro", "", buckets=m.MICRO_BUCKETS, registry_=reg)
    rs = np.random.RandomState(0)
    for i in range(50):
        c.inc(tags={"finish_reason": ("stop", "length")[i % 2]})
        c.inc(float(i % 3))
        g.set(i, tags={"role": "colocated"})
        g.add(-0.5)
        h.observe(float(rs.exponential(0.2)), tags={"phase": "verify"})
        mh.observe(float(rs.exponential(1e-3)))
    with g.track(tags={"role": "x"}):
        inside = g.get(tags={"role": "x"})
    with pytest.raises(ValueError):
        c.inc(-1.0)
    return {"counter": [c.get(tags={"finish_reason": "stop"}), c.get()],
            "gauge": [g.get(tags={"role": "colocated"}), g.get(), inside,
                      g.get(tags={"role": "x"})],
            "histogram": [h.count(tags={"phase": "verify"}), h.sum(tags={"phase": "verify"}),
                          mh.count()],
            "text": reg.render_prometheus(),
            "snapshot": reg.snapshot(),
            "merged": m.render_merged(reg, {"node-a" * 4: {"role": "decode",
                                                           "metrics": reg.snapshot()}})}


def test_metrics_match_reference():
    want = _exercise_metrics(jmetrics, jmetrics.MetricsRegistry())
    got = _exercise_metrics(tmetrics, tmetrics.MetricsRegistry())
    assert got == want
    assert "# TYPE t_latency histogram" in got["text"]
    assert 't_latency_bucket{phase="verify",le="+Inf"} 50.0' in got["text"]


def test_the_port_keeps_its_own_registry():
    assert tmetrics.registry is not jmetrics.registry
    assert tmetrics.registry.get("serve_ttft_seconds") is not None
    assert tmetrics.registry.get("serve_spec_proposed_tokens") is not None


def test_slo_digests_match_reference():
    assert tslo.BUCKET_BOUNDS == jslo.BUCKET_BOUNDS
    rs = np.random.RandomState(1)
    values = rs.lognormal(-3, 1.5, 400).tolist() + [5e-5, 250.0, 1e-4, 100.0]
    out = {}
    for name, (_m, slo, _t) in PACKAGES.items():
        a = slo.Digest("serve_ttft_seconds", {"role": "colocated"}, window_s=60.0)
        b = slo.Digest("serve_ttft_seconds", {"role": "colocated"}, window_s=60.0)
        for i, v in enumerate(values):
            (a if i % 3 else b).add(v, n=1 + i % 2, now=100.0 + 0.1 * i)
        now = 100.0 + 0.1 * len(values)
        snaps = [a.to_snapshot(now), b.to_snapshot(now)]
        merged = slo.merge_snapshots(snaps)
        key = next(iter(merged))
        out[name] = json.dumps({
            "quantiles": [a.quantile(q, now) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            "snapshots": snaps,
            "merged": {"key": key, **merged[key]},
            "merged_p95": slo.quantile_from_counts(merged[key]["counts"], 0.95),
            "sparse": slo.quantile_from_counts({3: 2, 70: 5}, 0.5),
            "empty": slo.quantile_from_counts([0] * 5, 0.5),
        }, sort_keys=True)
    assert out["port"] == out["reference"]


def test_slo_switch_and_window_read_the_environment(monkeypatch):
    for _name, (_m, slo, _t) in PACKAGES.items():
        assert slo.enabled() is True
    monkeypatch.setenv("RAY_TPU_SLO_DIGESTS", "0")
    monkeypatch.setenv("RAY_TPU_SLO_DIGEST_WINDOW_S", "12")
    for _name, (_m, slo, _t) in PACKAGES.items():
        assert slo.enabled() is False
        assert slo.Digest("x")._slice_s == 2.0
    assert tconfig.config.slo_digest_window_s == 12.0
    with pytest.raises(KeyError):
        tconfig.config.get("no_such_flag")


def test_slo_off_means_no_digest_work(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SLO_DIGESTS", "0")
    cfg = get_config("tiny-llama")
    engine = InferenceEngine(_np_weights("tiny-llama")[1], cfg, EngineConfig(**ENGINE_KW),
                             device="cpu")
    engine.slo_role = f"off-{uuid.uuid4().hex}"
    try:
        assert engine._slo_on is False
        engine.generate([1, 2, 3, 4], max_tokens=9, timeout_s=TIMEOUT_S)
        assert engine._slo == {}
        assert not [s for s in tslo.snapshot() if dict(s["tags"]).get("role") == engine.slo_role]
    finally:
        engine.stop()


def test_tracing_api_matches_reference(monkeypatch):
    for name, (_m, _s, tracing) in PACKAGES.items():
        monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_RATE", "0")
        tracing.clear()
        # the drain cursor counts every span this process recorded
        base, _ = tracing.drain_since(0)
        with tracing.span_if_traced("quiet") as s:
            assert s is None
        assert tracing.get_spans() == [] and tracing.maybe_begin("x") is None
        assert tracing.current_context() is None
        with tracing.start_span("root", {"route": "/t"}) as root:
            assert tracing.current_context() == root.context()
            with tracing.span_if_traced("child", {"i": 1}) as child:
                assert child.parent_id == root.span_id
            open_span = tracing.maybe_begin("later")
        with tracing.activate(open_span):
            with tracing.start_span("resumed"):
                pass
        open_span.finish()
        open_span.finish()  # idempotent
        with tracing.activate({"trace_id": root.trace_id, "span_id": "remote"}):
            with tracing.start_span("remote-child") as rc:
                assert rc.parent_id == "remote"
        monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_RATE", "1.0")
        assert tracing.should_sample() is True
        tree = tracing.get_trace(root.trace_id[:12])
        assert [n["name"] for n in tree] == ["root", "remote-child"], name
        assert sorted(c["name"] for c in tree[0]["children"]) == ["child", "later"]
        assert tree[0]["children"][1]["children"][0]["name"] == "resumed"
        cursor, recs = tracing.drain_since(base)
        assert cursor == base + 5 and len(recs) == 5
        assert tracing.drain_since(0) == (cursor, recs)
        assert tracing.drain_since(cursor) == (cursor, [])
        tracing.clear()
        assert tracing.ingest(recs + recs) == 5
        assert tracing.ingest(recs) == 0


def test_generate_records_one_engine_span_in_both_packages(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_RATE", "0")
    jeng, teng = _engines("tiny-llama")
    try:
        for engine, (_m, _s, tracing) in ((jeng, PACKAGES["reference"]),
                                          (teng, PACKAGES["port"])):
            tracing.clear()
            engine.generate([1, 2, 3], max_tokens=2, timeout_s=TIMEOUT_S)
            assert tracing.get_spans() == []  # untraced: no span
            with tracing.start_span("request") as root:
                engine.generate([1, 2, 3], max_tokens=2, request_id="rid-7",
                                timeout_s=TIMEOUT_S)
            spans = [s for s in tracing.get_spans(root.trace_id) if s["name"] != "request"]
            assert [(s["name"], s["attrs"], s["parent_id"]) for s in spans] == [
                ("engine.generate", {"request_id": "rid-7"}, root.span_id)]
    finally:
        jeng.stop()
        teng.stop()


# --------------------------------------------------------- engine counts

def _np_weights(name):
    cfg = jmodels.get_config(name)
    tree = jax.tree.map(np.asarray, jmodels.init_params(cfg, jax.random.PRNGKey(0)))
    return tree, params_from_numpy(tree, device="cpu")


def _engines(name, **kw):
    ecfg = dict(ENGINE_KW, **kw)
    tree, tparams = _np_weights(name)
    jeng = JInferenceEngine(tree, jmodels.get_config(name), JEngineConfig(**ecfg))
    teng = InferenceEngine(tparams, get_config(name), EngineConfig(**ecfg), device="cpu")
    role = f"telemetry-{uuid.uuid4().hex}"
    jeng.slo_role = teng.slo_role = role
    return jeng, teng


SERVE_METRICS = ("serve_requests_finished", "serve_tokens_generated",
                 "serve_prefix_cache_hit_tokens", "serve_ttft_seconds",
                 "serve_decode_step_phase_seconds", "serve_spec_proposed_tokens",
                 "serve_spec_accepted_tokens")


def _counts(m):
    """{(sample, tags): value} of the engine's counters and of the
    histograms' _count samples (times differ between the packages)."""
    out = {}
    for fam in m.registry.snapshot():
        if fam["name"] not in SERVE_METRICS:
            continue
        for sample, tags, value in fam["samples"]:
            if fam["kind"] == "counter" or sample.endswith("_count"):
                out[(sample, tuple(tuple(t) for t in tags))] = value
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v - before.get(k, 0.0)}


def _digest_counts(slo, role):
    return {s["name"]: s["count"] for s in slo.snapshot()
            if dict(map(tuple, s["tags"])).get("role") == role}


def _drive(engine, request_cls, stop_tok):
    """The request set: bucketed prompts, a chunked one, a prefix hit, a
    stop sequence, a streamed prefill_only export (layer-major frames) and
    a cancelled request. Sequential, greedy."""
    long_prompt = [(i * 7) % 60 + 1 for i in range(40)]
    out = [engine.generate(p, max_tokens=n, timeout_s=TIMEOUT_S) for p, n in (
        ([5, 6, 7, 8, 9, 10], 9), (list(range(3, 20)), 6), (long_prompt, 7),
        (long_prompt[:32] + [9, 8, 7], 5))]
    out.append(engine.generate([5, 6, 7, 8, 9, 10], max_tokens=9, stop=[[stop_tok]],
                               timeout_s=TIMEOUT_S))
    frames = []
    req = request_cls(request_id="export", prompt=list(range(2, 36)), max_tokens=4,
                      prefill_only=True, kv_sink=frames.append)
    engine.add_request(req)
    assert req.done.wait(TIMEOUT_S) and req.finish_reason == "prefill_done"
    return out, len(frames)


def test_engine_counts_match_reference():
    jeng, teng = _engines("tiny-llama")
    try:
        # a stop token from a first run, on both engines before the counts
        probe = [e.generate([5, 6, 7, 8, 9, 10], max_tokens=9, timeout_s=TIMEOUT_S)
                 for e in (jeng, teng)]
        assert probe[0]["token_ids"] == probe[1]["token_ids"]
        stop_tok = probe[0]["token_ids"][4]
        results = {}
        for name, engine, request_cls in (("reference", jeng, JRequest),
                                          ("port", teng, TRequest)):
            m, slo, _t = PACKAGES[name]
            before, digests = _counts(m), _digest_counts(slo, engine.slo_role)
            out, n_frames = _drive(engine, request_cls, stop_tok)
            results[name] = {
                "tokens": [r["token_ids"] for r in out],
                "reasons": [r["finish_reason"] for r in out],
                "frames": n_frames,
                "counts": _delta(before, _counts(m)),
                "digests": _delta(digests, _digest_counts(slo, engine.slo_role)),
                "tokens_per_step": engine.stats()["tokens_per_decode_step"],
                "gauge": m.registry.get("serve_tokens_per_decode_step").get(),
                "prefix_digest": engine.prefix_digest(),
            }
            results[name]["gauge"] = results[name]["gauge"] == results[name]["tokens_per_step"]
        got, want = results["port"], results["reference"]
        assert "stop" in want["reasons"] and want["counts"]
        assert got == want
        emitted = sum(len(r) for r in want["tokens"])
        tokens = want["counts"][("serve_tokens_generated", ())]
        assert tokens >= emitted + 1  # the export's first token; the stop is stripped
        assert want["digests"]["serve_ttft_seconds"] == 6
        phases = {dict(tags)["phase"] for sample, tags in want["counts"]
                  if sample == "serve_decode_step_phase_seconds_count"}
        assert phases == {"cancellation_check", "verify", "sample", "cache_bookkeeping",
                          "kv_framing"}
        assert want["digests"]["serve_e2e_seconds"] == 6
        assert len(want["prefix_digest"]["hashes"]) >= 4
    finally:
        jeng.stop()
        teng.stop()


def test_speculation_counts_match_reference(monkeypatch):
    # the reference's span picker (alpha 1.0): the width S sets how many
    # drafts a round proposes, so the packages must pick the same S
    monkeypatch.setattr(SpecDecoder, "_SPAN_ALPHA", 1.0)
    jeng, teng = _engines("tiny-llama", speculation={"mode": "ngram",
                                                     "num_speculative_tokens": 3})
    prompts = [[1, 2, 3, 4] * 4, [7, 8, 9] * 5 + [7], [11, 12, 13, 14, 15, 16]]
    try:
        results = {}
        for name, engine in (("reference", jeng), ("port", teng)):
            m, slo, _t = PACKAGES[name]
            before, digests = _counts(m), _digest_counts(slo, engine.slo_role)
            tokens = [engine.generate(p, max_tokens=12, timeout_s=TIMEOUT_S)["token_ids"]
                      for p in prompts]
            stats = engine.stats()
            results[name] = {
                "tokens": tokens,
                "counts": _delta(before, _counts(m)),
                "digests": _delta(digests, _digest_counts(slo, engine.slo_role)),
                "spec": {k: v for k, v in stats.items() if k.startswith("spec_")},
                "rate": m.registry.get("serve_spec_acceptance_rate").get(),
            }
        got, want = results["port"], results["reference"]
        assert want["counts"][("serve_spec_proposed_tokens", ())] > 0
        modes = {tags for sample, tags in want["counts"]
                 if sample == "serve_decode_step_phase_seconds_count"}
        assert (("mode", "spec"), ("phase", "propose_wait")) in modes
        assert got == want
    finally:
        jeng.stop()
        teng.stop()
