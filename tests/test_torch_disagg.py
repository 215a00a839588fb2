"""Disaggregated prefill/decode serving (ray_tpu_torch.serve.disagg)
against ray_tpu.serve.disagg, on the CPU at tiny-llama.

Every flow of tests/test_disagg.py that runs on one host runs under both
packages, the port on the reference's weights (PRNGKey(0), through
`params_from_numpy`) with device="cpu": the coordinator over EngineWorkers
under the object, channel and stream transports (concurrent mixed
lengths, streams with their finish reason, one connected trace, nothing
recorded for an untraced request), streamed migration into a pool of
another page size (8 -> 4, bucketed and chunked prefill, open_stream, a
prefix-warm destination, the prefix route that skips migration), the
chaos paths (the decode side dying, the prefill dying mid-stream, an idle
stream, a prefill reject), KvInbox hygiene, the kv_dest cache and its
concurrency, deploy_disagg through the serve runtime in thread mode, the
config, and the OpenAI front in coordinator mode over HTTP. The port's
tokens must equal the reference's and the port's own colocated engine's,
logprobs within LOGPROB_TOL; metric deltas and stats() must be equal
between the packages. TestKvRoundTrip and TestLayerMajorFraming live in
tests/test_torch_kv_transfer.py, TestWriterReconnect in
tests/test_torch_dag.py. The cross-host flows (TestDisaggCrossHost) are not
held here yet; their entry point, init(address=), is
(tests/test_torch_cross_host.py).

The engines are built once per module for each package and stopped at the
module's end; every wait carries a timeout.
"""

import json
import threading
import time
import urllib.request
import uuid

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu.models as jmodels
import ray_tpu.serve
import ray_tpu.serve.disagg as jdisagg
import ray_tpu.util.tracing as jtracing
import ray_tpu_torch
import ray_tpu_torch.core.channels
import ray_tpu_torch.serve
import ray_tpu_torch.serve.disagg as tdisagg
import ray_tpu_torch.util.tracing as ttracing
from ray_tpu.core import metrics as jmetrics
from ray_tpu.serve import config as jconfig
from ray_tpu.serve import engine as jengine
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.core import metrics as tmetrics
from ray_tpu_torch.models import get_config, params_from_numpy
from ray_tpu_torch.serve import config as tconfig
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.serve import llm as tllm
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

pytestmark = pytest.mark.disagg

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
# tests/test_disagg.py's engine, and its decode side at page size 4
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=96,
                 prefill_buckets=(16, 32))
DEC_KW = dict(page_size=4, max_pages=96)
LOGPROB_TOL = 1e-4  # tests/test_torch_serve_parity.py
WAIT_S = 120
PACKAGES = ("ray_tpu_torch", "ray_tpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = get_config("tiny-llama")
    return {"jcfg": jcfg, "jparams": jparams, "tree": tree, "tcfg": tcfg,
            "tparams": params_from_numpy(tree, device="cpu")}


class Pkg:
    """One package's disaggregated serving as a flow sees it."""

    def __init__(self, name, tiny):
        self.port = name == "ray_tpu_torch"
        self.api = ray_tpu_torch if self.port else ray_tpu
        self.serve = ray_tpu_torch.serve if self.port else ray_tpu.serve
        self.disagg = tdisagg if self.port else jdisagg
        self.engine_mod = tengine if self.port else jengine
        self.llm = tllm if self.port else jllm
        self.tracing = ttracing if self.port else jtracing
        self.registry = (tmetrics if self.port else jmetrics).registry
        self.cfg = tiny["tcfg"] if self.port else tiny["jcfg"]
        self.params = tiny["tparams"] if self.port else tiny["jparams"]
        self.device = {"device": "cpu"} if self.port else {}
        self.acc = {"num_gpus": 0} if self.port else {"num_tpus": 0}
        # bytes a migrated KV element takes: the port's blobs and frames
        # carry float32, the reference's the pool's bf16 (a deliberate
        # difference: serve_kv_migration_bytes reads twice the reference's)
        self.kv_itemsize = 4 if self.port else 2

    def kv_elems(self, nbytes):
        """Migrated KV elements from a byte count, comparable across the
        packages."""
        assert nbytes % self.kv_itemsize == 0
        return int(nbytes) // self.kv_itemsize

    def engine(self, **kw):
        ecfg = self.engine_mod.EngineConfig(**dict(ENGINE_KW, **kw))
        return self.engine_mod.InferenceEngine(self.params, self.cfg, ecfg, **self.device)

    def params_fn(self):
        return self.params, self.cfg

    def metric_count(self, name, **tags):
        return self.registry.get(name).count(tags or None)

    def metric(self, name, **tags):
        return self.registry.get(name).get(tags or None)


@pytest.fixture(scope="module")
def fleets(tiny):
    """Per package: a coordinator over the object transport (prefill page 8
    -> decode page 4) with its colocated engine, and one over the stream
    transport with chunked prefill (tiny frames, prefix routing off), as
    tests/test_disagg.py's `pair` and `spair`."""
    out = {}
    try:
        for name in PACKAGES:
            p = Pkg(name, tiny)
            f = out[name] = {"p": p}
            f["pe"], f["de"], f["ref"] = p.engine(), p.engine(**DEC_KW), p.engine()
            f["spe"] = p.engine(prefill_chunk=16)
            f["sde"] = p.engine(prefill_chunk=16, **DEC_KW)
            f["sref"] = p.engine(prefill_chunk=16)
            d = p.disagg
            f["co"] = d.DisaggCoordinator([d.EngineWorker(f["pe"], "p0")],
                                          [d.EngineWorker(f["de"], "d0")],
                                          {"kv_transfer": "object", "small_blob_bytes": 0})
            f["sco"] = d.DisaggCoordinator([d.EngineWorker(f["spe"], "sp0")],
                                           [d.EngineWorker(f["sde"], "sd0")],
                                           {"kv_stream_tokens": 8, "prefix_routing": False})
        # the object transport's first api.put may come from eight prefill
        # threads at once: the reference starts a runtime in each racing
        # thread (its init takes no lock) and a get then waits on the wrong
        # one, so its runtime starts here. The port's starts under the
        # race, as a user's would (ROADMAP C22).
        ray_tpu.init(ignore_reinit_error=True)
        yield out
    finally:
        for f in out.values():
            for key in ("co", "sco"):
                if key in f:
                    f[key].close()
            for key in ("pe", "de", "ref", "spe", "sde", "sref"):
                if key in f:
                    f[key].stop()


def _prompts(cfg, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in lengths]


def _match(port, ref):
    """Equal outright, but keys starting with 'logprobs', which must agree
    within LOGPROB_TOL (None, a logprob nobody has, on both sides)."""
    assert port.keys() == ref.keys()
    for key in port:
        if key.startswith("logprobs"):
            a = np.array(port[key], dtype=float)
            b = np.array(ref[key], dtype=float)
            assert a.shape == b.shape, key
            np.testing.assert_allclose(a, b, atol=LOGPROB_TOL, err_msg=key)
        else:
            assert port[key] == ref[key], key


def both(flow, fleets, *args):
    port = flow(fleets["ray_tpu_torch"]["p"], fleets["ray_tpu_torch"], *args)
    ref = flow(fleets["ray_tpu"]["p"], fleets["ray_tpu"], *args)
    if flow is streamed_trace:  # what only the port's span carries
        elems, frames = port.pop("export_counts")[0]
        assert elems > 0 and frames >= 4 and ref.pop("export_counts") == []
    _match(port, ref)
    return port


def _stats(co):
    """stats() with the health scores (host latencies) reduced to each
    replica's error count (the keys name workers by id())."""
    st = dict(co.stats())
    st["health"] = sorted(v["errors"] for v in st["health"].values())
    return st


# ------------------------------------------------------- the coordinator


def concurrent_mixed_lengths(p, f):
    """Eight concurrent mixed-length prompts through prefill replica A and
    decode replica B: token-identical to the colocated engine, migration
    metrics emitted."""
    prompts = _prompts(p.cfg, (5, 11, 17, 23, 29, 31, 8, 26))
    want = [f["ref"].generate(q, max_tokens=8) for q in prompts]
    tags = {"transport": "object"}
    n0, b0 = p.metric_count("serve_kv_migration_seconds", **tags), p.metric(
        "serve_kv_migration_bytes", **tags)
    results = [None] * len(prompts)

    def run(i):
        results[i] = f["co"].generate(prompts[i], max_tokens=8, timeout_s=WAIT_S)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    [t.start() for t in threads]
    [t.join(WAIT_S) for t in threads]
    return {"tokens": [r["token_ids"] for r in results],
            "colocated": [r["token_ids"] == w["token_ids"] for r, w in zip(results, want)],
            "logprobs": [r["logprobs"] for r in results],
            "logprobs_colocated": [w["logprobs"] for w in want],
            "shape": [(r["kv_transport"], p.kv_elems(r["migration_bytes"]), r["ttft_s"] > 0,
                       r["finish_reason"]) for r in results],
            "migrations": p.metric_count("serve_kv_migration_seconds", **tags) - n0,
            "elems": p.kv_elems(p.metric("serve_kv_migration_bytes", **tags) - b0),
            "stats": _stats(f["co"])}


def channel_transport(p, f):
    co2 = p.disagg.DisaggCoordinator(f["co"]._workers["prefill"], f["co"]._workers["decode"],
                                     {"kv_transfer": "channel"})
    try:
        prompt = _prompts(p.cfg, (12,))[0]
        want = f["ref"].generate(prompt, max_tokens=8)
        out = co2.generate(prompt, max_tokens=8, timeout_s=WAIT_S)
        return {"tokens": out["token_ids"], "colocated": out["token_ids"] == want["token_ids"],
                "logprobs": out["logprobs"], "transport": out["kv_transport"],
                "elems": p.kv_elems(out["migration_bytes"]), "stats": _stats(co2)}
    finally:
        co2.close()


def stream_tokens_and_finish_reason(p, f):
    prompt = _prompts(p.cfg, (9,))[0]
    want = f["ref"].generate(prompt, max_tokens=8)["token_ids"]
    ds = f["co"].open_stream(prompt, max_tokens=8, timeout_s=WAIT_S)
    toks = list(ds.tokens())
    return {"tokens": toks, "colocated": toks == want, "finish": ds.finish_reason,
            "elems": p.kv_elems(ds.migration_bytes), "logprobs": ds.logprobs,
            "logprob_at": [ds.logprob_at(0) is not None, ds.logprob_at(99)]}


def one_connected_trace(p, f):
    """One traced request yields ONE trace: admit, queue-wait, prefill,
    KV export, the migration fetch, KV import and decode share the trace
    id and chain into one tree under the client span."""
    prompt = _prompts(p.cfg, (9,))[0]
    tr = p.tracing
    tr.clear()
    with tr.start_span("client") as root:
        out = f["co"].generate(prompt, max_tokens=6, timeout_s=WAIT_S)
    spans = tr.get_spans(root.trace_id)
    by_id = {s["span_id"]: s for s in spans}
    connected = all(s["parent_id"] in by_id for s in spans if s["span_id"] != root.span_id)
    tree = tr.get_trace(root.trace_id)
    return {"tokens": out["token_ids"], "names": sorted({s["name"] for s in spans}),
            "connected": connected, "roots": [t["name"] for t in tree]}


def untraced_request_records_nothing(p, f):
    before = len(p.tracing.get_spans())
    out = f["co"].generate(_prompts(p.cfg, (7,))[0], max_tokens=4, timeout_s=WAIT_S)
    return {"tokens": out["token_ids"], "new_spans": len(p.tracing.get_spans()) - before}


COORDINATOR_FLOWS = [concurrent_mixed_lengths, channel_transport, stream_tokens_and_finish_reason,
                     one_connected_trace, untraced_request_records_nothing]


@pytest.mark.parametrize("flow", COORDINATOR_FLOWS, ids=lambda f: f.__name__)
def test_coordinator_matches_reference(flow, fleets):
    port = both(flow, fleets)
    if "colocated" in port:
        assert np.all(port["colocated"])
    if flow is concurrent_mixed_lengths:
        assert port["migrations"] == 8 and port["elems"] > 0
        assert all(s[0] == "object" and s[1] > 0 and s[2] for s in port["shape"])
        np.testing.assert_allclose(np.array(port["logprobs"], float),
                                   np.array(port["logprobs_colocated"], float),
                                   atol=LOGPROB_TOL)
    elif flow is channel_transport:
        assert port["transport"] == "channel" and port["elems"] > 0
    elif flow is stream_tokens_and_finish_reason:
        assert port["finish"] == "length" and port["elems"] > 0
    elif flow is one_connected_trace:
        assert {"disagg.admit", "disagg.queue_wait", "disagg.prefill", "disagg.kv_export",
                "disagg.kv_migration", "disagg.kv_import", "disagg.decode"} <= set(port["names"])
        assert port["connected"] and port["roots"] == ["client"]
    else:
        assert port["new_spans"] == 0


# ------------------------------------------------- streamed migration


def streamed_mismatched_pages(p, f):
    """Multi-frame import, 8 -> 4, token-identical to the colocated engine on
    the bucketed (short) and the chunked (40 > prefill_chunk) paths."""
    tags = {"transport": "stream"}
    n0 = p.metric_count("serve_kv_migration_seconds", **tags)
    b0 = p.metric("serve_kv_migration_bytes", **tags)
    out = {"tokens": [], "colocated": [], "logprobs": [], "shape": []}
    for prompt in _prompts(p.cfg, (5, 13, 29, 40), seed=21):
        want = f["sref"].generate(prompt, max_tokens=8)["token_ids"]
        res = f["sco"].generate(prompt, max_tokens=8, timeout_s=WAIT_S)
        out["tokens"].append(res["token_ids"])
        out["colocated"].append(res["token_ids"] == want)
        out["logprobs"].append(res["logprobs"])
        out["shape"].append((res["kv_transport"], p.kv_elems(res["migration_bytes"])))
    out["migrations"] = p.metric_count("serve_kv_migration_seconds", **tags) - n0
    out["elems"] = p.kv_elems(p.metric("serve_kv_migration_bytes", **tags) - b0)
    out["stats"] = _stats(f["sco"])
    return out


def open_stream_streamed(p, f):
    prompt = _prompts(p.cfg, (23,), seed=22)[0]
    want = f["sref"].generate(prompt, max_tokens=8)["token_ids"]
    ds = f["sco"].open_stream(prompt, max_tokens=8, timeout_s=WAIT_S)
    toks = list(ds.tokens())
    return {"tokens": toks, "colocated": toks == want, "finish": ds.finish_reason,
            "elems": p.kv_elems(ds.migration_bytes), "logprobs": ds.logprobs}


def prefix_warm_destination(p, f):
    """A destination whose prefix cache holds the prompt's pages from a prior
    import re-imports the same prompt over the stream token-exactly."""
    prompt = _prompts(p.cfg, (40,), seed=23)[0]
    want = f["sref"].generate(prompt, max_tokens=8)["token_ids"]
    first = f["sco"].generate(prompt, max_tokens=8, timeout_s=WAIT_S)
    warm = bool(f["sde"].prefix_digest()["hashes"])
    again = f["sco"].generate(prompt, max_tokens=8, timeout_s=WAIT_S)
    return {"tokens": [first["token_ids"], again["token_ids"]],
            "colocated": [first["token_ids"] == want, again["token_ids"] == want],
            "warm": warm, "transport": again["kv_transport"]}


def prefix_route_skips_migration(p, f):
    """A repeat prompt whose prefix is warm on the decode replica runs there:
    'skipped', zero bytes, token-identical, blocking and streaming."""
    co2 = p.disagg.DisaggCoordinator(f["sco"]._workers["prefill"], f["sco"]._workers["decode"],
                                     {"kv_stream_tokens": 8, "prefix_gossip_s": 0.0})
    try:
        prompt = _prompts(p.cfg, (40,), seed=24)[0]
        want = f["sref"].generate(prompt, max_tokens=8)["token_ids"]
        cold = co2.generate(prompt, max_tokens=8, timeout_s=WAIT_S)
        warm = co2.generate(prompt, max_tokens=8, timeout_s=WAIT_S)
        ds = co2.open_stream(prompt, max_tokens=8, timeout_s=WAIT_S)
        streamed = list(ds.tokens())
        return {"tokens": [cold["token_ids"], warm["token_ids"], streamed],
                "colocated": [t == want for t in (cold["token_ids"], warm["token_ids"],
                                                  streamed)],
                "warm": (warm["kv_transport"], warm["migration_bytes"],
                         warm["prefix_warm_tokens"]),
                "stream_bytes": ds.migration_bytes, "logprobs": warm["logprobs"],
                "stats": _stats(co2)}
    finally:
        co2.close()


def streamed_smoke(p, f):
    prompt = _prompts(p.cfg, (9,), seed=25)[0]
    out = f["sco"].generate(prompt, max_tokens=4, timeout_s=WAIT_S)
    return {"tokens": out["token_ids"], "transport": out["kv_transport"],
            "colocated": out["token_ids"] == f["sref"].generate(prompt, max_tokens=4)[
                "token_ids"]}


def streamed_trace(p, f):
    """The stream transport's trace: the export span is built by hand on
    the engine's threads, under the prefill span, and the import's spans
    chain under the decode side's. The port's export span carries the
    bytes and frames streamed; the reference's updates a dict its span has
    copied, so its span carries neither (a deliberate difference)."""
    prompt = _prompts(p.cfg, (29,), seed=26)[0]
    want = f["sref"].generate(prompt, max_tokens=4)["token_ids"]
    tr = p.tracing
    tr.clear()
    with tr.start_span("client") as root:
        out = f["sco"].generate(prompt, max_tokens=4, timeout_s=WAIT_S)
    spans = tr.get_spans(root.trace_id)
    by_id = {s["span_id"]: s for s in spans}
    export = [s for s in spans if s["name"] == "disagg.kv_export"]
    return {"tokens": out["token_ids"], "colocated": out["token_ids"] == want,
            "names": sorted({s["name"] for s in spans}),
            "connected": all(s["parent_id"] in by_id for s in spans
                             if s["span_id"] != root.span_id),
            "export": [(by_id[s["parent_id"]]["name"], s["attrs"]["stream"]) for s in export],
            "export_counts": [(p.kv_elems(s["attrs"]["bytes"]), s["attrs"]["frames"])
                              for s in export if "bytes" in s["attrs"]]}


STREAM_FLOWS = [streamed_mismatched_pages, open_stream_streamed, prefix_warm_destination,
                prefix_route_skips_migration, streamed_smoke, streamed_trace]


@pytest.mark.parametrize("flow", STREAM_FLOWS, ids=lambda f: f.__name__)
def test_streamed_migration_matches_reference(flow, fleets):
    port = both(flow, fleets)
    assert np.all(port["colocated"])
    if flow is streamed_mismatched_pages:
        assert port["migrations"] == 4 and all(s == ("stream", s[1]) and s[1] > 0
                                               for s in port["shape"])
    elif flow is prefix_warm_destination:
        assert port["warm"] and port["transport"] == "stream"
    elif flow is prefix_route_skips_migration:
        kind, nbytes, warm = port["warm"]
        assert kind == "skipped" and nbytes == 0 and warm >= 32
        assert port["stream_bytes"] == 0
    elif flow is streamed_smoke:
        assert port["transport"] == "stream"
    elif flow is streamed_trace:
        assert {"disagg.prefill", "disagg.kv_export", "disagg.kv_migration",
                "disagg.kv_import", "disagg.decode"} <= set(port["names"])
        assert port["connected"] and port["export"] == [("disagg.prefill", True)]


# ------------------------------------------------------------- chaos


def _settle_free(engine, free0, timeout=10.0):
    deadline = time.monotonic() + timeout
    while engine.stats()["free_pages"] != free0 and time.monotonic() < deadline:
        time.sleep(0.05)
    return engine.stats()["free_pages"] == free0


def decode_death_fails_prefill(p, f):
    """A kv_sink that raises (the decode side is gone) fails the prefill
    request, bucketed and chunked, and returns its pages."""
    src = f["spe"]
    free0 = src.stats()["free_pages"]
    errors = []
    for n in (24, 40):
        def sink(frame):
            raise RuntimeError("decode replica died")

        req = p.engine_mod.Request(request_id=uuid.uuid4().hex,
                                   prompt=_prompts(p.cfg, (n,))[0], max_tokens=8,
                                   prefill_only=True, kv_sink=sink, kv_window=8)
        src.add_request(req)
        errors.append((req.done.wait(60.0), "kv stream failed" in (req.error or "")))
    return {"errors": errors, "freed": _settle_free(src, free0)}


def prefill_death_mid_stream(p, f):
    """An error frame after two frames surfaces as KvMigrationError on the
    decode side, fast, with its pages freed and the inbox empty."""
    src, de = f["spe"], f["sde"]
    frames = []
    prompt = _prompts(p.cfg, (40,))[0]
    rid = "chaos-" + uuid.uuid4().hex[:8]
    req = p.engine_mod.Request(request_id=rid, prompt=list(prompt), max_tokens=8,
                               prefill_only=True, kv_sink=frames.append, kv_window=8)
    src.add_request(req)
    assert req.done.wait(60.0) and req.error is None
    free0 = de.stats()["free_pages"]
    inbox = p.disagg.KvInbox()
    for fr in frames[:2]:
        inbox.channel.put((rid, fr))
    inbox.channel.put((rid, {"request_id": rid, "error": "prefill replica died"}))
    request = {"request_id": rid, "prompt_ids": list(prompt), "max_tokens": 8,
               "kv": {"kind": "stream"}, "kv_stream_idle_s": 10.0}
    t0 = time.monotonic()
    raised = None
    try:
        p.disagg._import_request(de, request, inbox)
    except p.disagg.KvMigrationError as e:
        raised = "prefill replica" in str(e)
    return {"frames": len(frames) >= 3, "raised": raised, "fast": time.monotonic() - t0 < 10.0,
            "parked": inbox.parked(), "freed": _settle_free(de, free0)}


def stream_idle_timeout(p, f):
    inbox = p.disagg.KvInbox()
    request = {"request_id": "ghost-" + uuid.uuid4().hex[:8], "prompt_ids": [1, 2, 3],
               "max_tokens": 4, "kv": {"kind": "stream"}, "kv_stream_idle_s": 0.5}
    t0 = time.monotonic()
    raised = False
    try:
        p.disagg._import_request(f["sde"], request, inbox)
    except p.disagg.KvMigrationError:
        raised = True
    return {"raised": raised, "fast": time.monotonic() - t0 < 5.0}


def prefill_reject_fails_fast(p, f):
    """A 60-token prompt the prefill replica rejects at admission (over its
    largest bucket) poisons the stream: the decode leg fails within the
    idle window and the root cause surfaces."""
    co = p.disagg.DisaggCoordinator([p.disagg.EngineWorker(f["pe"], "cp0")],
                                    [p.disagg.EngineWorker(f["de"], "cd0")],
                                    {"kv_stream_idle_s": 20.0, "prefix_routing": False})
    try:
        free0 = f["de"].stats()["free_pages"]
        t0 = time.monotonic()
        err = None
        try:
            co.generate(_prompts(p.cfg, (60,))[0], max_tokens=8, timeout_s=60.0)
        except (ValueError, p.disagg.KvMigrationError) as e:
            err = type(e).__name__
        return {"error": err, "fast": time.monotonic() - t0 < 20.0,
                "freed": _settle_free(f["de"], free0), "stats": _stats(co)}
    finally:
        co.close()


CHAOS_FLOWS = [decode_death_fails_prefill, prefill_death_mid_stream, stream_idle_timeout,
               prefill_reject_fails_fast]


@pytest.mark.parametrize("flow", CHAOS_FLOWS, ids=lambda f: f.__name__)
def test_stream_chaos_matches_reference(flow, fleets):
    port = both(flow, fleets)
    expected = {
        decode_death_fails_prefill: {"errors": [(True, True), (True, True)], "freed": True},
        prefill_death_mid_stream: {"frames": True, "raised": True, "fast": True, "parked": 0,
                                   "freed": True},
        stream_idle_timeout: {"raised": True, "fast": True},
    }.get(flow)
    if expected is not None:
        assert port == expected
    else:
        assert port["error"] is not None and port["fast"] and port["freed"]


# ------------------------------------------------- inbox and kv_dest


def inbox_cancel_evicts(p):
    inbox = p.disagg.KvInbox(maxsize=8, ttl_s=60.0)
    out = []
    inbox.channel.put(("r1", {"blob": 1}))
    try:
        inbox.take("r2", timeout=0.6)  # drains, parking r1's blob
    except TimeoutError:
        out.append("timeout")
    out.append(inbox.parked())
    inbox.cancel("r1")
    out.append(inbox.parked())
    inbox.channel.put(("r1", {"blob": 2}))  # the late tail is dropped at park
    try:
        inbox.take("r2", timeout=0.6)
    except TimeoutError:
        out.append("timeout")
    out.append(inbox.parked())
    return out


def inbox_ttl_sweep(p):
    inbox = p.disagg.KvInbox(maxsize=8, ttl_s=1.5)
    out = []
    inbox.channel.put(("r1", {"blob": 1}))
    try:
        inbox.take("rX", timeout=0.3)
    except TimeoutError:
        out.append("timeout")
    out.append(inbox.parked())
    time.sleep(1.3)  # past ttl_s counting the drain above
    try:
        inbox.take("rY", timeout=0.6)  # this drain pass sweeps
    except TimeoutError:
        out.append("timeout")
    out.append(inbox.parked())
    return out


def inbox_take_delivers(p):
    inbox = p.disagg.KvInbox(maxsize=8, ttl_s=60.0)
    inbox.channel.put(("r1", {"blob": 1}))
    return [inbox.take("r1", timeout=5.0), inbox.parked()]


@pytest.mark.parametrize("flow,expected", [
    (inbox_cancel_evicts, ["timeout", 1, 0, "timeout", 0]),
    (inbox_ttl_sweep, ["timeout", 1, "timeout", 0]),
    (inbox_take_delivers, [{"blob": 1}, 0]),
], ids=["cancel_evicts_parked_and_drops_late_frames", "ttl_sweep_evicts_unclaimed",
        "take_still_delivers"])
def test_kv_inbox_hygiene_matches_reference(flow, expected, tiny):
    port = flow(Pkg("ray_tpu_torch", tiny))
    ref = flow(Pkg("ray_tpu", tiny))
    assert port == ref == expected


class _FakeReplica:
    def __init__(self, aid, delay=0.0):
        self._actor_id = aid
        self.calls = []
        self.delay = delay

    class _Method:
        def __init__(self, outer):
            self.outer = outer

        def remote(self, *a):
            time.sleep(self.outer.delay)  # widens the race window
            ref = object()
            self.outer.calls.append(ref)
            return ref

    @property
    def handle_request(self):
        return self._Method(self)


class _FakeController:
    def __init__(self, replicas):
        self.replicas = replicas  # deployment name -> [fake replicas]

    @property
    def get_replicas(self):
        outer = self

        class _M:
            def remote(self, name):
                return (outer.replicas[name], 1)

        return _M()


def kv_dest_cache(p):
    """kv_dest resolves ONCE per replica identity across resyncs and again
    only when the membership changes."""
    pa, da = _FakeReplica("pa"), _FakeReplica("da")
    ctrl = _FakeController({"P": [pa], "D": [da]})
    co = p.disagg.DisaggCoordinator([], [], {"prefix_routing": False})
    co._deployments = {"prefill": "P", "decode": "D"}
    co._controller = ctrl
    co._sync(force=True)
    w = co._workers["decode"][0]
    out = [co._kv_dest_for(w) is co._kv_dest_for(w), len(da.calls)]
    co._last_sync = 0.0
    co._sync(force=True)
    w2 = co._workers["decode"][0]
    co._kv_dest_for(w2)
    out += [w2 is w, len(da.calls)]
    db = _FakeReplica("db")
    ctrl.replicas["D"] = [db]
    co._last_sync = 0.0
    co._sync(force=True)
    w3 = co._workers["decode"][0]
    co._kv_dest_for(w3)
    out += [w3 is not w, len(db.calls), w.key in co._kv_dest_cache]
    return out


def kv_dest_single_fetch(p):
    """Concurrent first kv_dest calls on one ReplicaWorker fetch once."""
    rep = _FakeReplica("d0", delay=0.05)
    w = p.disagg.ReplicaWorker(rep)
    n = 6
    bar = threading.Barrier(n)
    dests = [None] * n

    def grab(i):
        bar.wait()
        dests[i] = w.kv_dest()

    ts = [threading.Thread(target=grab, args=(i,)) for i in range(n)]
    [t.start() for t in ts]
    [t.join(WAIT_S) for t in ts]
    return [len(rep.calls), all(d is dests[0] for d in dests)]


@pytest.mark.parametrize("flow,expected", [
    (kv_dest_cache, [True, 1, True, 1, True, 1, False]),
    (kv_dest_single_fetch, [1, True]),
], ids=["resolved_once_per_replica_identity", "concurrent_kv_dest_single_fetch"])
def test_kv_dest_cache_matches_reference(flow, expected, tiny, monkeypatch):
    out = {}
    for name in PACKAGES:
        p = Pkg(name, tiny)
        monkeypatch.setattr(p.disagg.api, "get", lambda ref, timeout=None: ref)
        out[name] = flow(p)
    assert out["ray_tpu_torch"] == out["ray_tpu"] == expected


def test_concurrent_kv_ingest_single_inbox_matches_reference(tiny):
    """LLMServer.kv_ingest: eight racing first calls share one inbox, the
    one the decode methods drain; the role shows in stats()."""
    out = {}
    for name in PACKAGES:
        p = Pkg(name, tiny)
        srv = p.llm.LLMServer._target(
            params_fn=p.params_fn, role="decode",
            engine_config=dict(max_batch_size=2, page_size=8, max_pages=32, max_seq_len=64),
            **p.device)
        try:
            n = 8
            bar = threading.Barrier(n)
            chans = [None] * n

            def grab(i):
                bar.wait()
                chans[i] = srv.kv_ingest({})

            ts = [threading.Thread(target=grab, args=(i,)) for i in range(n)]
            [t.start() for t in ts]
            [t.join(WAIT_S) for t in ts]
            st = srv.stats()
            out[name] = (len({c.chan_id for c in chans}),
                         chans[0].chan_id == srv._kv_inbox.channel.chan_id,
                         srv.role, st["role"], st["adapters"], srv.engine.slo_role,
                         srv.cancel({"request_id": "nobody"}))
        finally:
            srv.engine.stop()
    assert out["ray_tpu_torch"] == out["ray_tpu"] == (1, True, "decode", "decode", [],
                                                      "decode", False)
    with pytest.raises(ValueError, match="role"):
        tllm.LLMServer._target(role="both", device="cpu")


def test_adapter_residency_matches_reference(tiny):
    # bookkeeping only in both packages: the engine applies no adapter
    out = {}
    for name in PACKAGES:
        p = Pkg(name, tiny)
        srv = p.llm.LLMServer._target(
            params_fn=p.params_fn, role="decode",
            engine_config=dict(max_batch_size=2, page_size=8, max_pages=32, max_seq_len=64),
            **p.device)
        try:
            srv._adapter_capacity = 2
            loaded = [srv.load_adapter({"adapter_id": a, "weights": {"w": 1}})["evicted"]
                      for a in ("a", "b", "c")]
            srv._ensure_adapter({"adapter_id": "b"})
            try:
                srv._ensure_adapter({"adapter_id": "zz"})
                missing = None
            except ValueError as e:
                missing = "not resident" in str(e)
            st = srv.stats()
            out[name] = (loaded, srv.list_adapters(), st["adapters"], st["adapter_requests"],
                         missing)
        finally:
            srv.engine.stop()
    assert out["ray_tpu_torch"] == out["ray_tpu"] == (
        [[], [], ["a"]], ["b", "c"], ["b", "c"], {"b": 1}, True)


# --------------------------------------------------- the serve runtime


def _deploy_flow(p):
    p.serve.shutdown()
    p.api.shutdown()
    p.api.init(num_cpus=8, system_config=dict(THREAD_MODE), **p.acc)
    ecfg = dict(ENGINE_KW)
    try:
        co = p.disagg.deploy_disagg(
            "tiny-llama", {"prefill_replicas": 1, "decode_replicas": 1, "small_blob_bytes": 0},
            engine_config=ecfg, params_fn=p.params_fn, **p.device)
        ref = p.engine()
        try:
            st = _stats(co)
            prompts = _prompts(p.cfg, (5, 13, 21, 29), seed=11)
            want = [ref.generate(q, max_tokens=6)["token_ids"] for q in prompts]
            results = [None] * len(prompts)

            def run(i):
                results[i] = co.generate(prompts[i], max_tokens=6, timeout_s=WAIT_S)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
            [t.start() for t in threads]
            [t.join(WAIT_S) for t in threads]
            ds = co.open_stream(prompts[0], max_tokens=6, timeout_s=WAIT_S)
            streamed = list(ds.tokens())
            return {"tokens": [r["token_ids"] for r in results],
                    "colocated": [r["token_ids"] == w for r, w in zip(results, want)],
                    "logprobs": [r["logprobs"] for r in results],
                    "streamed": streamed == want[0],
                    "transport": [r["kv_transport"] for r in results],
                    "replicas": (st["prefill_replicas"], st["decode_replicas"]),
                    "placement_group": co._pg is None,
                    "roles": sorted(p.serve.status())}
        finally:
            ref.stop()
            co.close()
    finally:
        p.serve.shutdown()
        p.api.shutdown()


def test_deploy_disagg_two_replica_roundtrip_matches_reference(tiny):
    """deploy_disagg on one host: STRICT_SPREAD is infeasible, the default
    placement still yields two role replicas, and the output stays
    token-identical to a colocated engine."""
    port = _deploy_flow(Pkg("ray_tpu_torch", tiny))
    # the port's KV senders and its channel service end with serve.shutdown()
    # (the reference's senders, from earlier flows in this process, live on)
    senders = [t.name for t in threading.enumerate()
               if isinstance(getattr(getattr(t, "_target", None), "__self__", None),
                             tdisagg._KvSender)]
    assert senders == [] and tdisagg._kv_senders == {}
    assert ray_tpu_torch.core.channels.service_address() is None
    ref = _deploy_flow(Pkg("ray_tpu", tiny))
    _match(port, ref)
    assert all(port["colocated"]) and port["streamed"]
    assert port["replicas"] == (1, 1) and port["placement_group"]
    assert port["transport"] == ["stream"] * 4


def test_cross_host_disagg_waits_for_a5c():
    # TestDisaggCrossHost joins two hosts with init(address=) first; the
    # join is ported (the name is kept from when it raised): with no head at
    # the address it fails to connect and leaves no worker runtime
    with pytest.raises(ConnectionError):
        ray_tpu_torch.init(address="127.0.0.1:1", num_cpus=1)
    assert ray_tpu_torch.api._worker_runtime is None
    ray_tpu_torch.shutdown()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def _sse(port, path, payload):
    chunks = []
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        for line in r:
            line = line.decode().strip()
            if line == "data: [DONE]":
                break
            if line.startswith("data: "):
                chunks.append(json.loads(line[len("data: "):]))
    return chunks


def _openai_flow(p):
    p.serve.shutdown()
    p.api.shutdown()
    p.api.init(num_cpus=8, system_config=dict(THREAD_MODE), **p.acc)
    try:
        app = p.serve.build_openai_app(
            disagg={"prefill_replicas": 1, "decode_replicas": 1}, model_name="tiny-llama",
            params_fn=p.params_fn, engine_config=dict(ENGINE_KW), **p.device)
        p.serve.run(app, name="v1")
        port = p.serve.http_port()
        res = _post(port, "/v1/completions",
                    {"prompt": "hello there", "max_tokens": 6, "logprobs": 1})["result"]
        chat = _post(port, "/v1/chat/completions",
                     {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})["result"]
        chunks = _sse(port, "/v1/completions",
                      {"prompt": "hello there", "max_tokens": 6, "stream": True})
        stats = _post(port, "/v1/stats", {})["result"]
        text = res["choices"][0]["text"]
        return {"text": text, "finish": res["choices"][0]["finish_reason"],
                "usage": res["usage"],
                "logprobs": res["choices"][0]["logprobs"]["token_logprobs"],
                "chat": chat["choices"][0]["message"]["content"],
                "sse": ("".join(c["choices"][0]["text"] for c in chunks) == text,
                        chunks[-1]["choices"][0]["finish_reason"]),
                "stats": (stats["prefill_replicas"], stats["decode_replicas"],
                          stats["kv_transfer"], stats["kv_migrations"]),
                "apps": sorted(p.serve.status())}
    finally:
        p.serve.shutdown()
        p.api.shutdown()


def test_openai_coordinator_mode_matches_reference(tiny):
    """build_openai_app(disagg=...): role deployments behind an OpenAI front
    in coordinator mode, served over HTTP; the text equals the colocated
    engine's greedy output on the same ids (ByteTokenizer)."""
    port = _openai_flow(Pkg("ray_tpu_torch", tiny))
    ref = _openai_flow(Pkg("ray_tpu", tiny))
    _match(port, ref)
    p = Pkg("ray_tpu_torch", tiny)
    eng = p.engine()
    try:
        ids = list("hello there".encode())
        want = eng.generate(ids, max_tokens=6)["token_ids"]
    finally:
        eng.stop()
    assert port["text"] == bytes(t for t in want if t < 256).decode("utf-8", "replace")
    assert port["sse"] == (True, "length") and port["stats"][:3] == (1, 1, "stream")
    assert port["stats"][3] == 3  # three requests, each one migration


# ------------------------------------------------------------ config


def test_disagg_config_matches_reference():
    import dataclasses

    assert ({f.name: f.default for f in dataclasses.fields(tconfig.DisaggConfig)}
            == {f.name: f.default for f in dataclasses.fields(jconfig.DisaggConfig)})
    for mod in (tconfig, jconfig):
        cfg = mod.DisaggConfig.parse({"prefill_replicas": 2, "kv_transfer": "channel"})
        assert cfg.prefill_replicas == 2 and cfg.decode_replicas == 1
        assert mod.DisaggConfig.parse(cfg) is cfg


@pytest.mark.parametrize("value,match", [
    ({"kv_transfer": "carrier-pigeon"}, "kv_transfer"),
    ({"decode_replicas": 0}, "replica"),
    ({"prefil_replicas": 1}, "unknown"),
    ({"kv_frame_layout": "row"}, "kv_frame_layout"),
    ({"kv_stream_idle_s": 0}, "kv_stream_idle_s"),
    ([1], "mapping"),
], ids=["transfer", "replicas", "unknown", "layout", "idle", "mapping"])
def test_disagg_config_rejects_what_the_reference_rejects(value, match):
    errors = []
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match=match) as e:
            mod.DisaggConfig.parse(value)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
