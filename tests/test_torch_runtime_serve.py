"""LLMServer hosted as an actor in the port's runtime, against ray_tpu's
LLMServer hosted as an actor in ray_tpu, on the CPU.

The reference's tiny-llama weights (PRNGKey(0)) go through both packages
as numpy, into the actor through an ObjectRef; concurrent prompts through
the actor handles must give identical greedy tokens. Also here: a live
weight update through a ref (`update_weights({"ref": ...})`) equals one
from the tree in hand, bit for bit, and a ref that cannot be resolved
raises and leaves the weights alone; the runtime's trace export
(`export_to_timeline`) and `trace_torch`.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.models as jmodels
import ray_tpu_torch
from ray_tpu.serve.llm import LLMServer as JLLMServerDeployment
from ray_tpu.util import timeline as jtimeline
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch import LLMServer, get_config
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.util import timeline as ttimeline
from ray_tpu_torch.util import tracing as ttracing

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16)
WAIT_S = 120


@pytest.fixture(scope="module")
def weights():
    cfg = jmodels.get_config("tiny-llama")
    tree = jax.tree.map(np.asarray, jmodels.init_params(cfg, jax.random.PRNGKey(0)))
    tree1 = jax.tree.map(np.asarray, jmodels.init_params(cfg, jax.random.PRNGKey(1)))
    return {"jcfg": cfg, "tcfg": get_config("tiny-llama"), "np": tree, "np1": tree1}


def _prompts(cfg):
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in (5, 12, 20, 40)]


class PortHost:
    """The small class a user writes: an LLMServer over weights from a ref."""

    def __init__(self, tree, cfg):
        self.server = LLMServer(params_fn=lambda: (params_from_numpy(tree, device="cpu"), cfg),
                                engine_config=dict(ENGINE_KW), device="cpu")

    def generate(self, request):
        return self.server(request)

    def update_weights(self, request):
        return self.server.update_weights(request)

    def shutdown(self):
        self.server.shutdown()


class RefHost:
    def __init__(self, tree, cfg):
        self.server = JLLMServerDeployment._target(
            params_fn=lambda: (tree, cfg), engine_config=dict(ENGINE_KW))

    def generate(self, request):
        return self.server(request)

    def shutdown(self):
        self.server.engine.stop()


def _serve_through_actor(api, host_cls, tree, cfg, prompts):
    api.shutdown()
    api.init(num_cpus=8, system_config=dict(THREAD_MODE))
    try:
        actor = api.remote(max_concurrency=8)(host_cls).remote(api.put(tree), cfg)
        refs = [actor.generate.remote({"prompt_ids": p, "max_tokens": 8}) for p in prompts]
        out = api.get(refs, timeout=WAIT_S)
        api.get(actor.shutdown.remote(), timeout=WAIT_S)
        return [r["token_ids"] for r in out], [r["finish_reason"] for r in out]
    finally:
        api.shutdown()


def test_actor_hosted_server_matches_reference(weights):
    prompts = _prompts(weights["tcfg"])
    want = _serve_through_actor(ray_tpu, RefHost, weights["np"], weights["jcfg"], prompts)
    got = _serve_through_actor(ray_tpu_torch, PortHost, weights["np"], weights["tcfg"],
                               prompts)
    assert got == want
    assert all(len(t) == 8 for t in got[0])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_update_through_a_ref_equals_one_from_the_tree(weights):
    cfg = weights["tcfg"]
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, system_config=dict(THREAD_MODE))
    by_tree = LLMServer(params_fn=lambda: (params_from_numpy(weights["np"], device="cpu"), cfg),
                        engine_config=dict(ENGINE_KW), device="cpu")
    host = ray_tpu_torch.remote(max_concurrency=2)(PortHost).remote(
        ray_tpu_torch.put(weights["np"]), cfg)
    try:
        new = params_from_numpy(weights["np1"], device="cpu")
        assert by_tree.update_weights({"weights": new, "version": 3})["weights_version"] == 3
        ref = ray_tpu_torch.put(new)
        assert ray_tpu_torch.get(host.update_weights.remote(
            {"ref": ref, "version": 3}), timeout=WAIT_S) == {"weights_version": 3,
                                                             "role": "colocated"}
        moved = ray_tpu_torch.get(host.generate.remote(
            {"prompt_ids": [3, 1, 4, 1, 5], "max_tokens": 6}), timeout=WAIT_S)
        assert moved["token_ids"] == by_tree({"prompt_ids": [3, 1, 4, 1, 5],
                                              "max_tokens": 6})["token_ids"]
        assert moved["weights_version"] == 3

        # a ref that cannot be resolved: a failed task's, and one still pending
        @ray_tpu_torch.remote
        def broken():
            raise RuntimeError("no weights here")

        @ray_tpu_torch.remote
        def late():
            import time

            time.sleep(2.0)
            return weights["np1"]

        with pytest.raises(ray_tpu_torch.RayTaskError):
            ray_tpu_torch.get(host.update_weights.remote({"ref": broken.remote()}),
                              timeout=WAIT_S)
        with pytest.raises(ray_tpu_torch.RayTaskError, match="GetTimeoutError"):
            ray_tpu_torch.get(host.update_weights.remote(
                {"ref": late.remote(), "timeout_s": 0.05}), timeout=WAIT_S)
        again = ray_tpu_torch.get(host.generate.remote(
            {"prompt_ids": [3, 1, 4, 1, 5], "max_tokens": 6}), timeout=WAIT_S)
        assert again["weights_version"] == 3 and again["token_ids"] == moved["token_ids"]
    finally:
        by_tree.shutdown()
        ray_tpu_torch.get(host.shutdown.remote(), timeout=WAIT_S)
        ray_tpu_torch.shutdown()


def test_ref_update_is_bit_identical_to_a_tree_update(weights):
    cfg = weights["tcfg"]
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE))
    servers = [LLMServer(params_fn=lambda: (params_from_numpy(weights["np"], device="cpu"),
                                            cfg),
                         engine_config=dict(ENGINE_KW), device="cpu") for _ in range(2)]
    try:
        tree = params_from_numpy(weights["np1"], device="cpu")
        servers[0].update_weights({"weights": tree})
        servers[1].update_weights({"ref": ray_tpu_torch.put(tree), "timeout_s": 10})
        a, b, want = (_flat(servers[0].engine.params), _flat(servers[1].engine.params),
                      _flat(tree))
        assert a.keys() == b.keys() == want.keys()
        for k in a:
            assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
            assert torch.equal(b[k], want[k].to(b[k].dtype)), k  # the update landed
    finally:
        for s in servers:
            s.shutdown()
        ray_tpu_torch.shutdown()


def test_export_to_timeline_matches_reference():
    spans = [
        {"trace_id": "a" * 32, "span_id": "1" * 16, "parent_id": None, "name": "root",
         "attrs": {"route": "/chat", "n": 3, "skip": [1]}, "start_us": 1e6, "end_us": 1.5e6,
         "pid": 11},
        {"trace_id": "a" * 32, "span_id": "2" * 16, "parent_id": "1" * 16,
         "name": "engine.generate", "attrs": {"tokens": 8}, "start_us": 1.1e6,
         "end_us": None, "pid": 12},
    ]
    events = []
    for tr, tl in ((jtracing, jtimeline), (ttracing, ttimeline)):
        tr.clear()
        tl.clear()
        tr.ingest([dict(s) for s in spans])
        assert tr.export_to_timeline() == 2
        with tl._lock:
            events.append(list(tl._events))
        tr.clear()
        tl.clear()
    assert events[1] == events[0] and len(events[1]) == 2


def test_package_timeline_and_trace_torch(tmp_path):
    ttimeline.clear()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE))
    try:
        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        with ttimeline.trace_torch(str(tmp_path / "trace")):
            assert ray_tpu_torch.get(f.remote(1), timeout=WAIT_S) == 2
            torch.ones(4).add_(1)
    finally:
        ray_tpu_torch.shutdown()
    n = ray_tpu_torch.timeline(str(tmp_path / "timeline.json"))
    doc = json.load(open(tmp_path / "timeline.json"))
    assert n == len(doc["traceEvents"]) >= 1
    assert any(e["cat"] == "task" and e["name"].endswith("f") for e in doc["traceEvents"])
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1
    assert json.load(open(tmp_path / "trace" / traces[0]))["traceEvents"]
    ttimeline.clear()
