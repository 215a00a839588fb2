"""The OpenAI front (ray_tpu_torch.serve.openai_api) and the LLMServer
deployment against ray_tpu.serve's, on the CPU at tiny-llama.

The reference's tiny-llama weights (PRNGKey(0)) go to both packages'
apps through `params_fn`, to the port's as torch tensors
(`params_from_numpy`). One flow per package serves, over HTTP through
`serve.http_port()`, the routes of tests/test_serve.py's TestOpenAI
(completions, the nested chat route, models, the X-Request-Id header that
doubles as the trace id, the plain request id of an untraced request, SSE
streaming), then TestEngine's LLMServer deployment through its handle
(end to end, and a stream through the handle). Texts, finish reasons,
usage, logprobs (within 1e-4), the SSE chunks and their reassembly, the
trace's root span and the deployment's greedy token ids must be the
same. ByteTokenizer sets no stop token (its eos_token_id is None) in
either package.
"""

import json
import time
import urllib.request

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu.models as jmodels
import ray_tpu.serve
import ray_tpu.util.tracing
import ray_tpu_torch
import ray_tpu_torch.serve
import ray_tpu_torch.util.tracing
from ray_tpu_torch.models import get_config, params_from_numpy
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
# TestOpenAI._ENGINE and TestEngine's LLMServer engine (tests/test_serve.py)
OPENAI_ENGINE = dict(max_batch_size=2, page_size=8, max_pages=64, max_seq_len=128,
                     prefill_buckets=(32, 64))
LLM_ENGINE = dict(max_batch_size=2, page_size=8, max_pages=32, max_seq_len=64,
                  prefill_buckets=(16,))
WAIT_S = 300
LOGPROB_TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    cfg = jmodels.get_config("tiny-llama")
    tree = jax.tree.map(np.asarray, jmodels.init_params(cfg, jax.random.PRNGKey(0)))
    return {"jcfg": cfg, "tcfg": get_config("tiny-llama"), "np": tree}


def _request(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=WAIT_S)


def _post(port, path, payload):
    with _request(port, path, payload) as r:
        return json.loads(r.read())


def _sse(port, path, payload):
    """-> (content type, the data chunks before [DONE], whether [DONE] came)."""
    chunks, done = [], False
    with _request(port, path, payload) as r:
        ctype = r.headers["Content-Type"]
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                done = True
                break
            chunks.append(json.loads(data))
    return ctype, chunks, done


def _logprobs(res):
    return res["choices"][0]["logprobs"]["token_logprobs"]


def _strip(res):
    """A completion without what differs by construction (id, time) and
    with its logprobs taken out for a compare within tolerance."""
    res = dict(res)
    for key in ("id", "created"):
        res.pop(key)
    choice = dict(res["choices"][0])
    choice.pop("logprobs", None)
    res["choices"] = [choice]
    return res


def serve_flow(name, weights, monkeypatch):
    """Everything one package serves: -> (observations, logprob lists)."""
    if name == "ray_tpu":
        api, serve, tracing = ray_tpu, ray_tpu.serve, ray_tpu.util.tracing
        tree, cfg = weights["np"], weights["jcfg"]

        def params_fn():
            return tree, cfg

        device = {}
        acc = {"num_tpus": 0}
    else:
        api, serve, tracing = ray_tpu_torch, ray_tpu_torch.serve, ray_tpu_torch.util.tracing
        tree, cfg = weights["np"], weights["tcfg"]

        def params_fn():
            return params_from_numpy(tree, device="cpu"), cfg

        device = {"device": "cpu"}
        acc = {"num_gpus": 0}
    serve.shutdown()
    api.shutdown()
    api.init(num_cpus=8, system_config=dict(THREAD_MODE), **acc)
    seen, lps = {}, {}
    try:
        serve.run(serve.build_openai_app(model_name="tiny-llama", params_fn=params_fn,
                                         engine_config=dict(OPENAI_ENGINE), **device),
                  name="v1")
        port = serve.http_port()
        # completions, with logprobs, and the plain id of an untraced request
        res = _post(port, "/v1/completions", {"prompt": "hi", "max_tokens": 4,
                                               "logprobs": 1})["result"]
        rid = res["id"]
        seen["completions"] = _strip(res)
        seen["untraced_id"] = (rid.startswith("cmpl-"), len(rid.split("-")[-1]))
        lps["completions"] = _logprobs(res)
        # the nested chat route
        res = _post(port, "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 3,
                     "logprobs": True})["result"]
        lps["chat"] = [c["logprob"] for c in res["choices"][0]["logprobs"]["content"]]
        seen["chat"] = _strip(res)
        seen["models"] = _post(port, "/v1/models", {})["result"]
        # a longer greedy completion with a stop string
        res = _post(port, "/v1/completions", {"prompt": "The quick brown fox", "max_tokens": 12,
                                               "stop": ["\n"], "logprobs": 1})["result"]
        seen["longer"] = _strip(res)
        lps["longer"] = _logprobs(res)
        # SSE: four content chunks and a terminal one, which reassemble into
        # the non-streamed text of the same greedy request
        ctype, chunks, done = _sse(port, "/v1/completions",
                                   {"prompt": "hi", "max_tokens": 4, "stream": True})
        text = "".join(c["choices"][0]["text"] for c in chunks)
        seen["sse"] = (ctype.startswith("text/event-stream"), len(chunks), done,
                       [c["object"] for c in chunks],
                       [c["choices"][0].get("finish_reason") for c in chunks],
                       text == seen["completions"]["choices"][0]["text"],
                       len({c["id"] for c in chunks}))
        _ctype, chunks, done = _sse(port, "/v1/chat/completions",
                                    {"messages": [{"role": "user", "content": "hello"}],
                                     "max_tokens": 3, "stream": True})
        seen["chat_sse"] = ("".join(c["choices"][0]["delta"].get("content", "")
                                    for c in chunks)
                            == seen["chat"]["choices"][0]["message"]["content"],
                            chunks[-1]["choices"][0]["finish_reason"], done)
        # sampled at rate 1: the X-Request-Id header carries the trace id
        monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_RATE", "1.0")
        tracing.clear()
        with _request(port, "/v1/completions", {"prompt": "hi", "max_tokens": 2}) as r:
            rid = r.headers["X-Request-Id"]
            body = json.loads(r.read())
        monkeypatch.delenv("RAY_TPU_TRACE_SAMPLE_RATE")
        tid = rid.split("-")[-1]
        deadline = time.monotonic() + 30
        tree_ = []
        while not tree_ and time.monotonic() < deadline:
            tree_ = tracing.get_trace(tid)
            time.sleep(0.05)
        seen["traced"] = (rid.startswith("cmpl-"), body["result"]["id"] == rid, len(tid),
                          tree_[0]["name"] if tree_ else None,
                          sorted(s["name"] for s in tracing.get_spans(tid)))
        # the LLMServer deployment through its handle: end to end, and a
        # stream through the handle
        handle = serve.run(serve.LLMServer.options(name="llm-test").bind(
            model_name="tiny-llama", params_fn=params_fn, engine_config=dict(LLM_ENGINE),
            **device), name="llm")
        full = handle.remote({"prompt_ids": [1, 2, 3], "max_tokens": 5}).result(timeout=WAIT_S)
        stream = handle.options("stream").remote(
            {"prompt_ids": [1, 2, 3], "max_tokens": 5}).result(timeout=WAIT_S)
        seen["llm"] = (full["token_ids"], full["finish_reason"], list(stream))
        lps["llm"] = full["logprobs"]
        seen["http_llm"] = _post(port, "/llm", {"prompt_ids": [4, 5, 6, 7],
                                                "max_tokens": 4})["result"]["token_ids"]
        seen["status"] = serve.status()
    finally:
        try:
            serve.shutdown()
        finally:
            api.shutdown()
    return seen, lps


@pytest.fixture(scope="module")
def served(weights):
    """Each package's flow, run once for the module."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        ref = serve_flow("ray_tpu", weights, monkeypatch)
        port = serve_flow("ray_tpu_torch", weights, monkeypatch)
    return {"ray_tpu": ref, "ray_tpu_torch": port}


ROUTES = ["completions", "untraced_id", "chat", "models", "longer", "sse", "chat_sse",
          "traced", "llm", "http_llm", "status"]


@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_reference(served, route):
    (ref, ref_lps), (port, port_lps) = served["ray_tpu"], served["ray_tpu_torch"]
    assert sorted(port) == sorted(ref) == sorted(ROUTES)
    assert port[route] == ref[route]
    if route in ref_lps:
        assert len(port_lps[route]) == len(ref_lps[route]) > 0
        assert np.allclose(port_lps[route], ref_lps[route], atol=LOGPROB_TOL)


def test_outcomes_are_what_the_reference_tests_assert(served):
    port = served["ray_tpu_torch"][0]
    assert port["completions"]["object"] == "text_completion"
    assert port["completions"]["usage"]["completion_tokens"] == 4
    assert port["completions"]["choices"][0]["finish_reason"] == "length"
    assert port["chat"]["choices"][0]["message"]["role"] == "assistant"
    assert port["models"]["data"][0]["id"] == "tiny-llama"
    assert port["untraced_id"] == (True, 24)
    assert port["traced"][:4] == (True, True, 32, "request:completions")
    assert port["sse"] == (True, 5, True, ["text_completion.chunk"] * 5,
                           [None] * 4 + ["length"], True, 1)
    assert port["chat_sse"] == (True, "length", True)
    tokens, finish, streamed = port["llm"]
    assert len(tokens) == 5 and finish == "length" and streamed == tokens


def test_byte_tokenizer_and_chat_template_match_reference():
    from ray_tpu.serve import openai_api as jopenai
    from ray_tpu_torch.serve import openai_api as topenai

    text = "héllo\nworld ✓"
    jt, tt = jopenai.ByteTokenizer(), topenai.ByteTokenizer()
    assert tt.encode(text) == jt.encode(text)
    ids = tt.encode(text) + [300, 511]  # ids past a byte are dropped in both
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.eos_token_id is None and jt.eos_token_id is None
    msgs = [{"role": "system", "content": "be brief"}, {"content": "hi"}]
    assert topenai._chat_prompt(msgs) == jopenai._chat_prompt(msgs)
