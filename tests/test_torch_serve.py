"""ray_tpu_torch models and serving path against ray_tpu on the CPU.

The JAX package's tiny-model parameters go through params_from_numpy, so
both packages compute the same function; forward/prefill logits agree
within 1e-4 (f32, sums in another order), and the two engines, run with
the same EngineConfig on the same weights, give token-identical greedy
outputs with logprobs within 1e-4 over the bucketed path, the chunked
path, a prefix-cache hit and a stop sequence.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jmodels
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve import EngineConfig as JEngineConfig
from ray_tpu.serve import InferenceEngine as JInferenceEngine
from ray_tpu_torch import EngineConfig, InferenceEngine, LLMServer, get_config
from ray_tpu_torch.models import forward, init_params, params_from_numpy, prefill

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE_KW = dict(max_batch_size=4, page_size=8, max_pages=64, max_seq_len=64,
                 prefill_buckets=(16, 32), prefill_chunk=16)


def _both(name):
    cfg = jmodels.get_config(name)
    jparams = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, get_config(name), tparams


@pytest.fixture(scope="module")
def tiny_llama():
    return _both("tiny-llama")


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_forward_and_prefill_match_reference(name):
    jcfg, jparams, tcfg, tparams = _both(name)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jtransformer.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == 0.0
    last = np.array([19, 7], np.int32)
    want_l, want_c = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks), 32, jnp.asarray(last))
    got_l, got_c = prefill(tparams, tcfg, torch.from_numpy(toks), 32, torch.from_numpy(last))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LOGIT_TOL)
    np.testing.assert_allclose(got_c["k"].numpy(), np.asarray(want_c["k"]), **LOGIT_TOL)
    np.testing.assert_allclose(got_c["v"].numpy(), np.asarray(want_c["v"]), **LOGIT_TOL)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])  # rope / learned positions
def test_engine_matches_reference_engine(name):
    jcfg, jparams, tcfg, tparams = _both(name)
    jeng = JInferenceEngine(jparams, jcfg, JEngineConfig(**ENGINE_KW))
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW), device="cpu")
    long_prompt = [(i * 7) % 60 + 1 for i in range(40)]
    cases = [
        dict(prompt=[5, 6, 7, 8, 9, 10], max_tokens=8),            # bucket 16
        dict(prompt=list(range(3, 15)), max_tokens=10),            # bucket 16
        dict(prompt=long_prompt, max_tokens=8),                    # chunked: 3 chunks
        dict(prompt=long_prompt[:32] + [9, 8, 7], max_tokens=6),   # prefix hit: 2 chunks cached
    ]
    try:
        outs = []
        for case in cases:
            want = jeng.generate(**case)
            got = teng.generate(**case)
            assert got["token_ids"] == want["token_ids"], case
            np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=1e-4)
            assert got["finish_reason"] == want["finish_reason"] == "length"
            outs.append(got)
        assert teng.stats()["cached_pages"] > 0
        # a stop sequence taken from the unstopped output finishes early
        # and is stripped, identically in both engines
        toks = outs[0]["token_ids"]
        stop = [toks[3:5]]
        first = next(i for i in range(len(toks)) if toks[i:i + 2] == stop[0])
        want = jeng.generate([5, 6, 7, 8, 9, 10], max_tokens=8, stop=stop)
        got = teng.generate([5, 6, 7, 8, 9, 10], max_tokens=8, stop=stop)
        assert got["finish_reason"] == want["finish_reason"] == "stop"
        assert got["token_ids"] == want["token_ids"] == toks[:first]
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=1e-4)
        # reference and port agree on what an engine's stats report
        assert set(teng.stats()) <= set(jeng.stats()) | {"weights_version"}
        assert set(got) == set(want)
    finally:
        teng.stop()
        jeng.stop()


def test_concurrent_requests_match_sequential(tiny_llama):
    import threading

    _jcfg, _jparams, tcfg, tparams = tiny_llama
    prompts = [[1, 2, 3], [4, 5] * 10, [(i * 3) % 50 + 1 for i in range(30)], [9, 1, 3]]
    eng = InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW, decode_span=4),
                          device="cpu")
    try:
        solo = [eng.generate(p, max_tokens=6)["token_ids"] for p in prompts]
        results = [None] * len(prompts)

        def work(i):
            results[i] = eng.generate(prompts[i], max_tokens=6)["token_ids"]

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert results == solo
        streamed = list(eng.generate_stream(prompts[1], max_tokens=6))
        assert streamed == solo[1]
    finally:
        eng.stop()


def test_sampled_requests_stay_in_range(tiny_llama):
    _jcfg, _jparams, tcfg, tparams = tiny_llama
    eng = InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW), device="cpu")
    try:
        for kw in (dict(temperature=0.8), dict(temperature=0.8, top_p=0.9, top_k=20)):
            out = eng.generate([3, 4, 5], max_tokens=12, **kw)
            assert len(out["token_ids"]) == 12
            assert all(0 <= t < tcfg.vocab_size for t in out["token_ids"])
            assert all(lp <= 0 for lp in out["logprobs"])
    finally:
        eng.stop()


def test_llm_server_returns_reference_keys(tiny_llama):
    jcfg, jparams, _tcfg, _tparams = tiny_llama
    jeng = JInferenceEngine(jparams, jcfg, JEngineConfig(**ENGINE_KW))
    server = LLMServer._target(model_name="tiny-llama", device="cpu", engine_config=ENGINE_KW)
    try:
        want = jeng.generate([1, 2, 3], max_tokens=8)
        got = server({"prompt_ids": [1, 2, 3], "max_tokens": 8})
        assert set(got) == set(want)
        assert len(got["token_ids"]) == 8 and got["finish_reason"] == "length"
        assert server.stats()["role"] == "colocated"
    finally:
        server.shutdown()
        jeng.stop()


def test_entry_points_need_a_device_without_a_card(tiny_llama):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _jcfg, _jparams, tcfg, tparams = tiny_llama
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE_KW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer._target(model_name="tiny-llama")


def test_unported_features_raise(tiny_llama):
    # speculation is ported: its config is parsed, and a key it does not
    # know is an error, not an option silently ignored
    with pytest.raises(ValueError, match="unknown speculation option"):
        EngineConfig(**ENGINE_KW, speculation={"mode": "ngram", "k": 2})


def test_moe_config_serves_through_llm_server():
    """MoE configs are ported (tests/test_torch_moe.py holds them against
    the reference): tiny-moe serves through the user's entry point."""
    server = LLMServer._target(model_name="tiny-moe", device="cpu", seed=1,
                               engine_config=dict(ENGINE_KW, decode_span=4))
    try:
        out = server({"prompt_ids": [3, 1, 4, 1, 5, 9, 2, 6], "max_tokens": 6})
        again = server({"prompt_ids": [3, 1, 4, 1, 5, 9, 2, 6], "max_tokens": 6})
    finally:
        server.shutdown()
    assert len(out["token_ids"]) == 6 and out["finish_reason"] == "length"
    assert out["token_ids"] == again["token_ids"]
    params = server.engine.params
    assert params["layers"]["w_in"].shape[1] == get_config("tiny-moe").num_experts


def test_init_params_is_seeded_and_typed():
    cfg = get_config("tiny-llama")
    a = init_params(cfg, seed=3, device="cpu", dtype="bfloat16")
    b = init_params(cfg, seed=3, device="cpu", dtype="bfloat16")
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert a["layers"]["wq"].shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hdim)
    assert a["layers"]["wo"].shape == (cfg.n_layers, cfg.n_heads, cfg.hdim, cfg.d_model)
    assert torch.equal(a["embed"], b["embed"])


def test_port_imports_neither_jax_nor_ray_tpu():
    # it also serves tiny-moe with speculation, so the MoE path is checked
    # too, moves a prompt's KV out of the engine and back in, swaps the
    # weights live and renders the metrics, the digests and a trace, runs
    # one request through a disaggregated coordinator over two engines,
    # one health-plane pass and one fleet evaluation over it (importing the
    # plane, the fleet, the schema and the gRPC proxy loads neither grpc
    # nor protobuf);
    # then it starts the runtime (a task, an actor, a compiled graph, the
    # virtual cluster, the training gang, the ingest service, a Tuner, a
    # Pool and a logger)
    code = (
        "import json, sys\n"
        "import ray_tpu_torch, ray_tpu_torch.serve, ray_tpu_torch.models, ray_tpu_torch.train\n"
        "import ray_tpu_torch.data, ray_tpu_torch.train.trainer, ray_tpu_torch.train.checkpoint\n"
        "import ray_tpu_torch.tune, ray_tpu_torch.util, ray_tpu_torch.train.integrations\n"
        "import ray_tpu_torch.data.ingest\n"
        "import ray_tpu_torch.serve.disagg, ray_tpu_torch.core.channels, ray_tpu_torch.dag\n"
        "import ray_tpu_torch.core.health, ray_tpu_torch.serve.fleet, ray_tpu_torch.serve.schema\n"
        "import ray_tpu_torch.serve.grpc_proxy\n"
        "assert not [m for m in sys.modules if m == 'grpc' or m.startswith('grpc.')\n"
        "            or m.startswith('google.protobuf')]\n"
        "from ray_tpu_torch import tune, util\n"
        "from ray_tpu_torch.data import ingest\n"
        "from ray_tpu_torch.train import integrations\n"
        "import ray_tpu_torch.serve.spec_decode, ray_tpu_torch.serve.config\n"
        "import ray_tpu_torch.serve.programs, ray_tpu_torch.models.generate\n"
        "import ray_tpu_torch.parallel.moe\n"
        "from ray_tpu_torch.core import config, metrics\n"
        "from ray_tpu_torch.util import slo, tracing\n"
        "from ray_tpu_torch.serve import Request\n"
        "from ray_tpu_torch.serve.engine import prompt_page_fingerprints\n"
        "server = ray_tpu_torch.LLMServer._target(\n"
        "    model_name='tiny-moe', device='cpu', engine_config=dict(\n"
        "        max_batch_size=2, page_size=8, max_pages=32, max_seq_len=64,\n"
        "        prefill_buckets=(16,), prefill_chunk=16,\n"
        "        speculation={'mode': 'ngram', 'num_speculative_tokens': 2}))\n"
        "try:\n"
        "    out = server({'prompt_ids': [1, 2, 3, 1, 2], 'max_tokens': 4})\n"
        "    assert len(out['token_ids']) == 4\n"
        "    req = Request(request_id='e', prompt=[1, 2, 3, 1, 2], max_tokens=4,\n"
        "                  prefill_only=True)\n"
        "    server.engine.add_request(req)\n"
        "    blob = server.engine.export_kv_pages(req, timeout_s=60)\n"
        "    imp = Request(request_id='i', prompt=[1, 2, 3, 1, 2], max_tokens=4)\n"
        "    server.engine.import_kv_pages(imp, blob)\n"
        "    assert imp.done.wait(60) and imp.error is None and len(imp.output) == 4\n"
        "    assert len(prompt_page_fingerprints(list(range(17)), 8)) == 2\n"
        "    tree = ray_tpu_torch.init_params(server.engine.cfg, seed=1, device='cpu')\n"
        "    assert server.update_weights({'weights': tree})['weights_version'] == 1\n"
        "    with tracing.start_span('root') as root:\n"
        "        server({'prompt_ids': [4, 5, 6], 'max_tokens': 2})\n"
        "    assert len(tracing.get_spans(root.trace_id)) == 2\n"
        "    assert 'serve_weights_version{role=\"colocated\"} 1.0' in "
        "metrics.registry.render_prometheus()\n"
        "    assert slo.snapshot() and config.config.slo_digests\n"
        "    assert isinstance(server.prefix_digest()['hashes'], list)\n"
        "    from ray_tpu_torch.serve.disagg import DisaggCoordinator, EngineWorker\n"
        "    dec = ray_tpu_torch.LLMServer._target(\n"
        "        model_name='tiny-moe', device='cpu', role='decode', engine_config=dict(\n"
        "            max_batch_size=2, page_size=4, max_pages=64, max_seq_len=64,\n"
        "            prefill_buckets=(16,)))\n"
        "    try:\n"
        "        co = DisaggCoordinator([EngineWorker(server.engine)], [EngineWorker(dec.engine)])\n"
        "        res = co.generate([7, 8, 9, 10, 11], max_tokens=3)\n"
        "        assert res['kv_transport'] == 'stream' and len(res['token_ids']) == 3\n"
        "        from ray_tpu_torch.core.health import HealthPlane\n"
        "        from ray_tpu_torch.serve.fleet import FleetController\n"
        "        plane = HealthPlane(period_s=60.0)\n"
        "        assert plane.evaluate() == []\n"
        "        targets = FleetController(co, {}, plane=plane).evaluate_once()\n"
        "        assert targets == {'prefill': 1, 'decode': 1}\n"
        "        co.close()\n"
        "    finally:\n"
        "        dec.shutdown()\n"
        "finally:\n"
        "    server.shutdown()\n"
        "import ray_tpu_torch.api, ray_tpu_torch.cluster_utils\n"
        "ray_tpu_torch.api.init(num_cpus=2, system_config={'worker_processes': 0,\n"
        "                                                  'actor_processes': False})\n"
        "try:\n"
        "    @ray_tpu_torch.remote\n"
        "    def add(a, b):\n"
        "        return a + b\n"
        "    @ray_tpu_torch.remote\n"
        "    class Counter:\n"
        "        def __init__(self):\n"
        "            self.n = 0\n"
        "        def inc(self):\n"
        "            self.n += 1\n"
        "            return self.n\n"
        "    assert ray_tpu_torch.get(add.remote(ray_tpu_torch.put(1), 2), timeout=30) == 3\n"
        "    c = Counter.remote()\n"
        "    assert ray_tpu_torch.get([c.inc.remote() for _ in range(3)], timeout=30) == [1, 2, 3]\n"
        "    @ray_tpu_torch.remote\n"
        "    class Double:\n"
        "        def process(self, x):\n"
        "            return 2 * x\n"
        "    from ray_tpu_torch.dag import InputNode\n"
        "    d = Double.remote()\n"
        "    with InputNode() as inp:\n"
        "        graph = d.process.bind(inp).experimental_compile()\n"
        "    assert graph.execute(21).get(timeout=30) == 42\n"
        "    ray_tpu_torch.kill(d)\n"
        "    ray_tpu_torch.kill(c)  # its CPU goes to the data tasks beside the gang\n"
        "    from ray_tpu_torch import data, train\n"
        "    import tempfile\n"
        "    ds = data.from_numpy({'x': __import__('numpy').arange(8)}, parallelism=2)\n"
        "    def loop(config):\n"
        "        for b in train.get_dataset_shard('train').iter_device_batches(\n"
        "                batch_size=4, device='cpu'):\n"
        "            train.report({'s': int(b['x'].sum())})\n"
        "    with tempfile.TemporaryDirectory() as d:\n"
        "        r = train.TorchTrainer(loop, datasets={'train': ds},\n"
        "                               run_config=train.RunConfig(storage_path=d)).fit()\n"
        "        assert r.error is None and [m['s'] for m in r.metrics_history] == [6, 22]\n"
        "        p = train.save_pytree({'w': tree['embed']}, d + '/ck')\n"
        "        assert train.load_pytree(p, device='cpu')['w'].equal(tree['embed'])\n"
        "        cb = integrations.MLflowLoggerCallback(name='r', dir=d)\n"
        "        cb([{'loss': 1.0}])\n"
        "    svc = ingest.get_ingest_service(pool_min=1, pool_max=1, autoscale=False)\n"
        "    it = svc.register(ds, tenant='t', weight=2.0)\n"
        "    assert sum(len(b['x']) for b in it.iter_batches(batch_size=4)) == 8\n"
        "    ingest.shutdown_ingest_service()\n"
        "    g = tune.Tuner(lambda c: tune.report({'loss': c['x']}),\n"
        "                   param_space={'x': tune.grid_search([1, 2])}).fit()\n"
        "    assert g.get_best_result().config['x'] == 1\n"
        "    with util.Pool(processes=2) as pool:\n"
        "        assert pool.map(abs, [-1, -2]) == [1, 2]\n"
        "finally:\n"
        "    ray_tpu_torch.api.shutdown()\n"
        "cluster = ray_tpu_torch.cluster_utils.Cluster()\n"
        "try:\n"
        "    cluster.add_slice(num_hosts=2, chips_per_host=4)\n"
        "    assert ray_tpu_torch.cluster_resources()['GPU'] == 8.0\n"
        "finally:\n"
        "    cluster.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ray_tpu' or m.startswith('ray_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
