"""The online RL loop (ray_tpu_torch.rl.online) against ray_tpu.rl.online,
on the CPU at tiny-llama.

`_train_groups` on fixed trajectory groups (mixed completion lengths,
missing logprobs backfilled) gives the same loss, KL, reward and
parameters in both packages, from the same weights. Then the reference's
flows of tests/test_rl_online.py, each under both packages (each on its
own runtime in thread mode, with its own engines over the same weights,
the port's with device="cpu"): a stamped rollout (logprobs and
weights_version 0), the staleness bound dropping or correcting every
lagged trajectory (counted), a full weight sync landing mid-stream while
the stream keeps its length and its tokens in vocab, and stop() mid-
iteration leaving the inflight gauge at zero and the loop's channel out
of the registry; the counts must be equal between the packages. For the
port alone: stop() leaves no rollout thread running; the trainer owns its
parameters, so an engine built over the
tree the loop was given keeps its weights and outputs after an update
until the sync; and the rl_sync_stall health rule fires off the loop's
rl_sync_stall_fraction gauge. Every engine and runtime stops in a
`finally`.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.models as jmodels
import ray_tpu.rl.online as jonline
import ray_tpu.serve.disagg as jdisagg
import ray_tpu.serve.fleet as jfleet
import ray_tpu_torch
import ray_tpu_torch.rl.online as tonline
import ray_tpu_torch.serve.disagg as tdisagg
import ray_tpu_torch.serve.fleet as tfleet
from ray_tpu.core import channels as jchannels
from ray_tpu.core import metrics as jmetrics
from ray_tpu.serve import engine as jengine
from ray_tpu_torch.core import channels as tchannels
from ray_tpu_torch.core import health as thealth
from ray_tpu_torch.core import metrics as tmetrics
from ray_tpu_torch.models import get_config, params_from_numpy
from ray_tpu_torch.rl.module import tree_leaves
from ray_tpu_torch.serve import engine as tengine
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

pytestmark = pytest.mark.rl

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
ENGINE_KW = dict(max_batch_size=8, page_size=8, max_pages=128, max_seq_len=96,
                 prefill_buckets=(16, 32))
UPDATE_TOL = dict(rtol=1e-4, atol=1e-6)
WAIT_S = 60


@pytest.fixture(scope="module")
def tiny():
    jcfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    other = jmodels.init_params(jcfg, jax.random.PRNGKey(1))
    return {"jcfg": jcfg, "jparams": jparams, "tcfg": get_config("tiny-llama"),
            "tree": jax.tree.map(np.asarray, jparams), "jother": other,
            "other": jax.tree.map(np.asarray, other)}


class Pkg:
    """One package's online RL as a flow sees it."""

    def __init__(self, name, tiny):
        self.port = name == "ray_tpu_torch"
        self.api = ray_tpu_torch if self.port else ray_tpu
        self.online = tonline if self.port else jonline
        self.disagg = tdisagg if self.port else jdisagg
        self.fleet_mod = tfleet if self.port else jfleet
        self.engine_mod = tengine if self.port else jengine
        self.channels = tchannels if self.port else jchannels
        self.registry = (tmetrics if self.port else jmetrics).registry
        self.tiny = tiny
        self.cfg = tiny["tcfg"] if self.port else tiny["jcfg"]
        self.engines = []

    def params(self, key="tree"):
        if self.port:
            return params_from_numpy(self.tiny[key], device="cpu")
        return self.tiny["jparams" if key == "tree" else "jother"]

    def engine(self, params):
        ecfg = self.engine_mod.EngineConfig(**ENGINE_KW)
        extra = {"device": "cpu"} if self.port else {}
        e = self.engine_mod.InferenceEngine(params, self.cfg, ecfg, **extra)
        self.engines.append(e)
        return e

    def fleet(self, params=None):
        params = params if params is not None else self.params()
        workers = [self.disagg.EngineWorker(self.engine(params), f"w{i}") for i in range(2)]
        co = self.disagg.DisaggCoordinator(workers[:1], workers[1:], {"small_blob_bytes": 0})
        return self.fleet_mod.FleetController(co)

    def loop(self, fleet, params=None, **grpo):
        g = dict({"group_size": 4, "max_new_tokens": 8}, **grpo)
        loop_cfg = g.pop("loop", {})
        extra = {"device": "cpu"} if self.port else {}
        params = params if params is not None else self.params()
        return self.online.OnlineRLLoop(
            params, self.cfg, half_vocab_reward(self.cfg), fleet, prompts=[[1, 2, 3]],
            config_=self.online.OnlineRLConfig(grpo=self.online.GRPOConfig(**g), **loop_cfg),
            **extra)

    def stop(self):
        for e in self.engines:
            e.stop()


def half_vocab_reward(cfg):
    half = cfg.vocab_size // 2

    def reward(prompt_ids, completion_ids):
        return float(np.mean([t < half for t in completion_ids])) if completion_ids else 0.0

    return reward


def run_both(flow, tiny):
    """flow(pkg) under each package, each on its own thread-mode runtime,
    its engines stopped and its runtime shut down after."""
    out = []
    for name in ("ray_tpu_torch", "ray_tpu"):
        p = Pkg(name, tiny)
        p.api.shutdown()
        p.api.init(num_cpus=8, system_config=THREAD_MODE)
        try:
            out.append(flow(p))
        finally:
            p.stop()
            p.api.shutdown()
    return out


# ------------------------------------------------------------ the trainer


class BareCoordinator:
    """Stands where the loop expects a coordinator; _train_groups uses
    none of it."""


def trajectory_groups(online, vocab):
    rng = np.random.default_rng(0)
    groups = {}
    for gi, prompt in enumerate(([1, 2, 3], [7, 8, 9, 10])):
        trajs = []
        for i in range(5):
            n = 5 if i == 4 else 6  # one short completion: dropped for length
            comp = [int(t) for t in rng.integers(0, vocab, n)]
            lps = [None if (i + k) % 4 == 0 else float(-rng.uniform(0.5, 7.0))
                   for k in range(n)]
            trajs.append(online.Trajectory(prompt=list(prompt), completion=comp, logprobs=lps,
                                           weights_version=0, group=gi,
                                           reward=float(rng.normal())))
        groups[gi] = trajs
    return groups


def train_groups_flow(p):
    loop = p.loop(BareCoordinator(), lr=1e-3, kl_coef=0.05)
    try:
        backfills = p.registry.get("rl_logprob_backfills")
        b0 = backfills.get()
        first = loop._train_groups(trajectory_groups(p.online, p.cfg.vocab_size))
        second = loop._train_groups(trajectory_groups(p.online, p.cfg.vocab_size))
        params = loop.grpo.params
        leaves = ([t.detach().numpy() for t in tree_leaves(params)] if p.port
                  else [np.asarray(x) for x in jax.tree.leaves(params)])
        return first, second, backfills.get() - b0, leaves
    finally:
        loop.stop()


def test_train_groups_match(tiny):
    port, ref = run_both(train_groups_flow, tiny)
    for p_m, r_m in zip(port[:2], ref[:2]):
        assert p_m["groups_trained"] == r_m["groups_trained"] == 2.0
        for k in ("loss", "kl", "reward_mean"):
            np.testing.assert_allclose(p_m[k], r_m[k], **UPDATE_TOL)
    assert port[2] == ref[2] > 0  # the same missing logprobs backfilled
    assert port[1]["kl"] > 0.0
    for g, w in zip(port[3], ref[3]):
        np.testing.assert_allclose(g, w, **UPDATE_TOL)


# ---------------------------------------------- the reference's flows, both


def stamped_rollout(p):
    fleet = p.fleet()
    ds = fleet.co.open_stream([1, 2, 3], max_tokens=8, temperature=1.0)
    toks = list(ds.tokens())
    return (len(toks), ds.weights_version, len(ds.logprobs),
            all(lp is None or lp <= 0.0 for lp in ds.logprobs),
            any(lp is not None for lp in ds.logprobs))


def test_stamped_rollout_flow_matches(tiny):
    port, ref = run_both(stamped_rollout, tiny)
    assert port == ref == (8, 0, 8, True, True)


def lagged(policy):
    def flow(p):
        fleet = p.fleet()
        loop = p.loop(fleet, loop={"staleness_max_versions": 1, "staleness_policy": policy})
        stale = p.registry.get("rl_stale_trajectories")
        dropped = p.registry.get("rl_dropped_trajectories")
        tag = {"policy": "dropped" if policy == "drop" else "corrected"}
        s0, d0 = stale.get(tags=tag), dropped.get(tags={"reason": "stale"})
        try:
            # the fleet still serves generation 0; a trainer 3 versions
            # ahead makes every rollout stale beyond the bound
            loop.version = 3
            m = loop.run_iteration()
        finally:
            loop.stop()
        return (m["trajectories"], m["submitted"], stale.get(tags=tag) - s0,
                dropped.get(tags={"reason": "stale"}) - d0, m["weights_version"])
    return flow


@pytest.mark.parametrize("policy", ["drop", "correct"])
def test_staleness_flow_matches(tiny, policy):
    port, ref = run_both(lagged(policy), tiny)
    assert port == ref
    assert port == ((0.0, 4.0, 4, 4, 4.0) if policy == "drop" else (4.0, 4.0, 4, 0, 4.0))


def mid_stream_sync(p):
    fleet = p.fleet()
    ds = fleet.co.open_stream([5, 6, 7], max_tokens=24)
    it = ds.tokens()
    toks = [next(it) for _ in range(6)]
    out = fleet.sync_weights(weights=p.params("other"), version=1)
    toks.extend(it)
    return (len(out["failed"]), sorted({s["weights_version"] for s in out["synced"]}),
            len(out["synced"]), len(toks),
            all(isinstance(t, int) and 0 <= t < p.cfg.vocab_size for t in toks),
            sorted(v for v in fleet.co.weights_versions().values() if v is not None))


def test_mid_stream_sync_flow_matches(tiny):
    port, ref = run_both(mid_stream_sync, tiny)
    assert port == ref
    assert port[:5] == (0, [1], 2, 24, True)


def stop_mid_iteration(p):
    inflight = p.registry.get("rl_trajectories_inflight")
    fleet = p.fleet()
    loop = p.loop(fleet, group_size=16, max_new_tokens=16)
    t = threading.Thread(target=loop.run_iteration, daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + WAIT_S
        while inflight.get() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        was = inflight.get() > 0
        loop.stop()
        t.join(timeout=WAIT_S)
        with p.channels._registry._lock:
            kept = loop.channel.chan_id in p.channels._registry._chans
        loop.stop()  # idempotent
        try:
            loop.run_iteration()
            refused = False
        except RuntimeError:
            refused = True
        rollouts = sum(x.name.startswith("rl-rollout") for x in threading.enumerate())
        return (was, t.is_alive(), inflight.get(), kept, refused), rollouts
    finally:
        loop.stop()


def test_stop_hygiene_flow_matches(tiny):
    """Also the deliberate difference: the port's stop() starts no more
    rollouts and waits for those in flight, so no rollout thread (and no
    request to a replica) outlives it; the reference's leaves them running."""
    port, ref = run_both(stop_mid_iteration, tiny)
    assert port[0] == ref[0] == (True, False, 0.0, False, True)
    assert port[1] == 0


# ----------------------------------------------------------- the port alone


def test_an_engine_over_the_given_tree_keeps_its_weights_until_the_sync(tiny):
    """The trainer owns its parameters: the loop copies the tree it is
    given, so an engine built over that same tree (on the CPU both are the
    one f32 tiny-llama tree) serves the same weights and tokens after an
    update; the sync then copies the trainer's into it."""
    p = Pkg("ray_tpu_torch", tiny)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, system_config=THREAD_MODE)
    try:
        given = p.params()
        fleet = p.fleet(given)
        loop = p.loop(fleet, given, lr=1e-2)
        try:
            before = [t.clone() for t in tree_leaves(given)]
            engine = p.engines[1]

            def greedy():
                out = engine.generate([4, 5, 6], max_tokens=8)
                return out["token_ids"], out["logprobs"]

            served = greedy()
            m = loop._train_groups(trajectory_groups(p.online, p.cfg.vocab_size))
            assert m["groups_trained"] == 2.0
            trained = tree_leaves(loop.grpo.params)
            assert any(not torch.equal(a.detach(), b) for a, b in zip(trained, before))
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(given), before))
            assert greedy() == served
            loop._sync_weights()
            assert all(torch.equal(a, b.detach()) for a, b in zip(tree_leaves(given), trained))
            assert engine.weights_version == loop.version == 1
        finally:
            loop.stop()
    finally:
        p.stop()
        ray_tpu_torch.shutdown()


def test_sync_stall_rule_fires_off_the_loops_gauge(tiny, monkeypatch):
    """An iteration whose sync takes most of its wall sets
    rl_sync_stall_fraction past rl_sync_stall_max_pct; the stock
    rl_sync_stall rule reads it and fires after two evaluations."""
    p = Pkg("ray_tpu_torch", tiny)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, system_config=THREAD_MODE)
    try:
        fleet = p.fleet()
        real = fleet.sync_weights

        def slow_sync(**kw):
            time.sleep(1.0)
            return real(**kw)

        monkeypatch.setattr(fleet, "sync_weights", slow_sync)
        loop = p.loop(fleet, group_size=2, max_new_tokens=4)
        try:
            m = loop.run_iteration()
        finally:
            loop.stop()
        gauge = p.registry.get("rl_sync_stall_fraction").get()
        assert gauge == m["ledger_sync_stall_fraction"] > 0.05
        parts = sum(m[f"ledger_{k}"] for k in ("rollout", "reward", "train", "weight_sync",
                                                "other"))
        assert parts == pytest.approx(m["ledger_wall_seconds"], rel=1e-9)
        plane = thealth.HealthPlane(rules=[r for r in thealth.default_rules()
                                           if r.name == "rl_sync_stall"],
                                    digests_fn=lambda: [])
        plane.evaluate()
        fired = plane.evaluate()
        assert [a["rule"] for a in fired] == ["rl_sync_stall"]
    finally:
        p.stop()
        ray_tpu_torch.shutdown()
