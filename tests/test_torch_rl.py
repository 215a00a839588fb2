"""RL (ray_tpu_torch.rl) against ray_tpu.rl, on the CPU at CartPole and
tiny-llama sizes.

The numpy parts are the reference's code: the env, the connectors, the
replay buffers and the env runners draw the same numbers from the same
seed, so their flows must be equal outright (the runners as actors of
each package's runtime, in thread mode). Then the tensor parts from the
same numbers: the MLP module after `module_from_numpy` to 1e-6; GAE, the
truncation fold and V-trace to 1e-5; one update of every learner (PPO,
IMPALA, APPO, DQN plain and prioritized, SAC, BC, MARWIL, CQL,
MultiAgentPPO) from the same params, optimizer state and batch, losses
and every new leaf within rtol 1e-4 / atol 1e-6 (two updates, so that the
optimizer's moments are held too); GRPO's `_seq_logp` to 1e-5 and its
update under adam and under factored to 1e-4, its reference policy
untouched. The offline data path on a tiny parquet file. Last, the
deliberate differences: the target and behavior trees are copies that an
update leaves alone, and importing ray_tpu_torch.rl loads neither jax nor
ray_tpu.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.models as jmodels
import ray_tpu.rl as jrl
import ray_tpu_torch
import ray_tpu_torch.rl as trl
from ray_tpu_torch.models import get_config, params_from_numpy
from ray_tpu_torch.rl.module import tree_leaves
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

pytestmark = pytest.mark.rl

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
UPDATE_TOL = dict(rtol=1e-4, atol=1e-6)
MODULE_TOL = dict(rtol=1e-6, atol=1e-6)
TARGET_TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_module(seed, obs=4, actions=2, hidden=(16, 16)):
    return np_tree(jrl.init_mlp_module(jax.random.PRNGKey(seed), obs, actions, hidden))


def port_module(tree):
    return trl.module_from_numpy(tree, device="cpu")


def assert_trees_close(port, ref, tol=UPDATE_TOL):
    got = [t.detach().numpy() for t in tree_leaves(port)]
    want = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


def assert_close(port, ref, tol=UPDATE_TOL):
    if isinstance(port, torch.Tensor):
        port = port.detach()
    np.testing.assert_allclose(float(port), float(ref), **tol)


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def cartpole_rollout(seed=0, n=48):
    """One flat CartPole rollout's columns, from the reference's numpy
    code (an EnvRunner's sample body), without a runtime."""
    rng = np.random.default_rng(seed)
    env = jrl.CartPole()
    obs = env.reset(seed=seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones", "next_obs")}
    for _ in range(n):
        a = int(rng.integers(0, 2))
        nxt, r, term, trunc, _ = env.step(a)
        cols["obs"].append(obs)
        cols["actions"].append(a)
        cols["rewards"].append(r)
        cols["dones"].append(term or trunc)
        cols["next_obs"].append(nxt)
        obs = env.reset() if term or trunc else nxt
    return {"obs": np.asarray(cols["obs"], np.float32),
            "actions": np.asarray(cols["actions"], np.int32),
            "rewards": np.asarray(cols["rewards"], np.float32),
            "dones": np.asarray(cols["dones"], np.bool_),
            "next_obs": np.asarray(cols["next_obs"], np.float32)}


# ------------------------------------------------- the numpy parts, equal


def test_env_flows_are_equal():
    def flow(rl):
        env = rl.CartPole(max_steps=60)
        out = [env.reset(seed=3)]
        rng = np.random.default_rng(5)
        for _ in range(200):
            obs, r, term, trunc, _ = env.step(int(rng.integers(0, 2)))
            out.append((obs, r, term, trunc))
            if term or trunc:
                out.append(env.reset())
        ma = rl.MultiCartPole(n_agents=2, max_steps=30)
        out.append(ma.reset(seed=1))
        for t in range(40):
            step = ma.step({a: t % 2 for a in ma._alive})
            out.append(step[:4])
            if step[2]["__all__"]:
                out.append(ma.reset())
        return out

    port, ref = flow(trl), flow(jrl)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_equal(p, r)


def test_connector_flows_are_equal():
    def flow(rl):
        rng = np.random.default_rng(0)
        pipe = rl.build_pipeline([rl.FlattenObs(), rl.NormalizeObs(), rl.ScaleObs(scale=0.5),
                                  rl.ClipObs(-1.0, 1.0)])
        obs_out = [pipe(rng.normal(size=(2, 2)).astype(np.float32) * 3) for _ in range(40)]
        mask = rl.MaskLogits(lambda obs: np.asarray([True, obs[0] > 0]))
        logits = [mask(rng.normal(size=2), {"obs": rng.normal(size=1)}) for _ in range(8)]
        ro = {"rewards": rng.normal(size=16).astype(np.float32)}
        clipped = rl.build_pipeline([rl.ClipReward(-0.5, 0.5)])(dict(ro))["rewards"]
        return obs_out, logits, clipped

    port, ref = flow(trl), flow(jrl)
    for p, r in zip(port, ref):
        np.testing.assert_equal(p, r)


def test_replay_buffer_flows_are_equal():
    def flow(rl):
        ro = cartpole_rollout(1, n=40)
        plain = rl.ReplayBuffer(32, seed=2)
        prio = rl.PrioritizedReplayBuffer(32, alpha=0.6, beta=0.4, seed=2)
        out = []
        for buf in (plain, prio):
            buf.add_batch(ro)
            buf.add_batch({k: v[:10] for k, v in ro.items()})
        out.append(plain.sample(8))
        for i in range(3):
            batch, idx, weights = prio.sample(8)
            prio.update_priorities(idx, np.linspace(-1.0, 2.0, 8) * (i + 1))
            out.append((batch, idx, weights))
        return out, len(plain), len(prio)

    port, ref = flow(trl), flow(jrl)
    assert port[1:] == ref[1:] == (32, 32)
    np.testing.assert_equal(port[0], ref[0])


def runner_flow(pkg, rl):
    """Two EnvRunners, then two VectorEnvRunners of two envs, with a
    scale connector, as actors of `pkg`'s runtime; the same numpy
    weights. Returns their rollouts."""
    pkg.shutdown()
    pkg.init(num_cpus=4, system_config=THREAD_MODE)
    try:
        params = ref_module(0)
        out = []
        for envs in (1, 2):
            group = rl.EnvRunnerGroup(rl.CartPole, rl.mlp_forward_np, 2, 7,
                                      num_envs_per_runner=envs,
                                      connectors=[rl.ScaleObs(scale=0.5)])
            out.append(group.sample(40, params))
            out.append(group.sample(24, params, epsilon=0.3))
        return out
    finally:
        pkg.shutdown()


def test_env_runner_flows_are_equal():
    port, ref = runner_flow(ray_tpu_torch, trl), runner_flow(ray_tpu, jrl)
    assert [len(ros) for ros in port] == [2, 2, 2, 2]
    for p, r in zip(port, ref):
        np.testing.assert_equal(p, r)


# -------------------------------------------- the tensor parts, within tol


def test_mlp_forward_after_module_from_numpy():
    tree = ref_module(0, obs=6, actions=3, hidden=(32, 16))
    obs = np.random.default_rng(0).normal(size=(9, 6)).astype(np.float32)
    logits, value = trl.mlp_forward(port_module(tree), torch.from_numpy(obs))
    jlogits, jvalue = jrl.mlp_forward(tree, jnp.asarray(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODULE_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), **MODULE_TOL)
    np.testing.assert_equal(trl.mlp_forward_np(tree, obs), jrl.mlp_forward_np(tree, obs))
    # the port's own init: the reference's shapes, from a torch generator
    own = trl.init_mlp_module(torch.Generator().manual_seed(0), 6, 3, (32, 16), device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == [x.shape for x in jax.tree.leaves(tree)]


def test_gae_and_truncation_fold_match():
    from ray_tpu.rl.env_runner import fold_truncation_bootstrap as jfold
    from ray_tpu_torch.rl.env_runner import fold_truncation_bootstrap as tfold

    rng = np.random.default_rng(0)
    ro = {"rewards": rng.normal(size=50).astype(np.float32),
          "truncation_values": np.where(rng.random(50) < 0.2, rng.normal(size=50),
                                        0.0).astype(np.float32)}
    rew_t, rew_j = tfold(ro, 0.97), jfold(ro, 0.97)
    np.testing.assert_allclose(rew_t, rew_j, **TARGET_TOL)
    np.testing.assert_equal(tfold({"rewards": ro["rewards"]}, 0.9), ro["rewards"])
    values = rng.normal(size=50).astype(np.float32)
    dones = rng.random(50) < 0.1
    for args in ((rew_t, values, dones, 0.7, 0.99, 0.95), (rew_t, values, dones, 0.0, 1.0, 1.0)):
        for p, r in zip(trl.compute_gae(*args), jrl.compute_gae(*args)):
            np.testing.assert_allclose(p, r, **TARGET_TOL)


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.5, 0.8)])
def test_vtrace_targets_match(clip):
    rng = np.random.default_rng(1)
    T = 64
    cols = {"behavior_logp": np.log(rng.uniform(0.1, 0.9, T)).astype(np.float32),
            "target_logp": np.log(rng.uniform(0.1, 0.9, T)).astype(np.float32),
            "rewards": rng.normal(size=T).astype(np.float32),
            "values": rng.normal(size=T).astype(np.float32)}
    dones = rng.random(T) < 0.1
    got = trl.vtrace_targets(*[torch.from_numpy(cols[k]) for k in cols], 0.6,
                             torch.from_numpy(dones), 0.99, *clip)
    want = jrl.vtrace_targets(*[jnp.asarray(cols[k]) for k in cols], 0.6,
                              jnp.asarray(dones), 0.99, *clip)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TARGET_TOL)


def onpolicy_batch(seed, n=48, obs=4):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, obs)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32)}


def vtrace_batch(seed, n=48):
    ro = cartpole_rollout(seed, n)
    rng = np.random.default_rng(seed)
    return {"obs": ro["obs"], "actions": ro["actions"], "rewards": ro["rewards"],
            "dones": ro["dones"],
            "behavior_logp": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
            "bootstrap_value": np.float32(0.4)}


def two_updates(port_update, ref_update, port_args, ref_args, batches, n_out):
    """Two updates in each package, each fed its own outputs back: returns
    the last outputs of both."""
    p_out, r_out = None, None
    for b in batches:
        p_out = port_update(*port_args, b)
        r_out = ref_update(*ref_args, jbatch(b))
        port_args, ref_args = p_out[:n_out], r_out[:n_out]
    return p_out, r_out


def assert_aux_close(p_aux, r_aux):
    assert set(p_aux) == set(r_aux)
    for k in r_aux:
        assert_close(p_aux[k], r_aux[k])


@pytest.mark.parametrize("algo", ["ppo", "impala", "appo", "multi_agent_ppo"])
def test_policy_gradient_update_matches(algo):
    tree = ref_module(0)
    if algo == "multi_agent_ppo":
        cfg = dict(env_fn=lambda: jrl.MultiCartPole(2), num_env_runners=0, policy_ids=("a",),
                   minibatch_size=48)
        ref = jrl.MultiAgentPPO(jrl.MultiAgentPPOConfig(**cfg))
        port = trl.MultiAgentPPO(trl.MultiAgentPPOConfig(**cfg), device="cpu",
                                 params={"a": port_module(tree)})
        ref.params["a"] = tree
        ref.opt_state["a"] = ref.optimizer.init(tree)
        p_args, r_args = (port.params["a"], port.opt_state["a"]), (tree, ref.opt_state["a"])
    else:
        cls, config = {"ppo": ("PPO", "PPOConfig"), "impala": ("IMPALA", "IMPALAConfig"),
                       "appo": ("APPO", "APPOConfig")}[algo]
        cfg = dict(env_fn=jrl.CartPole, num_env_runners=0, hidden=(16, 16))
        ref = getattr(jrl, cls)(getattr(jrl, config)(**cfg))
        port = getattr(trl, cls)(getattr(trl, config)(**cfg), device="cpu",
                                 params=port_module(tree))
        ref.params, ref.opt_state = tree, ref.optimizer.init(tree)
        p_args, r_args = (port.params, port.opt_state), (ref.params, ref.opt_state)
    make = onpolicy_batch if algo in ("ppo", "multi_agent_ppo") else vtrace_batch
    p_out, r_out = two_updates(port._update, ref._update, p_args, r_args,
                               [make(1), make(2)], 2)
    assert_trees_close(p_out[0], r_out[0])
    if algo == "multi_agent_ppo":
        assert_close(p_out[2], r_out[2])
    else:
        assert_aux_close(p_out[2], r_out[2])
    assert p_out[1]["count"] == 2


def replay_batch(seed, n=32):
    ro = cartpole_rollout(seed, n)
    return dict(ro, dones=ro["dones"].astype(np.float32))


@pytest.mark.parametrize("double_dqn", [True, False])
def test_dqn_update_matches(double_dqn):
    tree, target = ref_module(0), ref_module(1)
    cfg = dict(env_fn=jrl.CartPole, num_env_runners=0, hidden=(16, 16), double_dqn=double_dqn)
    ref = jrl.DQN(jrl.DQNConfig(**cfg))
    port = trl.DQN(trl.DQNConfig(**cfg), device="cpu", params=port_module(tree))
    port.target_params = port_module(target)
    weights = np.linspace(0.5, 1.5, 32).astype(np.float32)
    batches = [dict(replay_batch(s), weights=weights) for s in (3, 4)]
    p_out, r_out = None, None
    p_args, r_args = (port.params, port.target_params, port.opt_state), \
        (tree, target, ref.optimizer.init(tree))
    for b in batches:
        p_out = port._update(*p_args, b)
        r_out = ref._update(*r_args, jbatch(b))
        p_args, r_args = (p_out[0], p_args[1], p_out[1]), (r_out[0], r_args[1], r_out[1])
    assert_trees_close(p_out[0], r_out[0])
    assert_close(p_out[2], r_out[2])
    np.testing.assert_allclose(p_out[3].numpy(), np.asarray(r_out[3]), **UPDATE_TOL)


def test_prioritized_dqn_flow_matches():
    """The prioritized variant: both packages' buffers draw the same batch
    and importance weights, one update each, the TD errors written back as
    priorities, and the next draw is the same again."""
    tree = ref_module(0)
    cfg = dict(env_fn=jrl.CartPole, num_env_runners=0, hidden=(16, 16), prioritized=True,
               batch_size=16, buffer_capacity=64)
    ref = jrl.DQN(jrl.DQNConfig(**cfg))
    port = trl.DQN(trl.DQNConfig(**cfg), device="cpu", params=port_module(tree))
    ref.params, ref.target_params, ref.opt_state = tree, tree, ref.optimizer.init(tree)
    ro = cartpole_rollout(5, 60)
    for algo in (ref, port):
        algo.buffer.add_batch(ro)
    draws = []
    for _ in range(2):
        (pb, pidx, pw), (rb, ridx, rw) = port.buffer.sample(16), ref.buffer.sample(16)
        np.testing.assert_equal((pb, pidx, pw), (rb, ridx, rw))
        draws.append(pidx)
        p_out = port._update(port.params, port.target_params, port.opt_state, dict(pb, weights=pw))
        r_out = ref._update(ref.params, ref.target_params, ref.opt_state,
                            jbatch(dict(rb, weights=rw)))
        ref.params, ref.opt_state = r_out[0], r_out[1]
        assert_close(p_out[2], r_out[2])
        td_p, td_r = p_out[3].numpy(), np.asarray(r_out[3])
        np.testing.assert_allclose(td_p, td_r, **UPDATE_TOL)
        port.buffer.update_priorities(pidx, td_r)  # the same priorities: the same next draw
        ref.buffer.update_priorities(ridx, td_r)
    assert_trees_close(port.params, ref.params)
    assert not np.array_equal(*draws)


def test_sac_update_matches():
    trees = {k: ref_module(i) for i, k in enumerate(("pi", "q1", "q2"))}
    cfg = dict(env_fn=jrl.CartPole, num_env_runners=0, hidden=(16, 16))
    ref = jrl.SAC(jrl.SACConfig(**cfg))
    port = trl.SAC(trl.SACConfig(**cfg), device="cpu",
                   params={k: port_module(v) for k, v in trees.items()})
    r_state = [trees["pi"], trees["q1"], trees["q2"], trees["q1"], trees["q2"], ref.log_alpha,
               ref.opt.init(trees["pi"]), ref.opt.init(trees["q1"]), ref.opt.init(trees["q2"]),
               ref.opt.init(ref.log_alpha)]
    p_state = [port.pi, port.q1, port.q2, port.q1_target, port.q2_target, port.log_alpha,
               port.pi_opt, port.q1_opt, port.q2_opt, port.alpha_opt]
    for seed in (6, 7):
        b = replay_batch(seed)
        p_out = port._update(*p_state, b)
        r_out = ref._update(*r_state, jbatch(b))
        p_state, r_state = list(p_out[:10]), list(r_out[:10])
    for i in range(5):
        assert_trees_close(p_out[i], r_out[i])
    assert_close(p_out[5], r_out[5])
    assert_aux_close(p_out[10], r_out[10])


def offline_batch(seed, n=40):
    ro = cartpole_rollout(seed, n)
    rng = np.random.default_rng(seed)
    return ro, rng.normal(size=n).astype(np.float32)


def test_offline_learner_updates_match():
    tree = ref_module(0)
    for name in ("BC", "MARWIL", "CQL"):
        config = getattr(jrl, f"{name}Config")(hidden=(16, 16))
        ref = getattr(jrl, name)(config)
        port = getattr(trl, name)(getattr(trl, f"{name}Config")(hidden=(16, 16)), device="cpu",
                                  params=port_module(tree))
        r_params, r_opt = tree, ref.optimizer.init(tree)
        target = ref_module(1)
        if name == "CQL":
            port.target_params = port_module(target)
        for seed in (8, 9):
            ro, returns = offline_batch(seed)
            obs, acts = ro["obs"], ro["actions"]
            if name == "BC":
                p_out = port._update(port.params, port.opt_state, obs, acts)
                r_out = ref._update(r_params, r_opt, jnp.asarray(obs), jnp.asarray(acts))
            elif name == "MARWIL":
                p_out = port._update(port.params, port.opt_state, obs, acts, returns, 1.3)
                r_out = ref._update(r_params, r_opt, jnp.asarray(obs), jnp.asarray(acts),
                                    jnp.asarray(returns), 1.3)
                assert_close(p_out[3], r_out[3])
            else:
                cols = (obs, acts, ro["rewards"], ro["dones"].astype(np.float32), ro["next_obs"])
                p_out = port._update(port.params, port.target_params, port.opt_state, *cols)
                r_out = ref._update(r_params, target, r_opt, *map(jnp.asarray, cols))
                for p, r in zip(p_out[3], r_out[3]):
                    assert_close(p, r)
            assert_close(p_out[2], r_out[2])
            r_params, r_opt = r_out[0], r_out[1]
        assert_trees_close(port.params, r_params)


def test_offline_dataset_round_trip(tmp_path):
    """rollouts_to_dataset's rows (with the Monte-Carlo returns) equal the
    reference's; save_rollouts / load_offline_dataset on a tiny parquet
    file give them back, and a BC epoch reads them."""
    ro = dict(cartpole_rollout(2, 30))
    rows_t = trl.rollouts_to_dataset([ro], gamma=0.9).take_all()
    rows_j = jrl.rollouts_to_dataset([ro], gamma=0.9).take_all()
    assert len(rows_t) == len(rows_j) > 0
    for a, b in zip(rows_t, rows_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64),
                                       rtol=1e-6)
    path = str(tmp_path / "rollouts")
    trl.save_rollouts([ro], path)
    back = trl.load_offline_dataset(path).take_all()
    assert len(back) == len(ro["obs"])
    np.testing.assert_equal(np.stack([r["obs"] for r in back]), ro["obs"])
    assert back[0]["obs"].dtype == np.float32
    bc = trl.BC(trl.BCConfig(hidden=(16,), batch_size=16), device="cpu")
    out = bc.train_epoch(trl.load_offline_dataset(path))
    assert np.isfinite(out["loss"]) and 0.0 <= out["accuracy"] <= 1.0


# ---------------------------------------------------------------- GRPO


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = jmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, get_config("tiny-llama"), np_tree(jparams)


def _reward(prompt_ids, completion_ids):
    return float(np.mean([t < 256 for t in completion_ids]))


def grpo_batch(seed, G=4, T=14, plen=5, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (G, T)).astype(np.int32), "prompt_len": plen,
            "advantages": rng.normal(size=G).astype(np.float32)}


@pytest.mark.parametrize("factored", [False, True])
def test_grpo_update_matches(tiny_lm, factored):
    jcfg, jparams, tcfg, tree = tiny_lm
    gcfg = dict(group_size=4, lr=1e-3, factored=factored)
    ref = jrl.GRPO(jparams, jcfg, _reward, jrl.GRPOConfig(**gcfg))
    port = trl.GRPO(params_from_numpy(tree, device="cpu"), tcfg, _reward,
                    trl.GRPOConfig(**gcfg), device="cpu")
    b = grpo_batch(0)
    lp_t, mask_t = port._seq_logp(port.params, b["tokens"], b["prompt_len"])
    lp_j, mask_j = ref._seq_logp(ref.params, jnp.asarray(b["tokens"]), b["prompt_len"])
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_equal(mask_t.numpy(), np.asarray(mask_j))
    # logp_old a little off the current policy, logp_ref the reference's
    noise = np.random.default_rng(1).normal(scale=0.05, size=lp_t.shape).astype(np.float32)
    batch = dict(b, logp_old=np.asarray(lp_j) + noise, logp_ref=np.asarray(lp_j) - noise)
    p_params, _, p_aux = port._update(port.params, port.opt_state, batch)
    r_params, _, r_aux = ref._update(ref.params, ref.opt_state, jbatch(batch))
    for k in ("loss", "pg_loss", "kl"):
        np.testing.assert_allclose(float(p_aux[k]), float(r_aux[k]), rtol=1e-4, atol=1e-6)
    moved = [float(np.abs(a - b).max()) for a, b in zip(
        [t.detach().numpy() for t in tree_leaves(p_params)], jax.tree.leaves(tree))]
    assert max(moved) > 1e-4  # the update moved the parameters
    assert_trees_close(p_params, r_params, dict(rtol=1e-4, atol=1e-6))
    # the reference policy is a copy the update left alone, as the reference's
    assert_trees_close(port.ref_params, tree, dict(rtol=0, atol=0))


def test_grpo_train_step_trains_a_copy(tiny_lm):
    """train_step on the port's own generator: the caller's tree and the
    reference policy stay as they were, the trainer's masters move, and
    the KL is positive from the second step on."""
    _jcfg, _jparams, tcfg, tree = tiny_lm
    given = params_from_numpy(tree, device="cpu")
    port = trl.GRPO(given, tcfg, _reward, trl.GRPOConfig(group_size=4, max_new_tokens=6,
                                                         lr=1e-2), device="cpu")
    outs = [port.train_step([1, 2, 3]) for _ in range(2)]
    assert all(np.isfinite(o["loss"]) for o in outs)
    assert abs(outs[0]["kl"]) < 1e-9 and outs[1]["kl"] > 1e-6
    assert_trees_close(given, tree, dict(rtol=0, atol=0))
    assert_trees_close(port.ref_params, tree, dict(rtol=0, atol=0))
    assert any(not torch.equal(a.detach(), b) for a, b in
               zip(tree_leaves(port.params), tree_leaves(given)))


def test_generate_hands_the_kernels_contiguous_rows(tiny_lm, monkeypatch):
    """GRPO's rollouts run models.generate, whose prefill normed the last
    position's rows as a strided view of the prompt's activations; K1's
    wrapper refuses such rows on the card (ValueError), so generate never
    ran there. On the CPU the plain version takes any rows: this pins
    the layout the kernel needs."""
    from ray_tpu_torch.models import generate, transformer

    real = transformer.rms_norm

    def contiguous_only(x, w, eps=1e-6):
        assert x.is_contiguous() and w.is_contiguous(), "non-contiguous rows to the norm"
        return real(x, w, eps=eps)

    monkeypatch.setattr(transformer, "rms_norm", contiguous_only)
    _jcfg, _jparams, tcfg, tree = tiny_lm
    out = generate(params_from_numpy(tree, device="cpu"), tcfg,
                   torch.tensor([[1, 2, 3, 4]] * 2), torch.Generator().manual_seed(0),
                   max_new_tokens=3, temperature=1.0)
    assert out.shape == (2, 3)


# ------------------------------------------------ deliberate differences


def test_target_and_behavior_trees_are_copies():
    """The reference binds target/behavior trees to the online one (JAX
    arrays are immutable); here the optimizers update in place, so those
    trees are copies an update leaves alone."""
    tree = ref_module(0)
    dqn = trl.DQN(trl.DQNConfig(env_fn=trl.CartPole, num_env_runners=0, hidden=(16, 16)),
                  device="cpu", params=port_module(tree))
    dqn._update(dqn.params, dqn.target_params, dqn.opt_state,
                dict(replay_batch(1), weights=np.ones(32, np.float32)))
    assert_trees_close(dqn.target_params, tree, dict(rtol=0, atol=0))
    impala = trl.IMPALA(trl.IMPALAConfig(env_fn=trl.CartPole, num_env_runners=0,
                                         hidden=(16, 16)), device="cpu", params=port_module(tree))
    impala._update(impala.params, impala.opt_state, vtrace_batch(1))
    assert_trees_close(impala.behavior_params, tree, dict(rtol=0, atol=0))
    with pytest.raises(AssertionError):
        assert_trees_close(impala.params, tree, dict(rtol=0, atol=0))


def test_ppo_trains_on_the_port_runtime():
    """PPO end to end on the port's runtime (thread mode): runners sample,
    the learner updates on the CPU, twice; the losses are finite."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, system_config=THREAD_MODE)
    try:
        algo = trl.PPO(trl.PPOConfig(env_fn=trl.CartPole, num_env_runners=2,
                                     rollout_steps_per_runner=64, minibatch_size=64,
                                     num_epochs=2, hidden=(16, 16)), device="cpu")
        outs = [algo.train() for _ in range(2)]
        assert all(np.isfinite(o["loss"]) for o in outs)
        assert outs[-1]["timesteps_this_iter"] == 128
    finally:
        ray_tpu_torch.shutdown()


def test_import_loads_neither_jax_nor_the_reference():
    code = ("import sys, ray_tpu_torch.rl\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ray_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
