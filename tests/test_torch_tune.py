"""Hyperparameter search (ray_tpu_torch.tune) against ray_tpu.tune, on the CPU.

Every flow of tests/test_tune.py runs under both packages in turn, each on
its own runtime in thread mode, and what the reference's test asserts must
hold in both, with the same outcome. Where the outcome does not depend on
the order in which concurrent trials report (search spaces, the best
config, errors, the data frame) the two results must be equal outright.
Then, with no runtime: `generate_configs` and `TPESearcher` draw the same
configs from the same seed, and each scheduler takes the same decisions on
one fixed sequence of results. Then the deliberate difference: a trial the
controller stops stops training in the port (its trainable unwinds at its
next report and frees what it holds), where the reference's killed trial
trains on to its end. Last, a tiny-llama trainable through train.lm
(device="cpu") under a Tuner in each package, from the same numpy weights
and batches: each trial's losses agree within test_torch_train.py's
LOSS_TOL.
"""

import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.tune as jtune
import ray_tpu_torch
import ray_tpu_torch.tune as ttune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune.trial import Trial as JTrial
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune.trial import Trial as TTrial
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
PACKAGES = {"ray_tpu": (ray_tpu, jtune), "ray_tpu_torch": (ray_tpu_torch, ttune)}
WAIT_S = 120
LOSS_TOL = dict(rtol=1e-4, atol=0)  # test_torch_train.py's


def within(seconds, fn, *args):
    """fn(*args) on a thread, joined for at most `seconds`."""
    out = {}

    def target():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            out["error"] = e

    t = threading.Thread(target=target, daemon=True, name="tune-test-flow")
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{fn.__name__} did not finish within {seconds} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def run(name, flow, *args):
    api, tune = PACKAGES[name]
    api.shutdown()
    api.init(num_cpus=8, system_config=dict(THREAD_MODE),
             **({"num_gpus": 0} if name == "ray_tpu_torch" else {"num_tpus": 0}))
    try:
        return within(WAIT_S, flow, tune, *args)
    finally:
        api.shutdown()


def both(flow, *args):
    return run("ray_tpu_torch", flow, *args), run("ray_tpu", flow, *args)


# ------------------------------------------------------------------ flows


def grid_and_samples(tune):
    return tune.generate_configs(
        {"lr": tune.grid_search([0.1, 0.2]), "wd": tune.choice([1, 2]), "c": 7},
        num_samples=3, seed=0)


def domains_in_range(tune):
    return tune.generate_configs(
        {"a": tune.uniform(0.0, 1.0), "b": tune.loguniform(1e-4, 1e-1),
         "c": tune.randint(3, 9)}, num_samples=20, seed=1)


def basic_optimization(tune):
    def trainable(config):
        tune.report({"loss": (config["x"] - 3.0) ** 2})

    grid = tune.Tuner(trainable, param_space={"x": tune.grid_search([0.0, 1.5, 3.0, 4.0])},
                      tune_config=tune.TuneConfig(metric="loss", mode="min")).fit()
    return (grid.get_best_result().config, len(grid), len(grid.errors),
            sorted(t.last_result["loss"] for t in grid.trials))


def final_return_dict(tune):
    def trainable(config):
        return {"score": config["x"] * 2}

    grid = tune.Tuner(trainable, param_space={"x": tune.grid_search([1, 5, 3])},
                      tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    return grid.get_best_result().config, sorted(t.last_result["score"] for t in grid.trials)


def retried(tune, d):
    os.makedirs(d, exist_ok=True)

    def flaky(config):
        marker = os.path.join(d, f"m{config['x']}")
        if config["x"] == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("flaky failure")
        tune.report({"loss": config["x"]})

    grid = tune.Tuner(flaky, param_space={"x": tune.grid_search([0, 1])},
                      tune_config=tune.TuneConfig(max_retries=1)).fit()
    return (len(grid.errors), grid.get_best_result().config,
            sorted((t.config["x"], t.restarts) for t in grid.trials))


def not_retried(tune):
    def bad(config):
        raise ValueError("nope")

    grid = tune.Tuner(bad, param_space={"x": tune.grid_search([1])}).fit()
    return [(t.status.value, "nope" in t.error) for t in grid.errors]


def dataframe(tune):
    def trainable(config):
        tune.report({"loss": config["x"]})

    df = tune.Tuner(trainable, param_space={"x": tune.grid_search([1, 2])}).fit().dataframe()
    return sorted(df.columns), sorted(zip(df["config/x"], df["loss"], df["status"]))


def asha(tune):
    def trainable(config):
        for it in range(1, 28):
            tune.report({"loss": 1.0 / it if config["good"] else 10.0,
                         "training_iteration": it})
            time.sleep(0.02)

    sched = tune.AsyncHyperBandScheduler(metric="loss", mode="min", max_t=27,
                                         grace_period=3, reduction_factor=3)
    grid = tune.Tuner(trainable, param_space={"idx": tune.grid_search(list(range(6))),
                                              "good": tune.grid_search([True, False])},
                      tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=sched,
                                                  max_concurrent_trials=4)).fit()
    stopped = [t for t in grid.trials if t.stopped_early]
    return (grid.get_best_result().config["good"], bool(stopped),
            all(not t.config["good"] for t in stopped))


def pbt(tune, d):
    import importlib

    train = importlib.import_module(tune.__name__.replace(".tune", ".train"))

    def trainable(config):
        ckpt = train.get_checkpoint()
        start = ckpt.get_metadata()["iteration"] if ckpt is not None else 0
        score = float(start)
        for it in range(start + 1, 13):
            score += config["factor"]
            path = os.path.join(d, f"{config['idx']}_{it}")
            os.makedirs(path, exist_ok=True)
            c = train.Checkpoint(path)
            c.set_metadata({"iteration": it})
            tune.report({"score": score, "training_iteration": it}, checkpoint=c)
            time.sleep(0.02)

    sched = tune.PopulationBasedTraining(metric="score", mode="max", perturbation_interval=4,
                                         hyperparam_mutations={"factor": [1.0, 2.0, 5.0]},
                                         seed=0)
    grid = tune.Tuner(trainable, param_space={"idx": tune.grid_search(list(range(4))),
                                              "factor": tune.grid_search([0.1])},
                      tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=sched,
                                                  max_concurrent_trials=4)).fit()
    mutated = [t for t in grid.trials if t.config["factor"] != 0.1]
    return bool(mutated), all(t.config["factor"] in (0.1, 1.0, 2.0, 5.0) for t in grid.trials)


def median_stopping(tune):
    def trainable(config):
        for i in range(1, 9):
            tune.report({"loss": config["q"] + 0.01 * i, "training_iteration": i})

    grid = tune.Tuner(trainable, param_space={"q": tune.grid_search([0.1, 0.1, 0.1, 5.0, 5.0])},
                      tune_config=tune.TuneConfig(
                          metric="loss", mode="min", max_concurrent_trials=5,
                          scheduler=tune.MedianStoppingRule(metric="loss", mode="min",
                                                            grace_period=2,
                                                            min_samples_required=2))).fit()
    stopped = [t for t in grid.trials if t.stopped_early]
    return (bool(stopped), all(t.config["q"] == 5.0 for t in stopped),
            grid.get_best_result().config["q"])


def tpe(tune):
    space = {"x": tune.uniform(-4.0, 4.0), "kind": tune.choice(["a", "b"])}

    def trainable(config):
        tune.report({"loss": (config["x"] - 2.0) ** 2 + (0.0 if config["kind"] == "b" else 1.0)})

    searcher = tune.TPESearcher(space, metric="loss", mode="min", num_samples=24, n_startup=6,
                                seed=0)
    grid = tune.Tuner(trainable, param_space=space, tune_config=tune.TuneConfig(
        metric="loss", mode="min", search_alg=searcher, max_concurrent_trials=2)).fit()
    late = grid.trials[12:]
    near = [t for t in late if abs(t.config["x"] - 2.0) < 1.5 and t.config["kind"] == "b"]
    return (len(grid), all(-4.0 <= t.config["x"] <= 4.0 for t in grid.trials),
            grid.get_best_result().metric("loss") < 0.5, len(near) >= len(late) // 3)


def tpe_budget(tune):
    space = {"x": tune.uniform(0.0, 1.0)}

    def trainable(config):
        tune.report({"loss": config["x"]})

    searcher = tune.TPESearcher(space, num_samples=5, n_startup=2, seed=1)
    grid = tune.Tuner(trainable, param_space=space,
                      tune_config=tune.TuneConfig(search_alg=searcher)).fit()
    return len(grid), sorted(t.config["x"] for t in grid.trials[:2])


FLOWS = {f.__name__: f for f in (grid_and_samples, domains_in_range, basic_optimization,
                                 final_return_dict, not_retried, asha, median_stopping, tpe,
                                 tpe_budget)}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_tune_flow_matches_reference(flow):
    got, want = both(FLOWS[flow])
    assert got == want


def test_retry_matches_reference(tmp_path):
    got, want = (run(p, retried, str(tmp_path / p)) for p in ("ray_tpu_torch", "ray_tpu"))
    assert got == want == (0, {"x": 0}, [(0, 0), (1, 1)])


def test_pbt_matches_reference(tmp_path):
    got, want = (run(p, pbt, str(tmp_path / p)) for p in ("ray_tpu_torch", "ray_tpu"))
    assert got == want == (True, True)


def test_dataframe_matches_reference():
    pytest.importorskip("pandas")
    got, want = both(dataframe)
    assert got == want
    assert [(x, loss) for x, loss, _ in got[1]] == [(1, 1), (2, 2)]


def test_flow_outcomes_are_the_reference_tests_asserts():
    # what the compared flows return, so that equal is not equally wrong
    assert run("ray_tpu_torch", asha) == (True, True, True)
    assert run("ray_tpu_torch", median_stopping) == (True, True, 0.1)
    assert run("ray_tpu_torch", tpe) == (24, True, True, True)
    best, n, errors, _ = run("ray_tpu_torch", basic_optimization)
    assert best == {"x": 3.0} and n == 4 and errors == 0
    assert run("ray_tpu_torch", not_retried) == [("ERROR", True)]


# -------------------------------------------- seeded draws and decisions


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_seeded_configs_are_the_references(seed):
    def space(tune):
        return {"lr": tune.loguniform(1e-5, 1e-1), "wd": tune.uniform(0.0, 0.3),
                "layers": tune.randint(2, 9), "act": tune.choice(["gelu", "relu", "silu"]),
                "bs": tune.grid_search([8, 16]), "const": 3}

    got = ttune.generate_configs(space(ttune), num_samples=4, seed=seed)
    want = jtune.generate_configs(space(jtune), num_samples=4, seed=seed)
    assert got == want and len(got) == 8


def test_tpe_suggestions_are_the_references():
    def suggestions(tune):
        space = {"x": tune.uniform(-4.0, 4.0), "y": tune.loguniform(1e-3, 1.0),
                 "n": tune.randint(1, 6), "kind": tune.choice(["a", "b", "c"])}
        searcher = tune.TPESearcher(space, metric="loss", mode="min", num_samples=20,
                                    n_startup=5, seed=3)
        out = []
        for i in range(21):
            cfg = searcher.suggest(f"t{i}")
            out.append(cfg)
            if cfg is not None:
                loss = (cfg["x"] - 1.0) ** 2 + cfg["y"] + cfg["n"] + (cfg["kind"] != "b")
                searcher.on_trial_complete(f"t{i}", {"loss": loss})
        return out

    got, want = suggestions(ttune), suggestions(jtune)
    assert got == want and got[-1] is None and len([c for c in got if c]) == 20


def _decisions(trial_cls, scheduler, results):
    """Feed `results` to the scheduler in order, as the controller does
    (on_result, then exploit); every trial holds a checkpoint by name."""
    trials = {}
    out = []
    for tid, config, result in results:
        trial = trials.setdefault(tid, trial_cls(trial_id=tid, config=dict(config),
                                                 checkpoint=f"ckpt-{tid}"))
        trial.results.append(result)
        decision = scheduler.on_result(trial, result, list(trials.values()))
        out.append((tid, decision, scheduler.exploit(trial, list(trials.values()))))
    return out


def _results():
    """A fixed sequence of (trial, config, result): eight trials of 16
    iterations, reporting round-robin, with losses spread by trial."""
    rng = np.random.RandomState(0)
    scale = rng.uniform(0.5, 2.0, 8)
    out = []
    for it in range(1, 17):
        for i in range(8):
            loss = float(scale[i] / it + 0.01 * rng.rand())
            out.append((f"t{i}", {"lr": 0.1 * (i + 1)},
                        {"loss": loss, "training_iteration": it}))
    return out


SCHEDULERS = {
    "fifo": lambda m: m.FIFOScheduler(),
    "asha": lambda m: m.AsyncHyperBandScheduler(metric="loss", mode="min", max_t=12,
                                                grace_period=2, reduction_factor=2),
    "median": lambda m: m.MedianStoppingRule(metric="loss", mode="min", grace_period=2,
                                             min_samples_required=3),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.01, 0.1, 1.0], "momentum": 0.9}, seed=0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_are_the_references(name):
    results = _results()
    got = _decisions(TTrial, SCHEDULERS[name](tsched), results)
    want = _decisions(JTrial, SCHEDULERS[name](jsched), results)
    assert got == want
    kinds = {d for _, d, _ in got}
    if name in ("asha", "median"):
        assert tsched.STOP in kinds  # the sequence exercises a stop
    if name == "pbt":
        assert any(e is not None for _, _, e in got)  # and an exploit


# ------------------------------------- a stopped trial stops (deliberate)

STOP_ITERS = 40


def stopped_trials(tune):
    """Four trials under ASHA, two of which plateau high and are stopped;
    each counts the iterations its trainable ran and holds a tensor whose
    life shows whether its frame is gone. -> ({idx: (stopped_early,
    results, iterations when fit() returned, iterations 1.5 s later,
    state alive when fit() returned)})."""
    counts, held = {}, {}

    def trainable(config):
        state = torch.ones(64)
        held[config["idx"]] = weakref.ref(state)
        for it in range(1, STOP_ITERS + 1):
            tune.report({"loss": 10.0 if config["idx"] % 2 else 1.0 / it,
                         "training_iteration": it})
            counts[config["idx"]] = it
            time.sleep(0.05)

    sched = tune.AsyncHyperBandScheduler(metric="loss", mode="min", max_t=STOP_ITERS,
                                         grace_period=2, reduction_factor=2)
    grid = tune.Tuner(trainable, param_space={"idx": tune.grid_search([0, 1, 2, 3])},
                      tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=sched,
                                                  max_concurrent_trials=4)).fit()
    at_fit = dict(counts)
    alive = {i: r() is not None for i, r in held.items()}
    deadline = time.monotonic() + STOP_ITERS * 0.05 + 1.5
    while time.monotonic() < deadline and any(counts[i] < STOP_ITERS for i in counts):
        time.sleep(0.05)
    return {t.config["idx"]: (t.stopped_early, len(t.results), at_fit[t.config["idx"]],
                              counts[t.config["idx"]], alive[t.config["idx"]])
            for t in grid.trials}


def test_a_stopped_trial_stops_training_where_the_references_trains_on():
    got, want = both(stopped_trials)
    stopped = sorted(i for i, row in got.items() if row[0])
    assert stopped and stopped == sorted(i for i, row in want.items() if row[0])
    assert all(i % 2 for i in stopped)  # the plateaued trials
    for i in stopped:
        early, reported, at_fit, later, alive = got[i]
        # the port: the trainable stopped at its next report after the stop,
        # ran no iteration after fit() returned, and its state was freed
        assert reported < STOP_ITERS and at_fit == later < STOP_ITERS
        assert at_fit <= reported + 8 and not alive
        # the reference: the killed trial's thread ran every iteration
        assert want[i][3] == STOP_ITERS and want[i][1] < STOP_ITERS


def test_a_stopped_session_raises_at_its_next_report():
    from ray_tpu_torch.train import session

    s = session._TrainSession(session.TrainContext(gang_name="t"))
    s.report({"a": 1})
    s.stop()
    with pytest.raises(session.SessionStopped):
        s.report({"a": 2})
    assert [r.metrics for r in s.drain()] == [{"a": 1}]
    assert not issubclass(session.SessionStopped, Exception)  # a user's except Exception


def test_gpu_shares_pack_trials_on_one_card():
    # "GPU" for the reference's "TPU" (resource accounting only: no tensor
    # here goes to a card): {"GPU": 0.25} packs four trials on one card
    def peak(share):
        lock, live, seen = threading.Lock(), [0], [0]

        def trainable(config):
            with lock:
                live[0] += 1
                seen[0] = max(seen[0], live[0])
            time.sleep(0.5)
            with lock:
                live[0] -= 1
            ttune.report({"loss": config["x"]})

        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=8, num_gpus=1, system_config=dict(THREAD_MODE))
        try:
            grid = within(WAIT_S, ttune.Tuner(
                trainable, param_space={"x": ttune.grid_search(list(range(4)))},
                tune_config=ttune.TuneConfig(max_concurrent_trials=4,
                                             resources_per_trial={"CPU": 1.0, "GPU": share})).fit)
        finally:
            ray_tpu_torch.shutdown()
        assert not grid.errors and len(grid) == 4
        return seen[0]

    assert peak(0.25) == 4


# ------------------------------------------- tiny-llama trials, both packages

LLAMA_STEPS = 4


def llama_trials(tune, jax_side):
    """Two trials (lr 1e-2 and 3e-3) of tiny-llama from the same numpy
    weights and batches: the reference's train.lm under jax, the port's
    with device="cpu". -> {lr: [loss per step]}."""
    import jax

    import ray_tpu.models as jmodels

    jcfg = jmodels.get_config("tiny-llama")
    host = jax.tree.map(np.asarray, jmodels.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(50)
    batches = []
    for _ in range(LLAMA_STEPS):
        toks = rng.randint(0, jcfg.vocab_size, (2, 25)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})

    def trainable(config):
        if jax_side:
            import jax.numpy as jnp

            from ray_tpu.train import lm as jlm

            opt = jlm.make_optimizer(config["lr"], warmup_steps=1, total_steps=10)
            params = jax.tree.map(jnp.asarray, host)
            state = {"step": jnp.zeros((), jnp.int32), "params": params,
                     "opt_state": opt.init(params)}
            step = jax.jit(jlm.make_train_step(jcfg, opt))
            feed = [jax.tree.map(jnp.asarray, b) for b in batches]
        else:
            from ray_tpu_torch import models, train

            opt = train.make_optimizer(config["lr"], warmup_steps=1, total_steps=10)
            cfg = models.get_config("tiny-llama")
            state = train.init_train_state(cfg, opt, device="cpu",
                                           params=models.params_from_numpy(host, device="cpu"))
            step = train.make_train_step(cfg, opt)
            feed = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
        for i, batch in enumerate(feed):
            state, m = step(state, batch)
            tune.report({"loss": float(m["loss"]), "training_iteration": i + 1})

    grid = tune.Tuner(trainable, param_space={"lr": tune.grid_search([1e-2, 3e-3])},
                      tune_config=tune.TuneConfig(metric="loss", mode="min",
                                                  max_concurrent_trials=2)).fit()
    assert not grid.errors, [t.error for t in grid.errors]
    return {t.config["lr"]: [r["loss"] for r in t.results] for t in grid.trials}


def test_tiny_llama_trials_match_the_references_losses():
    got = run("ray_tpu_torch", llama_trials, False)
    want = run("ray_tpu", llama_trials, True)
    assert sorted(got) == sorted(want) == [3e-3, 1e-2]
    for lr in got:
        assert len(got[lr]) == LLAMA_STEPS
        np.testing.assert_allclose(got[lr], want[lr], **LOSS_TOL, err_msg=f"lr {lr}")
    assert got[1e-2][0] == got[3e-3][0] and got[1e-2][-1] != got[3e-3][-1]  # the lr got through
