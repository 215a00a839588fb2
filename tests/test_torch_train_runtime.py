"""The training gang (ray_tpu_torch.train: TorchTrainer, configs, session,
checkpoints) against ray_tpu.train's JaxTrainer, on the CPU.

Each flow of tests/test_train.py's TestTrainerFlow runs under both
packages in turn, each on its own runtime in thread mode, and the metrics
history, the error and what the gang resumed from must be the same.
Checkpoint IO is held tree against tree: the reference writes orbax
directories, the port its own format (manifest + one raw file per leaf),
and neither reads the other's. Then the port alone: bit-exact roundtrips
of every leaf kind, the asynchronous writer's snapshot, the frames a
failed attempt's error no longer keeps, and each deliberate
NotImplementedError.
"""

import gc
import os
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.train as jtrain
import ray_tpu_torch
import ray_tpu_torch.train as ttrain
from ray_tpu_torch.core import core_worker
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
PACKAGES = {"ray_tpu": (ray_tpu, jtrain, jtrain.JaxTrainer),
            "ray_tpu_torch": (ray_tpu_torch, ttrain, ttrain.TorchTrainer)}


def run(name, flow, tmp):
    api, train, trainer = PACKAGES[name]
    api.shutdown()
    api.init(num_cpus=8, system_config=dict(THREAD_MODE))
    try:
        return flow(train, trainer, os.path.join(tmp, name))
    finally:
        api.shutdown()


def both(flow, tmp):
    return run("ray_tpu_torch", flow, str(tmp)), run("ray_tpu", flow, str(tmp))


# ------------------------------------------------------------------ flows


def report_and_context(train, trainer, d):
    def train_func(config):
        ctx = train.get_context()
        for step in range(3):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size(), "local": ctx.get_local_rank()})

    result = trainer(train_func, scaling_config=train.ScalingConfig(num_workers=2),
                     run_config=train.RunConfig(name="t", storage_path=d)).fit()
    return result.error, result.metrics_history, result.metrics, result.checkpoint


def worker_exception(train, trainer, d):
    def train_func(config):
        raise ValueError("boom")

    result = trainer(train_func, run_config=train.RunConfig(name="f", storage_path=d)).fit()
    return (type(result.error).__name__, type(result.error.__cause__).__name__,
            type(result.error.__cause__.cause).__name__, "boom" in str(result.error),
            result.metrics_history)


def gang_restart(train, trainer, d):
    marker = os.path.join(d, "failed_once")

    def train_func(config):
        ckpt = train.get_checkpoint()
        start = 0 if ckpt is None else ckpt.get_metadata()["step"] + 1
        for step in range(start, 4):
            ckpt_dir = os.path.join(config["dir"], f"ck_{step}")
            os.makedirs(ckpt_dir, exist_ok=True)
            c = train.Checkpoint(ckpt_dir)
            c.set_metadata({"step": step})
            train.report({"step": step, "resumed": start > 0}, checkpoint=c)
            if step == 2 and not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("x")
                raise RuntimeError("injected failure")

    os.makedirs(d, exist_ok=True)
    result = trainer(train_func, train_loop_config={"dir": d},
                     run_config=train.RunConfig(
                         name="ft", storage_path=d,
                         failure_config=train.FailureConfig(max_failures=1),
                         checkpoint_config=train.CheckpointConfig(num_to_keep=2))).fit()
    return (result.error, result.metrics_history,
            os.path.basename(result.checkpoint.path),
            sorted(n for n in os.listdir(d) if n.startswith("ck_")))


def restarts_exhausted(train, trainer, d):
    def train_func(config):
        train.report({"attempt": 1})
        raise RuntimeError("always")

    result = trainer(train_func, run_config=train.RunConfig(
        name="x", storage_path=d, failure_config=train.FailureConfig(max_failures=2))).fit()
    return type(result.error).__name__, "3 attempt" in str(result.error), result.metrics_history


def dataset_shards(train, trainer, d):
    from importlib import import_module

    data = import_module(train.__name__.replace(".train", ".data"))

    def train_func(config):
        rows = [int(r["x"]) for r in train.get_dataset_shard("train").iter_rows()]
        train.report({"rank": train.get_context().get_world_rank(), "rows": rows,
                      "legacy": sorted(config["datasets"])})

    ds = data.from_numpy({"x": np.arange(30)}, parallelism=3)
    result = trainer(train_func, scaling_config=train.ScalingConfig(num_workers=2),
                     datasets={"train": ds},
                     run_config=train.RunConfig(name="d", storage_path=d)).fit()
    return result.error, result.metrics_history


def callbacks(train, trainer, d):
    seen, ends = [], []

    class OnReport:
        def on_report(self, metrics):
            seen.append(dict(metrics))

        def __call__(self, history):
            ends.append(len(history))

    def train_func(config):
        for i in range(3):
            train.report({"i": i, "acc": [0.2, 0.9, 0.5][i]},
                         checkpoint=train.Checkpoint(os.path.join(config["dir"], f"c{i}")))

    for i in range(3):
        os.makedirs(os.path.join(d, f"c{i}"), exist_ok=True)
    result = trainer(train_func, train_loop_config={"dir": d}, run_config=train.RunConfig(
        name="cb", storage_path=d, callbacks=[OnReport()],
        checkpoint_config=train.CheckpointConfig(
            num_to_keep=2, checkpoint_score_attribute="acc"))).fit()
    return seen, ends, os.path.basename(result.checkpoint.path), result.metrics


FLOWS = {f.__name__: f for f in (report_and_context, worker_exception, gang_restart,
                                 restarts_exhausted, dataset_shards, callbacks)}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_trainer_flow_matches_reference(flow, tmp_path):
    got, want = both(FLOWS[flow], tmp_path)
    assert got == want


def test_report_flow_shapes():
    # what the compared flows return, so that equal is not equally empty
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        err, history, last, ckpt = run("ray_tpu_torch", report_and_context, d)
        assert err is None and ckpt is None
        assert history == [{"step": s, "rank": 0, "world": 2, "local": 0} for s in range(3)]
        err, history, best, kept = run("ray_tpu_torch", gang_restart, d)
        # the second attempt resumed from step 2's checkpoint, not from zero
        assert err is None and [m["step"] for m in history] == [0, 1, 2, 3]
        assert [m["resumed"] for m in history] == [False] * 3 + [True]
        assert best == "ck_3" and kept == ["ck_2", "ck_3"]  # num_to_keep=2 removed the rest


# ------------------------------------------------------- checkpoint IO


def test_pytree_roundtrip_matches_reference(tmp_path):
    tree = {"a": np.arange(8.0, dtype=np.float32), "b": {"c": np.ones((4, 4), np.float32),
                                                         "i": np.arange(6, dtype=np.int32)}}
    jpath = jtrain.save_pytree(jax_tree(tree), str(tmp_path / "orbax"))
    jback = jtrain.load_pytree(jpath)
    tpath = ttrain.save_pytree({"a": torch.from_numpy(tree["a"]),
                                "b": {"c": torch.from_numpy(tree["b"]["c"]),
                                      "i": torch.from_numpy(tree["b"]["i"])}},
                               str(tmp_path / "port"))
    tback = ttrain.load_pytree(tpath, device="cpu")
    for key in (("a",), ("b", "c"), ("b", "i")):
        j, t = jback, tback
        for k in key:
            j, t = j[k], t[k]
        assert np.asarray(j).dtype == t.numpy().dtype
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert os.path.isfile(os.path.join(tpath, "manifest.json"))


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_manager_topk(tmp_path, pkg):
    train = PACKAGES[pkg][1]
    mgr = train.CheckpointManager(num_to_keep=2, score_attribute="acc")
    paths = []
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        p = tmp_path / f"ck{i}"
        p.mkdir()
        paths.append(str(p))
        mgr.register(train.Checkpoint(str(p)), {"acc": acc})
    assert {c.path for c in mgr.all()} == {paths[1], paths[2]}
    assert mgr.best.path == paths[1] and mgr.latest.path == paths[2]
    assert not os.path.exists(paths[0])  # the evicted checkpoint's directory went


def test_checkpoint_metadata_and_broadcast(tmp_path):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, system_config=dict(THREAD_MODE))
    try:
        src = tmp_path / "src"
        src.mkdir()
        (src / "w.bin").write_bytes(b"abc")
        c = ttrain.Checkpoint(str(src))
        c.set_metadata({"step": 7})
        ref = ttrain.broadcast_checkpoint(c, timeout=10)
        back = ttrain.restore_checkpoint(ref, str(tmp_path / "dst"))
        assert back.get_metadata() == {"step": 7}
        assert (tmp_path / "dst" / "w.bin").read_bytes() == b"abc"
        assert c.to_directory(str(tmp_path / "copy")) == str(tmp_path / "copy")
    finally:
        ray_tpu_torch.shutdown()


def leaves_equal(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(leaves_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(leaves_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    return type(a) is type(b) and (a == b or (a != a and b != b))


def every_leaf_kind():
    gen = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(5, 7, generator=gen).to(torch.bfloat16),
        "f32": torch.randn(3, 2, 4, generator=gen),
        "nan": torch.tensor([float("nan"), -0.0, float("inf")]),
        "i64": torch.randint(-2**40, 2**40, (6,), generator=gen),
        "i32": torch.arange(-3, 3, dtype=torch.int32),
        "u8": torch.arange(0, 255, 7, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar_tensor": torch.tensor(1.25, dtype=torch.float64),
        "empty": torch.zeros(0, 3),
        "strided": torch.arange(12.0).reshape(3, 4).t(),
        "np": np.arange(12, dtype=np.float16).reshape(3, 4),
        "np_i8": np.array([-1, 2], np.int8),
        "np0": np.array(3.5),
        "np_scalar": np.float32(2.75),
        "ints": [0, -5, 2**62],
        "floats": (0.1, float("inf"), float("nan")),
        "flags": [True, False],
        "none": None,
        "nested": {"opt": {"count": 3, "v": [None, torch.ones(2)]}},
    }


def test_port_roundtrip_is_bit_exact_for_every_leaf_kind(tmp_path):
    tree = every_leaf_kind()
    path = ttrain.save_pytree(tree, str(tmp_path / "ck"))
    back = ttrain.load_pytree(path, device="cpu", target=tree)
    assert leaves_equal(tree, back)
    assert back["strided"].is_contiguous()
    # force=False refuses to overwrite; force replaces
    with pytest.raises(FileExistsError):
        ttrain.save_pytree(tree, path, force=False)
    ttrain.save_pytree({"x": torch.ones(1)}, path)
    assert leaves_equal(ttrain.load_pytree(path, device="cpu"), {"x": torch.ones(1)})


def test_load_pytree_checks_the_target(tmp_path):
    path = ttrain.save_pytree({"a": torch.zeros(2, 3), "b": [1, 2]}, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="shape"):
        ttrain.load_pytree(path, device="cpu", target={"a": torch.zeros(3, 2), "b": [1, 2]})
    with pytest.raises(ValueError):
        ttrain.load_pytree(path, device="cpu", target={"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError):
        ttrain.load_pytree(path, device="cpu", target={"a": torch.zeros(2, 3), "b": [1]})
    assert ttrain.load_pytree(path, device="cpu", target={"a": np.zeros((2, 3)), "b": [0, 0]})


def sorted_tree(tree):
    """The tree with every dict's keys sorted, as jax.tree maps and
    jax.device_get return a dict."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()
    return np.asarray(tree)


def test_load_pytree_matches_the_target_by_key_and_dtype_as_the_reference_does(tmp_path):
    # C4: a target whose keys come in another order restores, in the
    # target's order and dtypes, in both packages
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(4, dtype=np.int32)
    jpath = jtrain.save_pytree({"a": jnp.asarray(a), "b": jnp.asarray(b)},
                               str(tmp_path / "orbax"))
    jback = jtrain.load_pytree(jpath, target={"b": jnp.zeros(4, jnp.int32),
                                              "a": jnp.zeros((2, 3), jnp.float16)})
    tpath = ttrain.save_pytree({"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                               str(tmp_path / "port"))
    tback = ttrain.load_pytree(tpath, device="cpu", target={
        "b": torch.zeros(4, dtype=torch.int32), "a": torch.zeros(2, 3, dtype=torch.float16)})
    # the port keeps the target's order; jax hands a dict back sorted
    assert list(tback) == ["b", "a"] and set(jback) == {"a", "b"}
    for k in ("a", "b"):
        assert np.asarray(jback[k]).dtype == tback[k].numpy().dtype
        np.testing.assert_array_equal(np.asarray(jback[k]), tback[k].numpy())
    with pytest.raises(ValueError, match=r"lacks the target's keys \['c'\].*lacks \['b'\]"):
        ttrain.load_pytree(tpath, device="cpu", target={"a": torch.zeros(2, 3),
                                                        "c": torch.zeros(4)})


def test_the_flagship_load_of_a_sorted_tree_into_init_params(tmp_path):
    # C4 as examples/pretrain_and_serve.py loads a checkpoint: a tiny-llama
    # tree saved with its keys sorted, restored with target=init_params(...)
    import jax

    import ray_tpu.models as jmodels
    import ray_tpu_torch.models as tmodels

    jcfg, tcfg = jmodels.get_config("tiny-llama"), tmodels.get_config("tiny-llama")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    jpath = jtrain.save_pytree(sorted_tree(jparams), str(tmp_path / "orbax"))
    jback = jtrain.load_pytree(jpath, target=jmodels.init_params(jcfg, jax.random.PRNGKey(1)))
    tparams = tmodels.params_from_numpy(host, device="cpu")
    tpath = ttrain.save_pytree(sorted_tree(tparams), str(tmp_path / "port"))
    template = tmodels.init_params(tcfg, seed=1, device="cpu")
    assert list(template) != sorted(template)  # the order the save did not keep
    tback = ttrain.load_pytree(tpath, device="cpu", target=template)
    assert list(tback) == list(template)
    got, want = as_numpy(tback), jax.tree.map(np.asarray, jback)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the target's dtype wins, in both packages
    half = ttrain.load_pytree(tpath, device="cpu", target={
        k: v.to(torch.float16) if k == "embed" else v for k, v in template.items()})
    jhalf = jtrain.load_pytree(jpath, target={
        k: v.astype(jnp.float16) if k == "embed" else v
        for k, v in jmodels.init_params(jcfg, jax.random.PRNGKey(1)).items()})
    assert half["embed"].dtype == torch.float16 and jhalf["embed"].dtype == jnp.float16
    np.testing.assert_array_equal(half["embed"].numpy(), np.asarray(jhalf["embed"]))


def test_a_numpy_bf16_leaf_comes_back_as_a_value(tmp_path):
    # C5: ml_dtypes' bfloat16 reads '<V2' to numpy; the reference round-trips
    # it through orbax, the port stores and returns it as a torch bf16 tensor
    # (a deliberate difference: the port imports no ml_dtypes)
    import ml_dtypes

    a = np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)
    jback = jtrain.load_pytree(jtrain.save_pytree({"w": a}, str(tmp_path / "orbax")))
    tback = ttrain.load_pytree(ttrain.save_pytree({"w": a}, str(tmp_path / "port")),
                               device="cpu")
    assert tback["w"].dtype == torch.bfloat16 and tback["w"].shape == (4,)
    np.testing.assert_array_equal(tback["w"].float().numpy(),
                                  np.asarray(jback["w"]).astype(np.float32))
    with pytest.raises(TypeError, match="no torch counterpart"):
        ttrain.save_pytree({"v": np.zeros(2, np.dtype("V3"))}, str(tmp_path / "void"))


def test_async_writer_snapshots_before_an_in_place_change(tmp_path):
    writer = ttrain.AsyncCheckpointWriter()
    params = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
              "n": np.arange(4.0)}
    want = {"w": params["w"].clone(), "n": params["n"].copy()}
    writer.save(params, str(tmp_path / "ck"))
    params["w"].add_(1.0)  # the next optimizer step, in place
    params["n"] += 1.0
    writer.wait()
    assert leaves_equal(ttrain.load_pytree(str(tmp_path / "ck"), device="cpu"), want)
    stats = writer.stats[-1]
    assert stats["bytes"] == 6 * 2 + 4 * 8 and stats["snapshot_s"] >= 0 and stats["write_s"] >= 0


def test_async_writer_surfaces_a_failed_write(tmp_path):
    writer = ttrain.AsyncCheckpointWriter()
    writer.save({"x": object()}, str(tmp_path / "ck"))
    with pytest.raises(TypeError, match="unsupported leaf"):
        writer.wait()
    assert not os.path.exists(tmp_path / "ck")
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_entry_points_need_a_card_unless_told_the_cpu(tmp_path):
    path = ttrain.save_pytree({"x": torch.ones(2)}, str(tmp_path / "ck"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.load_pytree(path)
    with pytest.raises(RuntimeError, match="use_gpu"):
        ttrain.TorchTrainer(lambda c: None,
                            scaling_config=ttrain.ScalingConfig(use_gpu=True)).fit()


def test_not_ported_yet_raises_naming_the_roadmap_item(tmp_path):
    path = ttrain.save_pytree({"x": torch.ones(2)}, str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError, match="A7b"):
        ttrain.load_pytree(path, device="cpu", shardings={"x": object()})
    with pytest.raises(NotImplementedError, match="A7b"):
        ttrain.ScalingConfig(mesh_shape={"dp": 2})
    with pytest.raises(NotImplementedError, match="A7b"):
        ttrain.ScalingConfig(topology=(2, 2))
    with pytest.raises(NotImplementedError, match="A7b"):
        ttrain.ScalingConfig(distributed_bootstrap=True)
    with pytest.raises(NotImplementedError, match="A5b"):
        ttrain.ScalingConfig(workers_in_process=False)
    from ray_tpu_torch.train.worker_group import TrainWorker

    with pytest.raises(NotImplementedError, match="A7b"):
        TrainWorker._cls(0, 1, "g").setup_distributed(1)
    for name in ("MLflowLoggerCallback", "WandbLoggerCallback"):  # ported since A8
        assert getattr(ttrain, name).__module__ == "ray_tpu_torch.train.integrations"
        assert getattr(ttrain, name).__name__ == getattr(jtrain, name).__name__
    with pytest.raises(NotImplementedError, match="A7b"):
        getattr(ttrain, "PipelineTrainer")
    assert ttrain.ScalingConfig(use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert jtrain.ScalingConfig(use_tpu=True).worker_resources() == {"CPU": 1.0, "TPU": 1.0}


# ----------------------------------- a failed attempt leaves nothing behind


class Held:
    """What a training loop holds (its state) and whether it is still alive
    after fit() returns, without a garbage collection."""

    def __init__(self):
        self.refs = []

    def loop(self, train):
        def train_func(config):
            state = torch.ones(256, 256)
            self.refs.append(weakref.ref(state))
            if train.get_checkpoint() is None:
                d = os.path.join(config["dir"], "c0")
                os.makedirs(d, exist_ok=True)
                train.report({"attempt": 0}, checkpoint=train.Checkpoint(d))
                raise RuntimeError("fail once")
            train.report({"attempt": 1})

        return train_func


def restart_leaves_no_state(tmp):
    held = Held()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, system_config=dict(THREAD_MODE))
    try:
        before = {t.name for t in threading.enumerate()}
        result = ttrain.TorchTrainer(
            held.loop(ttrain), train_loop_config={"dir": tmp},
            run_config=ttrain.RunConfig(storage_path=tmp, failure_config=ttrain.FailureConfig(
                max_failures=1))).fit()
        alive = [r() is not None for r in held.refs]
        left = {t.name for t in threading.enumerate()} - before
    finally:
        ray_tpu_torch.shutdown()
    return result, alive, left


def test_a_restart_frees_the_failed_attempts_state(tmp_path):
    result, alive, left = restart_leaves_no_state(str(tmp_path))
    assert result.error is None and [m["attempt"] for m in result.metrics_history] == [0, 1]
    assert alive == [False, False]
    assert not [n for n in left if n.startswith(("actor-", "data-host-prefetch"))], left


def test_a_restart_keeps_the_state_when_frames_are_not_released(tmp_path, monkeypatch):
    # the planted fault of the card's phase: the failed attempt's error keeps
    # its frames, and through them its state, until the runtime goes
    monkeypatch.setattr(core_worker, "release_frames", lambda error: None)
    result, alive, _ = restart_leaves_no_state(str(tmp_path))
    assert result.error is None and alive == [True, False]


def test_a_task_error_keeps_no_locals_where_the_reference_does():
    def make(api):
        held = []

        @api.remote
        def fails():
            big = torch.ones(64)
            held.append(weakref.ref(big))
            raise ValueError("x")

        return fails, held

    out = {}
    for name, api in (("ray_tpu", ray_tpu), ("ray_tpu_torch", ray_tpu_torch)):
        api.shutdown()
        api.init(num_cpus=2, system_config=dict(THREAD_MODE))
        try:
            fails, held = make(api)
            with pytest.raises(api.RayTaskError) as info:
                api.get(fails.remote(), timeout=30)
            err = info.value
            del info
            gc.collect()
            out[name] = (type(err.cause).__name__, held[0]() is not None,
                         "fails" in "".join(__import__("traceback").format_tb(
                             err.cause.__traceback__)))
            del err
        finally:
            api.shutdown()
    assert out == {"ray_tpu": ("ValueError", True, True),
                   "ray_tpu_torch": ("ValueError", False, True)}
