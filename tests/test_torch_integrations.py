"""The trainer's logger callbacks (ray_tpu_torch.train.integrations) against
ray_tpu.train's, on the CPU.

The three flows of tests/test_integrations.py run under both packages in
turn: the local-fallback run layout (neither wandb nor mlflow is installed
on either machine), the end-only protocol's backfill, and the trainer's
wiring (on_report per rank-0 report, the history at the end). Each flow
writes its run directory under the package's own tmp directory, and the two
layouts must be equal file for file, with the wall-clock `_timestamp` of
each history record set aside.
"""

import json
import os

import pytest

import ray_tpu
import ray_tpu.train as jtrain
import ray_tpu_torch
import ray_tpu_torch.train as ttrain
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}


def layout(root):
    """{relative path: content} of every file under root, JSON parsed and
    history records without their timestamps."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                if name.endswith(".jsonl"):
                    recs = [json.loads(ln) for ln in f]
                    assert all(isinstance(r.pop("_timestamp"), float) for r in recs)
                    out[rel] = recs
                else:
                    out[rel] = json.load(f)
    return out


def wandb_fallback(train, d):
    cb = train.WandbLoggerCallback(project="proj", name="runA", dir=d, config={"lr": 0.1})
    cb.on_report({"loss": 1.0})
    cb.on_report({"loss": 0.5})
    cb([{"loss": 1.0}, {"loss": 0.5}])
    return cb._mode


def end_only_backfill(train, d):
    cb = train.MLflowLoggerCallback(experiment_name="exp", name="runB", dir=d)
    cb([{"a": 1}, {"a": 2}, {"a": 3}])
    return cb._mode


def trainer_wiring(train, d):
    streamed = []

    class Probe:
        def on_report(self, metrics):
            streamed.append(dict(metrics))

        def __call__(self, history):
            streamed.append({"END": len(history)})

    def loop(config):
        for i in range(3):
            train.report({"step": i, "loss": 1.0 / (i + 1)})

    trainer = getattr(train, "TorchTrainer", None) or train.JaxTrainer
    result = trainer(
        loop, scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            callbacks=[Probe(), train.WandbLoggerCallback(project="p", name="runC", dir=d)],
            storage_path=os.path.join(d, "..", "store"))).fit()
    assert result.error is None
    return streamed


FLOWS = {f.__name__: f for f in (wandb_fallback, end_only_backfill, trainer_wiring)}


def run(name, flow, d):
    api, train = {"ray_tpu": (ray_tpu, jtrain), "ray_tpu_torch": (ray_tpu_torch, ttrain)}[name]
    os.makedirs(d)
    api.shutdown()
    if flow is trainer_wiring:
        api.init(num_cpus=4, system_config=dict(THREAD_MODE))
    try:
        return flow(train, d), layout(d)
    finally:
        api.shutdown()


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_integration_flow_matches_reference(flow, tmp_path):
    got = run("ray_tpu_torch", FLOWS[flow], str(tmp_path / "port" / "runs"))
    want = run("ray_tpu", FLOWS[flow], str(tmp_path / "ref" / "runs"))
    assert got == want


def test_flow_layouts_are_the_reference_tests_asserts(tmp_path):
    mode, files = run("ray_tpu_torch", wandb_fallback, str(tmp_path / "a"))
    assert mode == "local" and sorted(files) == ["runA/config.json", "runA/history.jsonl",
                                                 "runA/summary.json"]
    assert files["runA/config.json"] == {"lr": 0.1}
    assert [(r["_step"], r["loss"]) for r in files["runA/history.jsonl"]] == [(0, 1.0), (1, 0.5)]
    assert files["runA/summary.json"] == {"loss": 0.5, "_num_reports": 2}
    _, files = run("ray_tpu_torch", end_only_backfill, str(tmp_path / "b"))
    assert [r["a"] for r in files["runB/history.jsonl"]] == [1, 2, 3]
    streamed, files = run("ray_tpu_torch", trainer_wiring, str(tmp_path / "c"))
    assert streamed == [{"step": 0, "loss": 1.0}, {"step": 1, "loss": 0.5},
                        {"step": 2, "loss": 1.0 / 3}, {"END": 3}]
    assert len(files["runC/history.jsonl"]) == 3  # streamed, not backfilled twice


def test_the_callbacks_are_exported_as_the_references():
    from ray_tpu_torch.train import integrations

    assert ttrain.MLflowLoggerCallback is integrations.MLflowLoggerCallback
    assert ttrain.WandbLoggerCallback is integrations.WandbLoggerCallback
    assert {n for n in vars(integrations) if not n.startswith("_")} == {
        n for n in vars(jtrain.integrations) if not n.startswith("_")}
