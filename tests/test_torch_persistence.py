"""Control-plane persistence (ray_tpu_torch/core/persistence.py,
`init(resume_from=)` and `control_plane_snapshot_path`) against the
reference's, on the CPU.

The flows of tests/test_persistence.py run under both packages: KV, the
jobs table (RUNNING becomes FAILED) and named actors (re-created from their
creation specs, placement-group strategies stripped) survive a restart;
snapshot writes are atomic; the interval writer writes while the runtime
lives and once more at shutdown. Then a driver process of the port killed
with SIGKILL mid-training resumes: its snapshot names the latest
checkpoint, and TorchTrainer continues from it. Every wait is bounded.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu.core.persistence as jpersist
import ray_tpu_torch
import ray_tpu_torch.core.persistence as tpersist
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ray_tpu": (ray_tpu, jpersist, {"num_tpus": 0, "system_config": {"worker_processes": 0}}),
        "ray_tpu_torch": (ray_tpu_torch, tpersist, {"num_gpus": 0, "system_config": {
            "worker_processes": 0, "actor_processes": False}})}
WAIT_S = 30


class Broker:
    def __init__(self, tag):
        self.tag = tag

    def get_tag(self):
        return self.tag


@pytest.fixture
def clean():
    for api, _p, _kw in PKGS.values():
        api.shutdown()
    yield
    for api, _p, _kw in PKGS.values():
        api.shutdown()


def _init(pkg, **extra):
    api, _p, kw = PKGS[pkg]
    sc = dict(kw["system_config"], **extra.pop("system_config", {}))
    return api.init(num_cpus=2, **{k: v for k, v in kw.items() if k != "system_config"},
                    system_config=sc, **extra)


def _flow(pkg, snap_path):
    api, persist, _kw = PKGS[pkg]
    rt = _init(pkg, system_config={"control_plane_snapshot_path": snap_path,
                                   "control_plane_snapshot_interval_s": 60.0})
    rt.control_plane.kv_put("app/latest", b"ckpt-0007")
    cls = api.remote(Broker)
    cls.options(name="broker").remote("v1")
    cls.remote("anonymous")  # anonymous actors are not restored
    assert api.get(api.get_actor("broker").get_tag.remote(), timeout=WAIT_S) == "v1"
    persist.write_snapshot(rt, snap_path)
    snap = persist.load_snapshot(snap_path)
    api.shutdown()
    rt2 = _init(pkg, resume_from=snap_path)
    out = {
        "kv": rt2.control_plane.kv_get("app/latest"),
        "tag": api.get(api.get_actor("broker").get_tag.remote(), timeout=WAIT_S),
        "failed": sorted(m.get("death_cause", "") for m in rt2.control_plane.list_jobs().values()
                         if m.get("state") == "FAILED"),
        "actors": sorted(a.class_name for a in rt2.control_plane.list_actors()),
        "named": sorted(snap["named_actors"]),
        "keys": sorted(snap),
    }
    api.shutdown()
    return out


def test_kv_jobs_and_named_actors_survive_a_restart(clean, tmp_path):
    got = _flow("ray_tpu_torch", str(tmp_path / "t.snap"))
    want = _flow("ray_tpu", str(tmp_path / "j.snap"))
    assert got == want
    assert got["kv"] == b"ckpt-0007" and got["tag"] == "v1" and got["named"] == ["broker"]
    assert got["actors"] == ["Broker"]
    assert got["failed"] == ["runtime died (restored from snapshot)"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_snapshot_write_is_atomic(clean, tmp_path, pkg):
    _api, persist, _kw = PKGS[pkg]
    snap_path = str(tmp_path / "cp.snap")
    rt = _init(pkg)
    rt.control_plane.kv_put("k", b"v1")
    persist.write_snapshot(rt, snap_path)
    first = persist.load_snapshot(snap_path)
    rt.control_plane.kv_put("k", b"v2")
    persist.write_snapshot(rt, snap_path)
    second = persist.load_snapshot(snap_path)
    assert first["kv"]["k"] == b"v1" and second["kv"]["k"] == b"v2"
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    with open(snap_path, "wb") as f:
        import cloudpickle

        f.write(cloudpickle.dumps({"version": 99}))
    with pytest.raises(ValueError, match="snapshot version"):
        persist.load_snapshot(snap_path)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_the_interval_writer_snapshots_and_writes_once_more_at_shutdown(clean, tmp_path, pkg):
    api, persist, _kw = PKGS[pkg]
    snap_path = str(tmp_path / "cp.snap")
    rt = _init(pkg, system_config={"control_plane_snapshot_path": snap_path,
                                   "control_plane_snapshot_interval_s": 0.1})
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(snap_path) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert os.path.exists(snap_path)
    rt.control_plane.kv_put("late", b"written at shutdown")
    rt._snapshot_writer._interval = 3600.0  # no interval write from here
    api.shutdown()
    assert persist.load_snapshot(snap_path)["kv"]["late"] == b"written at shutdown"


def test_a_placement_group_strategy_is_stripped_on_restore(clean, tmp_path):
    from ray_tpu_torch.core.task_spec import (PlacementGroupSchedulingStrategy,
                                              SchedulingStrategy)
    from ray_tpu_torch.sched import placement_group

    snap_path = str(tmp_path / "cp.snap")
    rt = _init("ray_tpu_torch")
    pg = placement_group([{"CPU": 1}])
    assert pg.ready(timeout=WAIT_S)
    strategy = PlacementGroupSchedulingStrategy(placement_group_id=pg.id, bundle_index=0)
    h = ray_tpu_torch.remote(Broker).options(name="pinned",
                                             scheduling_strategy=strategy).remote("pg")
    assert ray_tpu_torch.get(h.get_tag.remote(), timeout=WAIT_S) == "pg"
    tpersist.write_snapshot(rt, snap_path)
    ray_tpu_torch.shutdown()
    rt2 = _init("ray_tpu_torch", resume_from=snap_path)
    again = ray_tpu_torch.get_actor("pinned")
    assert ray_tpu_torch.get(again.get_tag.remote(), timeout=WAIT_S) == "pg"
    spec = rt2._actor_specs[again._actor_id]
    assert type(spec.options.scheduling_strategy) is SchedulingStrategy


_VICTIM = """
import os, sys, time
sys.path.insert(0, {repo!r})
import ray_tpu_torch
from ray_tpu_torch.train import RunConfig, TorchTrainer

snap, workdir = {snap!r}, {workdir!r}
ray_tpu_torch.init(num_cpus=2, num_gpus=0, system_config={{
    "control_plane_snapshot_path": snap, "control_plane_snapshot_interval_s": 0.2,
    "worker_processes": 0, "actor_processes": False}})

def train_func(config):
    from ray_tpu_torch import api, train
    ckpt = train.get_checkpoint()
    start = 0 if ckpt is None else ckpt.get_metadata()["step"] + 1
    for step in range(start, 100):
        d = os.path.join(config["dir"], f"ck_{{step}}")
        os.makedirs(d, exist_ok=True)
        c = train.Checkpoint(d)
        c.set_metadata({{"step": step}})
        # the latest checkpoint, recorded in the durable metadata plane
        api._auto_init().control_plane.kv_put("train/latest_ckpt", d.encode())
        train.report({{"step": step}}, checkpoint=c)
        with open(os.path.join(config["dir"], "progress"), "w") as f:
            f.write(str(step))
        time.sleep(0.25)

TorchTrainer(train_func, train_loop_config={{"dir": workdir}},
             run_config=RunConfig(name="chaos", storage_path=workdir)).fit()
"""


def test_a_sigkilled_driver_resumes_from_its_snapshot(clean, tmp_path):
    snap = str(tmp_path / "cp.snap")
    workdir = str(tmp_path / "work")
    os.makedirs(workdir)
    script = tmp_path / "victim.py"
    script.write_text(_VICTIM.format(repo=REPO, snap=snap, workdir=workdir))
    proc = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    progress = os.path.join(workdir, "progress")
    deadline = time.monotonic() + WAIT_S
    try:
        while time.monotonic() < deadline:
            if os.path.exists(progress) and int(open(progress).read() or 0) >= 2:
                break
            assert proc.poll() is None, f"the victim exited early, rc {proc.returncode}"
            time.sleep(0.1)
        else:
            raise AssertionError("the victim never reached step 2")
        time.sleep(0.6)  # a snapshot lands after the KV write
        proc.send_signal(signal.SIGKILL)  # the runtime dies, no cleanup
        proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    rt = _init("ray_tpu_torch", resume_from=snap)
    latest = rt.control_plane.kv_get("train/latest_ckpt")
    assert latest, "the latest checkpoint's path was lost"
    from ray_tpu_torch.train import Checkpoint, RunConfig, TorchTrainer

    ckpt = Checkpoint(latest.decode())
    resumed_start = ckpt.get_metadata()["step"] + 1
    assert resumed_start >= 2

    def train_func(config):
        from ray_tpu_torch import train

        c = train.get_checkpoint()
        start = 0 if c is None else c.get_metadata()["step"] + 1
        for step in range(start, start + 2):
            train.report({"step": step, "resumed_from": start})

    result = TorchTrainer(train_func, run_config=RunConfig(name="resumed",
                                                           storage_path=str(tmp_path)),
                          resume_from_checkpoint=ckpt).fit()
    assert result.error is None
    assert result.metrics_history[0]["resumed_from"] == resumed_start
    assert any(m.get("state") == "FAILED" for m in rt.control_plane.list_jobs().values())
