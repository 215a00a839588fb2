"""The profiling plane (ray_tpu_torch/util/profiler.py and the node agent's
profile_start / profile_fetch) against the reference's, on the CPU.

The flows of tests/test_profiler.py that need no dashboard or CLI run under
both packages: live stack dumps, the sampling profiler and its collapsed
form, a subprocess dumped and profiled through its signal handlers, the
goodput ledger over the same inputs, the resource gauges, the auto stack
dump on a firing stall alert, and the health payload's and summary's
utilization. Then the port's own: `device_memory_snapshot` reads the CUDA
caching allocator and never starts CUDA (zeros here and in a pool worker,
which holds no /dev/nvidia* file); the node agent samples its process,
lists its children, dumps a hung pool worker by signal, captures a
torch.profiler trace for kind="torch" and refuses kind="jax". Every wait
is bounded.
"""

import os
import signal
import threading
import time

import pytest

import ray_tpu.core.health as jhealth
import ray_tpu.core.process_pool as jpp
import ray_tpu.util.flight_recorder as jfr
import ray_tpu.util.profiler as jprof
import ray_tpu_torch
import ray_tpu_torch.core.health as thealth
import ray_tpu_torch.core.process_pool as tpp
import ray_tpu_torch.util.flight_recorder as tfr
import ray_tpu_torch.util.profiler as tprof
from _torch_fixtures import (  # noqa: F401
    _fresh_metric_registries,
    boot_forkserver,
    no_process_left,
)

PKGS = {"ray_tpu": (jprof, jfr, jhealth, jpp), "ray_tpu_torch": (tprof, tfr, thealth, tpp)}
both = pytest.mark.parametrize("pkg", list(PKGS))
WAIT_S = 30


def _stuck_in_named_function(evt):
    evt.wait(WAIT_S)


def _busy_spin(stop):
    x = 0
    while not stop.is_set():
        x += 1
    return x


def _child_canary_loop():
    t0 = time.time()
    while time.time() - t0 < WAIT_S:
        time.sleep(0.005)


def _child_entry(prof_module, log_dir, ready_path):
    import importlib

    importlib.import_module(prof_module).install_child_handlers(log_dir)
    with open(ready_path, "w") as f:
        f.write(str(os.getpid()))
    _child_canary_loop()


def _hung_canary_fn(seconds):
    time.sleep(seconds)


def _hang_task(pid_path, seconds):
    with open(pid_path, "w") as f:
        f.write(str(os.getpid()))
    _hung_canary_fn(seconds)
    return os.getpid()


def _child_snapshot():
    fds = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            fds.append(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:
            pass
    return tprof.device_memory_snapshot(), [f for f in fds if f.startswith("/dev/nvidia")]


@both
def test_dump_names_stuck_thread(pkg):
    prof = PKGS[pkg][0]
    evt = threading.Event()
    t = threading.Thread(target=_stuck_in_named_function, args=(evt,), name="stuck-canary",
                         daemon=True)
    t.start()
    try:
        time.sleep(0.05)
        dump = prof.dump_stacks()
        by_name = {th["name"]: th for th in dump["threads"]}
        assert dump["pid"] == os.getpid() and "stuck-canary" in by_name
        assert "_stuck_in_named_function" in [fr["func"] for fr in by_name["stuck-canary"]["frames"]]
        text = prof.format_stacks(dump)
        assert "stuck-canary" in text and "_stuck_in_named_function" in text
    finally:
        evt.set()
        t.join(timeout=5)


@both
def test_sampler_and_process_singleton_catch_a_busy_function(pkg):
    prof = PKGS[pkg][0]
    stop = threading.Event()
    t = threading.Thread(target=_busy_spin, args=(stop,), daemon=True)
    t.start()
    try:
        p = prof.SamplingProfiler(hz=200.0)
        p.start(duration_s=10.0)
        time.sleep(0.3)
        collapsed = p.stop()
        assert p.sample_count > 5 and any("_busy_spin" in s for s in collapsed)
        out = prof.start_profile(duration_s=10.0, hz=200.0)
        assert out["running"] and out["pid"] == os.getpid()
        prof.start_profile(duration_s=10.0, hz=200.0)  # idempotent
        time.sleep(0.3)
        f = prof.fetch_profile(stop=True)
    finally:
        stop.set()
        t.join(timeout=5)
    assert f["samples"] > 0 and not f["running"]
    assert any("_busy_spin" in s for s in prof.parse_collapsed(f["collapsed"]))


def test_collapsed_algebra_is_the_references():
    text = "a;b 2\nc 1\n\na;b 1\nbroken line\n"
    assert tprof.parse_collapsed(text) == jprof.parse_collapsed(text) == {"a;b": 3, "c": 1}
    profiles = ({"a;b": 2}, {"a;b": 3, "c": 1}, {})
    assert tprof.merge_collapsed(*profiles) == jprof.merge_collapsed(*profiles)


@both
def test_dump_and_profile_a_live_subprocess(pkg, tmp_path):
    prof, _fr, _h, pp = PKGS[pkg]
    session = str(tmp_path / "session")
    log_dir = os.path.join(session, "logs")
    os.makedirs(log_dir)
    ready = str(tmp_path / "ready.txt")
    proc = pp._mp_context().Process(target=_child_entry, args=(prof.__name__, log_dir, ready),
                                    daemon=True)
    proc.start()
    try:
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not os.path.exists(ready):
            time.sleep(0.05)
        assert os.path.exists(ready), "the child never installed its handlers"
        time.sleep(0.1)
        assert "_child_canary_loop" in prof.dump_child(proc.pid, session, timeout_s=10.0)
        prof.toggle_child_profile(proc.pid)
        time.sleep(0.5)
        text = prof.read_child_profile(proc.pid, session, timeout_s=10.0)
        collapsed = prof.parse_collapsed(
            "\n".join(x for x in text.splitlines() if not x.startswith("#")))
        assert sum(collapsed.values()) > 0
        assert any("_child_canary_loop" in s for s in collapsed)
    finally:
        proc.terminate()
        proc.join(timeout=10)


LEDGER_CASES = [
    dict(wall_s=10.0, data_stall_s=2.0, channel_wait_s=1.0, bubble_fraction=0.1,
         migration_s=0.5),
    dict(wall_s=2.0, data_stall_s=6.0, channel_wait_s=4.0),  # overcommitted
    dict(wall_s=0.0),
]


@pytest.mark.parametrize("case", LEDGER_CASES, ids=["partition", "overcommit", "zero"])
def test_goodput_ledger_is_the_references(case):
    got, want = tprof.goodput_ledger(**case), jprof.goodput_ledger(**case)
    assert got == pytest.approx(want, abs=1e-12)
    assert sum(got[c] for c in tprof.LEDGER_COMPONENTS) == pytest.approx(got["wall_seconds"])
    assert tprof.LEDGER_COMPONENTS == jprof.LEDGER_COMPONENTS


def test_ledger_from_metric_families_is_the_references():
    fams = [
        {"name": "train_stage_step_seconds", "samples": [
            ("train_stage_step_seconds", [("stage", "0")], 4.0),
            ("train_stage_step_seconds", [("stage", "1")], 6.0)]},
        {"name": "data_stage_stall_seconds", "samples": [("data_stage_stall_seconds", [], 1.0)]},
        {"name": "channel_recv_wait_seconds", "samples": [
            ("channel_recv_wait_seconds_sum", [], 0.5),
            ("channel_recv_wait_seconds_count", [], 7.0)]},
        {"name": "train_pipeline_bubble_fraction", "samples": [
            ("train_pipeline_bubble_fraction", [], 0.2),
            ("train_pipeline_bubble_fraction", [], 0.4)]},
        {"name": "train_pipeline_bubble_seconds", "samples": [
            ("train_pipeline_bubble_seconds", [("kind", "warmup")], 0.7),
            ("train_pipeline_bubble_seconds", {"kind": "drain"}, 0.2)]},
        {"name": "serve_kv_migration_seconds", "samples": [
            ("serve_kv_migration_seconds_sum", [], 0.25)]},
    ]
    got, want = tprof.ledger_from_samples(fams), jprof.ledger_from_samples(fams)
    assert got == pytest.approx(want, abs=1e-12)
    assert got["wall_seconds"] == 6.0 and got["bubble_warmup"] == 0.7
    assert tprof.ledger_from_samples(fams, wall_s=8.0) == pytest.approx(
        jprof.ledger_from_samples(fams, wall_s=8.0))


@both
def test_update_resource_gauges(pkg):
    prof = PKGS[pkg][0]
    row = prof.update_resource_gauges()
    assert row["process_rss_bytes"] > 0 and 0.0 <= row["host_cpu_used_fraction"] <= 1.0
    from importlib import import_module

    registry = import_module(f"{pkg}.core.metrics").registry
    assert {"host_cpu_used_fraction", "process_rss_bytes"} <= {
        fam["name"] for fam in registry.snapshot()}


def test_device_memory_snapshot_never_starts_cuda():
    import torch

    assert not torch.cuda.is_initialized()
    snap = tprof.device_memory_snapshot()
    assert snap == {"pid": os.getpid(), "backend": None, "live_arrays": 0, "live_bytes": 0,
                    "devices": []}
    assert not torch.cuda.is_initialized()
    # the reference's shape: the same keys
    assert set(snap) == set(jprof.device_memory_snapshot())


def test_device_memory_snapshot_reads_the_caching_allocator(monkeypatch):
    # a process whose CUDA is up: the allocator's counters, per device
    import torch

    stats = {"allocated_bytes.all.current": 1 << 30, "allocated_bytes.all.peak": 3 << 30,
             "reserved_bytes.all.current": 2 << 30, "active.all.current": 7,
             "active_bytes.all.current": (1 << 30) + 512}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: dict(stats))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (5 << 30, 80 << 30))
    snap = tprof.device_memory_snapshot()
    assert snap["backend"] == "cuda"
    assert snap["devices"] == [{"device": "cuda:0", "bytes_in_use": 1 << 30,
                                "peak_bytes_in_use": 3 << 30, "bytes_reserved": 2 << 30,
                                "bytes_limit": 80 << 30}]
    assert snap["live_arrays"] == 7 and snap["live_bytes"] == (1 << 30) + 512


@both
def test_a_firing_stall_alert_dumps_the_stacks_into_the_postmortem_stream(pkg):
    prof, fr, health, _pp = PKGS[pkg]
    stall = {"v": 0.0}
    plane = health.HealthPlane(
        rules=[health.Rule("data_stall_rising", "delta(data_stage_stall_seconds) > 1.0 for 2",
                           group_by=("stage",))],
        metrics_fn=lambda: [("data_stage_stall_seconds", {"stage": "tokenize"}, stall["v"])],
        digests_fn=lambda: [], period_s=60.0)
    assert prof.install_auto_dump(plane) is True
    fr.drain_postmortems()
    for v in (0.0, 5.0, 10.0):
        stall["v"] = v
        active = plane.evaluate()
    assert any(a["rule"] == "data_stall_rising" for a in active)
    dumps = [a for a in fr.drain_postmortems() if a["cause"] == "auto_dump:data_stall_rising"]
    assert len(dumps) == 1 and dumps[0]["pid"] == os.getpid()
    assert dumps[0]["alert"]["labels"].get("stage") == "tokenize"
    assert any("Thread" in line for line in dumps[0]["stack_dump"])


@both
def test_auto_dump_respects_config_gate(pkg, monkeypatch):
    prof, _fr, health, _pp = PKGS[pkg]
    monkeypatch.setenv("RAY_TPU_PROFILER_AUTO_DUMP", "0")
    plane = health.HealthPlane(rules=[], metrics_fn=lambda: [], digests_fn=lambda: [],
                               period_s=60.0)
    assert prof.install_auto_dump(plane) is False


def test_health_payload_fills_utilization_and_goodput_as_the_reference():
    rows = {}
    for pkg, (_prof, _fr, health, _pp) in PKGS.items():
        plane = health.HealthPlane(rules=[], metrics_fn=lambda: [], digests_fn=lambda: [],
                                   period_s=60.0)
        payload = plane.payload()
        rows[pkg] = payload
        assert payload["utilization"]["head"]["rss_bytes"] > 0
        assert set(payload["goodput"]) >= {"wall_seconds", *tprof.LEDGER_COMPONENTS}
    assert set(rows["ray_tpu_torch"]["utilization"]["head"]) == set(
        rows["ray_tpu"]["utilization"]["head"])
    assert set(rows["ray_tpu_torch"]["goodput"]) == set(rows["ray_tpu"]["goodput"])


def test_get_health_plane_installs_the_auto_dump():
    plane = thealth.get_health_plane()
    try:
        assert len(plane._subs) == 1
    finally:
        thealth.shutdown_health_plane()


# ------------------------------------------------- the node agent's surface


@pytest.fixture(scope="module")
def runtime(no_process_left):
    boot_forkserver()
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=2, system_config={
        "worker_processes": 2, "actor_processes": True, "get_concurrency": 1})
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_summary_has_utilization(runtime):
    from ray_tpu_torch.util.state import summary

    util = summary()["utilization"]
    assert next(iter(util.values()))["rss_bytes"] > 0


def test_agent_samples_its_process_and_refuses_kind_jax(runtime):
    agent = runtime.driver_agent
    stop = threading.Event()
    t = threading.Thread(target=_busy_spin, args=(stop,), daemon=True)
    t.start()
    try:
        out = agent.profile_start(kind="cpu", duration_s=10.0, hz=200.0)
        assert out["kind"] == "cpu" and out["pid"] == os.getpid()
        time.sleep(0.3)
        got = agent.profile_fetch(kind="cpu")
    finally:
        stop.set()
        t.join(timeout=5)
    assert got["samples"] > 0 and "_busy_spin" in got["collapsed"]
    stack = agent.profile_fetch(kind="stack")
    assert stack["pid"] == os.getpid() and "MainThread" in stack["text"]
    with pytest.raises(ValueError, match="torch"):
        agent.profile_start(kind="jax")


def test_agent_captures_a_torch_trace(runtime, tmp_path):
    import json

    import torch

    agent = runtime.driver_agent
    out = agent.profile_start(kind="torch", duration_s=0.5, logdir=str(tmp_path))
    assert out == {"pid": os.getpid(), "kind": "torch", "logdir": str(tmp_path)}
    with pytest.raises(RuntimeError, match="already running"):
        agent.profile_start(kind="torch", duration_s=0.5, logdir=str(tmp_path))
    torch.ones(64).add_(1)
    got = agent.profile_fetch(kind="torch")
    assert not got["running"] and len(got["files"]) == 1
    with open(got["files"][0]) as f:
        assert "traceEvents" in json.load(f)


def test_a_hung_pool_worker_is_dumped_through_the_agent(runtime, tmp_path):
    agent = runtime.driver_agent
    pid_path = str(tmp_path / "hung_pid.txt")
    ref = ray_tpu_torch.remote(max_retries=0)(_hang_task).remote(pid_path, 60.0)
    deadline = time.monotonic() + WAIT_S
    pid = 0
    while time.monotonic() < deadline and not pid:
        try:
            with open(pid_path) as f:
                pid = int(f.read().strip() or 0)
        except (OSError, ValueError):
            time.sleep(0.05)
    assert pid and pid != os.getpid()
    assert pid in agent.profile_fetch(kind="pids")["pool"]
    time.sleep(0.2)
    try:
        out = agent.profile_fetch(pid=pid, kind="stack")
        assert out["pid"] == pid and "_hung_canary_fn" in out["text"]
        # and its sampler, toggled by signal, sees the same function
        agent.profile_start(pid=pid, kind="cpu")
        time.sleep(0.3)
        prof = agent.profile_fetch(pid=pid, kind="cpu")["collapsed"]
        assert "_hung_canary_fn" in prof
    finally:
        os.kill(pid, signal.SIGKILL)
    with pytest.raises(Exception, match="died"):
        ray_tpu_torch.get(ref, timeout=WAIT_S)
    # the killed worker left a postmortem with its last stack dump
    arts = [p for p in tfr.list_postmortems() if f"postmortem-{pid}-" in p]
    assert len(arts) == 1
    art = tfr.load_postmortem(arts[0])
    assert art["exitcode"] == -signal.SIGKILL
    assert any("_hung_canary_fn" in line for line in art["stack_dump"])


def test_a_pool_worker_reads_zeros_and_holds_no_device_file(runtime):
    snap, files = ray_tpu_torch.get(ray_tpu_torch.remote(_child_snapshot).remote(),
                                    timeout=WAIT_S)
    assert snap["pid"] != os.getpid()
    assert snap["backend"] is None and snap["devices"] == [] and snap["live_bytes"] == 0
    assert files == []
