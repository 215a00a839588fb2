"""The port's single-host tooling against the reference's, on the CPU:
the log monitor (core/log_monitor.py), the state API (util/state.py), job
submission (job_submission.py), the core microbenchmarks
(microbenchmark.py) and the chaos harness (util/chaos.py) over the port's
wire (core/wire.py).

Each flow runs under both packages on the same inputs: tailing with
attribution, partial lines, history skipped, truncation, the pubsub
fan-out and the log inventory; the state rows and summary; a job's
status and logs, a stop, env vars and working_dir; every microbenchmark
pattern's row; a partition that drops or delays frames on the wire and
heals; SIGKILL of a process. The runtimes run in thread mode except where
a pool worker's stdout is what is read. `bench_cross_host` joins a worker
process to an RPC-serving head, in a process of its own per package. What
waits for ROADMAP A5c's third slice raises: `JobSubmissionClient(address=)`.
Every wait is bounded.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu.core.log_monitor as jlm
import ray_tpu.core.wire as jwire
import ray_tpu.job_submission as jjobs
import ray_tpu.microbenchmark as jmicro
import ray_tpu.util.chaos as jchaos
import ray_tpu.util.state as jstate
import ray_tpu_torch
import ray_tpu_torch.core.log_monitor as tlm
import ray_tpu_torch.core.wire as twire
import ray_tpu_torch.job_submission as tjobs
import ray_tpu_torch.microbenchmark as tmicro
import ray_tpu_torch.util.chaos as tchaos
import ray_tpu_torch.util.state as tstate
from _torch_fixtures import (  # noqa: F401
    _fresh_metric_registries,
    boot_forkserver,
    no_process_left,
)

WAIT_S = 30
PKGS = {"ray_tpu": dict(api=ray_tpu, lm=jlm, wire=jwire, jobs=jjobs, micro=jmicro,
                        chaos=jchaos, state=jstate, init=dict(num_tpus=0)),
        "ray_tpu_torch": dict(api=ray_tpu_torch, lm=tlm, wire=twire, jobs=tjobs, micro=tmicro,
                              chaos=tchaos, state=tstate, init=dict(num_gpus=0))}
both = pytest.mark.parametrize("pkg", list(PKGS))
THREAD_MODE = {"worker_processes": 0, "actor_processes": False, "get_concurrency": 1}


def _write(path, text, mode="a"):
    with open(path, mode) as f:
        f.write(text)


# ------------------------------------------------------------ log monitor


def _tail_flow(lm, d):
    """Every tailing case of tests/test_log_monitor.py, in one pass."""
    out = {}
    _write(os.path.join(d, "old-7.log"), "history\n")
    got = []
    mon = lm.LogMonitor(directory=d, sink=got.append)
    mon._offsets.update({n: os.path.getsize(p) for n, p in mon._files()})  # as start() does
    _write(os.path.join(d, "old-7.log"), "fresh\n")
    _write(os.path.join(d, "worker-123.out"), "a\nb\npart")
    _write(os.path.join(d, "notes.txt"), "ignored\n")
    out["first"] = mon.poll_once()
    _write(os.path.join(d, "worker-123.out"), "ial\n")
    out["second"] = mon.poll_once()
    _write(os.path.join(d, "worker-123.out"), "x\n", mode="w")  # truncated
    out["third"] = mon.poll_once()
    out["records"] = got
    out["inventory"] = sorted((r["file"], r["bytes"]) for r in lm.list_log_files(d))
    out["tail"] = lm.tail_log_file("old-7.log", n=1, directory=d)
    return out


def test_tailing_is_the_references(tmp_path):
    res = {}
    for pkg, m in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        res[pkg] = _tail_flow(m["lm"], str(d))
    assert res["ray_tpu_torch"] == res["ray_tpu"]
    assert [r["line"] for r in res["ray_tpu"]["records"]] == ["fresh", "a", "b", "partial", "x"]
    assert res["ray_tpu"]["records"][1]["pid"] == "123"


@both
def test_lines_fan_out_through_the_control_planes_pubsub(pkg, tmp_path):
    from importlib import import_module

    cp = import_module(f"{pkg}.core.control_plane").ControlPlane()
    got = []
    cp.pubsub.subscribe(PKGS[pkg]["lm"].LOG_CHANNEL, got.append)
    mon = PKGS[pkg]["lm"].LogMonitor(directory=str(tmp_path), sink=lambda r: None,
                                     pubsub=cp.pubsub, from_start=True)
    _write(str(tmp_path / "train-42.log"), "loss=0.5\n")
    assert mon.poll_once() == 1
    assert got == [{"file": "train-42.log", "pid": "42", "line": "loss=0.5"}]


@pytest.fixture(scope="module")
def procs_runtime(no_process_left):
    boot_forkserver()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, system_config={
        "worker_processes": 1, "actor_processes": True, "get_concurrency": 1})
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


def _chatty(tag):
    print(f"{tag} from the pool", flush=True)
    return os.getpid()


def test_a_pool_workers_print_reaches_the_monitor_with_its_pid(procs_runtime):
    seen = []
    mon = tlm.LogMonitor(sink=seen.append, poll_interval=0.05).start()
    try:
        pid = ray_tpu_torch.get(ray_tpu_torch.remote(_chatty).remote("hello"), timeout=WAIT_S)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not seen:
            time.sleep(0.05)
    finally:
        mon.stop()
    assert pid != os.getpid()
    assert {"file": f"worker-{pid}.out", "pid": str(pid), "line": "hello from the pool"} in seen


# ------------------------------------------------------------- state API


@pytest.fixture
def runtimes():
    for m in PKGS.values():
        m["api"].shutdown()
        m["api"].init(num_cpus=3, system_config=dict(THREAD_MODE), **m["init"])
    try:
        yield
    finally:
        for m in PKGS.values():
            m["api"].shutdown()


class Named:
    def ping(self):
        return "pong"


def _state_rows(m):
    api, state = m["api"], m["state"]
    a = api.remote(Named).options(name="tool").remote()
    api.get(a.ping.remote(), timeout=WAIT_S)
    ref = api.put(b"x" * 4096)
    nodes = state.list_nodes()
    actors = state.list_actors(filters=[("name", "=", "tool")])
    none = state.list_actors(filters=[("state", "!=", "ALIVE")])
    jobs = state.list_jobs()
    objects = state.list_objects()
    summary = state.summary()
    with pytest.raises(ValueError, match="filter op"):
        state.list_nodes(filters=[("state", "~", "x")])
    del ref
    return {
        "nodes": [(n["state"], n["resources_total"]) for n in nodes],
        "actors": [(r["class_name"], r["state"], r["name"], r["restarts"]) for r in actors],
        "none": none,
        "jobs": [j["state"] for j in jobs],
        "objects": len(objects) >= 1 and set(objects[0]) == {
            "object_id", "node_id", "size_bytes", "store", "pin_reason", "refcount", "locations",
            "age_s", "creator_task"},
        "summary": {k: summary[k] for k in ("nodes_alive", "nodes_total", "actors_by_state",
                                             "cluster_resources")},
        "utilization": sorted(next(iter(summary["utilization"].values()))),
    }


def test_state_rows_and_summary_are_the_references(runtimes):
    got, want = _state_rows(PKGS["ray_tpu_torch"]), _state_rows(PKGS["ray_tpu"])
    assert got == want
    assert got["actors"] == [("Named", "ALIVE", "tool", 0)]


@both
def test_the_metrics_endpoint_serves_the_registry(pkg):
    import urllib.request

    state = PKGS[pkg]["state"]
    port = state.start_metrics_server()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=WAIT_S) as r:
            assert r.status == 200 and r.headers["Content-Type"].startswith("text/plain")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=WAIT_S)
    finally:
        state.stop_metrics_server()


# ---------------------------------------------------------- job submission


def _jobs_flow(m, tmp_path):
    client = m["jobs"].JobSubmissionClient()
    ok = client.submit_job(entrypoint=f"{sys.executable} -c \"import os; "
                           "print(os.environ['JOB_TAG'], os.getcwd())\"",
                           runtime_env={"env_vars": {"JOB_TAG": "tagged"},
                                        "working_dir": str(tmp_path)},
                           submission_id=f"ok-{m['api'].__name__}")
    bad = client.submit_job(entrypoint="exit 3")
    slow = client.submit_job(entrypoint="sleep 20")
    out = {"ok": client.wait_until_finish(ok, timeout_s=WAIT_S),
           "bad": client.wait_until_finish(bad, timeout_s=WAIT_S)}
    out["logs"] = client.get_job_logs(ok).split()
    deadline = time.monotonic() + WAIT_S
    while client.get_job_status(slow) != "RUNNING" and time.monotonic() < deadline:
        time.sleep(0.05)
    out["stopped"] = client.stop_job(slow)
    out["slow"] = client.wait_until_finish(slow, timeout_s=WAIT_S)
    out["listed"] = sorted(j.get("entrypoint", "") for j in m["state"].list_jobs()
                           if j.get("entrypoint"))
    out["again"] = m["jobs"].JobSubmissionClient().get_job_status(ok)  # by name
    return out


def test_jobs_run_and_stop_as_in_the_reference(runtimes, tmp_path):
    got = _jobs_flow(PKGS["ray_tpu_torch"], tmp_path)
    want = _jobs_flow(PKGS["ray_tpu"], tmp_path)
    assert got == want
    assert got["ok"] == "SUCCEEDED" and got["bad"] == "FAILED" and got["slow"] == "STOPPED"
    assert got["logs"] == ["tagged", str(tmp_path)]


def test_an_entrypoint_is_a_driver_of_its_own(procs_runtime):
    # the supervisor runs in an actor process, which marks itself a pool
    # worker; its entrypoint does not inherit the mark
    client = tjobs.JobSubmissionClient()
    job = client.submit_job(entrypoint=f"{sys.executable} -c \"import os; "
                            "print(repr(os.environ.get('RAY_TPU_IN_POOL_WORKER')))\"")
    assert client.wait_until_finish(job, timeout_s=WAIT_S) == "SUCCEEDED"
    assert client.get_job_logs(job).strip() == "None"


def test_a_dashboard_address_waits_for_a5c():
    with pytest.raises(NotImplementedError, match="A5c"):
        tjobs.JobSubmissionClient(address="http://127.0.0.1:8265")


# --------------------------------------------------------- microbenchmarks


def test_every_pattern_reports_a_positive_rate(runtimes, monkeypatch, capsys):
    rows = {}
    for pkg, m in PKGS.items():
        # one short window a pattern, on the runtime this module started
        monkeypatch.setattr(m["api"], "init", lambda *a, **k: None)
        monkeypatch.setattr(m["micro"], "bench_cross_host", lambda api, min_seconds=2.0: [])
        rows[pkg] = m["micro"].run_all(min_seconds=0.05)
        assert all(r["value"] > 0 for r in rows[pkg]), rows[pkg]
        assert all(a.state.name == "DEAD" for a in m["api"].core.core_worker.get_runtime()
                   .control_plane.list_actors()), "a pattern left its actor alive"
    assert [(r["metric"], r["unit"]) for r in rows["ray_tpu_torch"]] == [
        (r["metric"], r["unit"]) for r in rows["ray_tpu"]]
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 2 * len(rows["ray_tpu"])


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_XHOST = """
import importlib, json, sys
name = sys.argv[1]
api = importlib.import_module(name)
micro = importlib.import_module(name + ".microbenchmark")
rows = micro.bench_cross_host(api, min_seconds=0.05)
api.shutdown()
print("ROWS", json.dumps(rows))
"""


def test_bench_cross_host_waits_for_a5c():
    # ported with the network slice (the name is kept from when it raised):
    # a joined worker process, in a process of its own per package, since
    # the bench restarts the runtime as an RPC-serving head
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_LOG_LEVEL="WARNING",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {pkg: subprocess.Popen([sys.executable, "-c", _XHOST, pkg], env=env, text=True,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pkg in ("ray_tpu", "ray_tpu_torch")}
    rows = {}
    for pkg, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=180)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        assert proc.returncode == 0 and "ROWS" in out, err[-3000:]
        rows[pkg] = json.loads(out.split("ROWS", 1)[1])
    assert [(m, u) for m, _, u in rows["ray_tpu_torch"]] == [(m, u) for m, _, u in rows["ray_tpu"]]
    assert [m for m, _, _ in rows["ray_tpu_torch"]] == [
        "xhost_task_roundtrip", "xhost_task_rtt_ms", "xhost_task_batch_64", "xhost_pull_mb_s"]
    assert all(v > 0 for _, v, _ in rows["ray_tpu_torch"])


# ------------------------------------------------------------------ chaos


@pytest.fixture
def wire_pair():
    lsock = socket.create_server(("127.0.0.1", 0))
    client = socket.create_connection(lsock.getsockname(), timeout=WAIT_S)
    server, _ = lsock.accept()
    server.settimeout(WAIT_S)
    try:
        yield client, server, f"127.0.0.1:{lsock.getsockname()[1]}"
    finally:
        for s in (client, server, lsock):
            s.close()


@both
def test_a_partition_drops_then_heals_on_the_wire(pkg, wire_pair):
    wire, chaos = PKGS[pkg]["wire"], PKGS[pkg]["chaos"]
    client, server, addr = wire_pair
    with chaos.partition():
        with pytest.raises(OSError, match="injected partition"):
            wire.send_msg(client, 1, {"x": 1})
    wire.send_msg(client, 1, {"x": 2})
    assert wire.recv_msg(server) == (1, {"x": 2})
    # scoped to the server's address: the client's frames fault both ways,
    # the server's (whose peer is the client's ephemeral port) pass
    with chaos.partition(addresses={addr}):
        with pytest.raises(OSError):
            wire.send_msg(client, 1, "dropped")
        wire.send_msg(server, 2, "through")
        with pytest.raises(OSError):
            wire.recv_msg(client)
    assert wire._fault_injector is None
    assert wire.recv_msg(client) == (2, "through")


@both
def test_a_delay_partition_slows_frames_and_heals_on_its_own(pkg, wire_pair):
    wire, chaos = PKGS[pkg]["wire"], PKGS[pkg]["chaos"]
    client, server, _addr = wire_pair
    with chaos.partition(mode="delay", delay_s=0.1, duration_s=0.3) as fault:
        t0 = time.monotonic()
        wire.send_msg(client, 1, "slow")
        assert time.monotonic() - t0 >= 0.1
        assert wire.recv_msg(server) == (1, "slow")
    assert fault.healed.is_set() and wire._fault_injector is None
    with pytest.raises(ValueError, match="partition mode"):
        with chaos.partition(mode="flood"):
            pass


@both
def test_kill_head_sigkills_and_reaps(pkg):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    assert PKGS[pkg]["chaos"].kill_head(proc, wait_s=WAIT_S) == proc.pid
    assert proc.returncode == -9
    assert PKGS[pkg]["chaos"].kill_worker_host(proc.pid) == proc.pid  # already gone


@both
def test_node_addresses_read_the_kv(pkg):
    from importlib import import_module

    cp = import_module(f"{pkg}.core.control_plane").ControlPlane()
    cp.kv_put("node_service/abcd", b"10.0.0.7:6399")
    cp.kv_put("object_transfer/abcd", "10.0.0.7:7000")
    assert PKGS[pkg]["chaos"].node_addresses(cp, "abcd") == {"10.0.0.7:6399", "10.0.0.7:7000"}
