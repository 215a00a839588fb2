"""The flight recorder (ray_tpu_torch/util/flight_recorder.py) against the
reference's, on the CPU.

The same calls go to both packages, each over a session directory of its
own: events into the ring, `attach` (the tracing sink and the on-disk
mirror, rewritten from the ring past its byte cap), the log bridge, a
postmortem folding a dead worker's mirror, stdout tail and last stack dump,
its dedup by pid, the drain/requeue queue, an alert-triggered dump, and
listing and loading artifacts. The artifacts must agree field by field
(times and pids aside). A real SIGKILL'd pool worker's postmortem is
tests/test_torch_persistence.py's and test_torch_profiler.py's.
"""

import collections
import json
import os

import pytest

import ray_tpu.core.logging as jlogging
import ray_tpu.util.flight_recorder as jfr
import ray_tpu.util.tracing as jtracing
import ray_tpu_torch.core.logging as tlogging
import ray_tpu_torch.util.flight_recorder as tfr
import ray_tpu_torch.util.tracing as ttracing
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

PKGS = {"ray_tpu": (jfr, jtracing, jlogging), "ray_tpu_torch": (tfr, ttracing, tlogging)}
_STATE = ("_ring", "_mirror_path", "_mirror_file", "_mirror_bytes", "_mirror_cap", "_pending",
          "_reaped")


@pytest.fixture
def sessions(tmp_path):
    """A session directory per package; each module's globals restored after."""
    saved = {}
    for name, (fr, tr, _lg) in PKGS.items():
        saved[name] = ({k: getattr(fr, k) for k in _STATE}, tr._flight_sink)
        fr._ring = collections.deque(maxlen=256)
        fr._pending, fr._reaped = [], set()
        for sub in ("logs", "flight"):
            os.makedirs(tmp_path / name / sub)
    yield {name: str(tmp_path / name) for name in PKGS}
    for name, (fr, tr, _lg) in PKGS.items():
        if fr._mirror_file is not None:
            fr._mirror_file.close()
        state, sink = saved[name]
        for k, v in state.items():
            setattr(fr, k, v)
        tr._flight_sink = sink


def _strip(entry):
    return {k: v for k, v in entry.items() if k not in ("ts", "pid", "written_at")}


def test_ring_records_and_snapshots_alike(sessions):
    out = {}
    for name, (fr, _tr, _lg) in PKGS.items():
        fr.record("boot", stage="init", n=3)
        fr.on_log("a log line")
        out[name] = [_strip(e) for e in fr.snapshot()]
    assert out["ray_tpu_torch"] == out["ray_tpu"] == [
        {"kind": "boot", "stage": "init", "n": 3}, {"kind": "log", "line": "a log line"}]


def test_attach_mirrors_spans_and_events_to_disk(sessions, monkeypatch):
    monkeypatch.setenv("RAY_TPU_FLIGHT_RECORDER_ENTRIES", "8")
    lines = {}
    for name, (fr, tr, _lg) in PKGS.items():
        fr.attach(os.path.join(sessions[name], "logs"), "worker")
        assert tr._flight_sink is not None
        assert fr._ring.maxlen == 8
        with tr.start_span("step", {"i": 1}):
            pass
        fr.record("custom", value=7)
        with open(fr.mirror_path_for(os.getpid(), sessions[name])) as f:
            lines[name] = [_strip(json.loads(x)) for x in f]
    for entries in lines.values():
        for e in entries:
            if e["kind"] == "span":
                for k in ("trace_id", "span_id", "start_us", "end_us"):
                    e.pop(k)
    assert lines["ray_tpu_torch"] == lines["ray_tpu"]
    assert [e["kind"] for e in lines["ray_tpu"]] == ["attach", "span", "custom"]


def test_the_mirror_is_rewritten_from_the_ring_past_its_cap(sessions, monkeypatch):
    monkeypatch.setenv("RAY_TPU_FLIGHT_RECORDER_ENTRIES", "4")
    monkeypatch.setenv("RAY_TPU_FLIGHT_RECORDER_BYTES", "600")
    out = {}
    for name, (fr, _tr, _lg) in PKGS.items():
        fr.attach(os.path.join(sessions[name], "logs"), "worker")
        for i in range(12):
            fr.record("tick", i=i, pad="x" * 40)
        path = fr.mirror_path_for(os.getpid(), sessions[name])
        with open(path) as f:
            out[name] = [_strip(json.loads(x)) for x in f]
        assert os.path.getsize(path) <= 600
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu"][-1]["i"] == 11


def test_a_log_line_reaches_the_ring_through_the_logger(sessions):
    out = {}
    for name, (fr, _tr, lg) in PKGS.items():
        lg.get_logger("flight_test", to_file=False).warning("bridged %d", 42)
        out[name] = [e for e in fr.snapshot() if e["kind"] == "log"]
    for entries in out.values():
        assert len(entries) == 1 and entries[0]["line"].endswith("bridged 42")


def _dead_worker(session, pid):
    """What a dead pool worker leaves: its mirror, stdout and stack file."""
    with open(os.path.join(session, "flight", f"flight-{pid}.jsonl"), "w") as f:
        for e in ({"ts": 1.0, "pid": pid, "kind": "attach", "component": "worker"},
                  {"ts": 2.0, "pid": pid, "kind": "span", "name": "execute:f"},
                  {"ts": 3.0, "pid": pid, "kind": "log", "line": "about to crash"}):
            f.write(json.dumps(e) + "\n")
        f.write("{not json\n")
    with open(os.path.join(session, "logs", f"worker-{pid}.out"), "w") as f:
        f.write("".join(f"stdout {i}\n" for i in range(60)))
    with open(os.path.join(session, "flight", f"stack-{pid}.txt"), "w") as f:
        f.write('Thread 0x1 (most recent call first):\n  File "w.py", line 3 in spin\n')


def test_a_postmortem_folds_the_dead_workers_records(sessions):
    arts = {}
    for name, (fr, _tr, _lg) in PKGS.items():
        _dead_worker(sessions[name], 4242)
        path = fr.write_postmortem(4242, "worker process died while running task",
                                   exitcode=-9, session=sessions[name], stdout_hint="worker")
        assert path and os.path.basename(path).startswith("postmortem-4242-")
        # crash detection may fire from two threads: the second is a no-op
        assert fr.write_postmortem(4242, "again", session=sessions[name]) is None
        assert fr.list_postmortems(sessions[name]) == [path]
        arts[name] = _strip(fr.load_postmortem(path))
        drained = fr.drain_postmortems()
        assert len(drained) == 1 and fr.drain_postmortems() == []
        fr.requeue_postmortems(drained)
        assert len(fr.drain_postmortems()) == 1
    assert arts["ray_tpu_torch"] == arts["ray_tpu"]
    art = arts["ray_tpu"]
    assert art["exitcode"] == -9 and len(art["stdout_tail"]) == 50
    assert [e["kind"] for e in art["events"]] == ["attach"] and art["logs"] == ["about to crash"]
    assert any("spin" in line for line in art["stack_dump"])


def test_an_alert_dump_rides_the_postmortem_stream(sessions):
    alert = {"rule": "heartbeat_gap", "state": "firing", "labels": {"node": "n1"},
             "value": 9.0, "node": "n1", "extra": "dropped"}
    arts = {}
    for name, (fr, _tr, _lg) in PKGS.items():
        path = fr.write_auto_dump(alert, "Thread A:\n  frame\n", session=sessions[name])
        assert os.path.basename(path).startswith(f"autodump-{os.getpid()}-")
        arts[name] = _strip(fr.load_postmortem(path))
        assert [a["cause"] for a in fr.drain_postmortems()] == ["auto_dump:heartbeat_gap"]
    assert arts["ray_tpu_torch"] == arts["ray_tpu"]
    assert "extra" not in arts["ray_tpu"]["alert"]
