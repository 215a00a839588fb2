"""The control plane over RPC (ray_tpu_torch/core/rpc.py) against the
reference's (ray_tpu/core/rpc.py), on the CPU.

Each flow of tests/test_rpc.py runs under both packages and the two
results must be equal: the full served surface over the wire, an unknown
method refused, a server exception crossing the wire, a pubsub event
pushed to the client, a child process driving the parent's control plane,
and the reconnect cases (an idempotent call riding out a head restart, a
non-idempotent one raising and not applied twice, a deadline bounding the
downtime, a subscription surviving a restart onto a fresh authority, no
reply-id crosstalk across connections, three kill/restart cycles leaking
no thread or fd, a delay partition, and a subscribe made while the head is
down). Then the registries (idempotent within allowed, here and in
core/shard.py), `shard_for_key` equal to the reference's for the same
keys, and the port's rule that a tensor off the CPU crosses the wire as a
CPU copy (`object_transfer.host_dumps`; `meta` stands in for CUDA here,
the card test is in tests/test_torch_kernels.py). Every wait is bounded.
"""

import importlib
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(name=name, cp=mod("core.control_plane"), ids=mod("core.ids"),
                           rpc=mod("core.rpc"), shard=mod("core.shard"), chaos=mod("util.chaos"))


PKGS = {name: _pkg(name) for name in ("ray_tpu", "ray_tpu_torch")}


class Served:
    """One package's ControlPlane served on an ephemeral port; restart()
    re-serves an authority on the same port, as a restarted head would."""

    def __init__(self, p):
        self.p = p
        self.cp = p.cp.ControlPlane()
        self.server = p.rpc.serve_control_plane(self.cp)
        self.port = self.server.server_address[1]
        self.servers = [self.server]

    def client(self):
        return self.p.rpc.RemoteControlPlane(self.server.address)

    def restart(self, cp=None):
        cp = cp or self.cp
        deadline = time.monotonic() + 10
        while True:
            try:
                self.server = self.p.rpc.serve_control_plane(cp, port=self.port)
                self.servers.append(self.server)
                return self.server
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    def close(self):
        for s in self.servers:
            s.stop()


def _wait_reconnected(client, count=1, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with client._conn_cv:
            if client.reconnect_count >= count and client._conn is not None:
                return True
        time.sleep(0.02)
    return False


def both(flow):
    out = {}
    for name, p in PKGS.items():
        served = Served(p)
        try:
            out[name] = flow(p, served)
        finally:
            served.close()
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu_torch"]


# ------------------------------------------------------------ in process


def full_surface_over_the_wire(p, s):
    client = s.client()
    try:
        nid = p.ids.NodeID.generate()
        client.register_node(p.cp.NodeInfo(node_id=nid, address="h1:1",
                                           resources_total={"CPU": 4.0}))
        landed = s.cp.get_node(nid) is not None
        client.heartbeat(nid, {"CPU": 2.0})
        avail = client.get_node(nid).resources_available
        kv = (client.kv_put("a/b", b"v"), client.kv_get("a/b"), client.kv_keys("a/"))
        aid = p.ids.ActorID.of(p.ids.JobID.next())
        client.register_actor(p.cp.ActorInfo(actor_id=aid, name="worker-0"))
        client.update_actor(aid, p.cp.ActorState.ALIVE, nid)
        actor = (client.get_actor(aid).state.name, client.get_named_actor("worker-0").actor_id == aid)
        jid = p.ids.JobID.next()
        client.register_job(jid, {"entrypoint": "x"})
        client.finish_job(jid, "SUCCEEDED")
        return {"landed": landed, "avail": avail, "kv": kv, "actor": actor,
                "job": client.list_jobs()[jid]["state"]}
    finally:
        client.close()


def unknown_method_and_server_exception(p, s):
    client = s.client()
    try:
        out = {}
        try:
            client.shutdown_everything()
        except AttributeError:
            out["unknown"] = "AttributeError"
        try:
            client.kv_put()  # missing args: the TypeError crosses the wire
        except TypeError:
            out["server"] = "TypeError"
        return out
    finally:
        client.close()


def pubsub_events_push_to_client(p, s):
    client = s.client()
    try:
        got, evt = [], threading.Event()

        def on_node(msg):
            got.append(msg)
            evt.set()

        client.subscribe("node", on_node)
        nid = p.ids.NodeID.generate()
        s.cp.register_node(p.cp.NodeInfo(node_id=nid, address="h", resources_total={}))
        pushed = evt.wait(10)
        return {"pushed": pushed, "state": got[0][0] if got else None,
                "same_node": bool(got) and got[0][1].node_id == nid}
    finally:
        client.close()


_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
from {pkg}.core.control_plane import NodeInfo
from {pkg}.core.ids import NodeID
from {pkg}.core.rpc import RemoteControlPlane

client = RemoteControlPlane({addr!r})
nid = NodeID.generate()
client.register_node(NodeInfo(node_id=nid, address="child:0",
                              resources_total={{"CPU": 8.0, "GPU": 4.0}}))
for _ in range(3):
    client.heartbeat(nid, {{"CPU": 8.0}})
    time.sleep(0.05)
client.kv_put("child/ready", nid.hex().encode())
assert client.kv_get("parent/hello") == b"hi"
client.close()
print("CHILD_OK", nid.hex())
"""


def child_process_drives_parent_control_plane(p, s):
    s.cp.kv_put("parent/hello", b"hi")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=REPO, pkg=p.name, addr=s.server.address)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    child = out.stdout.split("CHILD_OK")[1].strip()
    nodes = {n.node_id.hex(): n for n in s.cp.alive_nodes()}
    return {"alive": child in nodes, "total": nodes[child].resources_total,
            "ready": s.cp.kv_get("child/ready") == child.encode()}


IN_PROCESS = [full_surface_over_the_wire, unknown_method_and_server_exception,
              pubsub_events_push_to_client, child_process_drives_parent_control_plane]


@pytest.mark.parametrize("flow", IN_PROCESS, ids=lambda f: f.__name__)
def test_the_served_surface_matches_reference(flow):
    out = both(flow)
    if flow is full_surface_over_the_wire:
        assert out == {"landed": True, "avail": {"CPU": 2.0}, "kv": (True, b"v", ["a/b"]),
                       "actor": ("ALIVE", True), "job": "SUCCEEDED"}
    elif flow is unknown_method_and_server_exception:
        assert out == {"unknown": "AttributeError", "server": "TypeError"}
    elif flow is pubsub_events_push_to_client:
        assert out == {"pushed": True, "state": "ALIVE", "same_node": True}
    else:
        assert out == {"alive": True, "total": {"CPU": 8.0, "GPU": 4.0}, "ready": True}


# ------------------------------------------------------------- reconnect


def idempotent_call_rides_out_head_restart(p, s):
    s.cp.kv_put("ft/k", b"survives")
    client = s.client()
    try:
        first = client.kv_get("ft/k")
        s.server.stop()
        result = {}

        def call():
            result["v"] = client.kv_get("ft/k", _deadline_s=15.0)

        t = threading.Thread(target=call)
        t.start()
        time.sleep(0.3)  # the call is now parked waiting for a connection
        parked = "v" not in result
        s.restart()
        t.join(timeout=15)
        return {"first": first, "parked": parked, "done": not t.is_alive(),
                "value": result.get("v")}
    finally:
        client.close()


def nonidempotent_raises_and_is_not_duplicated(p, s):
    client = s.client()
    try:
        info = p.cp.ActorInfo(actor_id=p.ids.ActorID.of(p.ids.JobID.next()), name="ft-actor")
        with p.chaos.partition():
            try:
                client.register_actor(info, _deadline_s=3.0)
                raised = None
            except p.rpc.ControlPlaneUnavailable:
                raised = "ControlPlaneUnavailable"
        reconnected = _wait_reconnected(client)
        client.register_actor(info)  # the caller owns the retry
        return {"raised": raised, "reconnected": reconnected,
                "copies": len([a for a in s.cp.list_actors() if a.name == "ft-actor"])}
    finally:
        client.close()


def nonidempotent_deadline_bounds_downtime(p, s):
    client = s.client()
    try:
        s.server.stop()
        start = time.monotonic()
        try:
            client.register_job(p.ids.JobID.next(), {}, _deadline_s=1.0)
            raised = None
        except p.rpc.ControlPlaneUnavailable:
            raised = "ControlPlaneUnavailable"
        return {"raised": raised, "bounded": time.monotonic() - start < 5.0}
    finally:
        client.close()


def subscription_survives_head_restart(p, s):
    client = s.client()
    try:
        got, evt = [], threading.Event()

        def on_node(msg):
            got.append(msg)
            evt.set()

        client.subscribe("node", on_node)
        s.server.stop()
        cp2 = p.cp.ControlPlane()  # the restarted head: a brand-new authority
        s.restart(cp2)
        reconnected = _wait_reconnected(client)
        nid = p.ids.NodeID.generate()
        cp2.register_node(p.cp.NodeInfo(node_id=nid, address="h", resources_total={}))
        pushed = evt.wait(10)
        return {"reconnected": reconnected, "pushed": pushed,
                "state": got[0][0] if got else None,
                "same_node": bool(got) and got[0][1].node_id == nid}
    finally:
        client.close()


def no_reply_id_crosstalk_across_reconnects(p, s):
    s.cp.kv_put("ft/x", b"real")
    client = s.client()
    try:
        first = client.kv_get("ft/x")  # the old connection used id 1
        old = client._conn
        old.sock.shutdown(2)
        reconnected = _wait_reconnected(client)
        new = client._conn
        fresh = new is not old and new.next_id == 0 and not new.replies
        with old.cv:  # a stale reply for id 1 lands on the OLD map
            old.replies[1] = {"id": 1, "ok": True, "value": b"STALE"}
            old.cv.notify_all()
        return {"first": first, "reconnected": reconnected, "fresh": fresh,
                "after": client.kv_get("ft/x")}
    finally:
        client.close()


_CYCLES = """
import os, sys, threading, time
sys.path.insert(0, {repo!r})
from {pkg}.core.control_plane import ControlPlane
from {pkg}.core.rpc import RemoteControlPlane, serve_control_plane

cp = ControlPlane()
srv = serve_control_plane(cp)
port = srv.server_address[1]
cp.kv_put("ft/cycle", b"ok")
client = RemoteControlPlane(srv.address)
assert client.kv_get("ft/cycle") == b"ok"
time.sleep(0.2)  # let setup threads settle
base_threads = threading.active_count()
base_fds = len(os.listdir("/proc/self/fd"))
for cycle in range(3):
    srv.stop()
    deadline = time.monotonic() + 10
    while True:
        try:
            srv = serve_control_plane(cp, port=port)
            break
        except OSError:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    assert client.kv_get("ft/cycle", _deadline_s=15.0) == b"ok", cycle
assert client.reconnect_count >= 3
deadline = time.monotonic() + 10
while time.monotonic() < deadline:
    if (threading.active_count() <= base_threads
            and len(os.listdir("/proc/self/fd")) <= base_fds):
        break
    time.sleep(0.1)
assert threading.active_count() <= base_threads, [t.name for t in threading.enumerate()]
assert len(os.listdir("/proc/self/fd")) <= base_fds, "leaked fds"
client.close()
srv.stop()
print("CYCLES_OK", client.reconnect_count >= 3)
"""


def three_kill_restart_cycles_leak_nothing(p, s):
    # in a process of its own: thread and fd counts are the whole
    # process's, and a test worker's other tests move them
    out = subprocess.run([sys.executable, "-c", _CYCLES.format(repo=REPO, pkg=p.name)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return {"ok": out.stdout.strip().split()[-2:]}


def partition_delay_mode_slows_but_completes(p, s):
    s.cp.kv_put("ft/d", b"v")
    client = s.client()
    try:
        with p.chaos.partition(mode="delay", delay_s=0.2):
            start = time.monotonic()
            value = client.kv_get("ft/d")
            slowed = time.monotonic() - start >= 0.2
        return {"value": value, "slowed": slowed}
    finally:
        client.close()


def deferred_subscribe_registers_on_reconnect(p, s):
    client = s.client()
    try:
        s.server.stop()
        time.sleep(0.2)
        got = threading.Event()
        client.subscribe("node", lambda m: got.set())  # the head is DOWN here
        cp2 = p.cp.ControlPlane()
        s.restart(cp2)
        reconnected = _wait_reconnected(client)
        cp2.register_node(p.cp.NodeInfo(node_id=p.ids.NodeID.generate(), address="h",
                                        resources_total={}))
        return {"reconnected": reconnected, "pushed": got.wait(10)}
    finally:
        client.close()


RECONNECT = [idempotent_call_rides_out_head_restart, nonidempotent_raises_and_is_not_duplicated,
             nonidempotent_deadline_bounds_downtime, subscription_survives_head_restart,
             no_reply_id_crosstalk_across_reconnects, three_kill_restart_cycles_leak_nothing,
             partition_delay_mode_slows_but_completes, deferred_subscribe_registers_on_reconnect]


@pytest.mark.parametrize("flow", RECONNECT, ids=lambda f: f.__name__)
def test_reconnect_matches_reference(flow):
    out = both(flow)
    expected = {
        idempotent_call_rides_out_head_restart: {"first": b"survives", "parked": True,
                                                 "done": True, "value": b"survives"},
        nonidempotent_raises_and_is_not_duplicated: {"raised": "ControlPlaneUnavailable",
                                                     "reconnected": True, "copies": 1},
        nonidempotent_deadline_bounds_downtime: {"raised": "ControlPlaneUnavailable",
                                                 "bounded": True},
        subscription_survives_head_restart: {"reconnected": True, "pushed": True,
                                             "state": "ALIVE", "same_node": True},
        no_reply_id_crosstalk_across_reconnects: {"first": b"real", "reconnected": True,
                                                  "fresh": True, "after": b"real"},
        three_kill_restart_cycles_leak_nothing: {"ok": ["CYCLES_OK", "True"]},
        partition_delay_mode_slows_but_completes: {"value": b"v", "slowed": True},
        deferred_subscribe_registers_on_reconnect: {"reconnected": True, "pushed": True},
    }[flow]
    assert out == expected


# ------------------------------------------------------------ registries


def test_registries_and_routing_are_the_references():
    t, j = PKGS["ray_tpu_torch"], PKGS["ray_tpu"]
    for p in (t, j):
        assert p.rpc._IDEMPOTENT_METHODS <= p.rpc._ALLOWED_METHODS
        assert p.shard._SHARD_IDEMPOTENT_METHODS <= p.shard._SHARD_ALLOWED_METHODS
        assert p.shard._STANDBY_IDEMPOTENT_METHODS <= p.shard._STANDBY_ALLOWED_METHODS
        assert "promote" not in p.shard._STANDBY_IDEMPOTENT_METHODS
    for attr in ("_ALLOWED_METHODS", "_IDEMPOTENT_METHODS", "_SHARD_ROUTED_METHODS",
                 "_SHARD_DIR_METHODS"):
        assert getattr(t.rpc, attr) == getattr(j.rpc, attr), attr
    for attr in ("_SHARD_ALLOWED_METHODS", "_SHARD_IDEMPOTENT_METHODS",
                 "_STANDBY_ALLOWED_METHODS", "_STANDBY_IDEMPOTENT_METHODS", "SHARD_MAP_KEY"):
        assert getattr(t.shard, attr) == getattr(j.shard, attr), attr
    keys = [f"object_transfer_load/{i:032x}" for i in range(64)] + ["a", "", "ü/ß", "chan-x"]
    for n in (1, 2, 3, 4, 7):
        assert [t.rpc.shard_for_key(k, n) for k in keys] == [j.rpc.shard_for_key(k, n)
                                                              for k in keys]
    assert len({t.rpc.shard_for_key(k, 4) for k in keys}) > 1


# ------------------------------------------------ tensors off the CPU


def test_a_tensor_off_the_cpu_crosses_as_a_cpu_copy(monkeypatch):
    """The port's decision for a CUDA tensor in a value that leaves the
    process: the sender copies it to the CPU in its reducer (the
    reference's jax arrays cross as host bytes), so the receiver gets a
    CPU tensor and never starts CUDA. `meta` stands in for CUDA: its
    copy is faked by zeros of its shape and dtype."""
    from ray_tpu_torch.core import cross_host, object_transfer

    monkeypatch.setattr(object_transfer, "_to_host",
                        lambda t: torch.zeros(t.shape, dtype=t.dtype))
    on_card = torch.empty(2, 3, device="meta")
    param = torch.nn.Parameter(torch.empty(4, device="meta"))
    value = {"x": on_card, "p": param, "cpu": torch.ones(2), "f": lambda: 1}
    for blob in (cross_host._dumps(value), object_transfer._encode_blob(value)):
        got = (pickle.loads(blob) if blob[:4] != object_transfer._BLOB_MAGIC
               else object_transfer._decode_blob(blob))
        assert got["x"].device.type == "cpu" and got["x"].shape == (2, 3)
        assert isinstance(got["p"], torch.nn.Parameter) and got["p"].requires_grad
        assert got["p"].device.type == "cpu" and torch.equal(got["cpu"], torch.ones(2))
        assert got["f"]() == 1
    # without the copy the meta tensor would cross as itself
    monkeypatch.setattr(object_transfer, "_to_host", lambda t: t)
    assert pickle.loads(cross_host._dumps({"x": on_card}))["x"].device.type == "meta"
