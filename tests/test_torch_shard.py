"""The federated control plane (ray_tpu_torch/core/shard.py and
rpc.ShardedControlPlane) against the reference's, on the CPU.

Each flow runs under both packages and the results must be equal: KV and
object-directory writes routed by `shard_for_key` to the owning shard,
pubsub on the channel owner's shard; K=1 federation acting like the plain
head plane; a shard primary SIGKILLed under load, its warm standby
promoted onto the same port with the journal replayed to the primary's
state, and a fresh standby respawned behind it; a head started with
`control_plane_shards=2` serving RPC, whose joined host adopts the shard
map and writes straight to the owning shard. Then the port's own rule: a
shard process loads the control-plane modules only (no torch, no jax, no
`ray_tpu`). Every wait is bounded; every shard process ends with its test.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

import ray_tpu
import ray_tpu_torch
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC = {"ray_tpu": "num_tpus", "ray_tpu_torch": "num_gpus"}


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{name}.core.{m}")  # noqa: E731
    return SimpleNamespace(name=name, api=importlib.import_module(name), cp=mod("control_plane"),
                           ids=mod("ids"), rpc=mod("rpc"), shard=mod("shard"))


PKGS = {name: _pkg(name) for name in ("ray_tpu", "ray_tpu_torch")}


def both(flow):
    out = {name: flow(p) for name, p in PKGS.items()}
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu_torch"]


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def routed_to_the_owning_shard(p):
    head = p.cp.ControlPlane()
    shards = [p.shard.ControlPlaneShard(i, 2) for i in range(2)]
    head_srv = p.rpc.serve_control_plane(head)
    shard_srvs = [p.rpc.ControlPlaneServer(s, port=0,
                                           allowed_methods=p.shard._SHARD_ALLOWED_METHODS)
                  for s in shards]
    client = p.rpc.ShardedControlPlane(head_srv.address, [s.address for s in shard_srvs],
                                       role="test", route_directory=True)
    try:
        keys = [f"k/{i}" for i in range(8)]
        for k in keys:
            client.kv_put(k, k.upper())
        owners = [p.rpc.shard_for_key(k, 2) for k in keys]
        placed = all(shards[o].kv_get(k) == k.upper() and shards[1 - o].kv_get(k) is None
                     for k, o in zip(keys, owners))
        read = [client.kv_get(k) for k in keys]
        client.dir_add_location("obj1", "aa")
        dir_owner = shards[p.rpc.shard_for_key("obj1", 2)].dir_locations("obj1")
        got = threading.Event()
        client.subscribe("chan-x", lambda m: got.set())
        time.sleep(0.1)
        shards[p.rpc.shard_for_key("chan-x", 2)].publish("chan-x", {"v": 1})
        return {"owners": owners, "placed": placed, "read": read,
                "keys": sorted(client.kv_keys("k/")), "dir": (dir_owner,
                                                              client.dir_locations("obj1")),
                "pushed": got.wait(5.0)}
    finally:
        client.close()
        head_srv.stop()
        for srv in shard_srvs:
            srv.stop()


def k1_federation_is_behavior_identical(p):
    inner = p.cp.ControlPlane()
    sup = p.shard.ShardSupervisor(1, spawn_standby=False)
    sup.start()
    fed = None
    try:
        fed = p.shard.FederatedControlPlane(inner, sup)
        node = p.ids.NodeID.generate()
        fed.register_node(p.cp.NodeInfo(node_id=node, address="h", resources_total={"CPU": 1.0}))
        out = {"forwarded": inner.get_node(node) is not None}
        fed.kv_put("a/b", "v1")
        out["kv"] = (fed.kv_get("a/b"), fed.kv_keys("a/"), inner.kv_get("a/b"))
        fed.kv_del("a/b")
        out["deleted"] = fed.kv_get("a/b")
        got = threading.Event()
        fed.pubsub.subscribe("alerts", lambda m: got.set())
        time.sleep(0.1)
        fed.pubsub.publish("alerts", {"rule": "x"})
        out["pushed"] = got.wait(5.0)
        fed.kv_put(f"object_transfer_load/{node.hex()}", "0.9")
        fed.mark_node_dead(node)  # purges the dead node's gossip shard-side
        out["purged"] = fed.kv_get(f"object_transfer_load/{node.hex()}")
        return out
    finally:
        if fed is not None:
            fed.close()
        sup.stop()


def killed_primary_replays_its_journal(p):
    inner = p.cp.ControlPlane()
    sup = p.shard.ShardSupervisor(2)
    sup.start()
    fed = None
    try:
        fed = p.shard.FederatedControlPlane(inner, sup)
        for i in range(24):
            fed.kv_put(f"job/{i}", i)
        for i in range(0, 24, 3):
            fed.kv_del(f"job/{i}")
        nodes = [p.ids.NodeID.generate().hex() for _ in range(2)]
        fed._clients[0]._call("dir_add_location", "obj-a", nodes[0])
        fed._clients[0]._call("dir_add_location", "obj-a", nodes[1])
        fed._clients[0]._call("dir_remove_location", "obj-a", nodes[0])
        before = [fed._clients[i]._call("shard_info") for i in range(2)]
        port = sup.addresses[0]
        killed = sup.kill_primary(0)
        deadline = time.monotonic() + 30
        while not sup.failovers and time.monotonic() < deadline:
            time.sleep(0.05)
        healthy = sup.wait_healthy(30.0)
        # the promoted standby serves on the dead primary's port: the
        # client's reconnect loop rides the failover out
        keys = sorted(fed.kv_keys("job/"), key=lambda k: int(k.split("/")[1]))
        after = [fed._clients[i]._call("shard_info", _deadline_s=15.0) for i in range(2)]
        deadline = time.monotonic() + 30
        while sup._slots[0].standby is None and time.monotonic() < deadline:
            time.sleep(0.05)  # the warm spare respawns after the promotion
        respawned = sup._slots[0].standby is not None and sup._slots[0].standby.poll() is None
        return {"failovers": len(sup.failovers), "healthy": healthy,
                "same_port": sup.addresses[0] == port,
                "killed_new_pid": after[0]["pid"] != killed and _gone(killed),
                "keys": keys, "values": [fed.kv_get(k) for k in keys],
                "dir": fed._clients[0]._call("dir_locations", "obj-a") == [nodes[1]],
                "info": [(b["kv_len"], b["dir_len"], a["kv_len"], a["dir_len"], a["role"])
                         for b, a in zip(before, after)],
                "respawned": respawned}
    finally:
        if fed is not None:
            fed.close()
        sup.stop()


FLOWS = [routed_to_the_owning_shard, k1_federation_is_behavior_identical,
         killed_primary_replays_its_journal]


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_federation_matches_reference(flow):
    out = both(flow)
    if flow is routed_to_the_owning_shard:
        assert out["placed"] and out["pushed"] and len(set(out["owners"])) == 2
        assert out["read"] == [f"K/{i}" for i in range(8)]
        assert out["keys"] == [f"k/{i}" for i in range(8)] and out["dir"] == (["aa"], ["aa"])
    elif flow is k1_federation_is_behavior_identical:
        assert out == {"forwarded": True, "kv": ("v1", ["a/b"], None), "deleted": None,
                       "pushed": True, "purged": None}
    else:
        kept = [i for i in range(24) if i % 3]
        assert out["failovers"] == 1 and out["healthy"] and out["same_port"]
        assert out["killed_new_pid"] and out["respawned"] and out["dir"]
        assert out["keys"] == [f"job/{i}" for i in kept] and out["values"] == kept
        assert [a[:2] == a[2:4] for a in out["info"]] == [True, True]
        assert [a[4] for a in out["info"]] == ["primary", "primary"]


_JOIN = """
import {name}, sys
w = {name}.init(address={addr!r}, num_cpus=2, {acc}=0, resources={{"magic": 1.0}})
w.wait(timeout=300)
"""


def test_a_joined_host_adopts_the_shard_map_as_in_the_reference():
    out = {}
    for name, p in PKGS.items():
        api = p.api
        api.shutdown()
        rt = api.init(num_cpus=2, **{ACC[name]: 0}, system_config={
            "control_plane_rpc_port": 0, "control_plane_shards": 2, "worker_processes": 0,
            "actor_processes": False})
        sup, fed = rt._federation
        pids = [s.primary.pid for s in sup._slots] + [s.standby.pid for s in sup._slots]
        env = dict(os.environ, RAY_TPU_WORKER_PROCESSES="0", JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        os.environ["RAY_TPU_HEAD_ADDRESS"] = rt._cp_server.address
        proc = subprocess.Popen(
            [sys.executable, "-c", _JOIN.format(name=name, addr=rt._cp_server.address,
                                                acc=ACC[name])],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 90
            while len(rt.control_plane.alive_nodes()) < 2 and time.monotonic() < deadline:
                time.sleep(0.1)

            def write_there():
                import importlib

                w = importlib.import_module(f"{name}.api")._worker_runtime
                cp = w.control_plane
                cp.kv_put("joined/hello", b"from-worker")
                return type(cp).__name__, len(cp.shards)

            kind = api.get(api.remote(num_cpus=0, resources={"magic": 0.1})(
                write_there).remote(), timeout=60)
            owner = fed._clients[p.rpc.shard_for_key("joined/hello", 2)]
            out[name] = {"client": kind, "head_reads": fed.kv_get("joined/hello"),
                         "on_owner": owner._call("kv_get", "joined/hello"),
                         "map": json.loads(fed.kv_get(p.shard.SHARD_MAP_KEY))["addresses"]
                         == sup.addresses}
        finally:
            api.shutdown()
            os.environ.pop("RAY_TPU_HEAD_ADDRESS", None)
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        deadline = time.monotonic() + 10
        while not all(_gone(pid) for pid in pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        out[name]["shards_stopped"] = all(_gone(pid) for pid in pids)
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert out["ray_tpu_torch"] == {"client": ("ShardedControlPlane", 2),
                                    "head_reads": b"from-worker", "on_owner": b"from-worker",
                                    "map": True, "shards_stopped": True}


def test_a_shard_process_loads_the_control_plane_only():
    from ray_tpu_torch.core import shard

    # what the shard entry imports before it serves (argparse exits on
    # --help after every module-level import of core/shard.py has run)
    probe = ("import atexit, sys\n"
             "atexit.register(lambda: print('LOADED', sorted({m.split('.')[0] for m in "
             "sys.modules if m.split('.')[0] in ('torch', 'jax', 'ray_tpu', 'numpy')})))\n"
             + shard._SHARD_BOOT.replace("; ", "\n"))
    pkg_dir = os.path.join(REPO, "ray_tpu_torch")
    out = subprocess.run([sys.executable, "-c", probe, pkg_dir, "--help"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    # and a serving shard process maps no torch or jax library
    sup = shard.ShardSupervisor(1, spawn_standby=False)
    sup.start()
    try:
        with open(f"/proc/{sup._slots[0].primary.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "jaxlib" not in maps
    finally:
        sup.stop()
