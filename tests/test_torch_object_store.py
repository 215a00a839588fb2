"""The port's object store and its thread-mode limits, on the CPU.

`seal_value` keeps the reference's rule for host values (numpy, plain
Python: sealed at put, a fresh copy per get) and splits it for torch
tensors, which are mutable: a CPU tensor is sealed like numpy, a tree that
holds a tensor off the CPU passes through by reference (the `meta` device
stands in for CUDA here; tests/test_torch_kernels.py holds the CUDA case on
the card). Also pinned: a num_gpus task fails fast as infeasible on a box
without a card, the process flags start the worker-process pool and actor
processes (from system_config or the environment), and the cross-host,
persistence, federation, RPC and profiling entry points (A5c) raise
NotImplementedError naming their item.
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import ray_tpu_torch.cluster_utils
from ray_tpu.core import object_store as jstore
from ray_tpu_torch.core import object_store as tstore
from ray_tpu_torch.core.config import config as tconfig
from ray_tpu_torch.core.ids import ObjectID
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
WAIT_S = 20


@pytest.fixture
def runtime():
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4, system_config=dict(THREAD_MODE))
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_cpu_tensor_is_copied_at_put(runtime):
    t = torch.arange(6, dtype=torch.float32)
    tree = {"w": t, "b": [torch.ones(2)]}
    ref = ray_tpu_torch.put(tree)
    t.add_(100.0)  # the owner's later in-place change
    got = ray_tpu_torch.get(ref, timeout=WAIT_S)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))
    assert got["w"].data_ptr() != t.data_ptr()
    got["w"].zero_()  # nor does a consumer's change reach the next consumer
    assert torch.equal(ray_tpu_torch.get(ref, timeout=WAIT_S)["w"],
                       torch.arange(6, dtype=torch.float32))


def test_device_tree_passes_through_by_reference(runtime):
    # meta stands in for CUDA: any device but the CPU takes the same rule
    w = torch.empty(4, 8, device="meta")
    tree = {"layers": {"w": w}, "host": torch.ones(3)}
    assert tstore._has_device_leaves(tree)
    ref = ray_tpu_torch.put(tree)
    got = ray_tpu_torch.get(ref, timeout=WAIT_S)
    assert got is tree and got["layers"]["w"] is w  # the alias: no copy, no seal

    @ray_tpu_torch.remote
    def same(x):
        return x["layers"]["w"] is w

    assert ray_tpu_torch.get(same.remote(ref), timeout=WAIT_S)


def test_device_tree_is_never_measured_by_pickling_nor_spilled():
    store = tstore.MemoryObjectStore(capacity_bytes=4096)
    big = {"w": torch.empty(2 ** 31, device="meta")}  # 8 GiB, far past capacity
    assert store.sizeof(big) == 2 ** 33
    oid = ObjectID.generate()
    store.put(oid, tstore.seal_value(big))
    assert store.get(oid) is big and store.used_bytes() == 0
    host = ObjectID.generate()
    store.put(host, tstore.seal_value(np.zeros(200)))  # fills the host side
    assert store.used_bytes() > 0 and store.stats()["num_spilled"] == 0
    store.delete(oid)
    store.delete(host)
    assert store.used_bytes() == 0


VALUES = [None, 7, 2.5, True, "text", b"raw", np.arange(12).reshape(3, 4),
          {"a": np.ones(3, np.float32), "b": [1, "x", (2, 3)]}, [np.zeros(2), {"k": 1}],
          (1, 2.0, "three")]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__)
def test_host_values_seal_as_the_reference_does(value):
    got = tstore.seal_value(value)
    want = jstore.seal_value(value)
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, jstore.SealedBytes):
        a, b = got.load(), want.load()
        assert a is not value and type(a) is type(b)
        np.testing.assert_equal(a, b)
        np.testing.assert_equal(a, value)
        assert got.nbytes == want.nbytes
    else:
        assert got is value and want is value


def test_gpu_task_without_a_card_is_infeasible_as_in_the_reference():
    def run(api, accel):
        api.shutdown()
        api.init(num_cpus=2, system_config=dict(THREAD_MODE))
        try:
            @api.remote(**{f"num_{accel.lower()}s": 1})
            def on_card():
                return 1

            with pytest.raises(ValueError) as e:
                api.get(on_card.remote(), timeout=WAIT_S)
            return str(e.value).replace(accel, "ACCEL"), api.cluster_resources()
        finally:
            api.shutdown()

    port = run(ray_tpu_torch, "GPU")
    assert port == run(ray_tpu, "TPU")
    assert "infeasible" in port[0] and "GPU" not in port[1]


def _pid():
    return os.getpid()


class _Where:
    def pid(self):
        return os.getpid()


@pytest.mark.parametrize("flags", [{"worker_processes": 2, "actor_processes": False},
                                   {"worker_processes": 0, "actor_processes": True}],
                         ids=["worker_processes", "actor_processes"])
def test_process_flags_start_the_pool_and_actor_processes(flags):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, system_config=flags)
    try:
        task = ray_tpu_torch.get(ray_tpu_torch.remote(_pid).remote(), timeout=60)
        actor = ray_tpu_torch.remote(_Where).remote()
        home = ray_tpu_torch.get(actor.pid.remote(), timeout=60)
        # each flag moves its own kind of work out of this process, alone
        assert (task != os.getpid()) == bool(flags["worker_processes"])
        assert (home != os.getpid()) == flags["actor_processes"]
    finally:
        ray_tpu_torch.shutdown()
    assert tconfig._overrides == {}


def test_process_flag_from_the_environment_starts_the_pool(monkeypatch):
    ray_tpu_torch.shutdown()
    monkeypatch.setenv("RAY_TPU_WORKER_PROCESSES", "2")
    monkeypatch.setenv("RAY_TPU_ACTOR_PROCESSES", "0")
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.get(ray_tpu_torch.remote(_pid).remote(), timeout=60) != os.getpid()
    finally:
        ray_tpu_torch.shutdown()
    cluster = ray_tpu_torch.cluster_utils.Cluster()
    try:
        assert cluster.runtime.driver_agent._ensure_pool().num_workers == 2
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("kwargs", [
    {"address": "127.0.0.1:6379"},
    {"system_config": {"control_plane_rpc_port": 0}},
    {"system_config": {"control_plane_shards": 2}},
], ids=["address", "rpc_head", "federation"])
def test_cross_host_entry_points_raise_naming_a5c(kwargs):
    ray_tpu_torch.shutdown()
    with pytest.raises(NotImplementedError, match="A5c"):
        ray_tpu_torch.init(**kwargs)
    assert not ray_tpu_torch.is_initialized() and tconfig._overrides == {}


def test_in_process_runtime_refuses_what_waits(runtime):
    @ray_tpu_torch.remote
    class Isolated:
        def ping(self):
            return 1

    a = Isolated.remote()
    # compiled graphs over this process's actors are ported: bind builds a
    # node (tests/test_torch_dag.py runs the graphs)
    from ray_tpu_torch.dag import MethodNode

    node = a.ping.bind()
    assert isinstance(node, MethodNode) and node.method == "ping" and node.args == ()
    # an actor that asks for its own process gets one, even in thread mode
    b = Isolated.options(in_process=False).remote()
    assert ray_tpu_torch.get(b.ping.remote(), timeout=WAIT_S) == 1
    assert "worker process" in repr(runtime.driver_agent._actors[b._actor_id].instance)
    assert ray_tpu_torch.get(a.ping.remote(), timeout=WAIT_S) == 1


def test_transfer_plane_pulls_over_the_chunked_path(runtime, monkeypatch):
    # the host plane between runtimes, on localhost: an object past three
    # quarters of the staging arena rides ~chunk_bytes chunks over the
    # socket (tests/test_torch_transfer_native.py holds the native path)
    from ray_tpu_torch.core import object_transfer

    monkeypatch.setattr(object_transfer, "STAGING_BYTES", 1 << 20)
    value = {"a": np.arange(300_000, dtype=np.float64), "t": torch.arange(7)}
    ref = ray_tpu_torch.put(value)
    server = object_transfer.serve_object_transfer(runtime, "127.0.0.1", 0)
    client = object_transfer.ObjectTransferClient(chunk_bytes=256 * 1024)
    try:
        got = client.pull(server.address, ref.object_id)
        np.testing.assert_array_equal(got["a"], value["a"])
        assert torch.equal(got["t"], value["t"])
        raw = client.pull(server.address, ref.object_id, raw=True)
        assert isinstance(raw, tstore.SealedBytes) and raw.nbytes > 2_400_000
    finally:
        client.close()
        server.stop()


@pytest.fixture
def small_pull_runtime(monkeypatch):
    # striping and the relay tree start at 8 and 4 MiB by default; lowered
    # here so a small object takes those paths, and the staging arena with
    # them, so the object is too large to stage (as the reference's tests
    # do): a staged one goes native, or through the same-host handoff
    from ray_tpu_torch.core import object_transfer

    monkeypatch.setattr(object_transfer, "STAGING_BYTES", 1 << 20)
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=2, system_config=dict(
        THREAD_MODE, object_transfer_stripe_min_bytes=0,
        object_relay_min_bytes=0))
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_transfer_plane_stripes_a_pull_across_holders(small_pull_runtime):
    from ray_tpu_torch.core import object_transfer

    store = small_pull_runtime.driver_agent.store
    value = np.arange(400_000, dtype=np.float64)
    ref = ray_tpu_torch.put(value)
    servers = [object_transfer.ObjectTransferServer(store) for _ in range(2)]
    served = []
    read_range = servers[1]._read_range
    servers[1]._read_range = lambda *a: served.append(a[2]) or read_range(*a)
    client = object_transfer.ObjectTransferClient(chunk_bytes=256 * 1024)
    try:
        got = client.pull(servers[0].address, ref.object_id,
                          peers=[servers[1].address])
        np.testing.assert_array_equal(got, value)
        # the second holder served the upper stripe, from its start on
        assert served and min(served) > 0
    finally:
        client.close()
        for server in servers:
            server.stop()


def test_transfer_plane_relay_pull_caches_and_serves_onward(small_pull_runtime):
    from ray_tpu_torch.core import object_transfer

    rt = small_pull_runtime
    value = {"a": np.arange(300_000, dtype=np.float64), "t": torch.arange(5)}
    ref = ray_tpu_torch.put(value)
    holder = object_transfer.serve_object_transfer(rt, "127.0.0.1", 0)
    replica = tstore.MemoryObjectStore()
    relay = object_transfer.ObjectTransferServer(replica)
    client = object_transfer.ObjectTransferClient(chunk_bytes=256 * 1024)
    cached = []
    oid_hex = ref.object_id.hex()
    try:
        got = object_transfer.pull_from_any(
            rt.control_plane, ref.object_id, client=client,
            cache_store=replica, on_cached=cached.append, relay_server=relay,
            node_hex="puller")
        np.testing.assert_array_equal(got["a"], value["a"])
        assert torch.equal(got["t"], value["t"])
        assert cached == [ref.object_id] and replica.contains(ref.object_id)
        claims = rt.control_plane.kv_keys(f"{object_transfer.RELAY_PREFIX}{oid_hex}/")
        assert len(claims) == 1
        # the relay node now serves the object onward from its own buffer
        onward = client.pull(relay.address, ref.object_id, raw=True)
        np.testing.assert_array_equal(onward.load()["a"], value["a"])
        object_transfer.purge_relay_claims(oid_hex, rt.control_plane)
        assert not rt.control_plane.kv_keys(f"{object_transfer.RELAY_PREFIX}{oid_hex}/")
    finally:
        client.close()
        relay.stop()
        holder.stop()
