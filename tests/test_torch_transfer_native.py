"""The transfer plane's native path and same-host handoff
(ray_tpu_torch.core.object_transfer over shm_store) against the
reference's, on the CPU.

Each flow runs under both packages on a store, a transfer server and a
client of that package, with the same seeded numpy values, and the two
must agree on the value and on the data path the pull took (read off the
`object_pull_seconds` histogram's `path` tag): the native pull with the
handoff off (the staged blob streams arena-to-arena), the raw pull keeping
its seal, an object past three quarters of STAGING_BYTES taking the
chunked fallback, repeated pulls reusing the staged blob, close racing the
planes' background init, and the same-host shm handoff moving no byte over
a socket. Then pulls across the packages, both ways, natively and through
the handoff: the two speak one wire and one arena layout.
"""

import time

import numpy as np
import pytest

import ray_tpu.core.ids as jids
import ray_tpu.core.object_store as jstore
import ray_tpu.core.object_transfer as jot
import ray_tpu_torch.core.ids as tids
import ray_tpu_torch.core.object_store as tstore
import ray_tpu_torch.core.object_transfer as tot
from _torch_fixtures import _fresh_metric_registries  # noqa: F401
from ray_tpu.core.config import config as jconfig
from ray_tpu_torch.core.config import config as tconfig

PKGS = {"ray_tpu": (jot, jstore, jids, jconfig),
        "ray_tpu_torch": (tot, tstore, tids, tconfig)}


class Pkg:
    def __init__(self, name):
        self.name = name
        self.ot, self.store_mod, self.ids, self.config = PKGS[name]

    def oid(self):
        return self.ids.ObjectID.for_task_return(self.ids.TaskID.of(), 0)

    def paths(self) -> dict:
        return {p: self.ot._pull_seconds.count({"path": p})
                for p in ("native", "shm", "chunked")}


@pytest.fixture
def handoff():
    """Sets object_transfer_shm_handoff in both packages' configs for the
    test; both start from their defaults again after it."""
    def set_(on: bool):
        for *_, config in PKGS.values():
            config.apply_overrides({"object_transfer_shm_handoff": on})

    try:
        yield set_
    finally:
        for *_, config in PKGS.values():
            config.reset()


def wait_native(obj, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if obj._plane.native is not None:
            return True
        time.sleep(0.02)
    return False


def served(p, flow):
    store = p.store_mod.MemoryObjectStore()
    server = p.ot.ObjectTransferServer(store)
    client = p.ot.ObjectTransferClient()
    try:
        return flow(p, store, server, client)
    finally:
        client.close()
        server.stop()


def both(flow):
    return served(Pkg("ray_tpu_torch"), flow), served(Pkg("ray_tpu"), flow)


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


# ------------------------------------------------------------------- flows


def native_pull(p, store, server, client):
    arr = np.random.default_rng(0).standard_normal(500_000)  # ~4 MB
    oid = p.oid()
    store.put(oid, arr)
    assert wait_native(server)
    first = client.pull(server.address, oid)  # kicks the client plane's init
    assert wait_native(client)
    before = p.paths()
    second = client.pull(server.address, oid)
    return first.tobytes(), second.tobytes(), delta(p.paths(), before)


def raw_pull_keeps_its_seal(p, store, server, client):
    oid = p.oid()
    store.put(oid, p.store_mod.seal_value(np.random.default_rng(1).integers(0, 99, 100_000), "t"))
    assert wait_native(server)
    client.pull(server.address, oid, raw=True)
    assert wait_native(client)
    before = p.paths()
    raw = client.pull(server.address, oid, raw=True)
    return (isinstance(raw, p.store_mod.SealedBytes), raw.load().tobytes(),
            delta(p.paths(), before))


def repeat_pulls_reuse_the_stage(p, store, server, client):
    oid = p.oid()
    store.put(oid, list(range(50_000)))
    assert wait_native(server)
    first = client.pull(server.address, oid)
    sid = p.ot._stage_id(oid.binary(), False)
    staged = server._plane.staging.contains(sid)
    second = client.pull(server.address, oid)
    return first == second == list(range(50_000)), staged


def shm_handoff(p, store, server, client):
    arr = np.random.default_rng(2).standard_normal(262_144)
    oid = p.oid()
    store.put(oid, arr)
    assert wait_native(server)
    staged = client._call(server.address, "stage", oid.hex(), False)
    before, wire = p.paths(), p.ot._pull_bytes.get()
    out = client.pull(server.address, oid)
    return (staged["shm"]["token"] == p.ot._host_token(), out.tobytes(),
            delta(p.paths(), before), p.ot._pull_bytes.get() - wire)


@pytest.mark.parametrize("flow", [native_pull, raw_pull_keeps_its_seal,
                                  repeat_pulls_reuse_the_stage],
                         ids=lambda f: f.__name__)
def test_native_flow_matches_reference(flow, handoff):
    handoff(False)  # both ends share a host: the handoff would win the pull
    port, ref = both(flow)
    assert port == ref
    if flow is not repeat_pulls_reuse_the_stage:
        assert port[-1]["native"] == 1
    else:
        assert port == (True, True)


def test_shm_handoff_matches_reference(handoff):
    handoff(True)
    port, ref = both(shm_handoff)
    assert port == ref
    assert port[0] is True and port[2]["shm"] == 1 and port[3] == 0


def test_oversized_blob_takes_the_chunked_fallback(handoff, monkeypatch):
    handoff(True)
    for ot, *_ in PKGS.values():
        monkeypatch.setattr(ot, "STAGING_BYTES", 1 << 20)

    def flow(p, store, server, client):
        arr = np.random.default_rng(3).standard_normal(400_000)  # ~3 MB > 3/4 of 1 MB
        oid = p.oid()
        store.put(oid, arr)
        wait_native(server)
        before = p.paths()
        out = client.pull(server.address, oid)
        return out.tobytes(), delta(p.paths(), before)

    port, ref = both(flow)
    assert port == ref and port[1] == {"native": 0, "shm": 0, "chunked": 1}


def test_close_races_the_background_init():
    for name in PKGS:
        p = Pkg(name)
        for _ in range(5):
            server = p.ot.ObjectTransferServer(p.store_mod.MemoryObjectStore())
            client = p.ot.ObjectTransferClient()
            client._plane.start_async()
            client.close()  # the planes' init may be in flight
            server.stop()
            for plane in (client._plane, server._plane):
                assert plane.native is None and plane.staging is None, name


@pytest.mark.parametrize("on", [False, True], ids=["native", "handoff"])
@pytest.mark.parametrize("direction", ["port_pulls_reference", "reference_pulls_port"])
def test_pull_across_the_packages(direction, on, handoff):
    handoff(on)
    holder, puller = ((Pkg("ray_tpu"), Pkg("ray_tpu_torch"))
                      if direction == "port_pulls_reference" else
                      (Pkg("ray_tpu_torch"), Pkg("ray_tpu")))
    store = holder.store_mod.MemoryObjectStore()
    server = holder.ot.ObjectTransferServer(store)
    client = puller.ot.ObjectTransferClient()
    try:
        arr = np.random.default_rng(4).standard_normal(300_000)
        oid = holder.oid()
        store.put(oid, arr)
        assert wait_native(server)
        client.pull(server.address, oid)
        assert on or wait_native(client)
        before = puller.paths()
        out = client.pull(server.address, oid)
        assert np.array_equal(out, arr)
        assert delta(puller.paths(), before)["shm" if on else "native"] == 1
    finally:
        client.close()
        server.stop()
