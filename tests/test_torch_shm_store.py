"""The port's shared-memory store (ray_tpu_torch.core.shm_store) against the
reference's, on the CPU.

The two stores run the same C++ sources, the port's built at first use into
ray_tpu_torch/_build. Each scenario runs on a store of each package with the
same seeded numpy inputs, and the results must be equal: put/get/delete,
duplicate puts, pinned views, arrays of several dtypes and the pin a
derived view keeps, LRU eviction by bytes and by slots, the stats and the
ledger rows (object_ledger's snapshot of each). Then across processes: a
child process of the port alone reads what the parent sealed, a port handle
opens a store the reference created, and the native transfer plane pulls
between the packages both ways. Last, the port's own guard: a store larger
than the free space of /dev/shm is refused before its segment is sized.
"""

import gc
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest

import ray_tpu.core.object_ledger as jledger
import ray_tpu.core.shm_store as jshm
import ray_tpu_torch.core.object_ledger as tledger
import ray_tpu_torch.core.shm_store as tshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oid(i: int) -> bytes:
    return i.to_bytes(4, "big") + b"\x00" * (tshm.ID_SIZE - 4)


@pytest.fixture
def stores():
    made = []

    def make(capacity=1 << 20, max_objects=64):
        pair = []
        for mod, tag in ((tshm, "rtt"), (jshm, "rtpu")):
            s = mod.ShmObjectStore(f"/{tag}_test_{uuid.uuid4().hex[:8]}",
                                   capacity=capacity, max_objects=max_objects)
            made.append(s)
            pair.append(s)
        return pair

    try:
        yield make
    finally:
        for s in made:
            s.close()


def both(make, scenario, **kw):
    port, ref = make(**kw)
    return scenario(port, tshm), scenario(ref, jshm)


def crud(s, mod):
    out = [s.put(_oid(1), b"hello"), s.get_bytes(_oid(1)), s.contains(_oid(1))]
    try:
        s.put(_oid(1), b"again")
    except mod.ShmStoreError:
        out.append("duplicate refused")
    out += [s.delete(_oid(1)), s.contains(_oid(1)), s.get_bytes(_oid(1)), s.live_bytes()]
    return out


def pinned_view(s, mod):
    s.put(_oid(2), b"pinned bytes")
    view = s.get_view(_oid(2))
    out = [bytes(view), s.delete(_oid(2))]  # a pinned object cannot go
    s.release(_oid(2))
    return out + [s.delete(_oid(2))]


def arrays(s, mod):
    rng = np.random.default_rng(0)
    values = [rng.standard_normal((3, 5)).astype(np.float32), rng.integers(0, 9, 7),
              rng.standard_normal(4).astype(np.float16), np.array(2.5)]
    out = []
    for i, arr in enumerate(values):
        s.put_array(_oid(10 + i), arr)
        got = s.get_array(_oid(10 + i))
        out.append((got.dtype.str, got.shape, got.tobytes()))
        del got
    gc.collect()
    arr = np.arange(256, dtype=np.int64)
    s.put_array(_oid(30), arr)
    got = s.get_array(_oid(30))
    view = got[10:20]  # a derived view keeps the pin
    del got
    gc.collect()
    out += [s.delete(_oid(30)), int(view[0])]
    del view
    gc.collect()
    return out + [s.delete(_oid(30))]


def lru_eviction(s, mod):
    blob = np.random.default_rng(1).bytes(200 * 1024)
    for i in range(8):
        s.put(_oid(i), blob)
    out = [s.contains(_oid(i)) for i in range(8)] + [s.live_bytes() <= s.capacity()]
    try:
        s.put(_oid(99), b"x" * (2 << 20))
    except mod.ShmStoreError:
        out.append("oversized refused")
    return out


def slot_eviction(s, mod):
    for i in range(8):
        s.put(_oid(i), bytes([i]) * 64)
    s.put(_oid(100), b"fresh" * 16)  # the table is full: the LRU entry goes
    view = s.get_view(_oid(7))
    for i in range(200, 206):
        s.put(_oid(i), b"x" * 32)
    out = [s.contains(_oid(i)) for i in (0, 7, 100)]
    del view
    s.release(_oid(7))
    return out


def stats_and_ledger(s, mod):
    ledger = tledger if mod is tshm else jledger
    s.ledger_node = "ab" * 14
    for i in range(3):
        s.put(_oid(40 + i), bytes(100 * (i + 1)))
    s.annotate(_oid(41), pin_reason="user_put", creator_task="t")
    s.delete(_oid(42))
    rows = sorted(s.ledger_records(), key=lambda r: r["object_id"])
    snap = ledger.snapshot_store(s, s.ledger_node)
    return (s.stats(),
            [(r["object_id"], r["size_bytes"], r["pin_reason"], r["creator_task"],
              r["creator_node"], r["creator_pid"] == os.getpid()) for r in rows],
            sorted(snap), snap["store"], snap["total_bytes"],
            [(r["object_id"], r["store"]) for r in snap["records"]])


SCENARIOS = [crud, pinned_view, arrays, lru_eviction, stats_and_ledger]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_store_matches_reference(stores, scenario):
    port, ref = both(stores, scenario)
    assert port == ref


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8"])
def test_single_byte_dtypes_read_back_where_the_reference_fails(stores, dtype):
    # ROADMAP C18: the array header is "<dtype.str>|<shape>|", and a
    # single-byte dtype's str starts with "|"; the reference's parse splits
    # there and raises, the port's reads past it (the header is the same)
    port, ref = stores()
    arr = (np.random.default_rng(5).integers(0, 2, (3, 4)) > 0).astype(dtype)
    for s in (port, ref):
        s.put_array(_oid(1), arr)
    got = port.get_array(_oid(1))
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    del got
    with pytest.raises(TypeError, match="not understood"):
        ref.get_array(_oid(1))
    other = tshm.ShmObjectStore(ref.name, create=False)  # the reference's bytes, read by the port
    try:
        got = other.get_array(_oid(1))
        assert np.array_equal(got, arr)
        del got
    finally:
        other.close()


def test_slot_eviction_matches_reference(stores):
    port, ref = both(stores, slot_eviction, max_objects=8)
    assert port == ref == [False, True, True]


def test_the_library_builds_from_the_ports_sources():
    lib = tshm.build()
    assert lib.parent.parent == tshm.BUILD_ROOT and lib.name == "libshm_store.so"
    assert tshm.SRC_DIR.parts[-3:] == ("ray_tpu_torch", "core", "_shm")
    assert os.path.realpath(str(lib)) != os.path.realpath(jshm._SO)


_CHILD = """
import sys
from ray_tpu_torch.core.shm_store import ShmObjectStore
s = ShmObjectStore(sys.argv[1], create=False)
data = s.get_bytes(bytes.fromhex(sys.argv[2]))
s.put(bytes.fromhex(sys.argv[3]), data[::-1])
s.close()
print(sorted(m for m in sys.modules if m in ("jax", "ray_tpu") or m.startswith(("jax.", "ray_tpu."))))
"""


def test_cross_process_read_and_write(stores):
    port, _ = stores()
    payload = np.random.default_rng(2).bytes(4096)
    port.put(_oid(1), payload)
    out = subprocess.run([sys.executable, "-c", _CHILD, port.name, _oid(1).hex(), _oid(2).hex()],
                         capture_output=True, text=True, timeout=120, check=True,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert port.get_bytes(_oid(2)) == payload[::-1]


def test_a_port_handle_opens_the_references_store(stores):
    port, ref = stores()
    payload = np.random.default_rng(3).bytes(1000)
    ref.put(_oid(5), payload)
    other = tshm.ShmObjectStore(ref.name, create=False)
    try:
        assert other.get_bytes(_oid(5)) == payload and other.capacity() == ref.capacity()
    finally:
        other.close()


@pytest.mark.parametrize("direction", ["port_pulls_reference", "reference_pulls_port"])
def test_native_pull_across_the_packages(stores, direction):
    port, ref = stores(capacity=8 << 20)
    src, dst = (ref, port) if direction == "port_pulls_reference" else (port, ref)
    smod, dmod = (jshm, tshm) if direction == "port_pulls_reference" else (tshm, jshm)
    blob = np.random.default_rng(4).bytes(3 << 20)
    src.put(_oid(7), blob)
    server = smod.NativeTransferServer(src)
    client = dmod.NativeTransferClient()
    try:
        assert bytes(client.pull("127.0.0.1", server.port, _oid(7), len(blob))) == blob
        assert client.pull("127.0.0.1", server.port, _oid(8), 10) is None
        assert client.pull_into("127.0.0.1", server.port, _oid(7), dst) == len(blob)
        assert dst.get_bytes(_oid(7)) == blob
        with pytest.raises(dmod.PullRejected):  # larger than promised; the conn survives
            client.pull("127.0.0.1", server.port, _oid(7), 10)
        assert bytes(client.pull("127.0.0.1", server.port, _oid(7), len(blob))) == blob
    finally:
        client.close()
        server.stop()


def test_a_store_past_the_free_space_of_dev_shm_is_refused(monkeypatch):
    monkeypatch.setattr(tshm, "shm_free_bytes", lambda: 1 << 20)
    name = f"/rtt_refused_{uuid.uuid4().hex[:8]}"
    with pytest.raises(tshm.ShmStoreError, match="/dev/shm has 1048576 bytes free"):
        tshm.ShmObjectStore(name, capacity=4 << 20)
    assert not os.path.exists(f"/dev/shm/{name[1:]}")
    s = tshm.ShmObjectStore(name, capacity=512 << 10, max_objects=8)  # fits: made
    s.close()
