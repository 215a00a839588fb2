"""Compiled graphs (ray_tpu_torch.dag) and distributed channels
(ray_tpu_torch.core.channels) against ray_tpu's, on the CPU.

Each flow of tests/test_dag.py's TestCompiledDag runs under both packages
in thread mode (a two-stage pipeline executed repeatedly, two stages that
overlap, a user error reaching ref.get() and leaving the graph usable, an
actor still answering normal calls, refs resolved out of order), and the
results must be equal. Then DistChannel: put/get/put_many and the
capacity counter on the local registry and over a localhost TCP writer,
and the writer's reconnect, under both packages with equal outcomes.
The cross-host graph (TestCrossHostDag) waits for ROADMAP A5c: joining a
host and a graph with a node on one raise naming it. Every runtime is
shut down in a `finally`; every get carries a timeout.
"""

import queue
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.dag as jdag
import ray_tpu_torch
import ray_tpu_torch.dag as tdag
from ray_tpu.core import channels as jchannels
from ray_tpu_torch.core import channels as tchannels
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
WAIT_S = 30


class Pkg:
    def __init__(self, name):
        self.port = name == "ray_tpu_torch"
        self.api = ray_tpu_torch if self.port else ray_tpu
        self.dag = tdag if self.port else jdag
        self.channels = tchannels if self.port else jchannels


def run(name, flow):
    p = Pkg(name)
    p.api.shutdown()
    p.api.init(num_cpus=8, system_config=dict(THREAD_MODE),
               **({"num_gpus": 0} if p.port else {"num_tpus": 0}))
    try:
        return flow(p)
    finally:
        p.api.shutdown()


def both(flow):
    return run("ray_tpu_torch", flow), run("ray_tpu", flow)


# ------------------------------------------------------------ the graphs


def two_stage_pipeline(p):
    @p.api.remote
    class Doubler:
        def process(self, x):
            return x * 2

    @p.api.remote
    class AddOne:
        def process(self, x):
            return x + 1

    a, b = Doubler.remote(), AddOne.remote()
    with p.dag.InputNode() as inp:
        mid = a.process.bind(inp)
        out = b.process.bind(mid)
    dag = out.experimental_compile()
    first = dag.execute(5).get(timeout=WAIT_S)
    refs = [dag.execute(i) for i in range(10)]
    return first, [r.get(timeout=WAIT_S) for r in refs]


def stages_pipeline_concurrently(p):
    @p.api.remote
    class Slow:
        def work(self, x):
            time.sleep(0.05)
            return x

    a, b = Slow.remote(), Slow.remote()
    with p.dag.InputNode() as inp:
        out = b.work.bind(a.work.bind(inp))
    dag = out.experimental_compile()
    dag.execute(0).get(timeout=WAIT_S)  # warm both lanes
    t0 = time.monotonic()
    refs = [dag.execute(i) for i in range(8)]
    vals = [r.get(timeout=WAIT_S) for r in refs]
    # two pipelined 50 ms stages over 8 items: ~(8+1)*50 ms, not 8*100 ms
    return vals, time.monotonic() - t0 < 0.75


def user_error_propagates_to_get(p):
    @p.api.remote
    class Boom:
        def go(self, x):
            raise ValueError("kaput")

    @p.api.remote
    class After:
        def go(self, x):
            return x

    a, b = Boom.remote(), After.remote()
    with p.dag.InputNode() as inp:
        out = b.go.bind(a.go.bind(inp))
    dag = out.experimental_compile()
    seen = []
    for x in (1, 2):  # the graph survives an error: the next run raises too
        try:
            dag.execute(x).get(timeout=WAIT_S)
        except ValueError as e:
            seen.append(str(e))
    return seen


def actor_stays_usable_for_normal_calls(p):
    @p.api.remote(max_concurrency=2)
    class Dual:
        def process(self, x):
            return x * 10

        def ping(self):
            return "pong"

    a = Dual.remote()
    with p.dag.InputNode() as inp:
        out = a.process.bind(inp)
    dag = out.experimental_compile()
    return (dag.execute(3).get(timeout=WAIT_S), p.api.get(a.ping.remote(), timeout=WAIT_S),
            dag.execute(4).get(timeout=WAIT_S))


def refs_resolve_out_of_order(p):
    # envelope routing: each ref gets ITS execution's result even when
    # consumed out of submission order or completed out of order
    @p.api.remote(max_concurrency=4)
    class Jittery:
        def work(self, x):
            time.sleep(0.02 if x % 2 == 0 else 0.001)
            return x * 3

    a = Jittery.remote()
    with p.dag.InputNode() as inp:
        out = a.work.bind(inp)
    dag = out.experimental_compile()
    refs = [dag.execute(i) for i in range(8)]
    return {i: refs[i].get(timeout=WAIT_S) for i in reversed(range(8))}


FLOWS = [two_stage_pipeline, stages_pipeline_concurrently, user_error_propagates_to_get,
         actor_stays_usable_for_normal_calls, refs_resolve_out_of_order]


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__)
def test_compiled_graph_matches_reference(flow):
    port, ref = both(flow)
    assert port == ref
    expected = {
        two_stage_pipeline: (11, [i * 2 + 1 for i in range(10)]),
        stages_pipeline_concurrently: (list(range(8)), True),
        user_error_propagates_to_get: ["kaput", "kaput"],
        actor_stays_usable_for_normal_calls: (30, "pong", 40),
        refs_resolve_out_of_order: {i: i * 3 for i in reversed(range(8))},
    }[flow]
    assert port == expected


def test_bind_builds_the_references_node():
    def flow(p):
        @p.api.remote
        class A:
            def f(self, x, y):
                return x + y

        a = A.remote()
        with p.dag.InputNode() as inp:
            node = a.f.bind(inp, 7)
        return (type(node).__name__, node.method, isinstance(node.args[0], p.dag.InputNode),
                node.args[1], type(p.dag.bind(a, "f", 1, 2)).__name__,
                node.experimental_compile().execute(5).get(timeout=WAIT_S))

    port, ref = both(flow)
    assert port == ref == ("MethodNode", "f", True, 7, "MethodNode", 12)


def test_cross_host_graphs_wait_for_a5c():
    # TestCrossHostDag joins a second runtime with init(address=); a graph
    # whose node sits on a joined host would ride DistChannels homed there
    with pytest.raises(NotImplementedError, match="A5c"):
        ray_tpu_torch.init(address="127.0.0.1:1", num_cpus=1)
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=2, num_gpus=0, system_config=dict(THREAD_MODE))
    try:
        @ray_tpu_torch.remote
        class Stage:
            def process(self, x):
                return x

        s = Stage.remote()
        with tdag.InputNode() as inp:
            out = s.process.bind(inp)
        assert out.experimental_compile().execute(1).get(timeout=WAIT_S) == 1
        for agent in rt.agents.values():
            agent.is_remote = True
        try:
            with pytest.raises(NotImplementedError, match="A5c"):
                out.experimental_compile()
        finally:
            for agent in rt.agents.values():
                del agent.is_remote
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------- the channels


def _capacity(p):
    return p.channels.channel_stats()["capacity_reached"]


def local_channel(p):
    """Put/get/put_many on a channel homed in this process, then a put into
    a full channel: it times out with queue.Full and counts capacity."""
    addr = p.channels.ensure_service()
    ch = p.channels.DistChannel(addr, maxsize=3)
    arr = np.arange(6, dtype=np.float32)
    ch.put(("r1", {"k": arr}))
    ch.put_many([("r2", 1), ("r3", 2)])
    got = [ch.get(timeout=WAIT_S) for _ in range(3)]
    stats0 = p.channels.channel_stats()
    cap0 = _capacity(p)
    ch.put_many([1, 2, 3])
    full = False
    try:
        ch.put(4, timeout=0.2)
    except queue.Full:
        full = True
    drained = [ch.get(timeout=WAIT_S) for _ in range(3)]
    try:
        ch.get(timeout=0.1)
        empty = False
    except queue.Empty:
        empty = True
    ch.close()
    return (got[0][0], got[0][1]["k"].tolist(), got[1:], drained, full, empty,
            _capacity(p) - cap0, stats0["send_bytes"], stats0["recv_count"])


def remote_writer(p):
    """A producer that is not in the owner's process: puts ride a pooled
    TCP writer to the owner's service; a full queue refuses after the
    owner-side timeout with queue.Full and counts capacity."""
    reg = p.channels._Registry()
    svc = p.channels.ChannelService(reg, port=0)
    host, port = svc.server_address
    w = p.channels._Writer(f"{host}:{port}")
    try:
        w.put("c", {"k": np.ones(4, np.float32)}, 4, 5.0)
        w.put_many("c", ["a", "b"], 4, 5.0)
        q = reg.get_or_create("c", 4)
        got = [q.get_nowait() for _ in range(3)]
        cap0 = _capacity(p)
        w.put("d", 1, 1, 1.0)
        try:
            w.put("d", 2, 1, 0.1)
            full = False
        except queue.Full:
            full = True
        return (got[0]["k"].tolist(), got[1:], full, _capacity(p) - cap0,
                p.channels.channel_stats()["send_bytes"] > 0)
    finally:
        w.close()
        svc.stop()


def writer_reconnect(p):
    """TestWriterReconnect: a stale pooled socket reconnects once and
    replays; a dead service surfaces after one retry; an app-level
    refusal keeps the socket."""
    out = []
    reg = p.channels._Registry()
    svc = p.channels.ChannelService(reg, port=0)
    host, port = svc.server_address
    w = p.channels._Writer(f"{host}:{port}")
    try:
        w.put("c1", "v1", 8, 5.0)
        svc.stop()
        svc = p.channels.ChannelService(reg, port=port)
        w.put("c1", "v2", 8, 5.0)
        q = reg.get_or_create("c1", 8)
        out.append([q.get_nowait(), q.get_nowait()])
        w.put("c3", "v1", 1, 1.0)
        before = w._sock
        try:
            w.put("c3", "v2", 1, 0.1)
        except queue.Full:
            out.append(w._sock is before)
        svc.stop()
        try:
            w.put("c2", "v", 8, 1.0)
        except (OSError, p.channels.WireError) as e:
            out.append(isinstance(e, (OSError, p.channels.WireError)))
    finally:
        w.close()
        svc.stop()
    return out


CHANNEL_FLOWS = [local_channel, remote_writer, writer_reconnect]


@pytest.mark.parametrize("flow", CHANNEL_FLOWS, ids=lambda f: f.__name__)
def test_channel_matches_reference(flow):
    port, ref = both(flow)
    assert port == ref
    if flow is local_channel:
        assert port[:6] == ("r1", [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], [("r2", 1), ("r3", 2)],
                            [1, 2, 3], True, True)
        assert port[6] >= 1  # the full put counted backpressure
    elif flow is remote_writer:
        # counted twice: full at arrival (service) and refused (remote)
        assert port == ([1.0, 1.0, 1.0, 1.0], ["a", "b"], True, 2, True)
    else:
        assert port == [["v1", "v2"], True, True]


def test_channel_service_ends_with_the_runtime_and_its_channels_stay_local():
    # a deliberate difference: the reference's service lives as long as its
    # process; the port's ends at shutdown, and a channel homed here before
    # it stays a local queue after the next service starts on another port
    ray_tpu_torch.shutdown()
    addr = tchannels.ensure_service()
    ch = tchannels.DistChannel(addr, maxsize=4)
    ch.put("before")
    service = tchannels._service
    ray_tpu_torch.shutdown()
    assert tchannels.service_address() is None and not service._thread.is_alive()
    tchannels.ensure_service()
    try:
        ch.put("after")
        assert [ch.get(timeout=WAIT_S), ch.get(timeout=WAIT_S)] == ["before", "after"]
    finally:
        tchannels.shutdown_service()
