"""Compiled graphs: pre-bound actor pipelines over channels.

The port's copy of ray_tpu/dag.py: bind actor methods into a static graph
once, then execute it repeatedly through pre-allocated channels, skipping
the per-call task machinery (spec creation, scheduling, object store,
futures).

    with InputNode() as inp:
        mid = stage_a.process.bind(inp)
        out = stage_b.process.bind(mid)
    dag = out.experimental_compile()
    ref = dag.execute(x)       # returns immediately
    y = ref.get(timeout=...)   # reads the output channel

Execution model: ``execute`` pushes an ENVELOPE (per-execution result
channel + value) into the graph's entry channels and enqueues one
pre-bound closure per node onto its actor's mailbox
(NodeAgent.submit_direct). Each closure blocks on its input channels,
runs the bound method on the actor instance, and pushes the envelope on
to its consumers — so distinct actors pipeline (stage A works on item
N+1 while stage B works on item N), and because every value travels with
its own result channel, results route to the right DAGRef even when an
actor has max_concurrency > 1 and completes items out of order. Errors
propagate through the channels and raise at ``ref.get()``.

An actor dying mid-pipeline invalidates the DAG (execute() pre-checks
liveness and raises; an envelope stranded by a death never resolves and
its ref.get() times out): rebuild the graph after replacing the actor.

Every node of a graph lives in this process (thread mode), so every edge
is a local `Channel`. A graph with a node on a joined host would ride
DistChannels (core/channels.py) homed in each consumer's process; joined
hosts wait for ROADMAP A5c, and that branch raises NotImplementedError
naming it.
"""

from __future__ import annotations

import queue
import time
from typing import Any, Dict, List, Optional, Tuple

from .core.logging import get_logger

logger = get_logger("dag")

_A5C_REMOTE = ("compiled-graph edges to a joined host (DistChannels homed in "
               "remote processes) wait for ROADMAP A5c")


class Channel:
    """Bounded SPSC channel between nodes of one process: a queue."""

    def __init__(self, maxsize: int = 8):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize)

    def put(self, value: Any, timeout: Optional[float] = None) -> None:
        self._q.put(value, timeout=timeout)

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._q.get(timeout=timeout)


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Envelope:
    """One execution's traveling state: its value and its result channel."""

    __slots__ = ("result_ch", "value")

    def __init__(self, result_ch: Channel, value: Any):
        self.result_ch = result_ch
        self.value = value


class DAGNode:
    pass


class InputNode(DAGNode):
    """The graph's input placeholder, used as a context manager."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


class MethodNode(DAGNode):
    def __init__(self, handle, method: str, args: Tuple[Any, ...]):
        self.handle = handle
        self.method = method
        self.args = args

    def experimental_compile(self, max_inflight: int = 8) -> "CompiledDAG":
        return CompiledDAG(self, max_inflight)


class DAGRef:
    """Handle to one execution's output."""

    def __init__(self, channel: "Channel"):
        self._channel = channel

    def get(self, timeout: Optional[float] = 60.0) -> Any:
        try:
            out = self._channel.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("compiled DAG execution timed out") from None
        if isinstance(out, _Err):
            raise out.exc
        return out


class CompiledDAG:
    """A bound graph ready for repeated execution."""

    def __init__(self, output_node: MethodNode, max_inflight: int = 8):
        from . import api
        from .core.control_plane import ActorState

        self._rt = api._auto_init()
        self._max_inflight = max_inflight
        # topological order (args precede their consumers)
        self._nodes: List[MethodNode] = []
        seen: Dict[int, bool] = {}

        def visit(node):
            if not isinstance(node, MethodNode) or id(node) in seen:
                return
            seen[id(node)] = True
            for a in node.args:
                visit(a)
            self._nodes.append(node)

        visit(output_node)
        if not self._nodes:
            raise ValueError("compiled DAG needs at least one bound method")
        self._output_node = output_node
        self._is_output = {id(n): n is output_node for n in self._nodes}
        # resolve each node's agent once (the "compile": no per-call lookup);
        # actor creation is async, so wait for the actor to be ALIVE: its
        # node is recorded at STARTING, but the agent's runner exists only
        # once __init__ finishes
        self._agents = {}
        for node in self._nodes:
            deadline = time.monotonic() + 30.0
            while True:
                info = self._rt.control_plane.get_actor(node.handle._actor_id)
                if (info is not None and info.node_id is not None
                        and info.state is ActorState.ALIVE):
                    break
                if info is not None and info.state is ActorState.DEAD:
                    raise ValueError(f"actor for {node.method} is dead")
                if time.monotonic() > deadline:
                    raise ValueError(
                        f"actor for {node.method} never became alive"
                    )
                time.sleep(0.005)
            self._agents[id(node)] = self._rt.agents[info.node_id]
        if any(getattr(a, "is_remote", False) for a in self._agents.values()):
            raise NotImplementedError(f"CompiledDAG: {_A5C_REMOTE}")
        # one channel per (producer-or-input -> consumer-arg) edge
        self._input_edges: List[Any] = []       # InputNode fan-out
        self._in_channels: Dict[int, List[Tuple[int, Any]]] = {
            id(n): [] for n in self._nodes
        }  # node -> [(arg_index, channel)]
        self._out_channels: Dict[int, List[Any]] = {
            id(n): [] for n in self._nodes
        }
        for node in self._nodes:
            for i, a in enumerate(node.args):
                if isinstance(a, InputNode):
                    ch = Channel(max_inflight)
                    self._input_edges.append(ch)
                    self._in_channels[id(node)].append((i, ch))
                elif isinstance(a, MethodNode):
                    ch = Channel(max_inflight)
                    self._out_channels[id(a)].append(ch)
                    self._in_channels[id(node)].append((i, ch))
        # bind-once: closures are execution-independent (per-execution state
        # travels in the envelopes), so build them at compile time
        self._closures = [self._make_closure(n) for n in self._nodes]

    def _make_closure(self, node: MethodNode):
        in_chs = self._in_channels[id(node)]
        out_chs = self._out_channels[id(node)]
        is_output = self._is_output[id(node)]
        literals = list(node.args)
        method = node.method

        def run(instance):
            args = literals[:]
            err: Optional[_Err] = None
            result_ch: Optional[Channel] = None
            for i, ch in in_chs:
                env = ch.get()
                result_ch = env.result_ch  # same execution on every edge
                if isinstance(env.value, _Err):
                    err = env.value
                args[i] = env.value
            if err is None:
                try:
                    out = getattr(instance, method)(*args)
                except BaseException as e:  # noqa: BLE001 — user method
                    out = _Err(e)
            else:
                out = err  # propagate upstream failure past this node
            env = _Envelope(result_ch, out)
            for ch in out_chs:
                try:
                    ch.put(env, timeout=300.0)
                except queue.Full:
                    # downstream wedged (dead actor mid-pipeline): drop the
                    # envelope so this actor's lane survives; the execution's
                    # ref.get() will time out. The DAG needs rebuilding.
                    logger.error("compiled DAG channel wedged; dropping item")
            if is_output and result_ch is not None:
                result_ch.put(env.value)

        return run

    def execute(self, *args) -> DAGRef:
        """Push one input through the graph; returns immediately."""
        if len(args) != 1 and self._input_edges:
            raise TypeError("compiled DAG takes exactly one input")
        for node in self._nodes:  # fail BEFORE mutating channel state
            info = self._rt.control_plane.get_actor(node.handle._actor_id)
            if info is None or getattr(info.state, "value", "") == "DEAD":
                raise RuntimeError(
                    f"compiled DAG actor for {node.method} is dead; rebuild"
                )
        result_ch = Channel(1)
        env = _Envelope(result_ch, args[0] if args else None)
        for ch in self._input_edges:
            try:
                ch.put(env, timeout=60.0)
            except queue.Full:
                raise TimeoutError(
                    "compiled DAG backpressure: downstream stalled"
                ) from None
        for node, closure in zip(self._nodes, self._closures):
            self._agents[id(node)].submit_direct(node.handle._actor_id, closure)
        return DAGRef(result_ch)


def bind(handle, method: str, *args) -> MethodNode:
    return MethodNode(handle, method, args)
