"""Chaos harness: reusable fault injection for FT tests and examples.

The fault-injection plane SURVEY §5.3 calls for: process kills at the OS
level (`kill_head`, `kill_worker_host`) and network faults at the RPC
socket layer (`partition`), usable from pytest (`-m chaos`) and from
the reference's examples alike.

Process kills are real SIGKILLs — no cooperation from the victim, exactly
what a machine failure looks like to the rest of the cluster. Partitions
install a process-wide hook consulted by `core.wire` before every frame
send/recv in THIS process (`wire.set_fault_injector`): "drop" raises
OSError, which the reconnecting client treats as a lost connection;
"delay" sleeps, simulating a slow link. The hook blocks FRAMES, not TCP
connects — a reconnect dial during a drop partition succeeds but its
first roundtrip fails, so the process stays partitioned until heal.

The port's copy of ray_tpu/util/chaos.py, over the port's core/wire.py;
`kill_worker_host` takes a joined host's process (init(address=)).

    from ray_tpu_torch.util import chaos

    chaos.kill_head(head_proc)                      # SIGKILL + reap

    with chaos.partition(duration_s=3.0):           # all wire traffic
        ...                                         # heals on exit

    with chaos.partition(addresses={"10.0.0.7:6399"}, mode="delay",
                         delay_s=0.5):
        ...                                         # slow one peer
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from typing import Iterator, Optional, Set

from ..core.logging import get_logger
from ..core import wire

logger = get_logger("chaos")


def _pid_of(proc) -> int:
    """Accepts a subprocess.Popen, multiprocessing.Process, or raw pid."""
    return proc if isinstance(proc, int) else proc.pid


def _kill(proc, wait_s: float) -> int:
    pid = _pid_of(proc)
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        return pid  # already gone
    # reap if we own it, so the fixture does not leak a zombie
    waiter = getattr(proc, "wait", None)
    if waiter is not None:
        try:
            waiter(timeout=wait_s)
        except TypeError:
            waiter(wait_s)  # multiprocessing.Process.join-style signature
        except Exception:  # noqa: BLE001 — reaping is best-effort
            pass
    return pid


def kill_head(proc, wait_s: float = 10.0) -> int:
    """SIGKILL the head OS process (no cleanup runs — its sockets close
    via the kernel, which is what triggers client reconnects). Returns
    the pid. The caller restarts with ``init(resume_from=...)``."""
    pid = _kill(proc, wait_s)
    logger.warning("chaos: killed head pid %d", pid)
    return pid


def kill_worker_host(proc, wait_s: float = 10.0) -> int:
    """SIGKILL a joined worker-host process; the head reaps it via the
    stale-heartbeat sweep (health_check_timeout_ms). Returns the pid."""
    pid = _kill(proc, wait_s)
    logger.warning("chaos: killed worker host pid %d", pid)
    return pid


class _Fault:
    """The installed wire hook: one active fault per process (last wins)."""

    def __init__(self, mode: str, delay_s: float,
                 addresses: Optional[Set[str]], until: Optional[float]):
        self.mode = mode
        self.delay_s = delay_s
        self.addresses = addresses
        self.until = until
        self.healed = threading.Event()

    def _matches(self, sock) -> bool:
        if self.addresses is None:
            return True
        try:
            host, port = sock.getpeername()[:2]
        except OSError:
            return False
        return f"{host}:{port}" in self.addresses

    def __call__(self, sock, kind: str) -> None:
        if self.healed.is_set():
            return
        if self.until is not None and time.monotonic() >= self.until:
            self.healed.set()
            return
        if not self._matches(sock):
            return
        if self.mode == "delay":
            time.sleep(self.delay_s)
            return
        raise OSError(f"injected partition ({kind})")


def node_addresses(control_plane, node_id) -> Set[str]:
    """Resolve a node's advertised addresses (dispatch + transfer +
    channel service) from the control-plane KV, for address-scoped
    partitions. Accepts a NodeID or its hex string."""
    hexid = node_id if isinstance(node_id, str) else node_id.hex()
    addrs: Set[str] = set()
    for prefix in ("node_service/", "object_transfer/", "channel_service/"):
        val = control_plane.kv_get(prefix + hexid)
        if val:
            addrs.add(val.decode() if isinstance(val, bytes) else val)
    return addrs


@contextlib.contextmanager
def partition(node_id=None, duration_s: Optional[float] = None,
              mode: str = "drop", delay_s: float = 0.25,
              control_plane=None,
              addresses: Optional[Set[str]] = None) -> Iterator[_Fault]:
    """Partition THIS process at the RPC socket layer.

    - ``node_id`` + ``control_plane``: scope the fault to that node's
      KV-advertised addresses (see `node_addresses`).
    - ``addresses``: scope to an explicit ``{"host:port", ...}`` set.
    - neither: every wire frame in this process faults.
    - ``mode="drop"`` raises OSError per frame (connection-loss path);
      ``mode="delay"`` sleeps ``delay_s`` per frame (slow-link path).
    - ``duration_s``: auto-heal after this long; otherwise heals when the
      context exits.
    """
    if mode not in ("drop", "delay"):
        raise ValueError(f"unknown partition mode {mode!r}")
    if node_id is not None:
        if control_plane is None:
            raise ValueError("node_id-scoped partition needs control_plane")
        addresses = node_addresses(control_plane, node_id)
    until = None if duration_s is None else time.monotonic() + duration_s
    fault = _Fault(mode, delay_s, addresses, until)
    wire.set_fault_injector(fault)
    logger.warning("chaos: partition on (%s, mode=%s)",
                   "all" if addresses is None else sorted(addresses), mode)
    try:
        yield fault
        if duration_s is not None and not fault.healed.is_set():
            # the caller asked for a timed partition: hold until it expires
            remaining = until - time.monotonic()
            if remaining > 0:
                time.sleep(remaining)
    finally:
        fault.healed.set()
        wire.set_fault_injector(None)
        logger.warning("chaos: partition healed")
