"""Parent-death watchdog for helper processes.

The port's copy of ray_tpu/core/_pdeathsig.py. Chaos tests and crashed
drivers SIGKILL the runtime process; without a watchdog its
multiprocessing forkserver + resource-tracker daemons reparent to init
and live on.

Why NOT prctl(PR_SET_PDEATHSIG): that signal fires when the creating
THREAD exits, not the process — the forkserver is often booted from a
short-lived warmup thread, so the arm would kill it moments later (and a
forkserver lazily booted from a worker thread would cascade-kill every
live worker when that thread ends). A ppid watchdog has process-level
semantics: when the parent PROCESS dies, the child reparents (ppid
flips, typically to 1/subreaper) and the watchdog exits this process.

Used as a multiprocessing forkserver PRELOAD (import side effect arms
the watchdog inside the forkserver — the only hook multiprocessing
offers into that process) and called explicitly from pool-worker and
actor-process entry points. The cascade: runtime dies -> forkserver's
watchdog exits it -> each worker's parent (the forkserver) is gone ->
their watchdogs exit them -> the resource tracker's pipe closes -> it
exits on its own. The forkserver is one per interpreter: where the
reference package booted it first, its preload is the one that ran, so
the entry points never rely on this module's preload.
"""

from __future__ import annotations

import os
import threading


def set_pdeathsig(_sig: int = 15, poll_s: float = 1.0) -> bool:
    """Arm a die-with-parent watchdog for THIS process (name kept for the
    call sites; implemented as a ppid poll, see module docstring)."""
    parent = os.getppid()
    if parent <= 1:
        return False  # already orphaned or direct init child: nothing to watch

    def watch() -> None:
        while True:
            if os.getppid() != parent:
                os._exit(1)  # parent died: no cleanup, just stop existing
            threading.Event().wait(poll_s)

    t = threading.Thread(target=watch, daemon=True, name="parent-watchdog")
    t.start()
    return True


# forkserver preload hook: importing this module inside the forkserver
# (multiprocessing.set_forkserver_preload) arms the watchdog there
set_pdeathsig()
