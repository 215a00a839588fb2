"""Fixtures shared by the port's test files that run flows of both
packages. A test module imports a fixture by name to use it:

    from _torch_fixtures import _fresh_metric_registries  # noqa: F401
"""

import pytest


@pytest.fixture(autouse=True)
def _fresh_metric_registries():
    """Zero both packages' metric registries after each test: the flows
    here count into them, and a later test in this process, of either
    package, that reads an absolute count must see only its own."""
    yield
    from ray_tpu.core.metrics import registry as jregistry
    from ray_tpu_torch.core.metrics import registry as tregistry

    jregistry.fresh()
    tregistry.fresh()


def descendants(pid=None) -> dict:
    """{pid: command line} of every live (not zombie) descendant of `pid`
    (this process by default), read from /proc."""
    import os

    parents, cmds = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if fields[0] != "Z":
            parents[int(entry)], cmds[int(entry)] = int(fields[1]), cmd
    root = os.getpid() if pid is None else pid
    out, frontier = {}, [root]
    while frontier:
        p = frontier.pop()
        for child, parent in parents.items():
            if parent == p and child not in out:
                out[child] = cmds[child]
                frontier.append(child)
    return out


def boot_forkserver():
    """Boot the interpreter's one forkserver with both packages preloaded,
    so the workers of either fork warm. Whichever package boots it
    otherwise decides its preload, and the other's workers then import
    their package on each fork. A server left idle by an earlier test is
    stopped first."""
    from multiprocessing import forkserver

    from ray_tpu_torch.core.process_pool import stop_forkserver

    stop_forkserver(wait_s=0.0)
    forkserver.set_forkserver_preload(
        ["ray_tpu.core._pdeathsig", "ray_tpu_torch.core._pdeathsig"])
    forkserver.ensure_running()


@pytest.fixture(scope="module")
def no_process_left():
    """Fails the module if a process it started outlives it (waiting up to
    10 s): multiprocessing's resource tracker alone may stay, since it is
    one per interpreter."""
    import time

    before = set(descendants())
    yield
    deadline = time.monotonic() + 10
    while True:
        left = {p: c for p, c in descendants().items()
                if p not in before and "resource_tracker" not in c}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    assert not left, f"processes outlived the module: {left}"
