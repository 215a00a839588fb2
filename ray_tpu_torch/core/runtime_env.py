"""Runtime environments: per-task dependency/environment isolation.

Reference analogue: `python/ray/_private/runtime_env/` (env_vars,
working_dir, py_modules, pip plugins applied when the raylet starts a
worker for the task). TPU-native scope and its honest limits:

- **CPU pool tasks**: full support. The runtime_env ships with the task
  payload; the worker process applies env_vars / working_dir (chdir +
  sys.path) / py_modules / pip (cached per-hash install dir prepended to
  sys.path) around the call and restores afterwards — workers execute
  tasks serially, so scoped mutation is race-free.
- **Jobs** (`job_submission`): env_vars + working_dir on the entrypoint
  subprocess (already supported there; this module is the shared schema).
- **Device tasks and actors**: REJECTED with a clear error. They execute
  in the device-owning process by design (node_agent docstring); mutating
  that process's env/cwd would leak across every concurrent task. The
  reference can isolate these because every actor gets its own worker
  process — that is the documented gap, not silently dropped config.
- **Streaming tasks**: applied in-process (a generator cannot cross the
  pool boundary incrementally) under a process-wide mutual-exclusion lock
  (`_apply_lock`) held for the stream's whole lifetime, so concurrent
  appliers can never corrupt each other's save/restore. Two consequences:
  unrelated tasks in the same process can observe the env for the
  stream's duration (visibility, not corruption, is the accepted
  in-process limit), and one renv stream must not block on another renv
  stream's output on the same node — the second stream waits for the
  lock, so such a dependency would deadlock until the consumer's timeout.
  Keep renv streams independent (or give only one of them a runtime_env).

Cross-host code shipping (reference: `runtime_env/working_dir.py` GCS
package upload): at submission the driver zips `working_dir` into the
control-plane KV (`package_working_dir`); an executing node — possibly a
JOINED host that has never seen the driver's filesystem — resolves the
`kv://<sha>` uri back into a local cached extraction (`resolve`).

pip (reference: `runtime_env/pip.py` virtualenv-per-hash): requirements
install once into a content-hashed target dir (file-locked, shared across
workers on the host) that is prepended to sys.path for the task. Local
wheel paths work offline; index-backed requirements need egress.

Schema: {"env_vars": {str: str}, "working_dir": str,
"working_dir_uri": "kv://<sha>", "py_modules": [str], "pip": [str]}.

The port's copy of ray_tpu/core/runtime_env.py. `applied(renv)` runs in
the worker process around each pool task, and for the life of an actor
process; a task or actor that runs in-process (device work, thread mode)
refuses a runtime_env, as the reference does.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import sys
import threading
import zipfile
from typing import Any, Dict, Optional

_KNOWN_KEYS = {"env_vars", "working_dir", "working_dir_uri", "py_modules", "pip"}

_PKG_KV_PREFIX = "runtime_env/pkg/"
_MAX_PKG_BYTES = 200 << 20  # refuse to stuff >200MB into the control plane


def _cache_root() -> str:
    root = os.environ.get("RAY_TPU_ENV_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "ray_tpu")
    os.makedirs(root, exist_ok=True)
    return root


class RuntimeEnvError(RuntimeError):
    pass


def validate(renv: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not renv:
        return None
    unknown = set(renv) - _KNOWN_KEYS
    if unknown:
        raise RuntimeEnvError(
            f"unknown runtime_env keys {sorted(unknown)}; "
            f"supported: {sorted(_KNOWN_KEYS)}"
        )
    wd = renv.get("working_dir")
    if wd and not renv.get("working_dir_uri") and not os.path.isdir(wd):
        raise RuntimeEnvError(f"runtime_env working_dir does not exist: {wd}")
    for p in renv.get("py_modules") or []:
        if not os.path.exists(p):
            raise RuntimeEnvError(f"runtime_env py_module path missing: {p}")
    pip = renv.get("pip")
    if pip is not None and (
        not isinstance(pip, (list, tuple))
        or not all(isinstance(r, str) for r in pip)
    ):
        raise RuntimeEnvError("runtime_env 'pip' must be a list of requirement "
                              f"strings, got {pip!r}")
    return renv


# ---------------------------------------------------------------------------
# working_dir shipping through the control-plane KV
# ---------------------------------------------------------------------------


def package_working_dir(renv: Optional[Dict[str, Any]], control_plane):
    """Driver side: zip working_dir into the KV, return a renv whose
    working_dir travels as a content-addressed kv:// uri (idempotent:
    same content -> same key, overwrite=False)."""
    if not renv or not renv.get("working_dir") or renv.get("working_dir_uri"):
        return renv
    wd = renv["working_dir"]
    if not os.path.isdir(wd):
        raise RuntimeEnvError(f"runtime_env working_dir does not exist: {wd}")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(wd):
            for name in files:
                full = os.path.join(root, name)
                zf.write(full, os.path.relpath(full, wd))
    blob = buf.getvalue()
    if len(blob) > _MAX_PKG_BYTES:
        raise RuntimeEnvError(
            f"working_dir {wd} zips to {len(blob)} bytes (> "
            f"{_MAX_PKG_BYTES}); ship big inputs through the Data layer")
    sha = hashlib.sha256(blob).hexdigest()[:32]
    control_plane.kv_put(_PKG_KV_PREFIX + sha, blob, overwrite=False)
    out = dict(renv)
    out.pop("working_dir")
    out["working_dir_uri"] = f"kv://{sha}"
    return out


def resolve(renv: Optional[Dict[str, Any]], control_plane):
    """Executing-node side: materialize kv:// working_dir uris into a
    local cached extraction, so the renv handed to the worker contains
    only local paths. Safe to call with no uri (returns renv as-is)."""
    if not renv or not renv.get("working_dir_uri"):
        return renv
    uri = renv["working_dir_uri"]
    sha = uri.split("://", 1)[1]
    dest = os.path.join(_cache_root(), "pkgs", sha)
    if not os.path.isdir(dest):
        blob = control_plane.kv_get(_PKG_KV_PREFIX + sha)
        if blob is None:
            raise RuntimeEnvError(f"working_dir package {uri} not in KV")
        import shutil
        import tempfile

        # unique tmp per extractor: two processes racing on the same sha
        # must never interleave writes into one directory
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=sha + ".", dir=os.path.dirname(dest))
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)  # atomic publish; losers of the race clean up
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
    out = dict(renv)
    out.pop("working_dir_uri")
    out["working_dir"] = dest
    return out


# ---------------------------------------------------------------------------
# pip environments (per-hash cached install dirs)
# ---------------------------------------------------------------------------


def _pip_env_dir(reqs) -> str:
    canon = "\n".join(sorted(str(r) for r in reqs))
    sha = hashlib.sha256(canon.encode()).hexdigest()[:32]
    return os.path.join(_cache_root(), "pip_envs", sha)


def ensure_pip_env(reqs) -> str:
    """Install requirements into a content-hashed target dir ONCE per
    host (file-locked against concurrent workers); returns the dir to
    prepend to sys.path. The reference builds a full virtualenv; a
    --target dir layered over the interpreter's site gives the same
    per-task dependency view without re-execing the worker."""
    import fcntl
    import subprocess

    target = _pip_env_dir(reqs)
    done = os.path.join(target, ".ray_tpu_done")
    if os.path.exists(done):
        return target
    os.makedirs(target, exist_ok=True)
    lock_path = target + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(done):
            return target
        cmd = [sys.executable, "-m", "pip", "install", "--target", target,
               "--no-input", "--disable-pip-version-check", *reqs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeEnvError(
                f"pip install failed for {list(reqs)}:\n{proc.stderr[-2000:]}")
        with open(done, "w") as f:
            f.write("ok")
    return target


# Serializes concurrent appliers in ONE process (streaming tasks in the
# node agent): interleaved save/restore of env/cwd/sys.path would corrupt
# both envs and leak the loser's values permanently. Pool workers run
# serially, so there the lock is uncontended. The residual limit — other
# non-renv tasks in the same process can OBSERVE the env while a stream
# holds it — is the documented in-process tradeoff (module docstring).
_apply_lock = threading.RLock()


@contextlib.contextmanager
def applied(renv: Optional[Dict[str, Any]]):
    """Apply a runtime_env for the duration of one task, then restore.
    Appliers are mutually exclusive per process (see _apply_lock); full
    isolation needs a worker process."""
    if not renv:
        yield
        return
    with _apply_lock:
        with _applied_locked(renv):
            yield


@contextlib.contextmanager
def _applied_locked(renv: Dict[str, Any]):
    # failure-prone setup FIRST, before any process mutation: a pip
    # install that raises must not leak env_vars into the serially-reused
    # worker (nothing below the mutations may raise outside the finally)
    pip_dir = ensure_pip_env(renv["pip"]) if renv.get("pip") else None
    saved_env: Dict[str, Optional[str]] = {}
    for k, v in (renv.get("env_vars") or {}).items():
        saved_env[k] = os.environ.get(k)
        os.environ[k] = str(v)
    added_paths = []
    modules_before = set(sys.modules)
    if pip_dir is not None:
        sys.path.insert(0, pip_dir)
        added_paths.append(pip_dir)
    saved_cwd = None
    wd = renv.get("working_dir")
    if wd:
        saved_cwd = os.getcwd()
        os.chdir(wd)
        sys.path.insert(0, wd)
        added_paths.append(wd)
    for p in renv.get("py_modules") or []:
        sys.path.insert(0, p)
        added_paths.append(p)
    try:
        yield
    finally:
        # purge modules imported FROM the env's paths: a cached
        # sys.modules entry would leak the package (or a stale pinned
        # version) into the next task on this serially-reused worker
        for name in set(sys.modules) - modules_before:
            mod_file = getattr(sys.modules.get(name), "__file__", None) or ""
            if any(mod_file.startswith(p + os.sep) for p in added_paths):
                sys.modules.pop(name, None)
        for p in added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        if saved_cwd is not None:
            try:
                os.chdir(saved_cwd)
            except OSError:
                pass
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
