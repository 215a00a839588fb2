"""Checkpoints: directory-backed handles + pytree IO.

Reference analogue: `python/ray/train/_checkpoint.py :: Checkpoint` and
`train/_internal/storage.py :: StorageContext`.

The port's copy of ray_tpu/train/checkpoint.py. The reference writes
pytrees through orbax, a JAX library; the port writes its own format
(`save_pytree`): a `manifest.json` with the tree's structure (nested
dicts, lists and tuples) and, for each leaf, its kind, shape, dtype and
byte count, then one raw file per leaf, written from a host copy. Leaves
may be torch tensors (a bf16 leaf is stored as its raw 2-byte words),
numpy arrays or scalars, Python scalars or None; a numpy array of an
extension dtype that numpy holds as raw bytes (ml_dtypes' bfloat16) is
stored as, and comes back as, a torch tensor of that dtype.
`load_pytree` gives the same tree back bit for bit. The two formats do not
read each other. Restoring onto another layout (`shardings=`) waits for the
meshes of ROADMAP A7b.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.dispatch import resolve_device

_METADATA_FILE = ".ray_tpu_checkpoint.json"


class Checkpoint:
    """A directory full of files, with optional metadata."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.path.expanduser(path))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: str) -> str:
        dest = os.path.abspath(os.path.expanduser(dest))
        if dest != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint({self.path})"


# ---------------------------------------------------------------------------
# Cluster-wide restore (object-plane broadcast)
# ---------------------------------------------------------------------------


def broadcast_checkpoint(checkpoint: Checkpoint, *, timeout: float = 120.0):
    """Stage a checkpoint directory into the object plane and push it to
    every node through the collective relay tree (api.broadcast), so a
    gang restart restores from a same-host replica — zero-copy shm on
    the local node, one pipelined tree instead of N full pulls from the
    head — rather than every worker re-reading shared storage at once.
    Returns the ObjectRef to hand to `restore_checkpoint` on workers."""
    import io
    import tarfile

    from .. import api

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        tar.add(checkpoint.path, arcname=".")
    ref = api.put(buf.getvalue())
    try:
        api.broadcast(ref, timeout=timeout)
    except Exception:  # noqa: BLE001 — pre-seeding is best-effort
        pass  # workers fall back to on-demand pulls of the same ref
    return ref


def restore_checkpoint(ref, dest: str) -> Checkpoint:
    """Materialize a broadcast checkpoint (see `broadcast_checkpoint`)
    into `dest`. The get() resolves against the nearest replica — the
    local store when the broadcast reached this host."""
    import io
    import tarfile

    from .. import api

    blob = api.get(ref)
    dest = os.path.abspath(os.path.expanduser(dest))
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r") as tar:
        tar.extractall(dest)  # noqa: S202 — trusted intra-cluster payload
    return Checkpoint(dest)


# ---------------------------------------------------------------------------
# Pytree IO
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"
_FORMAT = "ray_tpu_torch.pytree"
_SCALARS = {bool: "bool", int: "int", float: "float"}


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r} in a checkpoint manifest")
    return dt


def _host_snapshot(tree: Any) -> Any:
    """A copy of `tree` on the host that no later in-place write to the
    caller's tensors or arrays can change. Card tensors go to pinned host
    memory by non-blocking copies, then one synchronize per device: when
    this returns, every copy has finished."""
    devices = set()

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        if isinstance(x, torch.Tensor):
            t = x.detach()
            if t.device.type == "cpu":
                return t.clone(memory_format=torch.contiguous_format)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            devices.add(t.device)
            return host
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True, order="C")
        return x

    out = copy(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def _write_tree(host_tree: Any, path: str, force: bool) -> int:
    """Write a host snapshot in the port's format under `path`, through a
    temporary directory renamed into place. Returns the bytes written."""
    path = os.path.abspath(os.path.expanduser(path))
    if os.path.exists(path):
        if not force:
            raise FileExistsError(f"checkpoint path {path} exists (force=False)")
        shutil.rmtree(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    leaves: List[Dict[str, Any]] = []

    def leaf_file(raw: np.ndarray, entry: Dict[str, Any]) -> Dict[str, Any]:
        entry["file"] = f"leaf_{len(leaves):05d}.bin"
        entry["nbytes"] = int(raw.nbytes)
        with open(os.path.join(tmp, entry["file"]), "wb") as f:
            f.write(memoryview(raw))
        leaves.append(entry)
        return {"leaf": len(leaves) - 1}

    def node(x):
        if isinstance(x, dict):
            if not all(isinstance(k, str) for k in x):
                raise TypeError("save_pytree: dict keys must be str")
            return {"dict": [[k, node(v)] for k, v in x.items()]}
        if isinstance(x, (list, tuple)):
            return {type(x).__name__: [node(v) for v in x]}
        if x is None:
            return {"none": None}
        if isinstance(x, torch.Tensor):
            raw = x.reshape(-1).view(torch.uint8).numpy()
            return leaf_file(raw, {"kind": "torch", "dtype": str(x.dtype).split(".")[-1],
                                   "shape": list(x.shape)})
        if isinstance(x, np.ndarray):
            if x.dtype.hasobject:
                raise TypeError("save_pytree: numpy arrays of objects are not leaves")
            if x.dtype.kind == "V":
                # an extension dtype numpy only knows as raw bytes (ml_dtypes'
                # bfloat16 reads '<V2'): kept as the torch dtype of its name,
                # so it comes back as a torch leaf of that dtype
                dt = getattr(torch, x.dtype.name, None)
                if (not isinstance(dt, torch.dtype) or x.dtype.fields is not None
                        or dt.itemsize != x.dtype.itemsize):
                    raise TypeError(f"save_pytree: numpy dtype {x.dtype.name!r} "
                                    f"({x.dtype.str}) has no torch counterpart")
                raw = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
                return leaf_file(raw, {"kind": "torch", "dtype": str(dt).split(".")[-1],
                                       "shape": list(x.shape)})
            raw = x.reshape(-1).view(np.uint8)
            return leaf_file(raw, {"kind": "numpy", "dtype": x.dtype.str,
                                   "shape": list(x.shape)})
        if isinstance(x, np.generic):
            raw = np.asarray([x]).view(np.uint8)
            return leaf_file(raw, {"kind": "numpy_scalar", "dtype": x.dtype.str,
                                   "shape": []})
        kind = _SCALARS.get(type(x))
        if kind is None:
            raise TypeError(f"save_pytree: unsupported leaf type {type(x).__name__}")
        arr = np.asarray([x], dtype={"bool": np.bool_, "int": np.int64,
                                     "float": np.float64}[kind])
        return leaf_file(arr.view(np.uint8), {"kind": kind, "dtype": arr.dtype.str,
                                              "shape": []})

    try:
        structure = node(host_tree)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"format": _FORMAT, "version": 1, "tree": structure,
                       "leaves": leaves}, f)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return sum(e["nbytes"] for e in leaves)


def save_pytree(tree: Any, path: str, *, force: bool = True) -> str:
    """Write a pytree under `path` (a directory; replaced when `force`).
    The card-to-host copy finishes before the files are written, so a
    caller may update its tensors in place as soon as this returns."""
    _write_tree(_host_snapshot(tree), path, force)
    return os.path.abspath(os.path.expanduser(path))


def _check_target(tree: Any, target: Any, where: str = "tree") -> None:
    if isinstance(target, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"load_pytree: {where} is a {type(tree).__name__}, the "
                             f"target a dict of {sorted(target)}")
        missing, extra = sorted(set(target) - set(tree)), sorted(set(tree) - set(target))
        if missing or extra:
            raise ValueError(f"load_pytree: {where} lacks the target's keys {missing} "
                             f"and has keys the target lacks {extra}")
        for k in target:
            _check_target(tree[k], target[k], f"{where}[{k!r}]")
    elif isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError(f"load_pytree: {where} does not match the target's "
                             f"{type(target).__name__} of {len(target)}")
        for i, (a, b) in enumerate(zip(tree, target)):
            _check_target(a, b, f"{where}[{i}]")
    elif hasattr(target, "shape"):
        if tuple(getattr(tree, "shape", ())) != tuple(target.shape):
            raise ValueError(f"load_pytree: {where} has shape "
                             f"{tuple(getattr(tree, 'shape', ()))}, the target "
                             f"{tuple(target.shape)}")
    elif (target is None) != (tree is None):
        raise ValueError(f"load_pytree: {where} is {tree!r}, the target {target!r}")


def _as_target(tree: Any, target: Any, dev) -> Any:
    """`tree` (checked against `target`) with its dicts in the target's key
    order and each leaf whose target leaf has a dtype cast to that dtype,
    as orbax restores a template: a torch target leaf gives a torch tensor
    on `dev`, a numpy one a numpy array."""
    if isinstance(target, dict):
        return {k: _as_target(tree[k], target[k], dev) for k in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_as_target(a, b, dev) for a, b in zip(tree, target))
    if isinstance(target, torch.Tensor):
        leaf = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.asarray(tree))
        return leaf.to(dev, target.dtype)
    if isinstance(target, (np.ndarray, np.generic)):
        arr = (tree.cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree))
        arr = arr.astype(target.dtype, copy=False)
        return arr if isinstance(target, np.ndarray) else arr[()]
    return tree


def load_pytree(
    path: str,
    target: Any = None,
    shardings: Any = None,
    device: Any = None,
) -> Any:
    """Restore a pytree written by `save_pytree`, bit for bit.

    - device: where torch leaves go (the card unless the caller names
      another; raises without a card). numpy leaves and scalars come back
      as they were saved.
    - target: a tree of the expected structure; its dict keys (in any
      order) and its leaves' shapes (anything with `.shape`) are checked,
      and a mismatch raises ValueError. The result takes the target's key
      order and each target leaf's dtype, as orbax restores a template.
    - shardings: waits for ROADMAP A7b (meshes) and raises.
    """
    if shardings is not None:
        raise NotImplementedError(
            "load_pytree(shardings=...): restoring onto a mesh layout waits for "
            "ROADMAP A7b")
    dev = resolve_device(device)
    path = os.path.abspath(os.path.expanduser(path))
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package's format")
    leaves = manifest["leaves"]
    on_card = dev.type == "cuda"

    def read(entry):
        nbytes = entry["nbytes"]
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=on_card)
        with open(os.path.join(path, entry["file"]), "rb") as f:
            if f.readinto(memoryview(buf.numpy())) != nbytes:
                raise ValueError(f"{path}/{entry['file']} is shorter than its manifest says")
        kind = entry["kind"]
        if kind == "torch":
            t = buf.to(dev, non_blocking=True) if on_card else buf
            return t.view(_torch_dtype(entry["dtype"])).reshape(entry["shape"])
        arr = buf.numpy().view(np.dtype(entry["dtype"]))
        if kind == "numpy":
            return arr.reshape(entry["shape"]).copy()
        if kind == "numpy_scalar":
            return arr[0].copy()
        return {"bool": bool, "int": int, "float": float}[kind](arr[0])

    def build(node):
        ((tag, body),) = node.items()
        if tag == "dict":
            return {k: build(v) for k, v in body}
        if tag in ("list", "tuple"):
            seq = [build(v) for v in body]
            return seq if tag == "list" else tuple(seq)
        if tag == "none":
            return None
        return read(leaves[body])

    tree = build(manifest["tree"])
    if on_card:
        torch.cuda.synchronize(dev)
    if target is not None:
        _check_target(tree, target)
        tree = _as_target(tree, target, dev)
    return tree


class AsyncCheckpointWriter:
    """Checkpoint writes on a background thread.

    `save` copies the tree to the host synchronously (card to pinned host
    memory, finished before it returns), so the training step that follows
    may update the tensors in place; only the file write overlaps later
    steps. wait() drains and raises a failed write's error. `stats` holds
    each save's {"path", "bytes", "snapshot_s", "write_s"}.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats: List[Dict[str, Any]] = []

    def save(self, tree: Any, path: str) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = _host_snapshot(tree)
        entry = {"path": path, "snapshot_s": time.perf_counter() - t0}
        self.stats.append(entry)

        def _write():
            try:
                t1 = time.perf_counter()
                entry["bytes"] = _write_tree(host_tree, path, True)
                entry["write_s"] = time.perf_counter() - t1
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# ---------------------------------------------------------------------------
# Top-k retention
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Tracks reported checkpoints, keeps top-k by score (or newest-k)."""

    def __init__(
        self,
        num_to_keep: Optional[int] = None,
        score_attribute: Optional[str] = None,
        score_order: str = "max",
    ):
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: List[Tuple[float, float, Checkpoint, Dict[str, Any]]] = []

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> None:
        if self.score_attribute and self.score_attribute in metrics:
            score = float(metrics[self.score_attribute])
            if self.score_order == "min":
                score = -score
        else:
            score = float("-inf")  # fall back to recency ordering
        self._entries.append((score, time.monotonic(), checkpoint, dict(metrics)))
        if self.num_to_keep is not None and len(self._entries) > self.num_to_keep:
            self._entries.sort(key=lambda e: (e[0], e[1]))
            evicted = self._entries.pop(0)
            shutil.rmtree(evicted[2].path, ignore_errors=True)

    @property
    def latest(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return max(self._entries, key=lambda e: e[1])[2]

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return max(self._entries, key=lambda e: (e[0], e[1]))[2]

    def all(self) -> List[Checkpoint]:
        return [e[2] for e in self._entries]
