"""Kernel dispatch for the PyTorch port: hand-written CUDA kernels on the
card, their plain PyTorch versions on the CPU.

One rule, decided by where a wrapper's tensors lie (`use_kernel`):
CUDA tensors launch the kernel, or the wrapper raises; CPU tensors take
the kernel's plain version. There is no environment override and no
fallback from a failed launch to the plain version.

The kernels are CUDA C++ for sm_90a in ray_tpu_torch/csrc/*.cu, each with a
plain C entry point that returns the launch's cudaError_t. `library()`
builds them at first use (one nvcc per source, all started together, then
one link) into ray_tpu_torch/_build/<hash of sources and flags>/ and loads
the shared library with ctypes. Nothing here includes PyTorch's headers, so
a build takes seconds.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a run can
reset the counts, drive a path, and read which kernels that path ran. A
wrapper called while a CUDA graph is being captured launches nothing:
`recording_launches` takes what such a capture counted back out of
`LAUNCHES` and keeps it, and each replay of the graph adds it once
(`add_launches`), to `LAUNCHES` and to `REPLAYED`, so that a path's eager
launches are the difference (`eager_launch_counts`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libray_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType

KERNELS = ("rms_norm", "rms_norm_bwd", "flash_attention", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "paged_attention_decode", "paged_attention_chunk",
           "paged_attention_verify")
# per kernel, and for K2 also the launches that wrote the lse residual
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS + ("flash_attention_lse",)}
# the share of LAUNCHES that graph replays added
REPLAYED: Dict[str, int] = dict(LAUNCHES)
_launch_lock = threading.Lock()
# the launches of a graph capture in progress on this thread
# (recording_launches); other threads' launches count as usual meanwhile
_recording = threading.local()
# this thread's own launches while a tally is open (tallying_launches)
_tally = threading.local()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argtypes (the stream is the last pointer of each)
_SIGNATURES = {
    "rtt_rms_norm": (_P, _P, _P, _I, _I, _F, _I, _I, _P),
    "rtt_rms_norm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    "rtt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _LL, _LL, _LL, _LL, _LL, _LL, _I, _F, _I, _P),
    "rtt_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _LL, _LL, _LL, _LL, _LL, _LL, _I, _F, _I, _P),
    "rtt_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _LL, _LL, _LL, _LL, _LL, _LL, _I, _F, _I, _P),
    "rtt_paged_attention_decode": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _I, _P),
    "rtt_paged_attention_chunk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _I, _P),
    "rtt_paged_attention_verify": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# filled by the build: seconds it took (0.0 when the library was already
# built) and the path of nvcc's log, which holds ptxas' register report
BUILD_INFO: Dict[str, object] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card and no explicit device this raises; it never
    falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the card (launch the kernel), False when
    they lie on the CPU (take the plain version). Mixed devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs on mixed or unsupported devices: {kinds}")


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code


def check_kv_layout(name: str, *tensors: torch.Tensor) -> None:
    """The attention kernels move K/V rows in 16-byte loads (csrc/common.cuh
    KVStager): each tensor needs a 16-byte aligned base, a unit stride on
    its last axis, and a last dimension and other strides that are
    multiples of 16 bytes. Raises ValueError otherwise."""
    for t in tensors:
        ve = 16 // t.element_size()
        if (t.data_ptr() % 16 or t.stride(-1) != 1 or t.shape[-1] % ve
                or any(s % ve for s in t.stride()[:-1])):
            raise ValueError(
                f"{name}: the kernel reads K/V in 16-byte loads and needs a 16-byte "
                f"aligned base, a unit last stride, and a head_dim and strides that "
                f"are multiples of {ve} elements; got shape {tuple(t.shape)}, "
                f"strides {t.stride()}, base offset {t.data_ptr() % 16} bytes")


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = REPLAYED[name] = 0


def launch_counts() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def eager_launch_counts() -> Dict[str, int]:
    """The launches the wrappers made themselves, outside any graph."""
    with _launch_lock:
        return {name: n - REPLAYED[name] for name, n in LAUNCHES.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph: `counts` as
    `recording_launches` recorded them at its capture."""
    with _launch_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n
            REPLAYED[name] += n


@contextlib.contextmanager
def recording_launches():
    """Around a graph capture: yields a dict that, when the block ends,
    holds the launches the wrappers made on this thread inside it, which
    never reach `LAUNCHES` (a capture enqueues nothing; its replays
    launch). Other threads, such as other engines' serving threads, count
    their launches as usual meanwhile."""
    counts: Dict[str, int] = {}
    _recording.counts = counts
    try:
        yield counts
    finally:
        _recording.counts = None


@contextlib.contextmanager
def tallying_launches():
    """Yields a dict that, while the block runs, counts the launches the
    wrappers make on this thread, which count in `LAUNCHES` as usual. So
    work that shares the card with other threads (trials of a tune run)
    can read its own launches."""
    counts: Dict[str, int] = {}
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build at first "
                           "use and need the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def build_dir() -> Path:
    """Build directory keyed by a hash of every source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless this exact source
    set is already built; returns the library's path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, log=str(out_dir / "build.log"))
        return lib_path
    nvcc = _nvcc()
    t0 = time.monotonic()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cu, _ = _sources()
    procs = []
    for src in cu:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log))
    try:
        tmp.rename(out_dir)  # atomic publish; a concurrent builder may win
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.monotonic() - t0,
                      log=str(out_dir / "build.log"))
    return lib_path


def load(path) -> ctypes.CDLL:
    """A built kernel library with its entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rtt_error_string.argtypes = [ctypes.c_int]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is not None:  # launches skip the lock once the library is loaded
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def launch(kernel: str, entry: str, device: torch.device, *args, also: str = "") -> None:
    """Call C entry point `entry` on `device`'s current stream, raise on a
    refused launch, and count one launch of `kernel` (and of the variant
    counter `also`, when given)."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = getattr(lib, entry)(*args, stream)
    else:  # the launch goes to the host thread's current device
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: "
                           f"{lib.rtt_error_string(err).decode()}")
    recording = getattr(_recording, "counts", None)
    if recording is not None:
        for name in (kernel, also) if also else (kernel,):
            recording[name] = recording.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[kernel] += 1
        if also:
            LAUNCHES[also] += 1
    tally = getattr(_tally, "counts", None)
    if tally is not None:
        for name in (kernel, also) if also else (kernel,):
            tally[name] = tally.get(name, 0) + 1
