"""Build and load the port's CUDA kernels (route: nvcc -> .so -> ctypes).

Each `ffrnet_torch/csrc/<name>.cu` is compiled by `nvcc` for `sm_90a`
into its own shared library with a plain C interface, at first use, into
`ffrnet_torch/_build/` (listed in `.gitignore`). A library's file name
carries a hash of its sources and flags, so an edited kernel rebuilds and
an unchanged one is reused. `build_all()` starts one `nvcc` per source,
all at once, and waits for every one of them. Processes that build at
once (the ranks of a data-parallel run) take turns on a file lock in the
build directory, so the first builds and the others find its libraries;
each library appears by an atomic rename, never half-written.

There is no fallback: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
KERNELS = ("se_gating", "self_similarity", "channel_branch", "warp", "int8_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/"
        "bin): the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of kernel `name` lives for the current sources."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every library of `names` that is not built yet, one nvcc
    each, in parallel. Returns the wall seconds spent; raises on failure."""
    t0 = time.perf_counter()
    if all(library_path(n).exists() for n in names):
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _build((n for n in names if not library_path(n).exists()), nvcc)
    return time.perf_counter() - t0


def _build(todo, nvcc: str) -> None:
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, out, tmp, proc in procs:  # wait for all, even after a failure
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n"
                            f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry point `symbol` of kernel library `name`, built if needed.

    Its signature is `n_ptrs` pointers, `n_ints` ints, then the stream; it
    returns a cudaError_t as int. Pointers and the stream are c_void_p, or
    ctypes would pass them as 32-bit ints.
    """
    key = (name, symbol)
    fn = _loaded.get(key)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _loaded[key] = fn
    return fn


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {rc}")


def stream_handle(device) -> int:
    """PyTorch's current stream on `device`, as the C functions take it."""
    return torch.cuda.current_stream(device).cuda_stream
