"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with `ctypes`; pointers and the
stream travel as ``c_void_p``.  Libraries live in ``_build/`` next to the
package, named by a hash of the source, the headers it may include and the
flags, so a stale library is never loaded.  A failed build raises with
``nvcc``'s output: nothing here falls back to a plain PyTorch path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: ``--fmad=false``: no multiply-add contraction, so each kernel rounds
#: exactly like its plain PyTorch version (separate multiply and add).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output (incl. ``-Xptxas -v`` register/shared-memory report) per
#: source built by this process, and its wall time in seconds.
build_logs: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit."
    )


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent ranks never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{build_logs[name]}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


_entries: dict = {}


def entry(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (it returns a
    ``cudaError_t``), with its ctypes signature set once."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _entries[(name, symbol)] = fn
    return fn


def resident_blocks(name: str, itemsize: int, n1: int, n2: int, k: int, by: int, bz: int) -> int:
    """Blocks of kernel ``csrc/<name>.cu`` resident per SM for this item
    size, (n1, n2), k and (by, bz) tile (its ``igg_<name>_occupancy`` entry,
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`; needs the card)."""
    fn = entry(name, f"igg_{name}_occupancy", [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    check(name, fn(itemsize, n1, n2, k, by, bz, ctypes.byref(blocks)), f"{name} occupancy")
    return blocks.value


def check(name: str, code: int, what: str) -> None:
    """Raise if a C entry of ``csrc/<name>.cu`` returned a non-zero
    ``cudaError_t``."""
    if code != 0:
        lib = load(name)
        lib.igg_cuda_error_string.restype = ctypes.c_char_p
        lib.igg_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.igg_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
