"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source under ``kernels/csrc/`` exposes a plain C function.
It is compiled on first use into ``kernels/build/`` (one shared library
per source, named by a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is never served from a stale
library) and loaded with ctypes. No
PyTorch header is compiled, which keeps a cold build to seconds.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
_BUILDING: dict[str, threading.Lock] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or "
                       "/usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers of ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built; a
    second caller of the same name waits for the first's compile."""
    with _LOCK:
        lock = _BUILDING.setdefault(name, threading.Lock())
    with lock:
        return _build(name, verbose)


def _build(name: str, verbose: bool) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, out)    # atomic: no builder ever sees half a library
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
    if lib is None:
        path = build(name)
        with _LOCK:
            lib = _LOADED.get(name) or ctypes.CDLL(str(path))
            _LOADED[name] = lib
    return lib
