"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``repro_torch/csrc/`` has a plain C interface and compiles
into its own shared library for ``sm_90a``.  A library is built at first use
into ``build/repro_torch/`` at the root of the checkout (``.gitignore`` lists
``build/``), named by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is not.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

# library name -> source under csrc/
SOURCES: dict[str, str] = {
    "wkv6": "wkv6.cu",
    "wkv6_backward": "wkv6_backward.cu",
    "rglru_scan": "rglru_scan.cu",
    "rglru_scan_backward": "rglru_scan_backward.cu",
    "whitedata_filter": "whitedata_filter.cu",
    "crdt_merge": "crdt_merge.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME/bin")


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile library ``name`` if it is missing.  Returns the compiler's
    output (``-Xptxas -v`` reports registers, shared memory and spills), or
    ``""`` when the library was already built."""
    target = _target(name)
    if target.is_file():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(target), str(CSRC / SOURCES[name])]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        target.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}")
    return out.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _LOADED:
        build(name)
        _LOADED[name] = ctypes.CDLL(str(_target(name)))
    return _LOADED[name]
