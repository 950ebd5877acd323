"""Versioned, atomic checkpoints of nested dict/list trees of tensors (the
port's own copy of ``repro.checkpoint.checkpoint``, in the same layout):

    <dir>/step_<n>/    (renamed from step_<n>.tmp once complete)
        meta.json      step, and per leaf its key, file, shape and dtype
        arr_<i>.npy    one file per leaf, on the host

Leaves are keyed by ``tree.leaf_paths`` (``/``-joined paths, dict keys in
sorted order and sequence indices, as the JAX package keys them), so a tree
of the same structure written by either package restores in the other.  bf16 leaves
are written as their 16-bit patterns in a ``V2`` array, the bytes the JAX
package writes for an ``ml_dtypes.bfloat16`` array, with "bfloat16" in
``meta.json``; they are read back by that name, so no ``ml_dtypes`` is
needed.  A Python int leaf (the trainer's step) is written as an int64
scalar and restored as an int.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..tree import leaf_paths

__all__ = ["save", "save_async", "restore", "latest_step", "available_steps", "gc_incomplete"]

_BF16 = "bfloat16"


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy, and the dtype name for meta.json."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    name = str(arr.dtype)
    if name == _BF16:                          # an ml_dtypes array handed in as it is
        arr = arr.view(np.dtype("V2"))
    return arr, name


def _write(ckpt_dir: str, step: int, host: list[tuple[str, np.ndarray, str]]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": []}
    for i, (key, arr, dtype) in enumerate(host):
        fname = f"arr_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"].append({"key": key, "file": fname, "shape": list(arr.shape),
                               "dtype": dtype})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _snapshot(tree: Any) -> list[tuple[str, np.ndarray, str]]:
    return [(key, *_to_host(leaf)) for key, leaf in leaf_paths(tree)]


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous save; returns the checkpoint's directory."""
    return _write(ckpt_dir, step, _snapshot(tree))


def save_async(ckpt_dir: str, step: int, tree: Any) -> threading.Thread:
    """Non-blocking save; returns the writer thread (join() to fence).  The
    host copy is taken before the thread starts, because the train step
    updates parameters and optimizer state in place; only the file I/O runs
    on the thread, whose ``write_s`` holds the seconds it took once it has
    ended."""
    host = _snapshot(tree)

    def write() -> None:
        t0 = time.perf_counter()  # lint: allow[wallclock] the checkpoint's write time
        _write(ckpt_dir, step, host)
        thread.write_s = time.perf_counter() - t0  # lint: allow[wallclock] the checkpoint's write time

    thread = threading.Thread(target=write, daemon=True)
    thread.write_s = None
    thread.start()
    return thread


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any, device: str | torch.device | None = None) -> Any:
    """A tree of ``like``'s structure holding checkpoint ``step``: each
    tensor leaf on ``device``, by default the device of the leaf it
    replaces (``like`` may then lie on the meta device), in the
    checkpoint's dtype, each int leaf an int.  Raises on a missing
    leaf or a shape that differs."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in meta["leaves"]}

    def build(tree: Any, key: str) -> Any:
        if isinstance(tree, dict):
            return {k: build(v, f"{key}/{k}" if key else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, f"{key}/{i}" if key else str(i)) for i, v in enumerate(tree))
        if tree is None:
            return None
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        ent = by_key[key]
        arr = _load(os.path.join(d, ent["file"]), ent["dtype"])
        expect = tuple(getattr(tree, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {key!r}: checkpoint shape {tuple(arr.shape)} != expected {expect}")
        if isinstance(tree, int):
            return int(arr)
        return arr.to(device if device is not None else getattr(tree, "device", "cpu"))

    return build(like, "")


def gc_incomplete(ckpt_dir: str) -> int:
    """Remove interrupted .tmp checkpoints; returns count removed."""
    if not os.path.isdir(ckpt_dir):
        return 0
    n = 0
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name))
            n += 1
    return n
