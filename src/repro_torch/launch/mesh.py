"""The device mesh for training across pods and within them (counterpart
of ``repro.launch.mesh``), and a launcher of local ranks.

The mesh is ``(P, D, M)`` over the axes (``pod``, ``data``, ``model``),
one process a rank, the ranks at their coordinates in row-major order over
the axes, as the reference's mesh orders its devices.  Under ``torchrun``
the process group comes from the environment; :func:`run_local_ranks`
starts the ranks of one host itself, over a ``FileStore``, for the tests
and ``chip_smoke.py``.  Every rank must issue the same collectives in the
same order (a mismatch would leave gloo waiting): each collective fails
the run after the group's timeout (:data:`COLLECTIVE_TIMEOUT_S` under
``torchrun``, the ranks' own under :func:`run_local_ranks`) instead of
hanging it.  The group is gloo: its messages are host tensors, which
every rank stages to and from its device (``dist.collectives.PodGroup``),
so several ranks can share one card.  NCCL refuses two ranks on one card,
and ``DTensor`` on a gloo mesh holds no card tensors, so each rank keeps
explicit local shards (``dist.inpod``).

:func:`fake_mesh` builds one rank's view of a mesh of any size over
torch's fake process group, whose collectives move nothing: the dry-run
(``launch.dryrun``) runs one rank of the production meshes
(:func:`production_mesh_shape`) in this process on the meta device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device

__all__ = ["AXES", "COLLECTIVE_TIMEOUT_S", "Mesh", "check_mesh_shape", "make_mesh",
           "rank_coords", "run_local_ranks", "production_mesh_shape", "fake_mesh"]

AXES = ("pod", "data", "model")
COLLECTIVE_TIMEOUT_S = 600


def check_mesh_shape(shape: tuple[int, ...], world_size: int,
                     axes: tuple[str, ...] = AXES) -> None:
    """Raise ``ValueError`` on a shape that does not give every axis a size
    of at least 1, or whose size is not the world size."""
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"mesh {tuple(shape)} does not give the axes {axes} a size each")
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh {tuple(shape)} holds {math.prod(shape)} ranks, "
                         f"the world has {world_size}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: each axis' size (``shape``), this
    rank's coordinate on each axis (``coords``) and the process groups of
    the ranks it shares an axis with: ``pod``, ``data`` and ``model`` (the
    ranks that differ from this one on that axis only, from a
    ``DeviceMesh``) and ``inpod`` (this rank's pod: every rank of its
    ``pod`` coordinate, in row-major order over ``data`` and ``model``)."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, dist.ProcessGroup]

    def get_group(self, axis: str = "pod") -> dist.ProcessGroup:
        return self.groups[axis]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...] = AXES,
              device: str | torch.device | None = None
              ) -> tuple[Mesh, dict[str, dist.ProcessGroup]]:
    """The mesh of ``shape`` over the gloo process group, and its ``pod``,
    ``data``, ``model`` and ``inpod`` groups.  Initialises the group from
    the environment (``torchrun``) when none is; selects ``device`` (default
    ``cuda``; without an index, card ``LOCAL_RANK`` modulo the cards there
    are, so that the ranks of one host share a single card) as this rank's
    compute device.  The mesh's device type is the CPU: the wire is gloo
    over host buffers.  Raises on a shape :func:`check_mesh_shape` refuses."""
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if dist.get_backend() != "gloo":
        raise ValueError(f"the pod exchange runs over gloo, the process group is "
                         f"{dist.get_backend()}")
    check_mesh_shape(tuple(shape), dist.get_world_size(), tuple(axes))
    if device.type == "cuda":       # without an index: the launcher's local rank, over the cards
        torch.cuda.set_device(device.index if device.index is not None else
                              int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    groups = _mesh_groups(tuple(shape), tuple(axes))
    mesh = Mesh(dict(zip(axes, shape)), rank_coords(dist.get_rank(), dict(zip(axes, shape))),
                groups)
    return mesh, groups


def production_mesh_shape(multi_pod: bool = False, reduced: bool = False) -> tuple[int, int, int]:
    """The reference's production mesh (``repro.launch.mesh``) in the
    port's three axes: ``(16, 16)`` over (``data``, ``model``), or ``(2,
    16, 16)`` across two pods; the ``reduced`` tier ``(4, 4)`` or ``(2, 2,
    4)``, the same layout scaled down.  A single pod is ``(1, D, M)``."""
    if reduced:
        return (2, 2, 4) if multi_pod else (1, 4, 4)
    return (2, 16, 16) if multi_pod else (1, 16, 16)


def _mesh_groups(shape: tuple[int, ...], axes: tuple[str, ...]) -> dict[str, dist.ProcessGroup]:
    """The ``pod``, ``data``, ``model`` and ``inpod`` groups of a mesh of
    ``shape`` over the initialised process group."""
    device_mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
    groups = {axis: device_mesh.get_group(axis) for axis in axes}
    per_pod = math.prod(shape[1:])
    groups["inpod"], _ = dist.new_subgroups_by_enumeration(
        [list(range(p * per_pod, (p + 1) * per_pod)) for p in range(shape[0])])
    return groups


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], rank: int = 0) -> Iterator[Mesh]:
    """Rank ``rank``'s :class:`Mesh` of ``shape`` over torch's fake process
    group (``FakeStore``, backend ``"fake"``), whose collectives return at
    once and move nothing, with its groups built as :func:`make_mesh`
    builds them; the group is destroyed on exit.  Raises when a process
    group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process without a process group; one is "
                           "initialised")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape)
    check_mesh_shape(tuple(shape), world, AXES)
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        sizes = dict(zip(AXES, shape))
        yield Mesh(sizes, rank_coords(rank, sizes), _mesh_groups(tuple(shape), AXES))
    finally:
        dist.destroy_process_group()


def rank_coords(rank: int, shape: dict[str, int]) -> dict[str, int]:
    """The coordinates of ``rank`` on a mesh of ``shape`` (axis -> size, in
    the mesh's axis order): row-major, the last axis fastest."""
    coords, rest = {}, rank
    for axis, size in reversed(list(shape.items())):
        coords[axis], rest = rest % size, rest // size
    return {axis: coords[axis] for axis in shape}


def _rank_main(fn: Callable, rank: int, world_size: int, store: str, timeout: float,
               args: tuple, results: mp.Queue) -> None:
    if "OMP_NUM_THREADS" not in os.environ:     # share the host's cores, as torchrun does
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # plain pickle: tensors are copied, not shared through file descriptors
    # that die with this process
    results.put((rank, True, pickle.dumps(out)))


def run_local_ranks(fn: Callable[..., Any], world_size: int, args: tuple = (), *,
                    timeout: float = 120.0) -> list[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined in
    one gloo process group, and return their results by rank.  ``fn`` and
    ``args`` must pickle; so must the results.  A rank that raises fails the
    call with its traceback; ranks still running ``timeout`` seconds after
    the start are killed and the call raises ``TimeoutError``."""
    ctx = mp.get_context("spawn")
    results: mp.Queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, os.path.join(tmp, "store"), timeout,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done: dict[int, Any] = {}
        failed: dict[int, str] = {}
        deadline = time.monotonic() + timeout  # lint: allow[wallclock] the ranks' timeout
        try:
            while len(done) + len(failed) < world_size:
                left = deadline - time.monotonic()  # lint: allow[wallclock] the ranks' timeout
                if left <= 0:
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and r not in done and r not in failed]
                    if not dead:
                        continue
                    try:            # a failed rank's traceback may still be in the pipe
                        rank, ok, payload = results.get(timeout=5)
                    except queue.Empty:
                        failed.update({r: f"exited with code {procs[r].exitcode}" for r in dead})
                        continue
                (done if ok else failed)[rank] = payload
                if failed:          # the others' reports of the broken group follow soon
                    deadline = min(deadline, time.monotonic() + 5)  # lint: allow[wallclock] the ranks' timeout
        finally:
            for p in procs:
                p.join(timeout=0 if failed else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        raise RuntimeError("\n".join(f"rank {r} of {world_size} failed:\n{failed[r]}"
                                     for r in sorted(failed)))
    if len(done) < world_size:
        missing = sorted(set(range(world_size)) - set(done))
        raise TimeoutError(f"ranks {missing} of {world_size} did not finish in {timeout:.0f} s")
    return [pickle.loads(done[r]) for r in range(world_size)]
