"""Training: the train step, AdamW, the synthetic data pipeline and
checkpoints with resume, on one card or on a mesh of ranks.  Counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch ARCH [--smoke] \
        [--steps 100 --seq-len 128 --global-batch 8 --lr 3e-4] \
        [--ckpt-dir DIR --ckpt-every 50] [--seed 0] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch ARCH --mesh 2,2,1 [--sync geococo --density 0.1] ...

``ARCH`` is one of ``configs.registry.ARCHS``.  Parameters are drawn from a
``torch.Generator`` seeded with ``--seed`` on the device, the same on every
rank; batch ``i`` comes from ``data.pipeline.make_batch`` with the same
seed, and under a mesh each rank trains on its rows of it.  ``--mesh
P,D,M`` runs one process a rank (``torchrun`` sets the world, of P x D x M
ranks): each keeps its blocks of the parameters, of AdamW's state and of
the residuals (``train.train_step``), the gradients synchronised across the
pods by ``--sync`` (flat / hier / geococo, ``--density`` for geococo's
top-k); with ``model`` above 1 the attention heads and an MoE's experts
are split over ``model``.  ``--control`` and ``--control-noise`` are
refused (the trainer slice, 6c).  With ``--ckpt-dir`` the run
resumes from the latest complete checkpoint there, as the reference
trainer's ``maybe_resume`` does, and saves every ``--ckpt-every`` steps.
Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint.checkpoint import available_steps, gc_incomplete, restore, save_async
from ..configs.base import ModelConfig
from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..data.pipeline import DataConfig, make_batch
from ..device import resolve_device, synchronize
from ..dist.collectives import SyncConfig
from ..dist.grouping import grouped_specs, leaf_specs, zero_residuals
from ..dist.inpod import InPodGroup
from ..dist.sharding import Spec, local_shard
from ..launch.mesh import check_mesh_shape, make_mesh
from ..models.model import cast_params_, init_params
from ..optim.adamw import AdamWConfig, adamw_init
from ..train.train_step import TrainConfig, build_train_step
from ..tree import map_paths

__all__ = ["StatePlacement", "train", "main"]

# the reference's flags that need the control plane: the slice of the port
# that brings them
_LATER = {
    "control": "the trainer slice (6c: control plane, straggler monitor)",
    "control_noise": "the trainer slice (6c: control plane, straggler monitor)",
}


def _pods(mesh) -> tuple[int, int]:
    """(this process' pod index, the number of pods)."""
    if mesh is None:
        return 0, 1
    return mesh.coords["pod"], mesh.shape["pod"]


def _rank(mesh) -> int:
    """This process' rank in the world (0 without a mesh)."""
    return 0 if mesh is None else dist.get_rank()


def _resume_step(ckpt_dirs: list[str], mesh) -> int | None:
    """The latest step complete in every directory this rank reads, agreed
    over the ranks (the least of their latest)."""
    common = set.intersection(*(set(available_steps(d)) for d in ckpt_dirs))
    last = max(common, default=-1)
    if mesh is not None and mesh.size > 1:
        t = torch.tensor([last])
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        last = int(t)
    return None if last < 0 else last


def _state_specs(cfg: ModelConfig, mesh, strategy: str) -> dict[str, Spec]:
    """The spec of every tensor leaf of the trainer's state, by its key."""
    specs = {f"{part}/{key}": spec for part in ("params", "opt/m", "opt/v")
             for key, spec in leaf_specs(cfg, mesh.shape, strategy).items()}
    specs["opt/step"] = ()
    specs.update({f"residuals/{key}": spec
                  for key, spec in grouped_specs(cfg, mesh.shape, strategy).items()})
    return specs


class StatePlacement:
    """Where this rank's share of the trainer's state lives, and how it is
    drawn, saved and restored.

    The state is the reference trainer's tree {"params", "opt", "step"},
    with "residuals" (f32, in the reference's grouped layout) when
    ``tcfg.sync`` carries them.  On a mesh whose pods hold several ranks
    each rank keeps its blocks of every leaf (``dist.sharding``); a
    checkpoint holds every leaf whole, in the layout of one process: pod
    0's first rank (``data`` 0, ``model`` 0) writes {"params", "opt",
    "step"} and pod 0's residuals to ``ckpt_dir``, the first rank of pod
    p > 0 its pod's {"residuals", "step"} to ``ckpt_dir/pod{p}``, each
    gathered over its pod's ranks.  So a checkpoint written on one mesh is
    read on another."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device: torch.device, mesh=None):
        self.cfg, self.tcfg, self.device, self.mesh = cfg, tcfg, device, mesh
        self.pod = _pods(mesh)[0]
        self.inpod = InPodGroup(mesh) if mesh is not None and mesh.size > 1 else None
        self.split = self.inpod is not None and self.inpod.size > 1
        self.specs = _state_specs(cfg, mesh, tcfg.sync.strategy) if self.split else {}
        # the rank that writes this pod's checkpoint
        self.writer = self.inpod is None or self.inpod.counts_once(())

    def own_dir(self, ckpt_dir: str) -> str:
        """The directory this rank's pod writes and reads its residuals in."""
        return ckpt_dir if self.pod == 0 else os.path.join(ckpt_dir, f"pod{self.pod}")

    def place(self, tree, prefix: str):
        """``tree``'s whole leaves (keys under ``prefix``) as this rank's
        blocks on its device."""
        if not self.split:
            return map_paths(tree, lambda key, leaf: leaf.to(self.device), prefix)
        mesh = self.mesh
        return map_paths(tree, lambda key, leaf: local_shard(leaf, self.specs[key], mesh.coords,
                                                              mesh.shape).to(self.device), prefix)

    def initial(self, seed: int) -> dict:
        """The state at step 0: parameters drawn whole on the device from
        ``seed`` (the same on every rank), this rank's blocks kept."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.place(cast_params_(init_params(self.cfg, gen, self.device),
                                         self.tcfg.param_dtype), "params")
        state = {"params": params, "opt": adamw_init(params, self.tcfg.optim), "step": 0}
        if self.tcfg.sync.needs_residuals:
            state["residuals"] = zero_residuals(self.cfg, self.device,
                                                self.mesh.shape if self.split else None,
                                                self.tcfg.sync.strategy)
        return state

    def latest(self, ckpt_dir: str) -> int | None:
        """The latest step complete in every directory this rank reads,
        agreed over the ranks, after this pod's writer removed what an
        interrupted save left."""
        if self.writer:
            gc_incomplete(self.own_dir(ckpt_dir))
        return _resume_step([ckpt_dir, self.own_dir(ckpt_dir)], self.mesh)

    def restore(self, ckpt_dir: str, step: int) -> dict:
        """Checkpoint ``step`` as this rank's state."""
        meta = init_params(self.cfg, None, "meta")
        like = {"params": meta, "opt": adamw_init(meta, self.tcfg.optim), "step": 0}
        residuals = self.tcfg.sync.needs_residuals
        if residuals and self.pod == 0:
            like["residuals"] = zero_residuals(self.cfg, "meta")
        read = restore(ckpt_dir, step, like, device="cpu")
        if residuals and self.pod > 0:
            read.update(restore(self.own_dir(ckpt_dir), step,
                                {"residuals": zero_residuals(self.cfg, "meta")}, device="cpu"))
        return {"step": read.pop("step"), **{k: self.place(v, k) for k, v in read.items()}}

    def save_async(self, ckpt_dir: str, state: dict):
        """Write ``state``'s checkpoint (every rank calls this; each pod's
        writer writes).  Returns the writer thread, or None on the others."""
        mine = state if self.pod == 0 else {"residuals": state.get("residuals"),
                                            "step": state["step"]}
        if self.split:
            mine = map_paths(mine, lambda key, leaf: (
                self.inpod.gather_to_first(leaf, self.specs[key])
                if isinstance(leaf, torch.Tensor) else leaf))
        if not self.writer:
            return None
        return save_async(self.own_dir(ckpt_dir), state["step"], mine)


def train(cfg: ModelConfig, tcfg: TrainConfig, data_cfg: DataConfig, steps: int, *,
          ckpt_dir: str | None = None, ckpt_every: int = 50, seed: int = 0,
          device: str | torch.device | None = None,
          log_every: int = 0, mesh=None) -> list[dict[str, float]]:
    """Train to ``steps`` optimizer steps in all and return one record per
    step run here: {"step", "loss", "grad_norm", "lr", "dt"} (and under a
    mesh of several ranks the step's parts and wire counts, see
    ``build_train_step``), ``dt`` the host time of the step, ending in a
    device synchronise (batch generation outside it).

    Every rank draws the same whole parameters and keeps its blocks,
    freeing the rest before step 1 (:class:`StatePlacement`).  With
    ``ckpt_dir`` the run resumes from the latest checkpoint complete for
    every pod, which may have been written on another mesh, and saves
    every ``ckpt_every`` steps."""
    device = resolve_device(device)
    step_fn = build_train_step(cfg, tcfg, device, mesh)
    where = StatePlacement(cfg, tcfg, device, mesh)
    state = where.initial(seed)
    if ckpt_dir is not None:
        last = where.latest(ckpt_dir)
        if last is not None:
            del state
            state = where.restore(ckpt_dir, last)
            if log_every and _rank(mesh) == 0:
                print(f"resumed from step {state['step']}")

    history: list[dict[str, float]] = []
    pending = None
    while state["step"] < steps:
        if mesh is not None:
            batch = make_batch(data_cfg, state["step"])     # the step moves its rank's rows
        else:
            batch = make_batch(data_cfg, state["step"], device)
        synchronize(device)
        t0 = time.perf_counter()  # lint: allow[wallclock] measured step time
        metrics = step_fn(state["params"], state["opt"], batch, state.get("residuals"))
        rec = {k: float(v) for k, v in metrics.items()}
        synchronize(device)
        dt = time.perf_counter() - t0  # lint: allow[wallclock] measured step time
        state["step"] += 1
        history.append({"step": state["step"], **rec, "dt": dt})
        if ckpt_dir is not None and state["step"] % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = where.save_async(ckpt_dir, state)
        if log_every and _rank(mesh) == 0 and (state["step"] % log_every == 0
                                               or state["step"] == steps):
            print(f"step {state['step']:5d}  loss {rec['loss']:.4f}  "
                  f"gnorm {rec['grad_norm']:.3f}  {dt * 1e3:.0f} ms")
    if pending is not None:
        pending.join()
    if mesh is not None and mesh.size > 1:  # every checkpoint is complete before any rank reads one
        dist.barrier()
    return history


def main(argv: list[str] | None = None) -> list[dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--mesh", default=None,
                    help="pod,data,model: P,D,M with one process a rank (torchrun)")
    ap.add_argument("--sync", default="hier",
                    help="registered device_sync strategy (flat/hier/geococo)")
    ap.add_argument("--density", type=float, default=0.10)
    for flag in _LATER:
        ap.add_argument("--" + flag.replace("_", "-"), default=None, nargs="?", const=True,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, slice_name in _LATER.items():
        if getattr(args, flag) is not None:
            ap.error(f"--{flag.replace('_', '-')} is not ported yet: it arrives with "
                     f"{slice_name} of the port")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        sync = SyncConfig(strategy=args.sync, density=args.density)
        shape = None
        if args.mesh is not None:
            shape = tuple(int(x) for x in args.mesh.split(","))
            world = (dist.get_world_size() if dist.is_initialized()
                     else int(os.environ.get("WORLD_SIZE", "1")))
            check_mesh_shape(shape, world)
    except ValueError as err:
        ap.error(str(err))

    tcfg = TrainConfig(sync=sync,
                       optim=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                         warmup_steps=max(args.steps // 20, 5)))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    device = resolve_device(args.device)
    ranks = 1 if shape is None else math.prod(shape)
    owns_group = ranks > 1 and not dist.is_initialized()
    mesh = make_mesh(shape, device=device)[0] if ranks > 1 else None
    try:
        hist = train(cfg, tcfg, data_cfg, args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, seed=args.seed, device=device,
                     log_every=10, mesh=mesh)
        if hist and _rank(mesh) == 0:
            print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
                  f"{len(hist)} steps on {device}, {_pods(mesh)[1]} pod(s), sync "
                  f"{sync.strategy}, mesh {','.join(map(str, shape or (1, 1, 1)))}")
    finally:
        if owns_group:
            dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
