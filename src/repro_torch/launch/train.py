"""Training: the train step, AdamW, the synthetic data pipeline and
checkpoints with resume, on one card or across pods.  Counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch ARCH [--smoke] \
        [--steps 100 --seq-len 128 --global-batch 8 --lr 3e-4] \
        [--ckpt-dir DIR --ckpt-every 50] [--seed 0] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node P -m repro_torch.launch.train \
        --arch ARCH --mesh P,1,1 [--sync geococo --density 0.1] ...

``ARCH`` is one of ``configs.registry.ARCHS``.  Parameters are drawn from a
``torch.Generator`` seeded with ``--seed`` on the device, the same on every
pod; batch ``i`` comes from ``data.pipeline.make_batch`` with the same seed,
and under a mesh each pod trains on its rows of it.  ``--mesh P,1,1`` runs
one process per pod (``torchrun`` sets the world), the gradients
synchronised by ``--sync`` (flat / hier / geococo, ``--density`` for
geococo's top-k); a mesh that shards within a pod is refused (in-pod
sharding, 6b-ii), as are ``--control`` and ``--control-noise`` (the
trainer slice, 6c).  With ``--ckpt-dir`` the run resumes from the latest
complete checkpoint there, as the reference trainer's ``maybe_resume``
does, and saves every ``--ckpt-every`` steps.  Only pod 0 prints.
"""

from __future__ import annotations

import argparse
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
from ..dist.grouping import zero_residuals
from ..launch.mesh import check_mesh_shape, make_mesh
from ..models.model import cast_params_, init_params
from ..optim.adamw import AdamWConfig, adamw_init
from ..train.train_step import TrainConfig, build_train_step

__all__ = ["train", "main"]

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
    group = mesh.get_group("pod")
    return dist.get_rank(group), dist.get_world_size(group)


def _resume_step(ckpt_dirs: list[str], mesh) -> int | None:
    """The latest step complete in every directory this pod reads, agreed
    over the pods (the least of their latest)."""
    common = set.intersection(*(set(available_steps(d)) for d in ckpt_dirs))
    last = max(common, default=-1)
    if mesh is not None and _pods(mesh)[1] > 1:
        t = torch.tensor([last])
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.get_group("pod"))
        last = int(t)
    return None if last < 0 else last


def train(cfg: ModelConfig, tcfg: TrainConfig, data_cfg: DataConfig, steps: int, *,
          ckpt_dir: str | None = None, ckpt_every: int = 50, seed: int = 0,
          device: str | torch.device | None = None,
          log_every: int = 0, mesh=None) -> list[dict[str, float]]:
    """Train to ``steps`` optimizer steps in all and return one record per
    step run here: {"step", "loss", "grad_norm", "lr", "dt"} (and under a
    mesh of several pods the step's parts and wire counts, see
    ``build_train_step``), ``dt`` the host time of the step, ending in a
    device synchronise (batch generation outside it).

    The state saved and restored is the reference trainer's tree {"params",
    "opt", "step"}, with "residuals" (f32, in the reference's grouped
    layout) when ``tcfg.sync`` carries them.  Under a mesh every pod draws
    the same parameters and the same global batch and keeps its own
    residuals: pod 0 writes the tree to ``ckpt_dir``, pod p > 0 its
    {"residuals", "step"} to ``ckpt_dir/pod{p}``; a resume reads the
    parameters and optimizer state from ``ckpt_dir`` and each pod's
    residuals as its own."""
    device = resolve_device(device)
    pod, n_pods = _pods(mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = cast_params_(init_params(cfg, gen, device), tcfg.param_dtype)
    state = {"params": params, "opt": adamw_init(params, tcfg.optim), "step": 0}
    if tcfg.sync.needs_residuals:
        state["residuals"] = zero_residuals(cfg, device)
    own_dir = ckpt_dir if ckpt_dir is None or pod == 0 else os.path.join(ckpt_dir, f"pod{pod}")
    if ckpt_dir is not None:
        gc_incomplete(own_dir)
        last = _resume_step([ckpt_dir, own_dir], mesh)
        if last is not None:
            shared = {k: v for k, v in state.items() if pod == 0 or k != "residuals"}
            state.update(restore(ckpt_dir, last, shared))
            if pod > 0 and "residuals" in state:
                state.update(restore(own_dir, last, {"residuals": state["residuals"]}))
            if log_every and pod == 0:
                print(f"resumed from step {state['step']}")
    step_fn = build_train_step(cfg, tcfg, device, mesh)
    history: list[dict[str, float]] = []
    pending = None
    while state["step"] < steps:
        if n_pods > 1:
            batch = make_batch(data_cfg, state["step"])     # the step moves its pod's rows
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
            mine = state if pod == 0 else {"residuals": state.get("residuals"),
                                           "step": state["step"]}
            pending = save_async(own_dir, state["step"], mine)
        if log_every and pod == 0 and (state["step"] % log_every == 0 or state["step"] == steps):
            print(f"step {state['step']:5d}  loss {rec['loss']:.4f}  "
                  f"gnorm {rec['grad_norm']:.3f}  {dt * 1e3:.0f} ms")
    if pending is not None:
        pending.join()
    if n_pods > 1:          # every pod's checkpoint is complete before any pod reads one
        dist.barrier(group=mesh.get_group("pod"))
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
                    help="pod,data,model: P,1,1 with one process per pod (torchrun)")
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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(sync=sync,
                       optim=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                         warmup_steps=max(args.steps // 20, 5)))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    device = resolve_device(args.device)
    owns_group = shape is not None and shape[0] > 1 and not dist.is_initialized()
    mesh = make_mesh(shape, device=device)[0] if shape is not None and shape[0] > 1 else None
    try:
        hist = train(cfg, tcfg, data_cfg, args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, seed=args.seed, device=device,
                     log_every=10, mesh=mesh)
        pod, n_pods = _pods(mesh)
        if hist and pod == 0:
            print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
                  f"{len(hist)} steps on {device}, {n_pods} pod(s), sync {sync.strategy}")
    finally:
        if owns_group:
            dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
