"""Training: the trainer (``train.trainer``: the train step, AdamW, the
synthetic data pipeline, checkpoints with resume and rollback, the control
plane), on one card or on a mesh of ranks.  Counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch ARCH [--smoke] \
        [--steps 100 --seq-len 128 --global-batch 8 --lr 3e-4] \
        [--ckpt-dir DIR --ckpt-every 50] [--seed 0] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch ARCH --mesh 4,1,1 [--sync geococo --density 0.1] \
        [--control [--control-noise 0.1]] ...

``ARCH`` is one of ``configs.registry.ARCHS``.  Parameters are drawn from a
``torch.Generator`` seeded with ``--seed`` on the device, the same on every
rank; batch ``i`` comes from ``data.pipeline.make_batch`` with the same
seed, and under a mesh each rank trains on its rows of it.  ``--mesh
P,D,M`` runs one process a rank (``torchrun`` sets the world, of P x D x M
ranks): each keeps its blocks of the parameters, of AdamW's state and of
the residuals (``train.train_step``), the gradients synchronised across the
pods by ``--sync`` (flat / hier / geococo, ``--density`` for geococo's
top-k); with ``model`` above 1 the attention heads and an MoE's experts
are split over ``model``.  ``--control`` (with more than one pod, as in the
reference) attaches a ``control.ControlPlane`` over the first P regions of
``core.latency.aws_latency_matrix`` under a jitter trace from ``--seed``,
probed through full-mesh EWMA monitoring with ``--control-noise``: its
events move hier's and geococo's relay ring, and rank 0 prints the plane's
summary after the run.  With ``--ckpt-dir`` the run resumes from the latest
complete checkpoint there, as the reference's ``maybe_resume`` does, and
saves every ``--ckpt-every`` steps.  Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..control import ControlPlane, MonitorView, TraceView
from ..core.latency import aws_latency_matrix, jitter_trace
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..dist.collectives import SyncConfig
from ..launch.mesh import check_mesh_shape, make_mesh
from ..optim.adamw import AdamWConfig
from ..train.train_step import TrainConfig, build_train_step  # noqa: F401  (re-exported)
from ..train.trainer import StatePlacement, Trainer, TrainerConfig

__all__ = ["StatePlacement", "train", "control_plane", "main"]


def _trainer(cfg: ModelConfig, tcfg: TrainConfig, data_cfg: DataConfig, steps: int, *,
             ckpt_dir: str | None, ckpt_every: int, seed: int,
             device: str | torch.device | None, log_every: int, mesh,
             control=None) -> Trainer:
    """A :class:`Trainer` for ``steps`` steps, resumed from ``ckpt_dir``'s
    latest checkpoint where there is one.  Raises ``NotImplementedError``
    for a model that reads frames or an image context: the data pipeline,
    as the reference's ``SyntheticLM`` (``src/repro/data/pipeline.py``),
    yields tokens only."""
    if cfg.frontend != "token" or cfg.n_img_tokens:
        raise NotImplementedError(
            f"{cfg.name} reads {'frames' if cfg.frontend != 'token' else 'an image context'}; "
            "the synthetic data pipeline yields tokens only, so it does not train yet")
    run_cfg = TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            log_every=log_every, seed=seed)
    trainer = Trainer(cfg, mesh, tcfg, run_cfg, data_cfg, control=control, device=device)
    if trainer.maybe_resume() and log_every and trainer.rank == 0:
        print(f"resumed from step {trainer.step_idx}")
    return trainer


def train(cfg: ModelConfig, tcfg: TrainConfig, data_cfg: DataConfig, steps: int, *,
          ckpt_dir: str | None = None, ckpt_every: int = 50, seed: int = 0,
          device: str | torch.device | None = None,
          log_every: int = 0, mesh=None) -> list[dict[str, float]]:
    """Train to ``steps`` optimizer steps in all and return one record per
    step run here: {"step", "loss", "grad_norm", "lr", "dt"} (and under a
    mesh of several ranks the step's parts and wire counts, see
    ``build_train_step``), ``dt`` the host time of the step, ending in a
    device synchronise (batch generation outside it).

    A :class:`~repro_torch.train.trainer.Trainer`, resumed and run: every
    rank draws the same whole parameters and keeps its blocks, freeing the
    rest before step 1 (:class:`StatePlacement`).  With ``ckpt_dir`` the
    run resumes from the latest checkpoint complete for every pod, which
    may have been written on another mesh, and saves every ``ckpt_every``
    steps."""
    return _trainer(cfg, tcfg, data_cfg, steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                    seed=seed, device=device, log_every=log_every, mesh=mesh).run()


def control_plane(n_pods: int, steps: int, seed: int, noise: float) -> ControlPlane:
    """The reference CLI's plane: the first ``n_pods`` AWS-style regions
    under jitter (``max(steps, 2)`` frames from ``seed``), observed through
    full-mesh EWMA probing with ``noise`` (its generator from ``seed + 1``),
    not ground truth."""
    base = aws_latency_matrix()[:n_pods, :n_pods]
    trace = jitter_trace(base, max(steps, 2), np.random.default_rng(seed))
    view = MonitorView(TraceView(trace), noise=noise, rng=np.random.default_rng(seed + 1))
    return ControlPlane(view)


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
    ap.add_argument("--control", action="store_true",
                    help="attach a ControlPlane: a monitored inter-pod latency trace drives "
                         "relay_psum's ring order and replans through typed network events")
    ap.add_argument("--control-noise", type=float, default=0.10,
                    help="probe noise sigma for the monitored view")
    args = ap.parse_args(argv)
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
    n_pods = 1 if shape is None else shape[0]
    control = (control_plane(n_pods, args.steps, args.seed, args.control_noise)
               if args.control and n_pods > 1 else None)
    try:
        trainer = _trainer(cfg, tcfg, data_cfg, args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, seed=args.seed, device=device,
                           log_every=10, mesh=mesh, control=control)
        hist = trainer.run()
        if trainer.rank == 0:
            if hist:
                print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
                      f"{len(hist)} steps on {device}, {n_pods} pod(s), sync "
                      f"{sync.strategy}, mesh {','.join(map(str, shape or (1, 1, 1)))}")
            if control is not None:
                print(f"control plane: {control.round} rounds, {control.replan_count} "
                      f"replans, relay order {control.relay_order}, events "
                      f"{control.event_counts()}, probe traffic {control.probe_bytes} B; "
                      f"step rebuilds {trainer.sync_rebuilds}")
    finally:
        if owns_group:
            dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
