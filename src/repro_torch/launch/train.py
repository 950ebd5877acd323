"""Training on one device: the train step, AdamW, the synthetic data
pipeline and checkpoints with resume.  Counterpart of
``repro.launch.train`` for one card (no mesh, no gradient sync).

    PYTHONPATH=src python -m repro_torch.launch.train --arch ARCH [--smoke] \
        [--steps 100 --seq-len 128 --global-batch 8 --lr 3e-4] \
        [--ckpt-dir DIR --ckpt-every 50] [--seed 0] [--device cpu]

``ARCH`` is one of ``configs.registry.ARCHS``.  Parameters are drawn from a
``torch.Generator`` seeded with ``--seed`` on the device; batch ``i`` comes
from ``data.pipeline.make_batch`` with the same seed.  With ``--ckpt-dir``
the run resumes from the latest complete checkpoint there, as the
reference trainer's ``maybe_resume`` does, and saves every
``--ckpt-every`` steps.  The reference's ``--mesh``, ``--sync``,
``--density`` and ``--control`` are refused: they arrive with the port's
gradient-sync and trainer slices.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.checkpoint import gc_incomplete, latest_step, restore, save_async
from ..configs.base import ModelConfig
from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..data.pipeline import DataConfig, make_batch
from ..device import resolve_device
from ..models.model import cast_params_, init_params
from ..optim.adamw import AdamWConfig, adamw_init
from ..train.train_step import TrainConfig, build_train_step

__all__ = ["train", "main"]

# the reference's flags that need a mesh or a control plane: the slice of
# the port that brings each
_LATER = {
    "mesh": "the gradient-sync slice (6b: mesh, FSDP/TP)",
    "sync": "the gradient-sync slice (6b: sync_gradients, geococo)",
    "density": "the gradient-sync slice (6b: geococo's chunked top-k)",
    "control": "the trainer slice (6c: control plane, straggler monitor)",
    "control_noise": "the trainer slice (6c: control plane, straggler monitor)",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, tcfg: TrainConfig, data_cfg: DataConfig, steps: int, *,
          ckpt_dir: str | None = None, ckpt_every: int = 50, seed: int = 0,
          device: str | torch.device | None = None,
          log_every: int = 0) -> list[dict[str, float]]:
    """Train to ``steps`` optimizer steps in all and return one record per
    step run here: {"step", "loss", "grad_norm", "lr", "dt"}, ``dt`` the
    host time of the step, ending in a device synchronise (batch generation
    outside it).  The state saved and restored is the reference trainer's
    tree {"params", "opt", "step"}."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = cast_params_(init_params(cfg, gen, device), tcfg.param_dtype)
    state = {"params": params, "opt": adamw_init(params, tcfg.optim), "step": 0}
    if ckpt_dir is not None:
        gc_incomplete(ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore(ckpt_dir, last, state)
            if log_every:
                print(f"resumed from step {state['step']}")
    step_fn = build_train_step(cfg, tcfg, device)
    history: list[dict[str, float]] = []
    pending = None
    while state["step"] < steps:
        batch = make_batch(data_cfg, state["step"], device)
        _sync(device)
        t0 = time.perf_counter()  # lint: allow[wallclock] measured step time
        metrics = step_fn(state["params"], state["opt"], batch)
        rec = {k: float(v) for k, v in metrics.items()}
        _sync(device)
        dt = time.perf_counter() - t0  # lint: allow[wallclock] measured step time
        state["step"] += 1
        history.append({"step": state["step"], **rec, "dt": dt})
        if ckpt_dir is not None and state["step"] % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_async(ckpt_dir, state["step"], state)
        if log_every and (state["step"] % log_every == 0 or state["step"] == steps):
            print(f"step {state['step']:5d}  loss {rec['loss']:.4f}  "
                  f"gnorm {rec['grad_norm']:.3f}  {dt * 1e3:.0f} ms")
    if pending is not None:
        pending.join()
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
    for flag in _LATER:
        ap.add_argument("--" + flag.replace("_", "-"), default=None, nargs="?", const=True,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, slice_name in _LATER.items():
        if getattr(args, flag) is not None:
            ap.error(f"--{flag.replace('_', '-')} is not ported yet: it arrives with "
                     f"{slice_name} of the port")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(optim=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                         warmup_steps=max(args.steps // 20, 5)))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    device = resolve_device(args.device)
    hist = train(cfg, tcfg, data_cfg, args.steps, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, seed=args.seed, device=device, log_every=10)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
              f"{len(hist)} steps on {device}")
    return hist


if __name__ == "__main__":
    main()
