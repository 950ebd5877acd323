"""End-to-end run of the PyTorch port: train a ~100M-parameter model
through ``repro_torch.train.trainer.Trainer`` (counterpart of
``examples/train_100m.py``).

    PYTHONPATH=src python examples/train_100m_torch.py                 # one card, 300 steps
    PYTHONPATH=src python examples/train_100m_torch.py --small --steps 40 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/train_100m_torch.py --small \\
        --device cpu --mesh 2,2,1 --sync geococo --control --ckpt-dir DIR

On one card (``--device``, default ``cuda``) the whole model trains in one
process.  Under ``torchrun`` with ``--mesh P,D,M`` each rank keeps its
blocks of the state, and the pods exchange their gradients by ``--sync``
(GeoCoCo's filtered top-k by default) over gloo; ``--control`` attaches the
reference CLI's control plane (``launch.train.control_plane``), whose relay
ring the trainer follows.  With ``--ckpt-dir`` the run checkpoints every 100
steps and resumes from the latest checkpoint there.  The loss must fall.
"""

import argparse
import math


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true", help="~20M params / short seq")
    ap.add_argument("--sync", default="geococo", choices=["flat", "hier", "geococo"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--mesh", default=None, help="pod,data,model under torchrun")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    import torch.distributed as dist

    from repro_torch.configs.base import Block, ModelConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.collectives import SyncConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import control_plane
    from repro_torch.models.model import param_count
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.small:
        cfg = ModelConfig(name="demo-20m", family="dense", n_layers=4, d_model=256, n_heads=8,
                          n_kv_heads=4, d_ff=1024, vocab_size=32_000,
                          blocks_pattern=(Block("attn", "dense"),))
        seq, gb = 128, 8
    else:
        # ~100M-parameter llama-style model
        cfg = ModelConfig(name="demo-100m", family="dense", n_layers=8, d_model=640, n_heads=10,
                          n_kv_heads=5, d_ff=2560, vocab_size=32_000,
                          blocks_pattern=(Block("attn", "dense"),))
        seq, gb = 256, 8

    shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    mesh = make_mesh(shape, device=args.device)[0] if shape and math.prod(shape) > 1 else None
    lead = mesh is None or dist.get_rank() == 0
    n_pods = 1 if shape is None else shape[0]
    tcfg = TrainConfig(sync=SyncConfig(strategy=args.sync, density=0.10, chunk=2048,
                                       min_leaf_size=16_384),
                       optim=AdamWConfig(lr=6e-4, total_steps=args.steps, warmup_steps=20))
    run_cfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=100,
                            log_every=10 if lead else 0, seed=0)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=gb, seed=0)
    control = (control_plane(n_pods, args.steps, seed=0, noise=0.10)
               if args.control and n_pods > 1 else None)
    try:
        trainer = Trainer(cfg, mesh, tcfg, run_cfg, data_cfg, control=control,
                          device=args.device)
        if lead:
            print(f"model {cfg.name}: {param_count(cfg) / 1e6:.1f}M params on "
                  f"{trainer.device}, mesh {shape or (1, 1, 1)}, sync={args.sync}")
        if trainer.maybe_resume() and lead:
            print(f"resumed from checkpoint at step {trainer.step_idx}")
        hist = trainer.run()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if not hist:
        return
    first, last = hist[0]["loss"], hist[-1]["loss"]
    if lead:
        print(f"\nloss {first:.4f} -> {last:.4f} over {len(hist)} steps "
              f"({(1 - last / first):+.1%}); step rebuilds {trainer.sync_rebuilds}")
    if not last < first:
        raise SystemExit("training must reduce the loss")


if __name__ == "__main__":
    main()
