"""Batched serving on a mesh with the PyTorch port: the counterpart of
``examples/serve_decode.py``.

    PYTHONPATH=src python examples/serve_decode_torch.py [--arch minitron-8b] \
        [--mesh 2,2,2] [--device cpu]

Serves a reduced-config model on P x D x M local ranks
(``repro_torch.launch.mesh.run_local_ranks``: one spawned process a rank,
joined over gloo; every rank on the one card, or on the CPU with
``--device cpu``): batch prefill of mixed prompts through the cached
forward (f32 compute on an f32 cache), then greedy decode steps through the
mesh step (``build_serve_step(mesh=)``), each rank on its rows of the batch
and its part of the cache, heads and experts split over ``model``.  The
prompts, and a VLM's image context drawn after them, come from numpy's
generator seeded 0, as the JAX example draws them; the image goes with the
prefill too (the JAX example leaves it out there: ROADMAP, fault 11).  It
prints a sample token row and every row's tokens as JSON.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_local_ranks  # noqa: E402
from repro_torch.launch.serve import init_model, make_image, make_prompts, serve  # noqa: E402
from repro_torch.train.train_step import TrainConfig  # noqa: E402

RANK_TIMEOUT = 600       # seconds for the ranks, the weights' draw included


def rank_main(rank: int, args: argparse.Namespace) -> dict:
    """One rank: the mesh, the same seeded weights and prompts on every
    rank, ``serve(mesh=)``; every row's tokens and this rank's times."""
    shape = tuple(int(x) for x in args.mesh.split(","))
    device = torch.device(args.device) if args.device else torch.device("cuda")
    mesh, _ = make_mesh(shape, device=device)
    cfg = get_smoke_config(args.arch)
    tcfg = TrainConfig()
    params = init_model(cfg, tcfg, 0, device)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, seed=0)
    img = make_image(cfg, args.batch, args.prompt_len, seed=0)
    res = serve(cfg, params, prompts, args.gen_len, tcfg, device, img, mesh)
    return {"tokens": res.tokens, "prefill_s": res.prefill_s, "decode_s": res.decode_s}


def main(argv: list[str] | None = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-8b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--mesh", default="2,2,2", help="pod,data,model")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if get_smoke_config(args.arch).is_encoder_only:
        ap.error(f"{args.arch} is encoder-only: it has no decode")
    if args.device is None and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    n_ranks = int(np.prod([int(x) for x in args.mesh.split(",")]))
    ranks = run_local_ranks(rank_main, n_ranks, (args,), timeout=RANK_TIMEOUT)
    gen = ranks[0]["tokens"]
    if any(not np.array_equal(got["tokens"], gen) for got in ranks):
        raise RuntimeError("the ranks gathered different tokens")
    if not ((gen >= 0) & (gen < get_smoke_config(args.arch).vocab_size)).all():
        raise RuntimeError("decoded a token outside the vocabulary")
    print(f"arch={args.arch}-smoke on mesh {args.mesh} ({n_ranks} ranks): prefilled "
          f"{args.batch} x {args.prompt_len} tokens in "
          f"{max(got['prefill_s'] for got in ranks) * 1e3:.1f} ms")
    print(f"decoded {gen.shape[1]} steps in "
          f"{max(got['decode_s'] for got in ranks) * 1e3:.1f} ms; sample row: {gen[0].tolist()}")
    print("tokens: " + json.dumps(gen.tolist()))
    return gen


if __name__ == "__main__":
    main()
