"""Batched serving: prefill of a batch of prompts, then greedy decode with
the recurrent state and the attention cache.  Counterpart of
``examples/serve_decode.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ARCH \
        [--smoke] [--batch 8 --prompt-len 24 --gen-len 16] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch ARCH --mesh 1,2,2 [--smoke] [--device cpu]

``ARCH`` is one of ``configs.registry.ARCHS``: rwkv6-7b (the default),
recurrentgemma-9b, minitron-8b, deepseek-7b, qwen2.5-32b,
deepseek-coder-33b, granite-moe-3b-a800m, deepseek-v3-671b,
llama-3.2-vision-90b, hubert-xlarge.

Prompts come from numpy with ``--seed``; parameters from a
``torch.Generator`` seeded the same way, on the device.  A VLM's image
context (numpy normal, (B, n_img_tokens, d_model)) is drawn from the same
generator after the prompts, as the JAX example draws it, and goes with the
prefill and with every decode step.  An encoder-only model (hubert-xlarge)
has no decode: for it the command runs the prefill step
(``build_serve_step(kind="prefill")``) over ``--batch`` x ``--prompt-len``
frames (numpy normal, (B, S, d_model)) from ``--seed`` and prints its time
and frames/s.  The cache holds
``prompt_len + gen_len`` positions, as the JAX example sizes it.  Prefill
runs in f32 compute on an f32 cache; decode runs in
``TrainConfig.compute_dtype``, as the JAX example does.  Between the two the
parameters are cast once, in place, so the card holds one serving copy:
``serve`` consumes the parameters it is given.  It prints a sample token
row.

With ``--mesh P,D,M`` (one process a rank, under ``torchrun``; gloo) it
serves as the reference's ``build_serve_step(cfg, mesh, tcfg)`` does:
every rank draws the same parameters and the global prompts, prefills and
decodes its rows of the batch (split over ``pod`` and ``data``) on its part
of the cache (``train_step.init_local_cache``), attention heads and
experts split over ``model``, and a cache of 8192 positions or more split
along its sequence over ``model``; the tokens are gathered, so every rank
holds the whole ``(B, gen_len)``.  Rank 0 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..device import resolve_device
from ..dist.sharding import batch_rows
from ..models.layers import Params
from ..models.model import cast_params_, init_params, param_dtypes
from ..train.train_step import TrainConfig, build_serve_step, init_local_cache
from .mesh import check_mesh_shape, make_mesh, rank_coords

__all__ = ["ServeResult", "EncodeResult", "make_prompts", "make_image", "make_frames",
           "init_model", "serve", "encode", "whole_rows", "mesh_counts", "main"]


@dataclasses.dataclass(frozen=True)
class ServeResult:
    tokens: np.ndarray      # (B, gen_len) int32: first from prefill, then decode
    prefill_s: float        # prefill, ending in a device synchronise
    decode_s: float         # the gen_len - 1 decode steps
    # on a mesh, this rank's counts of the prefill and of the decode steps
    # (``mesh_counts``); None in one process
    counts: dict | None = None


def mesh_counts(ctx) -> dict[str, float]:
    """A serving step's distribution context's counts since its last reset:
    the bytes to gloo of the ``model`` sums and gathers (``tp_bytes``), of
    which the sequence split's merge (``merge_bytes``), their host time
    (``tp_s``), the MoE's assignments routed and dropped."""
    return {"tp_bytes": ctx.stats.bytes_sent, "merge_bytes": ctx.merge_bytes,
            "tp_s": ctx.wall_s, "moe_assigned": float(ctx.moe_assigned),
            "moe_dropped": float(ctx.moe_dropped)}


@dataclasses.dataclass(frozen=True)
class EncodeResult:
    logits: torch.Tensor    # (B, S, V) in the compute dtype, on the device
    prefill_s: float        # the prefill step, ending in a device synchronise


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)


def make_image(cfg: ModelConfig, batch: int, prompt_len: int, seed: int = 0) -> np.ndarray | None:
    """The image context of ``make_prompts(cfg, batch, prompt_len, seed)``:
    (B, n_img_tokens, d_model) float32 normal, drawn from the seed's
    generator after the prompts; None for a model without one."""
    if not cfg.n_img_tokens:
        return None
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return rng.normal(size=(batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)


def make_frames(cfg: ModelConfig, batch: int, n_frames: int, seed: int = 0) -> np.ndarray:
    """Frame embeddings for a frames frontend: (B, S, d_model) float32
    normal from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, n_frames, cfg.d_model)).astype(np.float32)


def init_model(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
               device: str | torch.device | None = None) -> Params:
    """Random parameters in ``tcfg.param_dtype``, drawn on the device."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    return cast_params_(params, tcfg.param_dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def whole_rows(mesh, local: torch.Tensor, rows: int) -> torch.Tensor:
    """The global ``(rows, ...)`` tensor of which every rank of ``mesh``
    holds its rows (``dist.sharding.batch_rows``) in ``local``: gathered
    over every rank on the host, each block taken from the ranks that hold
    it.  A host tensor, the same on every rank."""
    every = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(every, local.contiguous())
    out = torch.empty((rows, *local.shape[1:]), dtype=local.dtype)
    for rank, part in enumerate(every):
        out[batch_rows(mesh.shape, rank_coords(rank, mesh.shape), rows)] = part
    return out


def serve(cfg: ModelConfig, params: Params, prompts: np.ndarray, gen_len: int,
          tcfg: TrainConfig = TrainConfig(),
          device: str | torch.device | None = None,
          img: np.ndarray | None = None, mesh=None) -> ServeResult:
    """Prefill ``prompts`` (B, P), then decode to ``gen_len`` tokens in all;
    ``img`` (B, n_img_tokens, d_model), a VLM's image context, goes with
    the prefill and every decode step.  ``params`` must be in
    ``tcfg.param_dtype``; they are cast in place to ``tcfg.compute_dtype``
    after prefill, so a second call with the same parameters raises rather
    than prefilling on the cast copy.  An encoder-only model has no decode
    (see :func:`encode`).

    On a ``mesh`` (``launch.mesh.Mesh``) every rank passes the whole
    parameters, the global prompts and image; it prefills and decodes its
    rows (``build_serve_step(mesh=)``) and returns every row's tokens,
    gathered; ``prefill_s`` and ``decode_s`` are its own."""
    device = resolve_device(device)
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step; run its "
                         "prefill step (encode) instead")
    if cfg.n_img_tokens and img is None:
        raise ValueError(f"{cfg.name} cross-attends to an image context: pass img")
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    if param_dtypes(params) != {tcfg.param_dtype}:
        raise ValueError(
            f"serve() prefills on parameters in {tcfg.param_dtype}; these are in "
            f"{sorted(map(str, param_dtypes(params)))} (already cast by an earlier call?)"
        )
    b, p = prompts.shape
    max_len = p + gen_len
    window = cfg.local_window
    if (any(blk.mixer == "attn_local" for blk in cfg.block_list())
            and max_len >= window and p > window):
        raise ValueError(
            f"a prompt of {p} tokens is longer than the local-attention window "
            f"({window}) of the ring cache a {max_len}-position cache becomes; the "
            "JAX package prefills that case wrongly (ROADMAP, fault 5), the port "
            "refuses it"
        )
    on_mesh = mesh is not None and mesh.size > 1
    toks = torch.from_numpy(np.ascontiguousarray(prompts, dtype=np.int32))
    extra = {} if img is None else {"img": torch.from_numpy(img)}
    # prefill in f32 compute, as the JAX example does, through the cached step
    prefill = build_serve_step(cfg, dataclasses.replace(tcfg, compute_dtype=torch.float32),
                               kind="decode", device=device, mesh=mesh)
    if on_mesh:
        own = batch_rows(mesh.shape, mesh.coords, b)
        extra = {k: v[own] for k, v in extra.items()}
        toks = toks[own]
    extra = {k: v.to(device) for k, v in extra.items()}
    with torch.inference_mode():
        t0 = time.perf_counter()  # lint: allow[wallclock] measured serving time
        cache = init_local_cache(cfg, b, max_len, mesh.shape if on_mesh else {},
                                 dtype=torch.float32, device=device)
        logits, cache = prefill.logits(params, cache, {"tokens": toks, **extra}, rows=b)
        last = logits[:, -1].float()
        del logits
        if not bool(torch.isfinite(last).all()):
            raise RuntimeError("prefill produced non-finite logits")
        tok = last.argmax(dim=-1).to(torch.int32)
        _sync(device)
        t1 = time.perf_counter()  # lint: allow[wallclock] measured serving time

        cast_params_(params, tcfg.compute_dtype)
        step = build_serve_step(cfg, tcfg, kind="decode", device=device, mesh=mesh)
        _sync(device)
        t2 = time.perf_counter()  # lint: allow[wallclock] measured serving time
        outs = [tok]
        for _ in range(gen_len - 1):
            tok, cache = step(params, cache, {"tokens": tok[:, None], **extra}, rows=b)
            outs.append(tok)
        _sync(device)
        t3 = time.perf_counter()  # lint: allow[wallclock] measured serving time
    tokens = torch.stack(outs, dim=1).cpu()
    if not on_mesh:
        return ServeResult(tokens=tokens.numpy(), prefill_s=t1 - t0, decode_s=t3 - t2)
    return ServeResult(tokens=whole_rows(mesh, tokens, b).numpy(), prefill_s=t1 - t0,
                       decode_s=t3 - t2, counts={"prefill": mesh_counts(prefill.ctx),
                                                 "decode": mesh_counts(step.ctx)})


def encode(cfg: ModelConfig, params: Params, frames: np.ndarray,
           tcfg: TrainConfig = TrainConfig(),
           device: str | torch.device | None = None, mesh=None) -> EncodeResult:
    """The prefill step (``build_serve_step(kind="prefill")``, in
    ``tcfg.compute_dtype``) over ``frames`` (B, S, d_model), for a model
    whose frontend reads frame embeddings.  On a ``mesh`` every rank passes
    the global frames and computes its rows (heads split over ``model``);
    the logits are gathered, so every rank returns all of them on its
    device, and ``prefill_s`` is its step's."""
    device = resolve_device(device)
    if cfg.frontend != "frames":
        raise ValueError(f"{cfg.name} reads {cfg.frontend}, not frames")
    step = build_serve_step(cfg, tcfg, kind="prefill", device=device, mesh=mesh)
    b = frames.shape[0]
    embeds = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.float32))
    on_mesh = mesh is not None and mesh.size > 1
    if on_mesh:
        embeds = embeds[batch_rows(mesh.shape, mesh.coords, b)]
    _sync(device)
    t0 = time.perf_counter()  # lint: allow[wallclock] measured serving time
    logits = step(params, {"embeds": embeds}, rows=b)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("the prefill step produced non-finite logits")
    _sync(device)
    t1 = time.perf_counter()  # lint: allow[wallclock] measured serving time
    if on_mesh:
        logits = whole_rows(mesh, logits.cpu(), b).to(device)
    return EncodeResult(logits=logits, prefill_s=t1 - t0)


def main(argv: list[str] | None = None) -> ServeResult | EncodeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-7b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--mesh", default=None,
                    help="pod,data,model: P,D,M with one process a rank (torchrun)")
    args = ap.parse_args(argv)
    shape = None
    if args.mesh is not None:
        try:
            shape = tuple(int(x) for x in args.mesh.split(","))
            world = (dist.get_world_size() if dist.is_initialized()
                     else int(os.environ.get("WORLD_SIZE", "1")))
            check_mesh_shape(shape, world)
        except ValueError as err:
            ap.error(str(err))

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig()
    device = resolve_device(args.device)
    on_mesh = shape is not None and np.prod(shape) > 1
    owns_group = on_mesh and not dist.is_initialized()
    mesh = make_mesh(shape, device=device)[0] if on_mesh else None
    try:
        return _run(args, cfg, tcfg, device, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, cfg: ModelConfig, tcfg: TrainConfig, device: torch.device,
         mesh) -> ServeResult | EncodeResult:
    """``main``'s serving, on ``mesh`` or one process; rank 0 prints."""
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    where = f"{device}" if mesh is None else (
        f"{device}, mesh {','.join(str(mesh.shape[a]) for a in ('pod', 'data', 'model'))}")
    params = init_model(cfg, tcfg, args.seed, device)
    if cfg.is_encoder_only:
        frames = make_frames(cfg, args.batch, args.prompt_len, args.seed)
        enc = encode(cfg, params, frames, tcfg, device, mesh)
        if enc.logits.shape != (args.batch, args.prompt_len, cfg.vocab_size):
            raise RuntimeError(f"logits have shape {tuple(enc.logits.shape)}")
        say(f"arch={cfg.name}: prefill step over {args.batch} x {args.prompt_len} frames "
            f"({tcfg.compute_dtype}) on {where} in {enc.prefill_s * 1e3:.1f} ms, "
            f"{args.batch * args.prompt_len / enc.prefill_s:.0f} frames/s")
        return enc
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed)
    img = make_image(cfg, args.batch, args.prompt_len, args.seed)
    res = serve(cfg, params, prompts, args.gen_len, tcfg, device, img, mesh)
    say(f"arch={cfg.name}: prefilled {args.batch} x {args.prompt_len} tokens "
        f"on {where} in {res.prefill_s * 1e3:.1f} ms")
    gen = res.tokens
    if gen.shape != (args.batch, args.gen_len):
        raise RuntimeError(f"decoded tokens have shape {gen.shape}")
    if not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise RuntimeError("decoded a token outside the vocabulary")
    say(f"decoded {gen.shape[1]} steps in {res.decode_s * 1e3:.1f} ms; "
        f"sample row: {gen[0].tolist()}")
    return res


if __name__ == "__main__":
    main()
