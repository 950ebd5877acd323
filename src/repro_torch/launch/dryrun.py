"""Dry-run: one rank's step of every (arch x shape x mesh) cell on the
meta device, counted (the counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \\
        --shape train_4k --mesh multi --strategy hier
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --tier reduced --smoke

The reference lowers and compiles each cell for a mesh of host devices and
reads XLA's analyses; the port runs rank 0's eager program on the meta
device, where tensors have shapes and no storage, inside a mesh of the
production shape over torch's fake process group
(``launch.mesh.fake_mesh``), and counts what it dispatches
(``launch.cost.CostMode``): FLOPs, HBM bytes, the peak of live storage
with the arguments held from the start, and what each collective would
hand to gloo, read from the port's own wire counters.  Nothing is
allocated and no card is needed: this is the one entry point of the port
that runs without one.  Every kernel wrapper takes its meta branch (no
launch) and reports its call's work (``kernels.work``).

A rank holds what the real step gives it: on a mesh, its blocks of the
parameters, of AdamW's m and v and of the residuals
(``dist.grouping.leaf_specs``, ``zero_residuals``) in training, the whole
parameters and its part of the cache (``train_step.init_local_cache``) in
serving, and its rows of the reference's batch (``input_specs``; the
global batch is passed and the step takes the rank's rows, held at their
size).  The training step is the mesh step's part before its host checks:
``SyncGrads`` (the forward and backward, the in-pod and ``model`` wire,
the pod exchange), the global norm and AdamW; the loss all-reduce and the
checksum gathers that follow read data, and the record lists them under
``left_out`` with the bytes they would move.  A failed cell is a fault of
the port's sharding, not of the models.

Tiers: ``full`` is the production meshes ``(1, 16, 16)`` and ``(2, 16,
16)``, ``reduced`` ``(1, 4, 4)`` and ``(2, 2, 4)``; ``--smoke`` takes the
smoke configs, so that a reduced cell runs in seconds on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from ..configs.base import SHAPES, ModelConfig, ShapeSpec
from ..configs.registry import ARCHS, cells, get_config, get_smoke_config
from ..dist.collectives import SyncConfig
from ..dist.grouping import leaf_specs, zero_residuals
from ..dist.sharding import batch_rows, local_shape
from ..models.model import cast_params_, init_params
from ..optim.adamw import adamw_init, adamw_update
from ..train.train_step import (SyncGrads, TrainConfig, build_serve_step, build_train_step,
                                grads_and_loss, init_local_cache)
from ..tree import map_paths
from .cost import CostMode
from .mesh import fake_mesh, production_mesh_shape

__all__ = ["TIERS", "input_batch", "dry_step", "run_cell", "main"]

TIERS = ("full", "reduced")
# the reference's lean dtype policy: bf16 parameters for the largest models
LEAN = ("deepseek-v3-671b", "llama-3.2-vision-90b")
GB = 1e9


def input_batch(cfg: ModelConfig, shape: ShapeSpec, device: str | torch.device = "meta"
                ) -> dict[str, torch.Tensor]:
    """The reference's ``input_specs`` for one cell, as uninitialised
    tensors on ``device``: int32 tokens (a decode's one a row), bf16
    ``embeds`` for a model that reads frames, bf16 ``img`` for one with an
    image context, int32 ``labels`` in training."""
    gb, s = shape.global_batch, shape.seq_len
    img = {"img": torch.empty((gb, cfg.n_img_tokens, cfg.d_model), dtype=torch.bfloat16,
                              device=device)} if cfg.n_img_tokens else {}
    if shape.kind == "decode":
        return {"tokens": torch.empty((gb, 1), dtype=torch.int32, device=device), **img}
    if cfg.frontend == "token":
        batch = {"tokens": torch.empty((gb, s), dtype=torch.int32, device=device)}
    else:
        batch = {"embeds": torch.empty((gb, s, cfg.d_model), dtype=torch.bfloat16, device=device)}
    batch |= img
    if shape.kind == "train":
        batch["labels"] = torch.empty((gb, s), dtype=torch.int32, device=device)
    return batch


def _rows(batch: dict[str, torch.Tensor], rows: slice) -> dict[str, torch.Tensor]:
    return {k: v[rows] for k, v in batch.items()}


def _at_end(cache, seq_len: int):
    """``cache`` with every ``len`` at ``seq_len - 1``: the decode step
    writes the last position of a context of ``seq_len``."""
    if isinstance(cache, dict):
        return {k: seq_len - 1 if k == "len" else _at_end(v, seq_len) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_at_end(v, seq_len) for v in cache]
    return cache


def _wire(groups: dict) -> dict[str, float | None]:
    """Bytes to gloo by counter: ``pod`` (the pod exchange), ``inpod`` (the
    in-pod gathers, reduce-scatters and the norm's sum over ``data`` and
    ``model``), ``model`` (the regions' sums over ``model`` and the MoE's
    count prefix over ``data``, the sequence split's merges apart) and
    ``merge`` (those merges, over ``model``); and the pod exchange's values
    (``collectives.WireStats``): ``pod_dense_values``, ``pod_sparse_values``
    and ``pod_nonzero_sent``, which depends on the data and is ``None``."""
    out = {"pod": 0.0, "inpod": 0.0, "model": 0.0, "merge": 0.0, "pod_dense_values": 0,
           "pod_sparse_values": 0, "pod_nonzero_sent": None}
    if "pods" in groups:
        stats = groups["pods"].stats
        out.update(pod=stats.bytes_sent, pod_dense_values=stats.dense_values,
                   pod_sparse_values=stats.sparse_values)
    if "inpod" in groups:
        out["inpod"] = groups["inpod"].stats.bytes_sent
    if "ctx" in groups and groups["ctx"] is not None:
        ctx = groups["ctx"]
        out["merge"] = ctx.merge_bytes
        out["model"] = ctx.stats.bytes_sent - ctx.merge_bytes
    return out


def _train_state(cfg: ModelConfig, tcfg: TrainConfig, mesh, optimizer: bool) -> dict:
    """This rank's training state on meta: parameters (cast to
    ``tcfg.param_dtype``), AdamW's m and v and, where the strategy carries
    them, the residuals, each at this rank's block (whole without a mesh)."""
    params = cast_params_(init_params(cfg, None, "meta"), tcfg.param_dtype)
    if mesh is not None:
        specs = leaf_specs(cfg, mesh.shape, tcfg.sync.strategy)
        params = map_paths(params, lambda key, p: torch.empty(
            local_shape(p.shape, specs[key], mesh.shape), dtype=p.dtype, device="meta"))
    state = {"params": params,
             "opt": adamw_init(params, tcfg.optim) if optimizer else None, "residuals": None}
    if tcfg.sync.needs_residuals:
        state["residuals"] = zero_residuals(cfg, "meta", None if mesh is None else mesh.shape,
                                           tcfg.sync.strategy)
    return state


def _left_out(cfg: ModelConfig, mesh, strategy: str) -> list[dict]:
    """The mesh step's host checks after AdamW, which read data and which
    the dry-run does not run, with the bytes each would hand to gloo a rank
    (gloo's ring factors, as ``dist.collectives.PodGroup`` counts them):
    one f32 loss, one int64 checksum a leaf over the pods and one a whole
    leaf over the pod's ranks."""
    world = mesh.size
    specs = leaf_specs(cfg, mesh.shape, strategy)
    n_pods, n_inpod = mesh.shape["pod"], mesh.shape["data"] * mesh.shape["model"]
    whole = sum(1 for spec in specs.values() if not any(spec))
    out = [{"name": "the loss' all-reduce over every rank", "group": "world",
            "bytes": 2 * (world - 1) / world * 4},
           {"name": "each leaf's checksum gathered over the pods", "group": "pod",
            "bytes": (n_pods - 1) * 8 * len(specs)}]
    if n_inpod > 1:
        out.append({"name": "each whole leaf's checksum gathered over the pod", "group": "inpod",
                    "bytes": (n_inpod - 1) * 8 * whole})
    return out


def _run_train(cfg, tcfg, mesh, batch, optimizer: bool, mode: CostMode) -> dict:
    state = _train_state(cfg, tcfg, mesh, optimizer)
    mode.hold([state["params"], state["opt"], state["residuals"]])
    if mesh is None:
        mode.hold(batch)
        step = build_train_step(cfg, tcfg, "meta")
        with mode:
            if optimizer:
                step(state["params"], state["opt"], batch)
            else:
                grads_and_loss(cfg, tcfg, state["params"], batch)
        return {}
    rows = batch_rows(mesh.shape, mesh.coords, next(iter(batch.values())).shape[0])
    for x in batch.values():          # the global batch, of which the rank holds its rows
        mode.hold(x, nbytes=x[rows].numel() * x.element_size())
    sync = SyncGrads(cfg, tcfg, "meta", mesh)
    with mode:
        grads, _, _ = sync(state["params"], batch, state["residuals"])
        if optimizer:
            gnorm = sync.inpod.global_norm(grads, list(sync.specs.values()))
            adamw_update(state["params"], grads, state["opt"], tcfg.optim, gnorm=gnorm)
        del grads
    return {"pods": sync.pods, "inpod": sync.inpod, "ctx": sync.ctx}


def _run_serve(cfg, tcfg, shape: ShapeSpec, mesh, batch, mode: CostMode,
               cache_len: int | None, cache_dtype: torch.dtype) -> dict:
    params = cast_params_(init_params(cfg, None, "meta"), tcfg.param_dtype)
    mode.hold(params)
    rows, kw = slice(None), {}
    if mesh is not None:
        rows = batch_rows(mesh.shape, mesh.coords, shape.global_batch)
        kw = {"rows": shape.global_batch}
    local = _rows(batch, rows)
    mode.hold(local)
    cached = shape.kind == "decode" or cache_len is not None
    step = build_serve_step(cfg, tcfg, kind="decode" if cached else "prefill", device="meta",
                            mesh=mesh)
    if not cached:
        with mode:
            step(params, local, **kw)
    else:
        cache = init_local_cache(cfg, shape.global_batch, cache_len or shape.seq_len,
                                 {} if mesh is None else mesh.shape, cache_dtype, "meta")
        if shape.kind == "decode":
            cache = _at_end(cache, shape.seq_len)
        mode.hold(cache)
        with mode:
            (step if shape.kind == "decode" else step.logits)(params, cache, local, **kw)
    return {"ctx": step.ctx} if mesh is not None else {}


def dry_step(cfg: ModelConfig, shape: ShapeSpec, tcfg: TrainConfig,
             mesh_shape: tuple[int, int, int] | None = None, *, rank: int = 0,
             optimizer: bool = True, cache_len: int | None = None,
             cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """One step of ``cfg`` at ``shape`` under ``tcfg`` on the meta device,
    counted: rank ``rank`` of a mesh of ``mesh_shape`` (``(P, D, M)``, over
    the fake process group), or one process with no mesh.  A training step
    takes ``build_train_step``'s path (one process) or the mesh step's
    part before its host checks; serving takes ``build_serve_step``'s,
    a decode at the last position of a cache of ``shape.seq_len`` in
    ``cache_dtype``, and a prefill with ``cache_len`` through the cached
    step (as ``serve()`` prefills) into an empty cache of that many
    positions.  ``optimizer=False`` leaves AdamW's state and update out of
    a training step (a step that is not the one the card runs).

    Returns ``{"cost": {"flops", "bytes", "kernel_flops", "kernel_bytes",
    "kernel_calls"}, "memory": {"argument_gb", "temp_gb", "peak_gb"},
    "wire": bytes to gloo by counter, "collective_link_bytes_by_axes",
    "left_out", "trace_s"}``."""
    t0 = time.perf_counter()  # lint: allow[wallclock] the dry-run's own time
    mode = CostMode("meta")
    batch = input_batch(cfg, shape)
    whole = mesh_shape is None or math.prod(mesh_shape) == 1
    ctx = contextlib.nullcontext() if whole else fake_mesh(tuple(mesh_shape), rank)
    with ctx as mesh:
        if shape.kind == "train":
            groups = _run_train(cfg, tcfg, mesh, batch, optimizer, mode)
        else:
            groups = _run_serve(cfg, tcfg, shape, mesh, batch, mode, cache_len, cache_dtype)
        wire = _wire(groups)
        left_out = (_left_out(cfg, mesh, tcfg.sync.strategy)
                    if mesh is not None and shape.kind == "train" else [])
    counts = mode.summary()
    by_axes = {"pod": wire["pod"], "data+model": wire["inpod"],
               "model": wire["model"] + wire["merge"]}
    return {
        "cost": {k: counts[k] for k in ("flops", "bytes", "kernel_flops", "kernel_bytes",
                                        "kernel_calls")},
        "memory": {"argument_gb": counts["argument_bytes"] / GB,
                   "temp_gb": (counts["peak_bytes"] - counts["argument_bytes"]) / GB,
                   "peak_gb": counts["peak_bytes"] / GB},
        "wire": wire,
        "collective_link_bytes_by_axes": {k: v for k, v in by_axes.items() if v},
        "left_out": left_out,
        "trace_s": time.perf_counter() - t0,  # lint: allow[wallclock] the dry-run's own time
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, strategy: str,
             density: float = 0.10, microbatches: int = 8,
             tier: str = "full", smoke: bool = False) -> dict:
    """The reference's ``run_cell``: rank 0's step of ``arch`` at
    ``SHAPES[shape_name]`` on the ``single`` or ``multi`` production mesh
    of ``tier``, under the sync ``strategy``; the reference's lean dtype
    policy and ``microbatches`` in training only."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    mesh_shape = production_mesh_shape(multi_pod=(mesh_kind == "multi"),
                                       reduced=(tier == "reduced"))
    lean = cfg.name in LEAN
    tcfg = TrainConfig(sync=SyncConfig(strategy=strategy, density=density),
                       param_dtype=torch.bfloat16 if lean else torch.float32,
                       microbatches=microbatches if shape.kind == "train" else 1)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(zip(("pod", "data", "model"), mesh_shape)), "strategy": strategy,
        "density": density, "tier": tier, "smoke": smoke, "kind": shape.kind,
        "param_dtype": str(tcfg.param_dtype).removeprefix("torch."),
        "compute_dtype": str(tcfg.compute_dtype).removeprefix("torch."),
        "microbatches": tcfg.microbatches,
    }
    rec.update(dry_step(cfg, shape, tcfg, mesh_shape))
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="hier",
                    help="registered device_sync strategy (flat/hier/geococo); validated "
                         "against the registry")
    ap.add_argument("--density", type=float, default=0.10)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--tier", default="full", choices=list(TIERS),
                    help="full = the production meshes (1,16,16) and (2,16,16); reduced = "
                         "(1,4,4) and (2,2,4)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the smoke model configs (a reduced cell runs in seconds)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun-torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    print(f"[tier] {args.tier}: meshes {production_mesh_shape(False, args.tier == 'reduced')}, "
          f"{production_mesh_shape(True, args.tier == 'reduced')} on the meta device"
          + (" (smoke configs)" if args.smoke else ""))

    if args.all:
        todo = cells()
    else:
        if args.arch is None:
            raise SystemExit("need --arch or --all")
        if args.arch not in ARCHS:
            raise SystemExit(f"unknown arch {args.arch!r}; known: {list(ARCHS)}")
        todo = [(a, s) for a, s in cells((args.arch,)) if args.shape is None or s.name == args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch, shape in todo:
        for mesh_kind in meshes:
            tag = f"{arch}__{shape.name}__{mesh_kind}__{args.strategy}"
            if args.tier != "full":
                tag += f"__{args.tier}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            print(f"[cell] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape.name, mesh_kind, args.strategy, args.density,
                               args.microbatches, tier=args.tier, smoke=args.smoke)
                rec["status"] = "ok"
                print(f"    ok: trace {rec['trace_s']:.1f}s  peak {rec['memory']['peak_gb']:.1f} "
                      f"GB a rank  flops {rec['cost']['flops']:.3e}  bytes "
                      f"{rec['cost']['bytes']:.3e}  wire {rec['collective_link_bytes_by_axes']}",
                      flush=True)
            except Exception as e:
                n_fail += 1
                rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                       "strategy": args.strategy, "tier": args.tier, "status": "fail",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
                print(f"    FAIL: {type(e).__name__}: {str(e)[:300]}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
