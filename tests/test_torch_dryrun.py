"""The dry-run (``repro_torch.launch.dryrun``) and its cost counter
(``launch.cost.CostMode``) on the CPU.

* One step of each mixer family at smoke size (training, serving and
  serve()'s cached prefill) counts the same FLOPs and bytes on the meta
  device as on the CPU, exactly: the dry-run takes the branches the real
  step takes.  On meta a repeated operation's results, made from the
  layout ``CostMode`` remembered, have the meta kernel's layout.
* Each kernel wrapper counts ``kernels.work``'s figure once, on the CPU
  (where its plain version runs) and on meta (its meta branch, no launch),
  and gives the plain version's shapes and dtypes.
* Each rank's bytes to gloo (the pod exchange, the in-pod gathers and
  reduce-scatters, the ``model`` sums) from a real step of four gloo ranks
  on (2, 1, 2) and (1, 2, 2) equal, to the byte, the dry-run's of that
  rank: training under flat, hier and geococo, and serving's cached
  prefill and decode.
* ``estimate_sync_bytes`` over a rank's blocks lies within 2x of the
  dry-run's pod bytes on the reduced multi-pod tier (the reference's rule
  for its own dry-run).
* The CLI writes an ``ok`` record on the reduced tier with ``--smoke``,
  exits 1 on an unknown arch, and leaves no process group behind.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist.collectives import SyncConfig, estimate_sync_bytes
from repro_torch.dist.grouping import zero_residuals
from repro_torch.dist.sharding import batch_rows
from repro_torch.kernels import work
from repro_torch.kernels.crdt_merge import ops as merge_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv6_ops
from repro_torch.kernels.whitedata_filter import ops as filter_ops
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostMode
from repro_torch.launch.mesh import fake_mesh, make_mesh, run_local_ranks
from repro_torch.models.model import cast_params_, init_cache, init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.train_step import (TrainConfig, build_serve_step, build_train_step,
                                          init_local_cache)
from repro_torch.train.trainer import StatePlacement

ROOT = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# the step's count on meta against the CPU
# ---------------------------------------------------------------------------

FAMILIES = ["minitron-8b", "granite-moe-3b-a800m", "deepseek-v3-671b", "rwkv6-7b",
            "recurrentgemma-9b", "hubert-xlarge", "llama-3.2-vision-90b"]
SMOKE_SHAPE = {"train": ShapeSpec("smoke train", 32, 2, "train"),
               "decode": ShapeSpec("smoke decode", 32, 2, "decode"),
               "prefill": ShapeSpec("smoke prefill", 32, 2, "prefill")}


def _filled(cfg, batch: dict, gen: torch.Generator) -> dict:
    """``batch`` (the dry-run's inputs) with values on the CPU: tokens
    below the vocabulary, normal frames and image contexts."""
    return {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen, dtype=torch.int32)
                if v.dtype == torch.int32 else torch.randn(v.shape, generator=gen).to(v.dtype))
            for k, v in batch.items()}


def _cpu_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, cache_len: int | None = None,
              cache_dtype: torch.dtype | None = None) -> dict:
    """The step the dry-run repeats, on the CPU under CostMode (a prefill
    with ``cache_len`` through the cached step into an empty cache, as
    ``serve()`` prefills)."""
    gen = torch.Generator().manual_seed(0)
    params = cast_params_(init_params(cfg, gen, "cpu"), tcfg.param_dtype)
    batch = _filled(cfg, dryrun.input_batch(cfg, shape, "cpu"), gen)
    mode = CostMode("cpu")
    if shape.kind == "train":
        opt = adamw_init(params, tcfg.optim)
        step = build_train_step(cfg, tcfg, "cpu")
        with mode:
            step(params, opt, batch)
    elif cache_len is not None:
        cache = init_local_cache(cfg, shape.global_batch, cache_len, {}, cache_dtype, "cpu")
        step = build_serve_step(cfg, tcfg, kind="decode", device="cpu")
        with mode:
            step.logits(params, cache, batch)
    elif shape.kind == "prefill":
        step = build_serve_step(cfg, tcfg, kind="prefill", device="cpu")
        with mode:
            step(params, batch)
    else:
        cache = dryrun._at_end(init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu"),
                               shape.seq_len)
        step = build_serve_step(cfg, tcfg, kind="decode", device="cpu")
        with mode:
            step(params, cache, batch)
    return mode.summary()


@pytest.mark.parametrize("arch,kind", [
    (arch, kind) for kind in ("train", "serve", "cached_prefill") for arch in FAMILIES
    if not (kind == "cached_prefill" and arch == "hubert-xlarge")])
def test_meta_counts_equal_the_cpu_step(arch, kind):
    """``cached_prefill`` is serve()'s prefill: the cached step's logits in
    f32 compute into an empty f32 cache of more positions than the prompt
    (the step chip_smoke.py's phase 31 counts on the card)."""
    cfg = get_smoke_config(arch)
    tcfg, cache = TrainConfig(), {}
    if kind == "serve":
        kind = "prefill" if cfg.is_encoder_only else "decode"
    elif kind == "cached_prefill":
        kind, tcfg = "prefill", TrainConfig(compute_dtype=torch.float32)
        cache = {"cache_len": SMOKE_SHAPE[kind].seq_len + 8, "cache_dtype": torch.float32}
    shape = SMOKE_SHAPE[kind]
    dry = dryrun.dry_step(cfg, shape, tcfg, **cache)
    cpu = _cpu_step(cfg, shape, tcfg, **cache)
    for key in ("flops", "bytes", "kernel_flops", "kernel_bytes", "kernel_calls"):
        assert dry["cost"][key] == cpu[key], key
    assert dry["cost"]["flops"] > 0 and dry["cost"]["bytes"] > 0
    assert dry["memory"]["peak_gb"] >= dry["memory"]["argument_gb"] > 0
    mixer = {b.mixer for b in cfg.block_list()}
    assert (dry["cost"]["kernel_calls"] > 0) == bool(mixer & {"rwkv", "rglru"})


def test_meta_layouts_repeat_the_meta_kernels():
    """On meta CostMode makes a repeated operation's results from the
    layout it remembered: the sizes, strides, dtypes and storage sizes the
    meta kernel gives, whatever the storage offset, for scalars of another
    type and for several results; a result that shares its input's storage
    though its schema promises a new tensor (``_unsafe_view``) still
    does."""
    base = torch.empty(200, device="meta")
    ints = torch.empty((4, 5), dtype=torch.int32, device="meta")
    perm = torch.empty((3, 4, 5), device="meta").permute(2, 0, 1)
    calls = [lambda o: base[o:o + 20].view(4, 5).exp(),
             lambda o: ints * 2, lambda o: ints * 2.0,
             lambda o: perm * base[o:o + 4].view(1, 1, 4),
             lambda o: torch.max(perm, dim=1),
             lambda o: torch.where(perm > 0, perm, 0.0),
             lambda o: torch.ops.aten._unsafe_view(base[o:o + 20], [4, 5])]

    def layout(out):
        outs = out if isinstance(out, tuple) else (out,)
        return [(x.shape, x.stride(), x.dtype, x.untyped_storage().nbytes()) for x in outs]

    mode = CostMode("meta")
    for call in calls:
        want = layout(call(0))
        with mode:
            first = layout(call(0))
            n = len(mode._layouts)
            again = layout(call(20))
        assert first == again == want
        assert len(mode._layouts) == n          # the repeat made no new entry


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_case(name: str, device: str):
    """(call, work, launch counter) of one wrapper at a small shape, its
    inputs made on the CPU and moved to ``device``."""
    g = torch.Generator().manual_seed(1)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(device)

    b, tt, h, n, d = 2, 5, 3, 16, 7
    if name == "wkv6":
        args = (t(b, tt, h, n), t(b, tt, h, n), t(b, tt, h, n),
                torch.rand((b, tt, h, n), generator=g).to(device), t(h, n), t(b, h, n, n))
        return lambda: wkv6_ops.wkv6(*args), work.wkv6(b, tt, h, n), wkv6_ops.wkv6
    if name == "wkv6_backward":
        args = (t(b, tt, h, n), t(b, tt, h, n), t(b, tt, h, n),
                torch.rand((b, tt, h, n), generator=g).to(device), t(h, n), t(b, h, n, n),
                t(b, tt, h, n), t(b, h, n, n))
        return (lambda: wkv6_ops.wkv6_backward(*args), work.wkv6_backward(b, tt, h, n),
                wkv6_ops.wkv6_backward)
    if name == "rglru_scan":
        args = (torch.rand((b, tt, d), generator=g).to(device), t(b, tt, d), t(b, d))
        return lambda: rglru_ops.rglru_scan(*args), work.rglru(b, tt, d), rglru_ops.rglru_scan
    if name == "rglru_scan_backward":
        args = (torch.rand((b, tt, d), generator=g).to(device), t(b, tt, d), t(b, d),
                t(b, tt, d), t(b, d))
        return (lambda: rglru_ops.rglru_scan_backward(*args), work.rglru_backward(b, tt, d),
                rglru_ops.rglru_scan_backward)
    if name == "whitedata_filter":
        gg, r = t(11, 13, dtype=torch.bfloat16), t(11, 13)
        return (lambda: filter_ops.whitedata_filter(gg, r, 0.5), work.whitedata_filter(143, 2, 4),
                filter_ops.whitedata_filter)
    if name == "crdt_merge_rows":
        table = torch.randint(0, 100, (20, 6), generator=g, dtype=torch.int32).to(device)
        rows = torch.randperm(20, generator=g)[:9].to(device)
        new_val = torch.randint(0, 100, (9, 6), generator=g, dtype=torch.int32).to(device)
        cur = torch.randint(0, 5, (9,), generator=g, dtype=torch.int32).to(device)
        new = torch.randint(0, 5, (9,), generator=g, dtype=torch.int32).to(device)
        return (lambda: (merge_ops.crdt_merge_rows(table, rows, cur, new_val, new),),
                work.crdt_merge_rows(9, 6, 4), merge_ops.crdt_merge_rows)
    if name == "crdt_join_rows":
        table = (torch.randint(0, 100, (20, 6), generator=g, dtype=torch.int32).to(device),
                 torch.randint(-1, 3, (20, 3), generator=g).to(device),
                 torch.randint(0, 24, (20,), generator=g).to(device),
                 (torch.rand(20, generator=g) < 0.7).to(device))
        batch = (torch.randperm(20, generator=g)[:9].to(device),
                 torch.randint(0, 100, (9, 6), generator=g, dtype=torch.int32).to(device),
                 torch.randint(-1, 3, (9, 3), generator=g).to(device),
                 torch.randint(0, 24, (9,), generator=g).to(device))
        return (lambda: (merge_ops.crdt_join_rows(*table, *batch),),
                work.crdt_join_rows(9, 6, 4), merge_ops.crdt_join_rows)
    m, w = 9, 6
    va = torch.randint(0, 100, (m, w), generator=g, dtype=torch.int32).to(device)
    vb = torch.randint(0, 100, (m, w), generator=g, dtype=torch.int32).to(device)
    ra = torch.randint(0, 5, (m,), generator=g, dtype=torch.int32).to(device)
    rb = torch.randint(0, 5, (m,), generator=g, dtype=torch.int32).to(device)
    return (lambda: merge_ops.crdt_merge(va, ra, vb, rb), work.crdt_merge(m, w, 4),
            merge_ops.crdt_merge)


KERNELS = ["wkv6", "wkv6_backward", "rglru_scan", "rglru_scan_backward", "whitedata_filter",
           "crdt_merge", "crdt_merge_rows", "crdt_join_rows"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_counts_its_work_once(name, device):
    call, want, counter = _kernel_case(name, device)
    before = counter.launches
    mode = CostMode(device)
    with mode:
        out = call()
    got = mode.summary()
    assert (got["flops"], got["bytes"], got["kernel_calls"]) == (want.flops, want.nbytes, 1)
    assert (got["kernel_flops"], got["kernel_bytes"]) == (want.flops, want.nbytes)
    assert counter.launches == before
    if device == "meta":        # the plain version's shapes and dtypes, no values
        ref, _, _ = _kernel_case(name, "cpu")
        ref_out = ref()
        for x, y in zip(out, ref_out):
            assert x.device.type == "meta"
            assert (x.shape, x.dtype) == (y.shape, y.dtype)


def test_meta_branches_refuse_what_the_kernels_refuse():
    x = torch.empty(1, 2, 1, 16, device="meta", dtype=torch.float64)
    with pytest.raises(TypeError):
        wkv6_ops.wkv6(x, x, x, x, torch.empty(1, 16, device="meta", dtype=torch.float64),
                      torch.empty(1, 1, 16, 16, device="meta", dtype=torch.float64))
    y = torch.empty(1, 2, 1, 24, device="meta")     # no kernel for head dim 24
    with pytest.raises(ValueError, match="head dims"):
        wkv6_ops.wkv6(y, y, y, y, torch.empty(1, 24, device="meta"),
                      torch.empty(1, 1, 24, 24, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        a = torch.empty(2, 3, 4, device="meta").transpose(0, 1)
        rglru_ops.rglru_scan(a, a, torch.empty(3, 4, device="meta"))
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(torch.empty(1, 2, 3), torch.empty(1, 2, 3, device="meta"),
                             torch.empty(1, 3))


# ---------------------------------------------------------------------------
# the wire, rank by rank, against gloo ranks
# ---------------------------------------------------------------------------

WIRE_ARCH = "granite-moe-3b-a800m"
WIRE_BATCH, WIRE_SEQ, WIRE_CACHE = 4, 32, 40
STRATEGIES = ("flat", "hier", "geococo")
F32 = torch.float32


def _wire_tcfg(strategy: str) -> TrainConfig:
    return TrainConfig(sync=SyncConfig(strategy), compute_dtype=F32)


def _wire_rank(rank: int, shape: tuple) -> dict:
    """One training step under each strategy and a cached prefill and a
    decode step, on this gloo rank of a mesh of ``shape``: the bytes its
    counters handed to gloo."""
    mesh, _ = make_mesh(shape, device="cpu")
    cfg = get_smoke_config(WIRE_ARCH)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (WIRE_BATCH, WIRE_SEQ + 1), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    out = {}
    for strategy in STRATEGIES:
        tcfg = _wire_tcfg(strategy)
        state = StatePlacement(cfg, tcfg, torch.device("cpu"), mesh).initial(0)
        metrics = build_train_step(cfg, tcfg, "cpu", mesh)(
            state["params"], state["opt"], batch, state.get("residuals"))
        out[strategy] = {"pod": metrics["bytes_sent"], "inpod": metrics["inpod_bytes"],
                         "model": metrics["tp_bytes"]}
    tcfg = _wire_tcfg("hier")
    params = init_params(cfg, gen, "cpu")
    own = batch_rows(mesh.shape, mesh.coords, WIRE_BATCH)
    step = build_serve_step(cfg, tcfg, kind="decode", device="cpu", mesh=mesh)
    cache = init_local_cache(cfg, WIRE_BATCH, WIRE_CACHE, mesh.shape, F32, "cpu")
    _, cache = step.logits(params, cache, {"tokens": batch["tokens"][own]}, rows=WIRE_BATCH)
    out["prefill"] = {"model": step.ctx.stats.bytes_sent, "merge": step.ctx.merge_bytes}
    step.ctx.reset()
    step(params, cache, {"tokens": batch["tokens"][own, :1]}, rows=WIRE_BATCH)
    out["decode"] = {"model": step.ctx.stats.bytes_sent, "merge": step.ctx.merge_bytes}
    return out


@functools.cache
def _gloo_wire(shape: tuple) -> list[dict]:
    return run_local_ranks(_wire_rank, 4, (shape,), timeout=300)


def _dry_wire(what: str, shape: tuple, rank: int) -> dict:
    cfg = get_smoke_config(WIRE_ARCH)
    if what in STRATEGIES:
        wire = dryrun.dry_step(cfg, ShapeSpec("wire", WIRE_SEQ, WIRE_BATCH, "train"),
                               _wire_tcfg(what), shape, rank=rank)["wire"]
        return {"pod": wire["pod"], "inpod": wire["inpod"], "model": wire["model"] + wire["merge"]}
    if what == "prefill":
        wire = dryrun.dry_step(cfg, ShapeSpec("wire", WIRE_SEQ, WIRE_BATCH, "prefill"),
                               _wire_tcfg("hier"), shape, rank=rank, cache_len=WIRE_CACHE,
                               cache_dtype=F32)["wire"]
    else:
        wire = dryrun.dry_step(cfg, ShapeSpec("wire", WIRE_CACHE, WIRE_BATCH, "decode"),
                               _wire_tcfg("hier"), shape, rank=rank, cache_dtype=F32)["wire"]
    assert wire["pod"] == wire["inpod"] == 0.0
    return {"model": wire["model"] + wire["merge"], "merge": wire["merge"]}


@pytest.mark.parametrize("what", [*STRATEGIES, "prefill", "decode"])
@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)], ids=["2x1x2", "1x2x2"])
def test_wire_bytes_equal_each_gloo_rank(shape, what):
    ranks = _gloo_wire(shape)
    for rank, got in enumerate(ranks):
        assert _dry_wire(what, shape, rank) == got[what], f"rank {rank}"
    moved = [sum(got[what].values()) for got in ranks]
    assert all(m > 0 for m in moved)
    assert not dist.is_initialized()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_estimate_within_2x_of_dryrun_pod_bytes(strategy):
    rec = dryrun.run_cell("minitron-8b", "train_4k", "multi", strategy, tier="reduced",
                          smoke=True)
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 4}
    blocks = zero_residuals(get_smoke_config("minitron-8b"), "meta", rec["mesh_shape"], strategy)
    est = estimate_sync_bytes(blocks, SyncConfig(strategy), 2)
    measured = rec["collective_link_bytes_by_axes"]["pod"]
    assert 0.5 <= measured / est <= 2.0
    if strategy != "geococo":       # a dense wire: the model is exact
        assert measured == est


# ---------------------------------------------------------------------------
# the CLI and the process group
# ---------------------------------------------------------------------------


def _cli(*args: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600, env=env)


def test_cli_writes_an_ok_record_and_refuses_an_unknown_arch(tmp_path):
    out = tmp_path / "dr"
    res = _cli("--arch", "rwkv6-7b", "--shape", "decode_32k", "--mesh", "both", "--tier",
               "reduced", "--smoke", "--out", str(out), cwd=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    assert [(r["mesh"], r["status"]) for r in recs] == [("multi", "ok"), ("single", "ok")]
    for r in recs:
        assert r["tier"] == "reduced" and r["smoke"] and r["kind"] == "decode"
        assert r["cost"]["kernel_calls"] == get_smoke_config("rwkv6-7b").n_layers
        assert set(r["memory"]) == {"argument_gb", "temp_gb", "peak_gb"}
    assert recs[0]["mesh_shape"] == {"pod": 2, "data": 2, "model": 4}
    bad = _cli("--arch", "no-such-arch", "--tier", "reduced", "--smoke", "--out", str(out),
               cwd=tmp_path)
    assert bad.returncode == 1
    assert "no-such-arch" in bad.stderr


def test_no_process_group_is_left():
    cfg = get_smoke_config("minitron-8b")
    dryrun.dry_step(cfg, SMOKE_SHAPE["decode"], TrainConfig(), (1, 2, 2))
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with fake_mesh((2, 2, 2)):
            assert dist.is_initialized() and dist.get_world_size() == 8
            1 / 0
    assert not dist.is_initialized()
    with fake_mesh((1, 1, 2)):
        with pytest.raises(RuntimeError, match="initialised"):
            with fake_mesh((1, 1, 2)):
                pass
    assert not dist.is_initialized()
