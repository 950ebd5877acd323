#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit as ``nvidia-smi`` reports them;
2. build every kernel from the sources in this checkout;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its CUDA-event time, its bound and the plain time;
4. rwkv6-7b at full width and depth, on its f32 weights: prefill + stepwise
   decode against the full forward, in f32 and bf16 compute, each decode
   position gated against a multiple of the noise floor measured in the same
   run without the cache;
5. rwkv6-7b served through ``repro_torch.launch.serve``: batch 8, prompts of
   512 tokens, 32 generated tokens (one from prefill, 31 decode steps), with
   every kernel's launch count read around it, and the device time of a
   prefill and of a decode step by kernel from ``torch.profiler``.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
L2_BYTES = 50 * 2**20

ARCH = "rwkv6-7b"
BATCH, PROMPT_LEN, GEN_LEN = 8, 512, 32
CHECK_PROMPT, CHECK_STEPS = 64, 4

# kernel vs plain, f32: both run the same recurrence; the plain version sums
# y through a batched matmul in another order.  Relative to the output scale.
WKV6_TOL = 2e-5
# prefill + stepwise decode vs the full forward, at full depth.  The two
# differ only in the shapes of their GEMMs and reductions (B rows per decode
# step, B x 68 in the full forward), so their sums run in another order,
# and the random 32-layer model amplifies that far beyond one rounding.
# Phase 4 measures this noise floor in the same run, changing only the row
# counts and with no cache involved, as the larger of: position 63 of a
# 64-token forward, and the decode positions of the 68-token forward run
# one sequence at a time, each against the 68-token forward of the batch.
# A decode position passes within FLOOR_MULT x that floor, or within
# DECODE_TOL where the floor is smaller (relative to the largest logit: f32
# with TF32 off leaves room for summation order only; bf16 is the tolerance
# of tests/test_archs_smoke.py).  A wrong state, token shift or layer cache
# is not a reordering of sums; phase 4 shows that a decode fed a zeroed
# state fails the same limit.
FLOOR_MULT = 4.0
DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GEMM_KERNEL_MARKS = ("gemm", "nvjet", "xmma", "cutlass")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(calls: list, reps: int = 5) -> float:
    """Device time of one call: the ``calls`` captured in one CUDA graph and
    replayed between two CUDA events, so host dispatch is left out.  Median
    over ``reps`` replays, divided by the number of calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()                              # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def dispatch_ms(fn, reps: int = 50) -> float:
    """Median time of one eager call of ``fn`` between two CUDA events, host
    dispatch included: what the main path pays where the device waits on
    the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wkv6_input_bytes(b: int, t: int, h: int, n: int) -> int:
    """r/k/v/w, u and the initial state, float32."""
    return 4 * (4 * b * t * h * n + h * n + b * h * n * n)


def wkv6_bound(b: int, t: int, h: int, n: int) -> tuple[float, str]:
    """Least time for one WKV6 call: r/k/v/w/u/s0 read once, y and the final
    state written once; 5 N^2 operations per step and head in the factored
    form y = r.S + (r.(u*k)) v, S <- diag(w) S + k v^T."""
    nbytes = wkv6_input_bytes(b, t, h, n) + 4 * (b * t * h * n + b * h * n * n)
    flops = 5 * b * h * t * n * n
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def wkv6_inputs(gen, b, t, h, n, *, zero_state: bool):
    import torch

    def mk():
        return torch.randn((b, t, h, n), generator=gen, device="cuda")

    r, k, v = mk(), mk(), mk()
    w = torch.rand((b, t, h, n), generator=gen, device="cuda") * 0.399 + 0.6
    u = torch.randn((h, n), generator=gen, device="cuda") * 0.5
    s0 = torch.randn((b, h, n, n), generator=gen, device="cuda") * 0.1
    if zero_state:
        s0.zero_()
    return r, k, v, w, u, s0


def check_close(name: str, got, want, tol: float) -> float:
    import torch

    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        fail(f"{name}: max abs err {err:.3e} > {tol:g} x {scale:.3e}")
    print(f"  {name}: max abs err {err:.3e}, rel {err / scale:.2e} "
          f"(scale {scale:.3e}, tol {tol:g} x scale)")
    return err


def phase_wkv6(ops, wkv6_ref):
    """Kernel vs plain at the main path's shapes; returns the kernel's
    JSON fields measured here (launches are filled in by phase 4)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = []
    timings = {}
    cases = [
        ("prefill", (BATCH, PROMPT_LEN, 64, 64), True),
        ("decode", (BATCH, 1, 64, 64), False),
        ("smoke head dim 16", (2, 64, 4, 16), False),
    ]
    for label, shape, zero in cases:
        args = wkv6_inputs(gen, *shape, zero_state=zero)
        y, s = ops.wkv6(*args)
        torch.cuda.synchronize()
        y_ref, s_ref = wkv6_ref(*args)
        errs.append(check_close(f"wkv6 {label} {shape} y", y, y_ref, WKV6_TOL))
        errs.append(check_close(f"wkv6 {label} {shape} state", s, s_ref, WKV6_TOL))
        if label in ("prefill", "decode"):
            # enough input sets that the L2 (50 MB) cannot hold them from one
            # call to the next, as on the main path, whose 32 layers each
            # bring their own state
            n_sets = min(20, -(-2 * L2_BYTES // wkv6_input_bytes(*shape)))
            sets = [args] + [wkv6_inputs(gen, *shape, zero_state=zero) for _ in range(n_sets - 1)]
            ms = device_ms([functools.partial(ops.wkv6, *sets[i % n_sets]) for i in range(20)])
            plain_ms = device_ms([functools.partial(wkv6_ref, *args)], reps=3)
            eager_ms = dispatch_ms(lambda: ops.wkv6(*args))
            bound_ms, bound_by = wkv6_bound(*shape)
            timings[label] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "eager_call_ms": eager_ms}
            del sets
            print(f"  wkv6 {label} {shape}: kernel {ms:.4f} ms on the device "
                  f"({eager_ms:.4f} ms per eager call), plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")

    # state continuation: [0, t1) then [t1, T) with the carried state == one pass
    r, k, v, w, u, s0 = wkv6_inputs(gen, BATCH, PROMPT_LEN, 64, 64, zero_state=False)
    t1 = 200
    halves = [tuple(x[:, sl].contiguous() for x in (r, k, v, w))
              for sl in (slice(0, t1), slice(t1, None))]
    y1, s1 = ops.wkv6(*halves[0], u, s0)
    y2, s2 = ops.wkv6(*halves[1], u, s1)
    torch.cuda.synchronize()
    y_ref, s_ref = wkv6_ref(r, k, v, w, u, s0)
    errs.append(check_close("wkv6 continuation y", torch.cat([y1, y2], 1), y_ref, WKV6_TOL))
    errs.append(check_close("wkv6 continuation state", s2, s_ref, WKV6_TOL))

    pre = timings["prefill"]
    return {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:28",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": pre["ms"],
        "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": None,   # no single PyTorch call computes WKV6
        "shape": pre["shape"],
        "decode": timings["decode"],
    }


def profile_device(label: str, run, n_runs: int,
                   matmul_flops: float | None = None) -> float | None:
    """Device time per call of ``run()``, from torch.profiler over ``n_runs``
    calls, with the kernels that take most of it; None when the profiler saw
    no device activity.  With ``matmul_flops`` it also prints the rate of
    the GEMM kernels over their own device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_runs):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key) for e in kernels]
    total_ms = sum(t for t, _, _ in dev_us) / n_runs / 1e3
    if total_ms <= 0:
        print(f"  {label}: device time not measured (the profiler saw no device activity)")
        return None
    print(f"  {label}: {total_ms:.2f} ms of device time per call (torch.profiler, {n_runs} "
          f"calls), {sum(c for _, c, _ in dev_us) / n_runs:.0f} kernels per call")
    for t, c, name in sorted(dev_us, reverse=True)[:8]:
        print(f"    {t / n_runs / 1e3:8.3f} ms/call  {c / n_runs:5.0f} launches/call  {name[:90]}")
    if matmul_flops is not None:
        gemm_ms = sum(t for t, _, name in dev_us
                      if any(m in name.lower() for m in GEMM_KERNEL_MARKS)) / n_runs / 1e3
        if gemm_ms > 0:
            print(f"    GEMM kernels: {gemm_ms:.2f} ms of device time, "
                  f"{matmul_flops / gemm_ms / 1e9:.1f} TFLOP/s over their own time "
                  f"(f32 peak {F32_FLOPS / 1e12:g})")
        else:
            print("    GEMM kernels: not identified by name")
    return total_ms


def print_busy(label: str, device_ms: float | None, wall_ms: float) -> None:
    if device_ms is not None:
        print(f"  {label}: {device_ms:.2f} ms of device time vs {wall_ms:.2f} ms wall on the "
              f"main path: device busy {device_ms / wall_ms:.1%}")


def _logits(cfg, params, tokens, cdt, cache=None):
    import torch

    from repro_torch.models.model import forward

    with torch.inference_mode():
        out, cache = forward(cfg, params, {"tokens": tokens}, cache=cache, compute_dtype=cdt)
    if not bool(torch.isfinite(out).all()):
        fail(f"forward over {tuple(tokens.shape)} ({cdt}) produced non-finite logits")
    return out.float(), cache


def _rel(got, want) -> float:
    """Max abs difference relative to the largest logit (at least 1)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def decode_limit(cfg, params, seq, cdt, full) -> float:
    """FLOOR_MULT x the noise floor of the stepwise-vs-full comparison, or
    DECODE_TOL where that is larger.  ``full`` is the forward over ``seq``."""
    import torch

    prefix = _rel(_logits(cfg, params, seq[:, :CHECK_PROMPT], cdt)[0][:, -1],
                  full[:, CHECK_PROMPT - 1])
    split = torch.cat([_logits(cfg, params, seq[i:i + 1], cdt)[0][:, CHECK_PROMPT:]
                       for i in range(seq.shape[0])])
    one_by_one = _rel(split, full[:, CHECK_PROMPT:])
    limit = max(DECODE_TOL[str(cdt).removeprefix("torch.")],
                FLOOR_MULT * max(prefix, one_by_one))
    print(f"  noise floor, no cache: position {CHECK_PROMPT - 1} of a {CHECK_PROMPT}-token "
          f"forward {prefix:.3e}; one sequence at a time {one_by_one:.3e}; "
          f"limit {limit:.3e} x the largest logit")
    return limit


def decode_vs_full(cfg, params, seq, cdt, full, *,
                   zero_state: bool = False) -> list[tuple[str, float]]:
    """``(label, error relative to the largest logit)`` per position: prefill
    of CHECK_PROMPT tokens with the cache, then the decode steps, against
    ``full``, the forward over all of ``seq`` in ``cdt`` compute.  With
    ``zero_state`` each decode step is fed a zeroed WKV state (a fault the
    check must catch)."""
    import torch

    from repro_torch.models.model import init_cache

    cache = init_cache(cfg, seq.shape[0], dtype=cdt, device=seq.device)
    pre, cache = _logits(cfg, params, seq[:, :CHECK_PROMPT], cdt, cache)
    out = [(f"position {CHECK_PROMPT - 1} (prefill)", _rel(pre[:, -1], full[:, CHECK_PROMPT - 1]))]
    for t in range(CHECK_PROMPT, seq.shape[1]):
        if zero_state:
            cache = {"layers": [dict(c, tmix=dict(c["tmix"], s=torch.zeros_like(c["tmix"]["s"])))
                                for c in cache["layers"]]}
        step, cache = _logits(cfg, params, seq[:, t:t + 1], cdt, cache)
        out.append((f"position {t} (decode)", _rel(step[:, 0], full[:, t])))
    return out


def main() -> None:
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_wkv import ops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
    from repro_torch.launch.serve import init_model, make_prompts, serve
    from repro_torch.models.model import forward, init_cache, param_count
    from repro_torch.train.train_step import TrainConfig, build_serve_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build
    for name in _build.SOURCES:
        t0 = time.perf_counter()
        log = _build.build(name)
        print(f"[2] {name}: {'built' if log else 'up to date'} in "
              f"{time.perf_counter() - t0:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 3. kernels vs plain
    print("[3] kernels vs plain PyTorch on the card")
    wkv6_entry = phase_wkv6(ops, wkv6_ref)

    cfg = get_config(ARCH)
    tcfg = TrainConfig()
    n_params = param_count(cfg)
    t0 = time.perf_counter()
    params = init_model(cfg, tcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[4] {cfg.name}: {n_params:,} parameters in f32 on the card "
          f"({time.perf_counter() - t0:.1f} s to draw)")

    # ---- 4. prefill + stepwise decode vs the full forward, full width and depth
    seq = torch.from_numpy(make_prompts(cfg, BATCH, CHECK_PROMPT + CHECK_STEPS, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[4] prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights)")
        full = _logits(cfg, params, seq, cdt)[0]
        limit = decode_limit(cfg, params, seq, cdt, full)
        for label, err in decode_vs_full(cfg, params, seq, cdt, full):
            print(f"  {label}: {err:.3e} x the largest logit ({err / limit:.2f} of the limit)")
            if err > limit:
                fail(f"{cdt} {label}: stepwise vs full {err:.3e} > {limit:.3e}")
        faulty = [err for label, err in decode_vs_full(cfg, params, seq, cdt, full, zero_state=True)
                  if "decode" in label]
        print(f"  decode fed a zeroed state: {', '.join(f'{e:.3e}' for e in faulty)} "
              f"({max(faulty) / limit:.1f} x the limit at most)")
        if max(faulty) <= limit:
            fail(f"{cdt}: the check does not catch a decode step fed a zeroed state")
        del full
    del seq

    # ---- 5. main path: serve rwkv6-7b at full width
    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, seed=0)
    matmul_params = n_params - cfg.vocab_size * cfg.d_model    # the embedding is a gather
    matmul_flops = 2 * matmul_params * BATCH * PROMPT_LEN

    def prefill():       # as serve() prefills: f32 compute on the f32 weights
        with torch.inference_mode():
            forward(cfg, params, {"tokens": torch.from_numpy(prompts).to(dev)},
                    cache=init_cache(cfg, BATCH, dtype=torch.float32, device=dev),
                    compute_dtype=torch.float32)

    # profiled before serve() casts the weights; also the first-call set-up
    # of cuBLAS at these shapes, outside the timed run
    print(f"[5] {cfg.name}: device time by kernel, outside the counted run")
    prefill_dev_ms = profile_device(f"prefill {BATCH}x{PROMPT_LEN}", prefill, 1, matmul_flops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.wkv6.launches = 0
    res = serve(cfg, params, prompts, GEN_LEN, tcfg, dev)
    launches = ops.wkv6.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = cfg.n_layers * GEN_LEN
    if launches != expected:
        fail(f"wkv6 launched {launches} times on the main path, expected {expected}")
    gen = res.tokens
    if gen.shape != (BATCH, GEN_LEN) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        fail(f"decoded tokens malformed: shape {gen.shape}")
    wkv6_entry["launches"] = launches
    decode_steps = GEN_LEN - 1
    print(f"[5] served {cfg.name}: prefill {BATCH}x{PROMPT_LEN} (f32 compute): "
          f"{res.prefill_s * 1e3:.1f} ms, {BATCH * PROMPT_LEN / res.prefill_s:.0f} prompt tokens/s")
    print(f"  decode {decode_steps} steps ({tcfg.compute_dtype}): "
          f"{res.decode_s / decode_steps * 1e3:.2f} ms/step, "
          f"{BATCH * decode_steps / res.decode_s:.1f} tokens/s")
    print(f"  peak device memory {peak_gb:.2f} GB; wkv6 launches {launches} "
          f"= {cfg.n_layers} layers x (1 prefill + {decode_steps} decode steps)")
    print(f"  sample row: {gen[0].tolist()}")
    print(f"  prefill matmuls: {matmul_flops / res.prefill_s / 1e12:.1f} TFLOP/s over the "
          f"prefill's wall time, a lower bound on their rate (2 x {matmul_params:,} x "
          f"{BATCH * PROMPT_LEN} tokens)")
    print_busy("prefill", prefill_dev_ms, res.prefill_s * 1e3)

    # decode device time, outside the counted run, on the weights serve() cast
    step = build_serve_step(cfg, tcfg, kind="decode", device=dev)
    state = {"cache": init_cache(cfg, BATCH, dtype=torch.float32, device=dev),
             "tok": torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)}

    def decode():
        tok, state["cache"] = step(params, state["cache"], {"tokens": state["tok"]})
        state["tok"] = tok[:, None]

    decode()
    decode_dev_ms = profile_device("decode step", decode, 3)
    print_busy("decode step", decode_dev_ms, res.decode_s / decode_steps * 1e3)

    leaked = sorted(m for m in sys.modules if m == "jax" or m.split(".")[0] == "repro")
    if leaked:
        fail(f"the port imported {leaked}")
    print(json.dumps({"kernels": [wkv6_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
