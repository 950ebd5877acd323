#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit as ``nvidia-smi`` reports them;
2. build every kernel from the sources in this checkout, one ``nvcc`` per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with its CUDA-graph device time, its bound and the plain
   time;
4. rwkv6-7b at full width and depth, on its f32 weights: prefill + stepwise
   decode against the full forward, in f32 and bf16 compute, each decode
   position gated against a multiple of the noise floor measured in the same
   run without the cache; a decode fed a zeroed WKV state must fail the gate;
5. rwkv6-7b served through ``repro_torch.launch.serve``: batch 8, prompts of
   512 tokens, 32 generated tokens (one from prefill, 31 decode steps), with
   every kernel's launch count read around it, and the device time of a
   prefill and of a decode step by kernel from ``torch.profiler``;
6. recurrentgemma-9b at full width and all 38 layers, on its f32 weights:
   the check of phase 4 (linear attention cache), failed on purpose by a
   decode fed a zeroed RG-LRU state and by one fed a zeroed KV cache;
7. the local-attention ring cache, which the main path's 544-position cache
   never reaches: batch 2, a prompt of exactly the window (2048), 8 decode
   steps that wrap the ring, against the full forward (banded attention),
   f32, all 38 layers, gated as in phase 6;
8. recurrentgemma-9b served as in phase 5.

The rwkv6-7b weights are released before recurrentgemma-9b's are drawn: the
two would not fit on one 80 GB card together.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import concurrent.futures
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

RWKV, RG = "rwkv6-7b", "recurrentgemma-9b"
BATCH, PROMPT_LEN, GEN_LEN = 8, 512, 32
CHECK_PROMPT, CHECK_STEPS = 64, 4
RING_BATCH, RING_STEPS = 2, 8

# kernel vs plain, f32, relative to the output scale.  WKV6: the plain
# version sums y through a batched matmul in another order.  RG-LRU: the
# same recurrence, one FMA per step in the kernel where the plain version
# rounds the product and the sum; the recurrence is contractive, so the
# difference stays a few ulps of the state.
WKV6_TOL = 2e-5
RGLRU_TOL = 1e-5
# prefill + stepwise decode vs the full forward, at full depth.  The two
# differ only in the shapes of their GEMMs and reductions (B rows per decode
# step, B x 68 in the full forward), so their sums run in another order,
# and a random model of 32 or 38 layers amplifies that far beyond one
# rounding.  decode_limit measures this noise floor in the same run,
# changing only the row counts and with no cache involved, as the larger
# of: the last prompt position of a prompt-only forward, and the decode
# positions of the full forward run one sequence at a time, each against
# the full forward of the batch.  A decode position passes within
# FLOOR_MULT x that floor, or within DECODE_TOL where the floor is smaller
# (relative to the largest logit: f32 with TF32 off leaves room for
# summation order only; bf16 is the tolerance of tests/test_archs_smoke.py).
# A wrong state, token shift or layer cache is not a reordering of sums:
# each check shows that decode steps fed a zeroed part of the cache fail
# the same limit.
FLOOR_MULT = 4.0
DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# injected cache faults: the cache leaves zeroed before every decode step
RWKV_FAULTS = {"a zeroed WKV state": ("s",)}
RG_FAULTS = {"a zeroed RG-LRU state (h, conv)": ("h", "conv"),
             "a zeroed attention KV cache": ("k", "v")}
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


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time on the card (ms): bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def wkv6_input_bytes(b: int, t: int, h: int, n: int) -> int:
    """r/k/v/w, u and the initial state, float32."""
    return 4 * (4 * b * t * h * n + h * n + b * h * n * n)


def wkv6_bound(b: int, t: int, h: int, n: int) -> tuple[float, str]:
    """Least time for one WKV6 call: r/k/v/w/u/s0 read once, y and the final
    state written once; 5 N^2 operations per step and head in the factored
    form y = r.S + (r.(u*k)) v, S <- diag(w) S + k v^T."""
    nbytes = wkv6_input_bytes(b, t, h, n) + 4 * (b * t * h * n + b * h * n * n)
    return _bound(nbytes, 5 * b * h * t * n * n)


def rglru_input_bytes(b: int, t: int, d: int) -> int:
    """a, b and h0, float32."""
    return 4 * (2 * b * t * d + b * d)


def rglru_bound(b: int, t: int, d: int) -> tuple[float, str]:
    """Least time for one RG-LRU scan: a, b, h0 read once, h and h_T written
    once; one FMA (2 operations) per element and step."""
    nbytes = rglru_input_bytes(b, t, d) + 4 * (b * t * d + b * d)
    return _bound(nbytes, 2 * b * t * d)


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


def rglru_inputs(gen, b, t, d):
    import torch

    a = torch.rand((b, t, d), generator=gen, device="cuda") * 0.499 + 0.5
    bterm = torch.randn((b, t, d), generator=gen, device="cuda") * 0.5
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    return a, bterm, h0


def check_close(name: str, got, want, tol: float) -> float:
    import torch

    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        fail(f"{name}: max abs err {err:.3e} > {tol:g} x {scale:.3e}")
    print(f"  {name}: max abs err {err:.3e}, rel {err / scale:.2e} "
          f"(scale {scale:.3e}, tol {tol:g} x scale)")
    return err


def time_kernel(name, kernel, plain, make_inputs, shape, input_bytes, bound) -> dict:
    """Device time of ``kernel`` at ``shape`` from a CUDA-graph replay that
    cycles enough input sets (at least 12, and at least twice the 50 MB L2)
    that the L2 cannot hold them from one call to the next, as on the main
    path, whose layers each bring their own inputs; the plain version's
    device time and one eager call's time beside it."""
    n_sets = max(12, -(-2 * L2_BYTES // input_bytes(*shape)))
    sets = [make_inputs(*shape) for _ in range(n_sets)]
    ms = device_ms([functools.partial(kernel, *s) for s in sets])
    plain_ms = device_ms([functools.partial(plain, *sets[0])], reps=3)
    eager_ms = dispatch_ms(lambda: kernel(*sets[0]))
    bound_ms, bound_by = bound(*shape)
    print(f"  {name} {shape}: kernel {ms:.4f} ms on the device over {n_sets} input sets "
          f"({eager_ms:.4f} ms per eager call), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "eager_call_ms": eager_ms}


def kernel_entry(name: str, source: str, replaces: str, errs: list, timings: dict) -> dict:
    pre = timings["prefill"]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,          # filled in by the main path's run
        "max_abs_err": max(errs),
        "ms": pre["ms"],
        "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": None,
        "shape": pre["shape"],
        "decode": timings["decode"],
    }


def phase_wkv6(ops, wkv6_ref) -> dict:
    """WKV6 vs plain at the rwkv6 path's shapes (library_ms: no single
    PyTorch call computes WKV6)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, timings = [], {}
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
            timings[label] = time_kernel(
                "wkv6 " + label, ops.wkv6, wkv6_ref,
                lambda *sh, z=zero: wkv6_inputs(gen, *sh, zero_state=z),
                shape, wkv6_input_bytes, wkv6_bound)

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
    return kernel_entry("wkv6", "src/repro_torch/csrc/wkv6.cu",
                        "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:28", errs, timings)


def phase_rglru(ops, rglru_scan_ref) -> dict:
    """RG-LRU scan vs plain at the recurrentgemma path's shapes, with a
    nonzero h0 (library_ms: no single PyTorch call computes a stable linear
    recurrence)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, timings = [], {}
    cases = [("prefill", (BATCH, PROMPT_LEN, 4096)), ("decode", (BATCH, 1, 4096)),
             ("odd shape", (2, 37, 96))]
    for label, shape in cases:
        args = rglru_inputs(gen, *shape)
        h, h_last = ops.rglru_scan(*args)
        torch.cuda.synchronize()
        h_ref, last_ref = rglru_scan_ref(*args)
        errs.append(check_close(f"rglru_scan {label} {shape} h", h, h_ref, RGLRU_TOL))
        errs.append(check_close(f"rglru_scan {label} {shape} h_T", h_last, last_ref, RGLRU_TOL))
        if label in ("prefill", "decode"):
            timings[label] = time_kernel(
                "rglru_scan " + label, ops.rglru_scan, rglru_scan_ref,
                lambda *sh: rglru_inputs(gen, *sh), shape, rglru_input_bytes, rglru_bound)

    a, b, h0 = rglru_inputs(gen, BATCH, PROMPT_LEN, 4096)
    t1 = 200
    h1, last1 = ops.rglru_scan(a[:, :t1].contiguous(), b[:, :t1].contiguous(), h0)
    h2, last2 = ops.rglru_scan(a[:, t1:].contiguous(), b[:, t1:].contiguous(), last1)
    torch.cuda.synchronize()
    h_ref, last_ref = rglru_scan_ref(a, b, h0)
    errs.append(check_close("rglru_scan continuation h", torch.cat([h1, h2], 1), h_ref,
                            RGLRU_TOL))
    errs.append(check_close("rglru_scan continuation h_T", last2, last_ref, RGLRU_TOL))
    return kernel_entry("rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
                        "src/repro/kernels/rglru_scan/rglru_scan.py:27", errs, timings)


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


def decode_limit(cfg, params, seq, cdt, full, prompt: int = CHECK_PROMPT) -> float:
    """FLOOR_MULT x the noise floor of the stepwise-vs-full comparison, or
    DECODE_TOL where that is larger.  ``full`` is the forward over ``seq``."""
    import torch

    prefix = _rel(_logits(cfg, params, seq[:, :prompt], cdt)[0][:, -1], full[:, prompt - 1])
    split = torch.cat([_logits(cfg, params, seq[i:i + 1], cdt)[0][:, prompt:]
                       for i in range(seq.shape[0])])
    one_by_one = _rel(split, full[:, prompt:])
    limit = max(DECODE_TOL[str(cdt).removeprefix("torch.")],
                FLOOR_MULT * max(prefix, one_by_one))
    print(f"  noise floor, no cache: position {prompt - 1} of a {prompt}-token "
          f"forward {prefix:.3e}; one sequence at a time {one_by_one:.3e}; "
          f"limit {limit:.3e} x the largest logit")
    return limit


def _tensors(tree):
    """The tensors of a nested dict/list of parameters or cache."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for sub in tree for t in _tensors(sub)]
    return [tree]


def _zeroed(tree, names: tuple[str, ...]):
    """The cache with every tensor stored under one of ``names`` zeroed."""
    import torch

    if isinstance(tree, dict):
        return {k: torch.zeros_like(v) if k in names else _zeroed(v, names)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeroed(v, names) for v in tree]
    return tree


def decode_vs_full(cfg, params, seq, cdt, full, *, prompt: int = CHECK_PROMPT,
                   zero: tuple[str, ...] = ()) -> list[tuple[str, float]]:
    """``(label, error relative to the largest logit)`` per position: prefill
    of ``prompt`` tokens on a cache of ``seq``'s length, then the decode
    steps, against ``full``, the forward over all of ``seq`` in ``cdt``
    compute.  Each decode step is fed a cache whose leaves named in ``zero``
    are zeroed (a fault the check must catch)."""
    from repro_torch.models.model import init_cache

    cache = init_cache(cfg, seq.shape[0], seq.shape[1], dtype=cdt, device=seq.device)
    pre, cache = _logits(cfg, params, seq[:, :prompt], cdt, cache)
    out = [(f"position {prompt - 1} (prefill)", _rel(pre[:, -1], full[:, prompt - 1]))]
    for t in range(prompt, seq.shape[1]):
        step, cache = _logits(cfg, params, seq[:, t:t + 1], cdt, _zeroed(cache, zero))
        out.append((f"position {t} (decode)", _rel(step[:, 0], full[:, t])))
    return out


def check_decode(cfg, params, seq, cdt, prompt: int, faults: dict) -> None:
    """Phases 4, 6 and 7: every decode position within the limit, every
    injected fault beyond it."""
    full = _logits(cfg, params, seq, cdt)[0]
    limit = decode_limit(cfg, params, seq, cdt, full, prompt)
    for label, err in decode_vs_full(cfg, params, seq, cdt, full, prompt=prompt):
        print(f"  {label}: {err:.3e} x the largest logit ({err / limit:.2f} of the limit)")
        if err > limit:
            fail(f"{cfg.name} {cdt} {label}: stepwise vs full {err:.3e} > {limit:.3e}")
    for fault, names in faults.items():
        faulty = [err for label, err in decode_vs_full(cfg, params, seq, cdt, full,
                                                       prompt=prompt, zero=names)
                  if "decode" in label]
        print(f"  decode fed {fault}: {', '.join(f'{e:.3e}' for e in faulty)} "
              f"({max(faulty) / limit:.1f} x the limit at most)")
        if max(faulty) <= limit:
            fail(f"{cfg.name} {cdt}: the check does not catch a decode fed {fault}")


def phase_serve(tag: str, cfg, params, tcfg, dev, counters: dict, expected: dict) -> dict:
    """Serve ``cfg`` at BATCH x PROMPT_LEN, GEN_LEN tokens, through
    ``launch.serve``, with every kernel's launch count set to 0 just before
    and read just after; the device time of a prefill (before serving casts
    the weights) and of a decode step by kernel.  Returns the counts."""
    import torch

    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import forward, init_cache, param_count
    from repro_torch.train.train_step import build_serve_step

    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, seed=0)
    max_len = PROMPT_LEN + GEN_LEN
    matmul_params = param_count(cfg) - cfg.vocab_size * cfg.d_model   # the embedding is a gather
    matmul_flops = 2 * matmul_params * BATCH * PROMPT_LEN

    def prefill():       # as serve() prefills: f32 compute on the f32 weights
        with torch.inference_mode():
            forward(cfg, params, {"tokens": torch.from_numpy(prompts).to(dev)},
                    cache=init_cache(cfg, BATCH, max_len, dtype=torch.float32, device=dev),
                    compute_dtype=torch.float32)

    # profiled before serve() casts the weights; also the first-call set-up
    # of cuBLAS at these shapes, outside the counted run
    print(f"{tag} {cfg.name}: device time by kernel, outside the counted run")
    prefill_dev_ms = profile_device(f"prefill {BATCH}x{PROMPT_LEN}", prefill, 1, matmul_flops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    res = serve(cfg, params, prompts, GEN_LEN, tcfg, dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != expected:
        fail(f"{cfg.name}: kernel launches on the main path {launches}, expected {expected}")
    gen = res.tokens
    if gen.shape != (BATCH, GEN_LEN) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        fail(f"{cfg.name}: decoded tokens malformed: shape {gen.shape}")
    decode_steps = GEN_LEN - 1
    print(f"{tag} served {cfg.name}: prefill {BATCH}x{PROMPT_LEN} (f32 compute): "
          f"{res.prefill_s * 1e3:.1f} ms, {BATCH * PROMPT_LEN / res.prefill_s:.0f} prompt tokens/s")
    print(f"  decode {decode_steps} steps ({tcfg.compute_dtype}): "
          f"{res.decode_s / decode_steps * 1e3:.2f} ms/step, "
          f"{BATCH * decode_steps / res.decode_s:.1f} tokens/s")
    print(f"  peak device memory {peak_gb:.2f} GB; kernel launches {launches} "
          f"(1 prefill + {decode_steps} decode steps)")
    print(f"  sample row: {gen[0].tolist()}")
    print(f"  prefill matmuls: {matmul_flops / res.prefill_s / 1e12:.1f} TFLOP/s over the "
          f"prefill's wall time, a lower bound on their rate (2 x {matmul_params:,} x "
          f"{BATCH * PROMPT_LEN} tokens)")
    print_busy("prefill", prefill_dev_ms, res.prefill_s * 1e3)
    by_dtype: dict = {}
    for leaf in _tensors(params):
        by_dtype[leaf.dtype] = by_dtype.get(leaf.dtype, 0) + leaf.numel()
    print("  the serving copy after the cast: " + ", ".join(
        f"{n:,} {dt} parameters ({n * dt.itemsize / 1e9:.2f} GB)" for dt, n in by_dtype.items()))

    # decode device time, outside the counted run, on the weights serve() cast
    step = build_serve_step(cfg, tcfg, kind="decode", device=dev)
    state = {"cache": init_cache(cfg, BATCH, max_len, dtype=torch.float32, device=dev),
             "tok": torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)}

    def decode():
        tok, state["cache"] = step(params, state["cache"], {"tokens": state["tok"]})
        state["tok"] = tok[:, None]

    decode()
    decode_dev_ms = profile_device("decode step", decode, 3)
    print_busy("decode step", decode_dev_ms, res.decode_s / decode_steps * 1e3)
    return launches


def run_rwkv6(dev, tcfg, counters) -> dict:
    """Phases 4 and 5; the weights are freed on return."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import init_model, make_prompts
    from repro_torch.models.model import param_count

    cfg = get_config(RWKV)
    t0 = time.perf_counter()
    params = init_model(cfg, tcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[4] {cfg.name}: {param_count(cfg):,} parameters in f32 on the card "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    seq = torch.from_numpy(make_prompts(cfg, BATCH, CHECK_PROMPT + CHECK_STEPS, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[4] prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights)")
        check_decode(cfg, params, seq, cdt, CHECK_PROMPT, RWKV_FAULTS)
    return phase_serve("[5]", cfg, params, tcfg, dev, counters,
                       {"wkv6": cfg.n_layers * GEN_LEN, "rglru_scan": 0})


def run_recurrentgemma(dev, tcfg, counters) -> dict:
    """Phases 6, 7 and 8; the weights are freed on return."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import init_model, make_prompts
    from repro_torch.models.model import param_count

    cfg = get_config(RG)
    t0 = time.perf_counter()
    params = init_model(cfg, tcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_rglru = sum(blk.mixer == "rglru" for blk in cfg.block_list())
    print(f"[6] {cfg.name}: {param_count(cfg):,} parameters in f32 on the card "
          f"({time.perf_counter() - t0:.1f} s to draw); {n_rglru} RG-LRU and "
          f"{cfg.n_layers - n_rglru} local-attention blocks")

    # ---- 6. prefill + stepwise decode vs the full forward, linear KV cache
    seq = torch.from_numpy(make_prompts(cfg, BATCH, CHECK_PROMPT + CHECK_STEPS, seed=1)).to(dev)
    for cdt in (torch.float32, tcfg.compute_dtype):
        print(f"[6] prefill {CHECK_PROMPT} + {CHECK_STEPS} decode steps vs full forward, all "
              f"{cfg.n_layers} layers, {cdt} compute ({tcfg.param_dtype} weights), "
              f"a linear cache of {CHECK_PROMPT + CHECK_STEPS} positions")
        check_decode(cfg, params, seq, cdt, CHECK_PROMPT, RG_FAULTS)
    del seq

    # ---- 7. the ring cache: a prompt of exactly the window, decode wraps it
    window = cfg.local_window
    seq = torch.from_numpy(make_prompts(cfg, RING_BATCH, window + RING_STEPS, seed=2)).to(dev)
    print(f"[7] ring cache: batch {RING_BATCH}, prefill {window} + {RING_STEPS} decode steps "
          f"(cache of {window + RING_STEPS} positions -> a ring of {window}) vs the full "
          f"forward (banded attention), all {cfg.n_layers} layers, float32 compute")
    check_decode(cfg, params, seq, torch.float32, window,
                 {"a zeroed attention KV cache": ("k", "v")})
    del seq
    torch.cuda.empty_cache()

    # ---- 8. main path
    return phase_serve("[8]", cfg, params, tcfg, dev, counters,
                       {"wkv6": 0, "rglru_scan": n_rglru * GEN_LEN})


def build_all(_build) -> None:
    """Phase 2: one nvcc per source, all started together."""
    def timed(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        futures = {name: pool.submit(timed, name) for name in _build.SOURCES}
        for name, fut in futures.items():
            log, secs = fut.result()
            print(f"[2] {name}: {'built' if log else 'up to date'} in {secs:.2f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")


def main() -> None:
    t_start = time.perf_counter()
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wkv6_ops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
    from repro_torch.train.train_step import TrainConfig

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
    build_all(_build)

    # ---- 3. kernels vs plain
    print("[3] kernels vs plain PyTorch on the card")
    entries = {"wkv6": phase_wkv6(wkv6_ops, wkv6_ref),
               "rglru_scan": phase_rglru(rglru_ops, rglru_scan_ref)}
    counters = {"wkv6": wkv6_ops.wkv6, "rglru_scan": rglru_ops.rglru_scan}

    tcfg = TrainConfig()
    entries["wkv6"]["launches"] = run_rwkv6(dev, tcfg, counters)["wkv6"]
    torch.cuda.empty_cache()
    print(f"  released the {RWKV} weights: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "still allocated")
    entries["rglru_scan"]["launches"] = run_recurrentgemma(dev, tcfg, counters)["rglru_scan"]

    leaked = sorted(m for m in sys.modules if m == "jax" or m.split(".")[0] == "repro")
    if leaked:
        fail(f"the port imported {leaked}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
