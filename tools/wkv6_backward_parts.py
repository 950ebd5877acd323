"""Where the WKV6 backward kernel's time goes, on the card.

Builds ``src/repro_torch/csrc/wkv6_backward.cu`` as it is and with one part
cut out at a time, times each at the training shape (2, 4096, 64, 64) from
a CUDA-graph replay over three input sets (as ``chip_smoke.py`` times the
kernel), and prints each time and what the cut part cost.  A cut variant
computes wrong values: only its time means anything.  Other versions of the
source can be timed beside it, in turns, for example the parent commit's:

    git show HEAD~1:src/repro_torch/csrc/wkv6_backward.cu > build/parent.cu
    python3 tools/wkv6_backward_parts.py --also parent=build/parent.cu

Run from the root of the checkout, on a machine with a CUDA card and
``nvcc``; the libraries go to ``build/wkv6_backward_parts/``.  A cut whose
anchor text is no longer in the source fails with that text.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "wkv6_backward.cu"
OUT = ROOT / "build" / "wkv6_backward_parts"
SHAPE = (2, 4096, 64, 64)

# part -> (anchor in the source, its replacement), applied in turn
CUTS: dict[str, list[tuple[str, str]]] = {
    "the forward checkpoint sweep": [(
        "  for (int c = 0; c < n_chunks; ++c) {\n    store_tile<N>",
        "  if (T < 0) for (int c = 0; c < n_chunks; ++c) {\n    store_tile<N>")],
    "the recompute of a chunk's states": [(
        "      for (int s = 0; s < kChunk - 1; ++s) recompute(s);\n", "")],
    "7 of each chunk's 8 steps": [(
        "      for (int s = kChunk - 2; s >= 0; --s) step_from_hist(s);\n", "")],
    "the steps' shuffles": [
        ("      fold<6>(x, cg & (G / 2), G / 2, M);\n      fold<3>(x, cg & (G / 4), G / 4, M);\n",
         ""),
        ("        fold<2>(x, cg & 2, 2, M);\n        fold<1>(x, cg & 1, 1, M);\n", ""),
        ("      fold<2>(pv, lane & (L / 2), L / 2, M);\n", ""),
        ("        fold<1>(pv, lane & (L / 4), L / 4, M);\n", "")],
    "the finish passes": [
        ("    if (c + 1 < n_chunks) finish(c + 1);\n", ""),
        ("  finish(0);\n", "")],
}


def cut(src: str, pairs: list[tuple[str, str]]) -> str:
    for anchor, replacement in pairs:
        if anchor not in src:
            raise SystemExit(f"anchor not in {SOURCE.name}:\n{anchor}")
        src = src.replace(anchor, replacement)
    return src


def build(sources: dict[str, str], nvcc: str, flags: tuple[str, ...]) -> dict:
    """Compile every source at once, one nvcc each; the loaded entry points."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(src)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *flags, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(str(so)).wkv6_backward
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--also", action="append", default=[], metavar="NAME=PATH",
                        help="another version of the source, timed beside this one")
    args = parser.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    src = SOURCE.read_text()
    sources = {"whole kernel": src}
    sources.update({f"without {part}": cut(src, pairs) for part, pairs in CUTS.items()})
    for item in args.also:
        name, _, path = item.partition("=")
        sources[name] = Path(path).read_text()
    fns = build(sources, _build._nvcc(), _build.NVCC_FLAGS)

    def run(fn, r, k, v, w, u, state, dy, ds_fin):
        b, t, h, n = r.shape
        ckpt = torch.empty((b * h, -(-t // 8), n, n), dtype=torch.float32, device=r.device)
        outs = [torch.empty_like(r) for _ in range(4)]
        du_part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
        ds0 = torch.empty_like(state)
        rc = fn(*(x.data_ptr() for x in (r, k, v, w, u, state, dy, ds_fin, ckpt, *outs,
                                         du_part, ds0)),
                b, t, h, n, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    gen = torch.Generator(device="cuda").manual_seed(5)
    sets = []
    for _ in range(3):
        b, t, h, n = SHAPE
        sets.append((*cs.wkv6_inputs(gen, b, t, h, n, zero_state=True),
                     torch.randn(SHAPE, generator=gen, device="cuda"),
                     torch.zeros((b, h, n, n), device="cuda")))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):       # in turns: forwards, then backwards
        for name in order:
            times[name].append(cs.device_ms([functools.partial(run, fns[name], *s)
                                             for s in sets], reps=3))
    whole = min(times["whole kernel"])
    bound_ms, bound_by = cs.wkv6_backward_bound(*SHAPE)
    print(f"WKV6 backward {SHAPE}, bound {bound_ms:.4f} ms ({bound_by})")
    for name, ts in times.items():
        ms = min(ts)
        print(f"  {name}: {ms:.4f} ms ({', '.join(f'{x:.4f}' for x in ts)}), "
              f"{ms / SHAPE[1] * 1e3:.4f} us per step, {whole - ms:+.4f} ms against the whole")


if __name__ == "__main__":
    main()
