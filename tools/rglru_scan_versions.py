"""The RG-LRU scan kernels, forward and backward, in several versions on the card.

Builds ``src/repro_torch/csrc/rglru_scan.cu`` and ``rglru_scan_backward.cu``
as they are, with other ring sizes where asked, and other versions of the
two sources (for example the parent commit's), checks each against the
plain recurrences, and times each at the training shape (1, 4096, 4096) and
the serving prefill's (8, 512, 4096) from a CUDA-graph replay over input
sets that the 50 MB L2 cannot hold (12 for the forward and 3 for the
backward, as ``chip_smoke.py`` times them), the versions in turns, forwards
and then backwards:

    git show HEAD~1:src/repro_torch/csrc/rglru_scan.cu > build/parent_fwd.cu
    git show HEAD~1:src/repro_torch/csrc/rglru_scan_backward.cu > build/parent_bwd.cu
    python3 tools/rglru_scan_versions.py \\
        --also parent=build/parent_fwd.cu,build/parent_bwd.cu --ring 32,4

``--ring K,S`` adds a version of both sources whose ring holds S stages of K
steps; ``--cuts`` adds versions with one part cut out at a time (the walk,
the ring's refills, the stores of the outputs), which compute wrong values
and are only timed.  Run from the root of the checkout, on a machine with a
CUDA card and ``nvcc``; the libraries go to ``build/rglru_scan_versions/``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "rglru_scan_versions"
SHAPES = ((1, 4096, 4096), (8, 512, 4096))
RING = ("constexpr int kSteps = ", "constexpr int kStages = ")
# part -> (anchor, replacement) pairs, each applied to the sources that hold it
CUTS: dict[str, list[tuple[str, str]]] = {
    "the walk": [("    if (live && nk == K) {\n", "    if (live && T < 0) {\n"),
                 ("    if (live && t0 > 0) {\n", "    if (live && T < 0) {\n"),
                 ("    } else if (live) {", "    } else if (live && T < 0) {")],
    "the refills": [("    if (st + S - 1 < n_stages) fill(st + S - 1);\n", "")],
    "the stores": [
        ("          *reinterpret_cast<float4*>(g) = "
         "*reinterpret_cast<const float4*>(so + k * kLanes + c);\n", ""),
        ("          *reinterpret_cast<float4*>(ga) = "
         "*reinterpret_cast<const float4*>(so + k * kLanes + c);\n"
         "          *reinterpret_cast<float4*>(gb) =\n"
         "              *reinterpret_cast<const float4*>(so + (K + k) * kLanes + c);\n", "")],
}


def ring_variant(src: str, ks: str) -> str:
    """``src`` with a ring of S stages of K steps, ``ks`` = "K,S"."""
    for anchor, value in zip(RING, ks.split(",")):
        src, n = re.subn(re.escape(anchor) + r"\d+;", f"{anchor}{int(value)};", src)
        if n != 1:
            raise SystemExit(f"anchor not in the source: {anchor}")
    return src


def cut(pair: tuple[str, str], edits: list[tuple[str, str]]) -> tuple[str, str]:
    out = list(pair)
    for anchor, replacement in edits:
        if not any(anchor in src for src in out):
            raise SystemExit(f"anchor in neither source:\n{anchor}")
        out = [src.replace(anchor, replacement) for src in out]
    return tuple(out)


def build(versions: dict[str, tuple[str, str]], nvcc: str, flags: tuple[str, ...]) -> dict:
    """Compile every source at once, one nvcc each; the loaded entry points
    (forward, backward) of each version, and what ptxas said of them."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, pair) in enumerate(versions.items()):
        for part, src in zip(("fwd", "bwd"), pair):
            cu = OUT / f"v{i}_{part}.cu"
            cu.write_text(src)
            procs[name, part] = (cu.with_suffix(".so"), subprocess.Popen(
                [nvcc, *flags, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {name: {} for name in versions}
    for (name, part), (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} {part}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name} {part}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        fn = lib.rglru_scan_forward if part == "fwd" else lib.rglru_scan_backward
        fn.argtypes = [ctypes.c_void_p] * (5 if part == "fwd" else 8) + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name][part] = fn
    return fns


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--also", action="append", default=[], metavar="NAME=FWD,BWD",
                        help="another version of the two sources, timed beside these")
    parser.add_argument("--ring", action="append", default=[], metavar="K,S")
    parser.add_argument("--cuts", action="store_true")
    args = parser.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_backward_ref, rglru_scan_ref

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    here = ((CSRC / "rglru_scan.cu").read_text(), (CSRC / "rglru_scan_backward.cu").read_text())
    versions = {"this": here}
    for ks in args.ring:
        versions[f"ring {ks}"] = tuple(ring_variant(s, ks) for s in here)
    if args.cuts:
        versions.update({f"without {part}": cut(here, edits) for part, edits in CUTS.items()})
    for item in args.also:
        name, _, paths = item.partition("=")
        versions[name] = tuple(Path(p).read_text() for p in paths.split(","))
    fns = build(versions, _build._nvcc(), _build.NVCC_FLAGS)

    def run(fn, *tensors):
        b, t, d = tensors[0].shape
        rc = fn(*(x.data_ptr() for x in tensors), b, t, d, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    def forward(fn, a, bterm, h0):
        h, h_last = torch.empty_like(a), torch.empty_like(h0)
        run(fn, a, bterm, h0, h, h_last)
        return h, h_last

    def backward(fn, a, h, h0, dh, dh_last):
        da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
        run(fn, a, h, h0, dh, dh_last, da, db, dh0)
        return da, db, dh0

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(20)
    for shape in SHAPES:
        fwd_sets = [cs.rglru_inputs(gen, *shape) for _ in range(12)]
        bwd_sets = []
        for a, bterm, h0 in fwd_sets[:3]:
            h, _ = rglru_scan_ref(a, bterm, h0)
            bwd_sets.append((a, h, h0, torch.randn(shape, generator=gen, device="cuda"),
                             torch.randn(shape[::2], generator=gen, device="cuda")))
        want_f = rglru_scan_ref(*fwd_sets[0])
        want_b = rglru_scan_backward_ref(*bwd_sets[0])
        for name, pair in fns.items():
            if name.startswith("without"):
                continue
            for got, want in ((forward(pair["fwd"], *fwd_sets[0]), want_f),
                              (backward(pair["bwd"], *bwd_sets[0]), want_b)):
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    cs.check_close(f"{name} {shape}", g, w, cs.RGLRU_TOL)
        times = {(name, part): [] for name in fns for part in ("fwd", "bwd")}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name, "fwd"].append(cs.device_ms(
                    [functools.partial(forward, fns[name]["fwd"], *s) for s in fwd_sets]))
                times[name, "bwd"].append(cs.device_ms(
                    [functools.partial(backward, fns[name]["bwd"], *s) for s in bwd_sets],
                    reps=3))
        del fwd_sets, bwd_sets
        torch.cuda.empty_cache()
        for part, bound in (("fwd", cs.rglru_bound), ("bwd", cs.rglru_backward_bound)):
            bound_ms, bound_by = bound(*shape)
            print(f"rglru_scan {part} {shape}, bound {bound_ms:.4f} ms ({bound_by})")
            for name in fns:
                ts = times[name, part]
                print(f"  {name}: {min(ts):.4f} ms ({', '.join(f'{x:.4f}' for x in ts)}), "
                      f"{bound_ms / min(ts):.1%} of bound")


if __name__ == "__main__":
    main()
