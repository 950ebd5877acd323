"""Roofline over the dry-run's records (the counterpart of
``repro.launch.roofline``), for one NVIDIA H100 SXM5 a rank.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun results/dryrun-torch

Per (arch x shape x mesh) cell, three terms from rank 0's counts
(``launch.dryrun``), each the least time the card and its links could
take:

    t_compute    = FLOPs / the peak of the cell's compute dtype
    t_memory     = HBM bytes / HBM3's rate
    t_collective = data+model bytes / NVLink's rate + pod bytes / InfiniBand's

The peaks are the H100 SXM5 data sheet's (NVIDIA): bf16 dense tensor
989.4 TFLOP/s, f32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s,
NVLink 4 900 GB/s a GPU in both directions (450 GB/s each way); the pod
axis crosses one 400 Gb/s NDR InfiniBand port a GPU (50 GB/s each way),
as a DGX H100 wires its eight ConnectX-7 ports.  The ``data`` and
``model`` axes are taken at NVLink's rate.  The bytes a rank hands to
gloo are what would cross its links; gloo's ring factors are in them.

Also MODEL_FLOPS = 6 N_active D (train), 2 N_active D (prefill), 2
N_active B (decode) a rank, the useful share of the counted FLOPs, the
dominant term and a note on what would move it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.base import SHAPES
from ..configs.registry import get_config
from ..models.model import active_param_count

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "POD_BW", "roofline_terms", "model_flops",
           "build_table", "main"]

# NVIDIA H100 SXM5 data sheet
PEAK_FLOPS = {"bfloat16": 989.4e12,     # dense tensor-core bf16
              "float32": 67e12}         # f32 outside the tensor cores
HBM_BW = 3.35e12                        # HBM3, B/s
NVLINK_BW = 450e9                       # NVLink 4, B/s each way (data, model)
POD_BW = 50e9                           # one 400 Gb/s NDR InfiniBand port a GPU (pod)


def model_flops(arch: str, shape_name: str, mesh_shape: dict) -> float:
    """Analytic useful FLOPs a rank a step."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = active_param_count(cfg)
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len / chips
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len / chips
    return 2.0 * n_active * shape.global_batch / chips      # decode: one token a sequence


def roofline_terms(rec: dict) -> dict:
    cost, by_axes = rec["cost"], rec["collective_link_bytes_by_axes"]
    peak = PEAK_FLOPS[rec.get("compute_dtype", "bfloat16")]
    t_compute = cost["flops"] / peak
    t_memory = cost["bytes"] / HBM_BW
    nvlink_bytes = sum(v for k, v in by_axes.items() if k != "pod")
    t_nvlink = nvlink_bytes / NVLINK_BW
    t_pod = by_axes.get("pod", 0.0) / POD_BW
    t_coll = t_nvlink + t_pod
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_collective_nvlink_s": t_nvlink,
        "t_collective_pod_s": t_pod,
    }
    terms["dominant"] = max(("compute", t_compute), ("memory", t_memory),
                            ("collective", t_coll), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    terms["roofline_step_s"] = bound
    terms["compute_fraction_of_bound"] = t_compute / bound if bound else 0.0
    mf = model_flops(rec["arch"], rec["shape"], rec["mesh_shape"])
    terms["model_flops"] = mf
    terms["useful_ratio"] = mf / cost["flops"] if cost["flops"] else 0.0
    # MFU at the bound (what perfect overlap would reach)
    terms["roofline_mfu"] = mf / (bound * peak) if bound else 0.0
    return terms


_NOTES = {
    "compute": "compute-bound: keep the tensor cores fed (bf16 GEMMs, fewer f32 elementwise "
               "passes) or cut recompute (remat policy)",
    "memory": "HBM-bound: fuse elementwise chains, cut activation precision, reduce remat re-reads",
    "collective": "collective-bound: shrink the dominant axis' traffic (sums as all-reduces, "
                  "not gathers; sharded serving weights; a sparse pod wire)",
}


def build_table(dryrun_dir: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            rows.append({"arch": rec.get("arch"), "shape": rec.get("shape"),
                         "mesh": rec.get("mesh"), "strategy": rec.get("strategy"),
                         "status": "fail", "error": rec.get("error", "")[:200]})
            continue
        terms = roofline_terms(rec)
        rows.append({"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
                     "strategy": rec["strategy"], "status": "ok",
                     "peak_gb": rec["memory"]["peak_gb"], "trace_s": rec["trace_s"], **terms,
                     "note": _NOTES[terms["dominant"]]})
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun-torch")
    ap.add_argument("--out", default="results/roofline-torch.json")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"],
                    help="the meshes of the printed table")
    args = ap.parse_args(argv)
    rows = build_table(args.dryrun)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)

    sel = [r for r in rows if r["status"] == "ok" and args.mesh in ("both", r["mesh"])]
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':6s} {'strat':6s} {'t_comp':>9s} {'t_mem':>9s} "
           f"{'t_coll':>9s} {'dom':>6s} {'bound s':>9s} {'MFU@roof':>8s} {'useful':>7s} "
           f"{'peakGB':>8s} {'trace s':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for r in sel:
        print(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} {r['strategy']:6s} "
              f"{r['t_compute_s']:9.3f} {r['t_memory_s']:9.3f} {r['t_collective_s']:9.3f} "
              f"{r['dominant'][:6]:>6s} {r['roofline_step_s']:9.3f} {r['roofline_mfu']:8.1%} "
              f"{r['useful_ratio']:7.2f} {r['peak_gb']:8.1f} {r['trace_s']:8.1f}")
    fails = [r for r in rows if r["status"] != "ok"]
    if fails:
        print(f"\n{len(fails)} failed cells:")
        for r in fails:
            print(f"  {r['arch']} {r['shape']} {r['mesh']}: {r['error'][:120]}")
    print(f"\nfull table -> {args.out}")


if __name__ == "__main__":
    main()
