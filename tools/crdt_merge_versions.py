"""The CRDT merge kernels in several versions on the card.

Builds ``src/repro_torch/csrc/crdt_merge.cu`` as it is and other versions of
it given on the command line (for example the parent commit's), checks each
against the plain versions, and times them in turns, each from a CUDA-graph
replay as ``chip_smoke.py`` times them:

* the dense merge at (3,400, 250) int32, over input sets past the 50 MB L2,
  and at (10^7, 250) int32 on one input set (20 GB);
* at a commit's size, 3,400 distinct rows of 250 int32 words joined into a
  table of 10^7 rows, every row taken, over input sets past the L2: the
  table's rows gathered, merged by the version's dense kernel and scattered
  back (the commit's path before the indexed join), and the indexed join
  where the version has one;
* once a turn, the join as the library's four calls (``index_select``,
  ``torch.where``, ``torch.maximum``, ``index_copy_``).

    git show HEAD~1:src/repro_torch/csrc/crdt_merge.cu > build/parent_merge.cu
    python3 tools/crdt_merge_versions.py --also parent=build/parent_merge.cu

Run from the root of the checkout, on a machine with a CUDA card and
``nvcc``; the libraries go to ``build/crdt_merge_versions/``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "crdt_merge.cu"
OUT = ROOT / "build" / "crdt_merge_versions"
K, N, TABLE_ROWS, BIG_ROWS = 3400, 250, 10_000_000, 10_000_000
CHUNK = 1_000_000


def build(versions: dict[str, str], nvcc: str, flags: tuple[str, ...]) -> dict:
    """Compile every version at once, one nvcc each; (dense, join) entry
    points of each, the join None where the version has none."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(versions.items()):
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
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        dense = lib.crdt_merge_forward
        dense.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                          + [ctypes.c_int, ctypes.c_void_p])
        dense.restype = ctypes.c_int
        join = getattr(lib, "crdt_merge_rows_forward", None)
        if join is not None:
            join.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                             + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
            join.restype = ctypes.c_int
        fns[name] = (dense, join)
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
    from repro_torch.kernels.crdt_merge.ref import crdt_merge_ref, crdt_merge_rows_ref

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    versions = {"this": SOURCE.read_text()}
    for item in args.also:
        name, _, path = item.partition("=")
        versions[name] = Path(path).read_text()
    fns = build(versions, _build._nvcc(), _build.NVCC_FLAGS)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dense(fn, va, ra, vb, rb):
        out_val, out_ver = torch.empty_like(va), torch.empty_like(ra)
        rc = fn(va.data_ptr(), ra.data_ptr(), vb.data_ptr(), rb.data_ptr(), out_val.data_ptr(),
                out_ver.data_ptr(), va.shape[0], va.shape[1], va.element_size(), stream())
        if rc != 0:
            raise RuntimeError(f"dense launch failed ({rc})")
        return out_val, out_ver

    def join(fn, table, rows, cur, new_val, new):
        out_rank = torch.empty_like(cur)
        rc = fn(table.data_ptr(), table.shape[0], rows.data_ptr(), cur.data_ptr(),
                new_val.data_ptr(), new.data_ptr(), out_rank.data_ptr(), rows.numel(),
                table.shape[1], table.element_size(), stream())
        if rc != 0:
            raise RuntimeError(f"join launch failed ({rc})")
        return out_rank

    def table_paths(dense_fn, join_fn) -> dict:
        """The ways a version joins a batch into the table's rows."""
        out = {"gather, merge, scatter": functools.partial(
            cs.gather_merge_scatter, functools.partial(dense, dense_fn))}
        if join_fn is not None:
            out["join"] = functools.partial(join, join_fn)
        return out

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(30)
    set_bytes = 2 * (4 * K * N + 4 * K)
    n_sets = max(12, -(-2 * cs.L2_BYTES // set_bytes))
    small = [(*cs.merge_batch(gen, K, N), *cs.merge_batch(gen, K, N)) for _ in range(n_sets)]
    big = (*cs.merge_batch(gen, BIG_ROWS, N), *cs.merge_batch(gen, BIG_ROWS, N))
    table = torch.randint(-2**31, 2**31 - 1, (TABLE_ROWS, N), generator=gen, device="cuda",
                          dtype=torch.int32)
    joins = [cs.join_inputs(gen, TABLE_ROWS, K, N, torch.int32, top=2**20, taken=True)
             for _ in range(n_sets)]

    # ---- each version against the plain versions
    for name, (dense_fn, join_fn) in fns.items():
        for label, inputs in (("small", small[0]), ("big", big)):
            got_val, got_ver = dense(dense_fn, *inputs)
            torch.cuda.synchronize()
            m = inputs[0].shape[0]
            for lo in range(0, m, CHUNK):
                sl = slice(lo, lo + CHUNK)
                want_val, want_ver = crdt_merge_ref(*(x[sl] for x in inputs))
                cs.same_bits(f"{name} dense {label} rows {lo}+", got_val[sl], want_val)
                cs.same_bits(f"{name} dense {label} versions {lo}+", got_ver[sl], want_ver)
            del got_val, got_ver
        for label, fn in table_paths(dense_fn, join_fn).items():
            want = table.clone()
            want_rank = crdt_merge_rows_ref(want, *joins[0])
            got_rank = fn(table, *joins[0])
            torch.cuda.synchronize()
            cs.same_bits(f"{name} {label} table", table, want)
            cs.same_bits(f"{name} {label} out_rank", got_rank, want_rank)
            del want
        torch.cuda.empty_cache()
        print(f"  {name}: bit-exact against the plain versions")

    # ---- device times, the versions in turns
    cases = {"dense (3400, 250)": cs.merge_bound(K, N, 4),
             "dense (10^7, 250)": cs.merge_bound(BIG_ROWS, N, 4),
             "gather, merge, scatter": cs.ranked_bound(K, N, 4, K),
             "join": cs.ranked_bound(K, N, 4, K)}
    times: dict = {}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            dense_fn, join_fn = fns[name]
            runs = {"dense (3400, 250)": [functools.partial(dense, dense_fn, *s) for s in small],
                    "dense (10^7, 250)": [functools.partial(dense, dense_fn, *big)]}
            for case, fn in table_paths(dense_fn, join_fn).items():
                runs[case] = [functools.partial(fn, table, *j) for j in joins]
            for case, calls in runs.items():
                times.setdefault((case, name), []).append(cs.device_ms(calls))
        times.setdefault(("join", "library"), []).append(
            cs.device_ms([functools.partial(cs.join_library, table, *j) for j in joins]))
    for case, (bound_ms, bound_by) in cases.items():
        print(f"{case}: bound {bound_ms * 1e3:.3f} us ({bound_by})")
        for (c, name), ts in times.items():
            if c == case:
                print(f"  {name}: {min(ts) * 1e3:.3f} us ({', '.join(f'{x * 1e3:.3f}' for x in ts)}), "
                      f"{bound_ms / min(ts):.1%} of bound")


if __name__ == "__main__":
    main()
