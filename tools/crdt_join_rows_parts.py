"""Where the store's join (``crdt_join_rows``) spends its time, on the card.

Builds ``src/repro_torch/csrc/crdt_merge.cu`` as it is and with one part of
the join cut out at a time, times each at a YCSB commit (3,400 rows of 250
int32 words) and at TPC-C's (34,000 rows of 30) into a table of 10^7 rows,
every row taken, over input sets past the L2 (``chip_smoke.rising_ms``, as
phase 3 times the kernel), in turns, and prints each time and what the cut
part cost.  The ranked join of the same source (``crdt_merge_rows``, whose
only column touched at random is the payload) is timed beside it.  A cut
variant computes wrong tables: only its time means anything.  Other
versions of the source that have ``crdt_join_rows_forward`` can be timed
beside it, in turns (``--also NAME=PATH``, a variant written to ``build/``):

    python3 tools/crdt_join_rows_parts.py

Run from the root of the checkout, on a machine with a CUDA card and
``nvcc``; the libraries go to ``build/crdt_join_rows_parts/``.  A cut whose
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
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "crdt_merge.cu"
OUT = ROOT / "build" / "crdt_join_rows_parts"
TABLE_ROWS = 10_000_000
SHAPES = {"YCSB 3,400 x 250": (3400, 250), "TPC-C 34,000 x 30": (34_000, 30)}

# part -> (anchor in the source, its replacement), applied in turn
CUTS: dict[str, list[tuple[str, str]]] = {
    "the table's triple and presence read (every row taken)": [
        ("    const int64_t c0 = tv[0], c1 = tv[1], c2 = tv[2];\n",
         "    const int64_t c0 = -(1LL << 62), c1 = 0, c2 = 0;\n"),
        ("    const bool absent = table_present[row] == 0,", "    const bool absent = false,")],
    "the triple, length and presence writes": [
        ("      tv[0] = b.n0;\n      tv[1] = b.n1;\n      tv[2] = b.n2;\n"
         "      if (cur_len != b.len) table_len[row] = b.len;\n"
         "      if (absent) table_present[row] = 1;   // a present row's byte is not stored again\n",
         "")],
    "the triple's write": [
        ("      tv[0] = b.n0;\n      tv[1] = b.n1;\n      tv[2] = b.n2;\n", "")],
    "the length's read and write": [
        ("    const int64_t cur_len = table_len[row];\n", ""),
        ("      if (cur_len != b.len) table_len[row] = b.len;\n", "")],
    "the payload's loads and stores": [
        ("    store_chunk(table, buf, dst, mine, sub, lanes, words);\n", "")],
    "took": [("    took[i] = take;\n", "")],
}


def cut(src: str, pairs: list[tuple[str, str]]) -> str:
    for anchor, replacement in pairs:
        if anchor not in src:
            raise SystemExit(f"anchor not in {SOURCE.name}:\n{anchor}")
        src = src.replace(anchor, replacement)
    return src


def build(sources: dict[str, str], nvcc: str, flags: tuple[str, ...]) -> dict:
    """Compile every source at once, one nvcc each; (join, ranked join)
    entry points of each."""
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
        lib = ctypes.CDLL(str(so))
        join = lib.crdt_join_rows_forward
        join.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                         + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        join.restype = ctypes.c_int
        ranked = lib.crdt_merge_rows_forward
        ranked.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                           + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        ranked.restype = ctypes.c_int
        fns[name] = (join, ranked)
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

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def join(fn, val, ver, length, present, rows, new_val, new_ver, new_len):
        took = torch.empty(rows.numel(), dtype=torch.bool, device=rows.device)
        rc = fn(val.data_ptr(), ver.data_ptr(), length.data_ptr(), present.data_ptr(),
                val.shape[0], rows.data_ptr(), new_val.data_ptr(), new_ver.data_ptr(),
                new_len.data_ptr(), took.data_ptr(), rows.numel(), val.shape[1],
                val.element_size(), stream())
        if rc != 0:
            raise RuntimeError(f"join launch failed ({rc})")
        return took

    def ranked(fn, table, rows, cur, new_val, new):
        out_rank = torch.empty_like(cur)
        rc = fn(table.data_ptr(), table.shape[0], rows.data_ptr(), cur.data_ptr(),
                new_val.data_ptr(), new.data_ptr(), out_rank.data_ptr(), rows.numel(),
                table.shape[1], table.element_size(), stream())
        if rc != 0:
            raise RuntimeError(f"ranked launch failed ({rc})")
        return out_rank

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(35)
    for label, (k, n) in SHAPES.items():
        table = cs.join_table(gen, TABLE_ROWS, n, torch.int32,
                              payload=torch.randint(-2**31, 2**31 - 1, (TABLE_ROWS, n),
                                                    generator=gen, device="cuda",
                                                    dtype=torch.int32))
        sets = cs.join_sets(gen, TABLE_ROWS, k, n)
        ranks = [cs.join_inputs(gen, TABLE_ROWS, k, n, torch.int32, top=2**20, taken=True)
                 for _ in range(len(sets))]
        times: dict = {}
        for order in (list(fns), list(fns)[::-1]):        # in turns: forwards, then backwards
            for name in order:
                join_fn, ranked_fn = fns[name]
                times.setdefault(name, []).append(
                    cs.rising_ms(functools.partial(join, join_fn), table, sets)["ms"])
            times.setdefault("the ranked join", []).append(cs.device_ms(
                [functools.partial(ranked, fns["whole kernel"][1], table[0], *r) for r in ranks]))
        bound_ms, bound_by = cs.join_bound(k, n, 4, k)
        whole = min(times["whole kernel"])
        print(f"crdt_join_rows at {label} into {TABLE_ROWS:,} rows, every row taken: bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by})")
        for name, ts in times.items():
            ms = min(ts)
            print(f"  {name}: {ms * 1e3:.3f} us ({', '.join(f'{x * 1e3:.3f}' for x in ts)}), "
                  f"{(whole - ms) * 1e3:+.3f} us against the whole")
        del table, sets, ranks
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
