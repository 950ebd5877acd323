"""The port's store join (``crdt_join_rows``: a batch joined straight into a
table's values, versions, lengths and presence, ``(epoch, seq, node)``
compared) against the reference's dict store ``DeltaCRDTStore``: the same
updates through ``CRDTTable.join_rows(*top_rows(...))``, through the plain
version ``crdt_join_rows_ref`` and through ``apply_many`` give the
reference's state, both digests and ``apply_many``'s count.  Also against
the join it replaced (dense ranks by ``version_rank``, the ranked join
``crdt_merge_rows_ref``, the three columns written after) wherever no
absent row meets a ``Version.ZERO`` update (fault 16), and the wrapper's
refusals, its meta branch and its work count.
``test_torch_crdt_merge_gpu.py`` holds the CUDA kernel against the plain
version on the card.

Inputs are numpy arrays from a seed.  Triples are drawn from a few values
a component, so that every component ties, with ``Version.ZERO``'s -1,
``LOAD_VERSION`` and components past 2^31.  Neither side imports JAX.
"""

import numpy as np
import pytest
import torch

from repro.core import crdt as rcrdt
from repro_torch.core import crdt as pcrdt
from repro_torch.kernels import work
from repro_torch.kernels.crdt_merge import ops
from repro_torch.kernels.crdt_merge.ref import crdt_join_rows_ref, crdt_merge_rows_ref

N_KEYS, VB = 60, 12
PARTS = ([-1, 0, 1, 2**33], [-1, 0, 5, 2**31 + 3], [-1, 0, 1, 4])
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}


def _triples(rng, m: int) -> np.ndarray:
    """(m, 3) int64: each component one of PARTS, a sixteenth LOAD_VERSION
    and a sixteenth Version.ZERO."""
    ver = np.stack([rng.choice(p, m) for p in PARTS], 1).astype(np.int64)
    ver[rng.random(m) < 1 / 16] = pcrdt.LOAD_VERSION
    ver[rng.random(m) < 1 / 16] = -1
    return ver


def _start(rng):
    """A table and a reference store in one state: a third of the keys
    absent, the rest at versions from ``_triples`` (Version.ZERO among
    them), values of 0 to VB bytes; the payload of each (key, version)."""
    present = rng.random(N_KEYS) >= 1 / 3
    ver = _triples(rng, N_KEYS)
    entries = [(f"k{i}", rng.bytes(int(rng.integers(0, VB + 1))), tuple(ver[i].tolist()))
               for i in range(N_KEYS) if present[i]]
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    pcrdt.load_entries(table, entries)
    ref = rcrdt.DeltaCRDTStore()
    for key, val, v in entries:
        ref.apply(rcrdt.Update(key, val, rcrdt.Version(*v)))
    return table, ref, {(key, v): val for key, val, v in entries}


def _batch(rng, table, payload: dict, n: int) -> list[tuple[str, bytes, tuple]]:
    """n updates over the keys (repeated), versions from ``_triples``, a
    quarter the key's version in the table; one payload a (key, version)."""
    out = []
    cur = table.versions.tolist()
    for _ in range(n):
        i = int(rng.integers(N_KEYS))
        v = tuple(cur[i]) if rng.random() < 0.25 else tuple(_triples(rng, 1)[0].tolist())
        val = payload.setdefault((f"k{i}", v), rng.bytes(int(rng.integers(0, VB + 1))))
        out.append((f"k{i}", val, v))
    return out


def _tensors(table, batch):
    rows = torch.tensor([table.row_of(k) for k, _, _ in batch], dtype=torch.int64)
    return (rows, table.pack([v for _, v, _ in batch]),
            torch.tensor([v for _, _, v in batch], dtype=torch.int64),
            torch.tensor([len(v) for _, v, _ in batch], dtype=torch.int64))


def _state(table) -> tuple:
    return ({k: (v, (ver.epoch, ver.seq, ver.node)) for k, (v, ver) in table.full_state().items()},
            table.digest(), table.digest(values_only=True))


def _ref_state(ref) -> tuple:
    return ({k: (v, (ver.epoch, ver.seq, ver.node)) for k, (v, ver) in ref.full_state().items()},
            ref.digest(), ref.digest(values_only=True))


@pytest.mark.parametrize("path", ["join_rows", "plain", "apply_many"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_join_matches_the_reference_store(seed, path):
    """Three batches into one table: each joined through ``join_rows``, the
    plain version on the table's tensors, or ``apply_many`` (whose count is
    the reference's too)."""
    rng = np.random.default_rng(seed)
    table, ref, payload = _start(rng)
    for _ in range(3):
        batch = _batch(rng, table, payload, 80)
        want = ref.apply_many([rcrdt.Update(k, v, rcrdt.Version(*t)) for k, v, t in batch])
        if path == "apply_many":
            got = table.apply_many([pcrdt.Update(k, v, pcrdt.Version(*t)) for k, v, t in batch])
            assert got == want
        else:
            top = table.top_rows(*_tensors(table, batch))
            if path == "join_rows":
                took = table.join_rows(*top)
            else:
                took = crdt_join_rows_ref(table.values, table.versions, table.lengths,
                                          table.present, *top)
            assert took.dtype == torch.bool and took.shape == top[0].shape
        assert _state(table) == _ref_state(ref)
    assert len(table) == len(ref)


def _columns(rng, r: int, n: int, dtype):
    """A table's four columns, a tenth of the rows absent (Version.ZERO,
    length 0), as ``CRDTTable`` keeps them."""
    if dtype == torch.int32:
        val = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (r, n), dtype=np.int32))
    else:
        val = torch.from_numpy(rng.normal(size=(r, n)).astype(np.float32)).to(dtype)
    ver = torch.from_numpy(_triples(rng, r))
    length = torch.from_numpy(rng.integers(0, 4 * n + 1, r))
    present = torch.from_numpy(rng.random(r) >= 0.1)
    ver[~present] = -1
    length[~present] = 0
    return [val, ver, length, present]


def _distinct_batch(rng, cols, k: int):
    """k distinct rows (row R - 1 among them) and their batch: a quarter of
    the triples the row's own."""
    val, ver = cols[0], cols[1]
    r, n = val.shape
    rows = np.concatenate([[r - 1], rng.permutation(r - 1)[:k - 1]]).astype(np.int64)
    new_ver = _triples(rng, k)
    same = rng.random(k) < 0.25
    new_ver[same] = ver.numpy()[rows[same]]
    new_val = _columns(rng, k, n, val.dtype)[0]
    return [torch.from_numpy(rows), new_val, torch.from_numpy(new_ver),
            torch.from_numpy(rng.integers(0, 4 * n + 1, k))]


def _ranked(cols, rows, new_val, new_ver, new_len):
    """The store's join before ``crdt_join_rows``: dense ranks of both
    sides, the ranked join, the three columns written after."""
    val, ver, length, present = cols
    k = rows.numel()
    cur_ver = ver[rows]
    rank = pcrdt.version_rank(torch.cat([cur_ver, new_ver])).to(torch.int32)
    took = crdt_merge_rows_ref(val, rows, rank[:k], new_val, rank[k:]) != rank[:k]
    ver[rows] = torch.where(took[:, None], new_ver, cur_ver)
    length[rows] = torch.where(took, new_len, length[rows])
    present[rows] = present[rows] | took
    return took


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes and shapes, floats bit for bit."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,k,n", [(64, 7, 250), (1000, 1000, 100), (300, 1, 7), (5000, 33, 3)])
def test_join_is_the_join_it_replaced_but_fault_16(r, k, n, dtype):
    """Where no absent row meets a Version.ZERO update the wrapper, the
    plain version and the ranked composition give the same columns and
    ``took``; an absent row under a Version.ZERO update is taken by the
    join (the reference stores it) and kept by the composition."""
    rng = np.random.default_rng(r + k + n)
    cols = _columns(rng, r, n, DTYPES[dtype])
    batch = _distinct_batch(rng, cols, k)
    absent = ~cols[3][batch[0]]
    zero = (batch[2] == -1).all(1)
    batch[2][absent & zero] = torch.tensor(pcrdt.LOAD_VERSION)
    got, plain, old = ([c.clone() for c in cols] for _ in range(3))
    took = ops.crdt_join_rows(*got, *batch)
    assert torch.equal(took, crdt_join_rows_ref(*plain, *batch))
    assert torch.equal(took, _ranked(old, *batch))
    for a, b, c in zip(got, plain, old):
        assert _same(a, b) and _same(a, c)
    # rows outside the batch and rows kept are untouched
    moved = torch.zeros(r, dtype=torch.bool)
    moved[batch[0][took]] = True
    assert all(_same(a[~moved], c[~moved]) for a, c in zip(got, cols))
    if k > 1:
        # fault 16: a Version.ZERO update into an absent row
        i = int(torch.nonzero(absent).flatten()[0]) if absent.any() else 0
        cols[3][batch[0][i]] = False
        cols[1][batch[0][i]] = -1
        batch[2][i] = -1
        a, b = [c.clone() for c in cols], [c.clone() for c in cols]
        assert bool(ops.crdt_join_rows(*a, *batch)[i])
        assert not bool(_ranked(b, *batch)[i])
        assert bool(a[3][batch[0][i]]) and a[1][batch[0][i]].tolist() == [-1, -1, -1]


@pytest.mark.parametrize("case", ["ties", "absent", "last_component"])
def test_join_rule_on_each_kind_of_row(case):
    """Equal triples keep the table's row; an absent row takes any version,
    Version.ZERO included; a triple above in its node alone is taken."""
    cols = [torch.arange(24, dtype=torch.int32).view(6, 4),
            torch.tensor([[2**33, 2**31 + 3, 4]] * 6), torch.full((6,), 7),
            torch.ones(6, dtype=torch.bool)]
    rows = torch.tensor([5, 0, 2])
    new_ver = cols[1][rows].clone()
    if case == "absent":
        cols[3][rows] = False
        cols[1][rows] = -1
        new_ver[:] = -1
    elif case == "last_component":
        new_ver[:, 2] += 1
    before = [c.clone() for c in cols]
    took = ops.crdt_join_rows(*cols, rows, torch.full((3, 4), -9, dtype=torch.int32), new_ver,
                              torch.tensor([1, 2, 3]))
    if case == "ties":
        assert not took.any()
        assert all(torch.equal(a, b) for a, b in zip(cols, before))
    else:
        assert took.all() and (cols[0][rows] == -9).all() and cols[3].all()
        assert torch.equal(cols[1][rows], new_ver) and cols[2][rows].tolist() == [1, 2, 3]
        keep = torch.tensor([False, True, False, True, True, False])
        assert torch.equal(cols[0][keep], before[0][keep])


def test_empty_batch_changes_nothing():
    cols = _columns(np.random.default_rng(9), 10, 7, torch.float32)
    before = [c.clone() for c in cols]
    took = ops.crdt_join_rows(*cols, torch.zeros(0, dtype=torch.int64),
                              torch.zeros(0, 7), torch.zeros(0, 3, dtype=torch.int64),
                              torch.zeros(0, dtype=torch.int64))
    assert took.shape == (0,) and took.dtype == torch.bool
    assert all(torch.equal(a, b) for a, b in zip(cols, before))
    table = pcrdt.CRDTTable(4, 8, device="cpu")
    assert table.join_rows(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 2, dtype=torch.int32),
                           torch.zeros(0, 3, dtype=torch.int64),
                           torch.zeros(0, dtype=torch.int64)).shape == (0,)
    assert table.merges == 0


def test_join_rows_counts_one_join_and_returns_took_without_a_sync():
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    ups = [pcrdt.Update("k3", b"a" * VB, pcrdt.Version(1, 0, 0)),
           pcrdt.Update("k3", b"b" * VB, pcrdt.Version(2, 0, 0)),
           pcrdt.Update("k7", b"c" * VB, pcrdt.Version.ZERO)]
    rows = torch.tensor([table.row_of(u.key) for u in ups])
    vers = torch.tensor([(u.version.epoch, u.version.seq, u.version.node) for u in ups])
    took = table.join_rows(*table.top_rows(rows, table.pack([u.value for u in ups]), vers))
    assert table.merges == 1 and took.tolist() == [True, True]
    assert table.get(["k3", "k7"]) == [b"b" * VB, b"c" * VB]


def test_meta_branch_returns_took_and_touches_nothing():
    meta = dict(device="meta")
    cols = (torch.empty(100, 30, dtype=torch.int32, **meta),
            torch.empty(100, 3, dtype=torch.int64, **meta),
            torch.empty(100, dtype=torch.int64, **meta), torch.empty(100, dtype=torch.bool, **meta))
    batch = (torch.empty(40, dtype=torch.int64, **meta),
             torch.empty(40, 30, dtype=torch.int32, **meta),
             torch.empty(40, 3, dtype=torch.int64, **meta), torch.empty(40, dtype=torch.int64, **meta))
    before = ops.crdt_join_rows.launches
    took = ops.crdt_join_rows(*cols, *batch)
    assert (took.device.type, took.shape, took.dtype) == ("meta", (40,), torch.bool)
    assert ops.crdt_join_rows.launches == before


def test_work_counts_every_row_taken_unless_told():
    # TPC-C's commit: 34,000 rows of 120 bytes, all taken: 11.53 MB
    assert work.crdt_join_rows(34_000, 30, 4) == work.Work(
        34_000, 2 * 34_000 * 120 + 66 * 34_000 + 33 * 34_000)
    assert work.crdt_join_rows(34_000, 30, 4).nbytes == 11_526_000
    assert work.crdt_join_rows(3400, 250, 4).nbytes == 2 * 3400 * 1000 + 99 * 3400
    assert work.crdt_join_rows(3400, 250, 4, taken=0) == work.Work(3400, 66 * 3400)
    assert work.crdt_join_rows(0, 250, 2) == work.Work(0, 0)


def _cpu_args():
    rng = np.random.default_rng(0)
    cols = _columns(rng, 8, 4, torch.float32)
    return cols, _distinct_batch(rng, cols, 3)


@pytest.mark.parametrize("bad", [
    ("table_val", lambda t: t[0], ValueError, r"\(R, N\) and \(K, N\)"),
    ("new_val", lambda t: t[:, :3], ValueError, r"\(R, N\) and \(K, N\)"),
    ("table_ver", lambda t: t[:, :2], ValueError, r"table_ver must be \(8, 3\)"),
    ("table_len", lambda t: t[:5], ValueError, r"table_len must be \(8,\)"),
    ("rows", lambda t: t[:2], ValueError, r"rows must be \(3,\)"),
    ("new_ver", lambda t: t[:2], ValueError, r"new_ver must be \(3, 3\)"),
    ("new_len", lambda t: t[:2], ValueError, r"new_len must be \(3,\)"),
    ("table_ver", lambda t: t.to(torch.int32), TypeError, "table_ver must be torch.int64"),
    ("table_len", lambda t: t.to(torch.int32), TypeError, "table_len must be torch.int64"),
    ("table_present", lambda t: t.to(torch.uint8), TypeError, "table_present must be torch.bool"),
    ("rows", lambda t: t.to(torch.int32), TypeError, "rows must be torch.int64"),
    ("new_ver", lambda t: t.to(torch.int32), TypeError, "new_ver must be torch.int64"),
    ("new_len", lambda t: t.to(torch.float32), TypeError, "new_len must be torch.int64"),
    ("new_val", lambda t: t.to(torch.bfloat16), TypeError, "two dtypes"),
    ("new_val", lambda t: t.to("meta"), ValueError, "one CUDA device"),
    ("table_present", lambda t: t.to("meta"), ValueError, "one CUDA device"),
], ids=lambda b: f"{b[0]}-{b[2].__name__}-{b[3][:12]}")
def test_wrapper_refuses_what_it_does_not_take(bad):
    name, change, error, match = bad
    cols, batch = _cpu_args()
    names = ["table_val", "table_ver", "table_len", "table_present", "rows", "new_val", "new_ver",
             "new_len"]
    args = cols + batch
    args[names.index(name)] = change(args[names.index(name)])
    with pytest.raises(error, match=match):
        ops.crdt_join_rows(*args)


@pytest.mark.parametrize("layout", ["payload", "float64", "versions", "out_of_range"])
def test_wrapper_refuses_what_the_kernel_does_not_take(layout):
    """On meta (as on the card): non-contiguous tensors and payloads the
    kernel has no word for; on the CPU a row outside [0, R) raises and
    writes nothing."""
    cols, batch = _cpu_args()
    if layout == "out_of_range":
        for bad in ([1, 8, 2], [-1, 0, 2]):
            got = [c.clone() for c in cols]
            with pytest.raises(IndexError, match=r"\[0, 8\)"):
                ops.crdt_join_rows(*got, torch.tensor(bad), *batch[1:])
            assert all(torch.equal(a, b) for a, b in zip(got, cols))
        return
    meta = [x.to("meta") for x in cols + batch]
    if layout == "payload":
        meta[5] = torch.empty(4, 3, device="meta").t()
        error, match = ValueError, "contiguous"
    elif layout == "versions":
        meta[6] = torch.empty(3, 3, dtype=torch.int64, device="meta").t()
        error, match = ValueError, "contiguous"
    else:
        meta[0] = meta[0].to(torch.float64)
        meta[5] = meta[5].to(torch.float64)
        error, match = TypeError, "float32, bfloat16 or int32"
    with pytest.raises(error, match=match):
        ops.crdt_join_rows(*meta)
