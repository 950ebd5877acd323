"""The port's CRDT store (``repro_torch.core.crdt.CRDTTable``) against the
reference's dict ``DeltaCRDTStore`` on the CPU: the same updates, applied
in permuted orders and with duplicates, give the same state and the same
SHA-256 digests bit for bit (ACI); reads, the loader, the key interning
and the int32 order key of the join.  Neither side imports JAX here.
"""

import numpy as np
import pytest
import torch

from repro.core import crdt as rcrdt
from repro_torch.core import crdt as pcrdt

N_KEYS, VB = 40, 12


def _updates(rng, n: int, *, n_keys: int = N_KEYS, epochs: int = 3) -> list:
    """Random updates over a small key space, each (key, version) with one
    payload (the reference store's invariant), versions over several
    epochs and a wide seq range."""
    out, payload = [], {}
    for i in range(n):
        key = f"k{int(rng.integers(n_keys))}"
        ver = rcrdt.Version(int(rng.integers(epochs)), int(rng.integers(5000)),
                            int(rng.integers(5)))
        val = payload.setdefault((key, ver), rng.bytes(VB))
        out.append(rcrdt.Update(key, val, ver, txn_id=i))
    return out


def vtuple(v) -> tuple:
    return (v.epoch, v.seq, v.node)


def _port(u: rcrdt.Update) -> pcrdt.Update:
    return pcrdt.Update(u.key, u.value, pcrdt.Version(*vtuple(u.version)), u.txn_id)


def _state(table: pcrdt.CRDTTable) -> dict:
    return {k: (v, vtuple(ver)) for k, (v, ver) in table.full_state().items()}


def _ref_state(store: rcrdt.DeltaCRDTStore) -> dict:
    return {k: (v, vtuple(ver)) for k, (v, ver) in store.full_state().items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_matches_the_reference_under_permutations_and_duplicates(seed):
    rng = np.random.default_rng(seed)
    ups = _updates(rng, 300)
    ref = rcrdt.DeltaCRDTStore()
    ref.apply_many(ups)
    want = (_ref_state(ref), ref.digest(), ref.digest(values_only=True), len(ref))
    for trial in range(3):
        perm = [ups[i] for i in rng.permutation(len(ups))]
        dups = perm + [perm[i] for i in rng.integers(0, len(perm), 80)]
        table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
        # in batches of mixed sizes, so one join sees a key several times
        # and later joins meet the earlier ones' rows
        cuts = sorted(rng.choice(np.arange(1, len(dups)), 4, replace=False).tolist())
        for lo, hi in zip([0] + cuts, cuts + [len(dups)]):
            table.apply_many([_port(u) for u in dups[lo:hi]])
        assert (_state(table), table.digest(), table.digest(values_only=True),
                len(table)) == want
        assert table.merges == 5


def test_join_is_idempotent_and_keeps_the_table_on_a_tie():
    rng = np.random.default_rng(3)
    ups = [_port(u) for u in _updates(rng, 120)]
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    table.apply_many(ups)
    before = (_state(table), table.digest())
    assert table.apply_many(ups) == 0
    # a same-version update with another payload (a meta-only form in the
    # reference) does not replace the row
    key, (val, ver) = next(iter(table.full_state().items()))
    assert table.apply_many([pcrdt.Update(key, b"\x00" * VB, ver)]) == 0
    assert (_state(table), table.digest()) == before
    assert table.get(key) == val


def test_merge_updates_matches_the_reference():
    rng = np.random.default_rng(4)
    ups = _updates(rng, 200)
    want = {k: (u.value, vtuple(u.version)) for k, u in rcrdt.merge_updates(ups).items()}
    got = {k: (u.value, vtuple(u.version))
           for k, u in pcrdt.merge_updates([_port(u) for u in ups[::-1] + ups]).items()}
    assert got == want


def test_reads_gather_many_rows():
    rng = np.random.default_rng(5)
    ups = _updates(rng, 60)
    ref = rcrdt.DeltaCRDTStore()
    ref.apply_many(ups)
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    table.apply_many([_port(u) for u in ups])
    keys = [f"k{i}" for i in range(N_KEYS)]
    assert table.get(keys) == [ref.get(k) for k in keys]
    assert [vtuple(v) for v in table.version_of(keys)] == \
        [vtuple(ref.version_of(k)) for k in keys]
    absent = next(k for k in keys if ref.get(k) is None)
    assert table.get(absent) is None and table.version_of(absent) == pcrdt.Version.ZERO
    snap = table.snapshot()
    table.apply_many([pcrdt.Update(absent, b"x" * VB, pcrdt.Version(9, 0, 0))])
    assert snap.get(absent) is None and table.get(absent) == b"x" * VB


def test_loader_starts_both_stores_from_one_state():
    rng = np.random.default_rng(6)
    ref = rcrdt.DeltaCRDTStore()
    ref.apply_many(_updates(rng, 80))
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    pcrdt.load_entries(table, [(k, v, vtuple(ver))
                               for k, (v, ver) in ref.full_state().items()])
    assert table.digest() == ref.digest()
    more = _updates(rng, 80, epochs=5)
    ref.apply_many(more)
    table.apply_many([_port(u) for u in more])
    assert table.digest() == ref.digest()
    with pytest.raises(ValueError, match="each key once"):
        pcrdt.load_entries(table, [("k1", b"a" * VB, (0, 0, 0))] * 2)


def test_digest_orders_keys_as_strings_with_hot_rows():
    table = pcrdt.CRDTTable(120, 4, n_regions=3, hot_set_size=11, device="cpu")
    ref = rcrdt.DeltaCRDTStore()
    keys = ["k9", "k10", "k100", "k11", "k0", "h0:0", "h2:10", "h1:3", "h0:10"]
    for i, k in enumerate(keys):
        u = rcrdt.Update(k, bytes([i, 1, 2, 3]), rcrdt.Version(1, i, 0))
        ref.apply(u)
        table.apply_many([_port(u)])
    assert table.digest() == ref.digest()
    assert table.digest(values_only=True) == ref.digest(values_only=True)


def test_key_interning():
    table = pcrdt.CRDTTable(1000, 8, n_regions=12, hot_set_size=16, device="cpu")
    for row in [0, 7, 9, 10, 99, 100, 999, 1000, 1015, 1016, 1000 + 11 * 16 + 15]:
        key = table.key_of(row)
        assert table.row_of(key) == row
        assert int(table.key_lengths(torch.tensor([row]))) == len(key)
    for bad in ["k1000", "k-1", "k01", "h12:0", "h0:16", "x3", "", "h1"]:
        with pytest.raises(KeyError):
            table.row_of(bad)


@pytest.mark.parametrize("vb", [1, 4, 6, 13, 96])
def test_values_pack_at_any_width(vb):
    table = pcrdt.CRDTTable(4, vb, device="cpu")
    vals = [bytes(range(i, i + vb)) for i in range(3)]
    assert table.unpack(table.pack(vals)) == vals
    with pytest.raises(ValueError):
        table.pack([b"x" * (vb + 1)])


def test_order_key_is_exact_beyond_int32():
    """The join's int32 order key is a dense rank, exact where a packed
    (epoch, seq, node) would overflow."""
    vers = torch.tensor([[2**40, 3, 1], [2**40, 2, 9], [-1, -1, -1], [2**40, 3, 1],
                         [5, 2**33, 0]], dtype=torch.int64)
    rank = pcrdt.version_rank(vers)
    want = {v: i for i, v in enumerate(sorted({tuple(r) for r in vers.tolist()}))}
    assert rank.tolist() == [want[tuple(r)] for r in vers.tolist()]
    table = pcrdt.CRDTTable(2, 4, device="cpu")
    table.apply_many([pcrdt.Update("k0", b"aaaa", pcrdt.Version(2**40, 2, 9))])
    table.apply_many([pcrdt.Update("k0", b"bbbb", pcrdt.Version(5, 2**33, 0)),
                      pcrdt.Update("k1", b"cccc", pcrdt.Version(0, 0, 0))])
    assert table.get(["k0", "k1"]) == [b"aaaa", b"cccc"]


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(7)
    cols = [rng.integers(0, 4, 200) for _ in range(4)]
    got = pcrdt.lexsort([torch.from_numpy(c) for c in cols])
    assert got.tolist() == np.lexsort(cols).tolist()


def test_apply_many_counts_updates_as_the_reference():
    """Fault 14: the count of updates that changed the store, applied in
    batch order, not of rows that changed."""
    ups = [("k1", (1, 0, 0)), ("k1", (2, 0, 0)), ("k2", (1, 0, 0))]
    ref = rcrdt.DeltaCRDTStore()
    want = ref.apply_many([rcrdt.Update(k, b"v" * VB, rcrdt.Version(*v)) for k, v in ups])
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    got = table.apply_many([pcrdt.Update(k, b"v" * VB, pcrdt.Version(*v)) for k, v in ups])
    assert (got, want) == (3, 3)


def _repeats(rng, order: str) -> list:
    """A batch that repeats keys, each key's versions ascending, descending
    or equal in batch order (or the three mixed over the keys), the keys
    interleaved at random."""
    per_key = {}
    for k in rng.choice(N_KEYS, 12, replace=False).tolist():
        n = int(rng.integers(1, 5))
        vs = sorted({(int(rng.integers(3)), int(rng.integers(20)), int(rng.integers(4)))
                     for _ in range(n)})
        kind = order if order != "mixed" else ["ascending", "descending", "equal"][k % 3]
        if kind == "descending":
            vs = vs[::-1]
        elif kind == "equal":
            vs = [vs[0]] * n
        per_key[f"k{k}"] = vs
    out = []
    while per_key:
        key = sorted(per_key)[int(rng.integers(len(per_key)))]
        out.append((key, per_key[key].pop(0)))
        if not per_key[key]:
            del per_key[key]
    return out


@pytest.mark.parametrize("loaded", [False, True])
@pytest.mark.parametrize("order", ["ascending", "descending", "equal", "mixed"])
def test_apply_many_count_on_repeated_keys(order, loaded):
    rng = np.random.default_rng(["ascending", "descending", "equal", "mixed"].index(order))
    table = pcrdt.CRDTTable(N_KEYS, VB, device="cpu")
    if loaded:
        rows = torch.arange(N_KEYS)
        pcrdt.load_rows(table, rows, pcrdt.seeded_words(1, rows, table.words))
    ref = rcrdt.DeltaCRDTStore()
    ref.apply_many([rcrdt.Update(k, v, rcrdt.Version(*vtuple(ver)))
                    for k, (v, ver) in table.full_state().items()])
    for _ in range(3):
        batch = _repeats(rng, order)
        payload = {(k, v): rng.bytes(VB) for k, v in batch}
        want = ref.apply_many([rcrdt.Update(k, payload[k, v], rcrdt.Version(*v))
                               for k, v in batch])
        got = table.apply_many([pcrdt.Update(k, payload[k, v], pcrdt.Version(*v))
                                for k, v in batch])
        assert got == want
        assert _state(table) == _ref_state(ref)


def test_warehouse_key_interning():
    table = pcrdt.CRDTTable(0, 120, n_warehouses=101, items_per_warehouse=1000, device="cpu")
    assert (table.w_base, table.n_rows) == (0, 101_000)
    for row in [0, 9, 10, 999, 1000, 1009, 10_000, 100_999]:
        key = table.key_of(row)
        assert table.row_of(key) == row
        assert int(table.key_lengths(torch.tensor([row]))) == len(key)
    assert table.key_of(1005) == "w1:i5" and table.key_of(10_002) == "w10:i2"
    for bad in ["w101:i0", "w1:i1000", "w1:5", "w01:i5", "w1:i05", "w1", "k3", "h0:0", "wx:i1"]:
        with pytest.raises(KeyError):
            table.row_of(bad)
    mixed = pcrdt.CRDTTable(20, 8, n_regions=2, hot_set_size=3, n_warehouses=2,
                            items_per_warehouse=4, device="cpu")
    keys = [mixed.key_of(r) for r in range(mixed.n_rows)]
    assert keys[19:22] == ["k19", "h0:0", "h0:1"] and keys[26:] == ["w0:i0", "w0:i1", "w0:i2",
                                                                   "w0:i3", "w1:i0", "w1:i1",
                                                                   "w1:i2", "w1:i3"]
    got, _ = mixed.key_bytes(torch.arange(mixed.n_rows))
    assert [bytes(r).rstrip(b"\0").decode() for r in got.tolist()] == keys
