"""The store's digest (``CRDTTable.digest``, ``digests``) against the
reference's ``DeltaCRDTStore.digest`` on the CPU, bit for bit, state and
values only: keys across digit-length boundaries in all three families
(``k{i}``, ``h{r}:{h}``, ``w{w}:i{i}``, where ``:`` sorts after the digits),
versions with negative fields, 80-, 100- and 120-byte values in one table,
an empty store, a store made by the bulk loader, and chunk sizes that
split entries or hold less than one.  A card-only test holds the card's
digest to the CPU's.  Neither side imports JAX here.
"""

import numpy as np
import pytest
import torch

from repro.core import crdt as rcrdt
from repro_torch.core import crdt as pcrdt
from repro_torch.core import workload as pwl

CHUNKS = (13, 150, 1001, pcrdt.DIGEST_CHUNK_BYTES)


def vtuple(v) -> tuple:
    return (v.epoch, v.seq, v.node)


def digests_at(table, chunk: int) -> tuple:
    """``digest()``, ``digest(values_only=True)`` and ``digests()`` with the
    store's chunk set to ``chunk`` bytes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcrdt, "DIGEST_CHUNK_BYTES", chunk)
        return table.digest(), table.digest(values_only=True), table.digests()


def stream_lengths(ref) -> tuple[int, int]:
    """The bytes that the reference's state and value digests hash."""
    kv = sum(len(k.encode()) + len(v) for k, (v, _) in ref.full_state().items())
    vs = sum(len(f"{ver.epoch}:{ver.seq}:{ver.node}") for _, ver in ref.full_state().values())
    return kv + vs, kv


def both(table, ref, chunks=CHUNKS) -> None:
    want = (ref.digest(), ref.digest(values_only=True))
    for c in chunks:
        state, values, pair = digests_at(table, c)
        assert (state, values, pair) == (*want, want), c
        assert table.digest_bytes == stream_lengths(ref), c


def apply_both(table, ref, entries) -> None:
    """``(key, value, version)`` entries applied to both stores."""
    ref.apply_many([rcrdt.Update(k, v, rcrdt.Version(*ver)) for k, v, ver in entries])
    table.apply_many([pcrdt.Update(k, v, pcrdt.Version(*ver)) for k, v, ver in entries])


def ref_of(table) -> rcrdt.DeltaCRDTStore:
    """The reference store holding ``table``'s state."""
    ref = rcrdt.DeltaCRDTStore()
    ref.apply_many([rcrdt.Update(k, v, rcrdt.Version(*vtuple(ver)))
                    for k, (v, ver) in table.full_state().items()])
    return ref


@pytest.mark.parametrize("family", ["k", "h", "w"])
def test_keys_across_digit_lengths_sort_as_strings(family):
    table = pcrdt.CRDTTable(1200, 8, n_regions=13, hot_set_size=12, n_warehouses=12,
                            items_per_warehouse=105, device="cpu")
    keys = {
        "k": ["k9", "k10", "k99", "k100", "k999", "k1000", "k1199", "k0", "k1", "k11", "k101"],
        "h": ["h1:5", "h10:0", "h1:10", "h12:11", "h2:1", "h0:0", "h9:9", "h11:3"],
        "w": ["w1:i5", "w10:i2", "w1:i50", "w11:i104", "w0:i0", "w9:i99", "w10:i100", "w2:i1"],
    }[family]
    ref = rcrdt.DeltaCRDTStore()
    apply_both(table, ref, [(k, bytes([i, 7]) * 4, (1, i, 0)) for i, k in enumerate(keys)])
    assert sorted(table.full_state()) == sorted(keys)
    both(table, ref)


def test_three_families_with_negative_fields_and_three_widths():
    rng = np.random.default_rng(0)
    table = pcrdt.CRDTTable(150, 120, n_regions=11, hot_set_size=11, n_warehouses=13,
                            items_per_warehouse=101, device="cpu")
    ref = rcrdt.DeltaCRDTStore()
    payload, entries = {}, []
    for _ in range(600):
        key = table.key_of(int(rng.integers(table.n_rows)))
        # versions above Version.ZERO, with negative seq and node fields
        ver = (int(rng.integers(-1, 12)), int(rng.integers(-30, 3000)), int(rng.integers(-3, 9)))
        if ver[0] == -1:
            ver = (-1, abs(ver[1]), ver[2])
        val = payload.setdefault((key, ver), rng.bytes(int(rng.choice([80, 100, 120]))))
        entries.append((key, val, ver))
    for lo in range(0, len(entries), 150):
        apply_both(table, ref, entries[lo:lo + 150])
    assert {len(v) for v, _ in table.full_state().values()} == {80, 100, 120}
    assert any(ver.seq < 0 or ver.node < 0 for _, ver in table.full_state().values())
    both(table, ref)
    assert (len(table), table.get(entries[0][0])) == (len(ref), ref.get(entries[0][0]))


def test_an_empty_store():
    table = pcrdt.CRDTTable(10, 4, device="cpu")
    both(table, rcrdt.DeltaCRDTStore(), chunks=(1, pcrdt.DIGEST_CHUNK_BYTES))


@pytest.mark.parametrize("gen", ["ycsb", "tpcc"])
def test_a_store_made_by_the_bulk_loader(gen, monkeypatch):
    monkeypatch.setattr(pwl, "LOAD_CHUNK_ROWS", 333)
    if gen == "ycsb":
        g = pwl.YCSBGenerator(pwl.YCSBConfig(n_keys=1500, value_bytes=100, hot_write_frac=0.1,
                                             hot_locality=True), 5,
                              node_region=[0, 0, 1, 1, 2])
    else:
        g = pwl.TPCCGenerator(pwl.TPCCConfig(n_warehouses=12, items_per_warehouse=120), 5)
    table = g.table("cpu")
    g.load(table, seed=4)
    assert len(table) == table.n_rows
    state = table.full_state()
    assert {vtuple(ver) for _, ver in state.values()} == {pcrdt.LOAD_VERSION}
    assert {len(v) for v, _ in state.values()} == {g.value_bytes}
    ref = ref_of(table)
    both(table, ref, chunks=(99, 4096, pcrdt.DIGEST_CHUNK_BYTES))
    # a later update on top of the load
    key = table.key_of(7)
    apply_both(table, ref, [(key, b"\x01" * 80, (0, 0, 1))])
    both(table, ref, chunks=(pcrdt.DIGEST_CHUNK_BYTES,))


def test_seeded_words_are_splitmix64():
    """The loader's values, against SplitMix64 on Python integers."""
    m64 = (1 << 64) - 1

    def mix(x):
        x = (x + 0x9E3779B97F4A7C15) & m64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m64
        return x ^ (x >> 31)

    seed, n_words = 12345, 5
    rows = torch.tensor([0, 1, 2, 77, 10**7 - 1])
    got = pcrdt.seeded_words(seed, rows, n_words)
    for i, r in enumerate(rows.tolist()):
        for j in range(n_words):
            x = mix(mix((r * 3 + j // 2 + seed * 0x2545F4914F6CDD1D) & m64))
            assert int(got[i, j]) & 0xFFFFFFFF == (x >> (32 * (j % 2))) & 0xFFFFFFFF


def test_load_rows_checks_its_rows():
    table = pcrdt.CRDTTable(10, 8, device="cpu")
    vals = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="each row once"):
        pcrdt.load_rows(table, torch.tensor([3, 3]), vals)
    with pytest.raises(IndexError):
        pcrdt.load_rows(table, torch.tensor([3, 10]), vals)
    with pytest.raises(ValueError, match="lengths"):
        pcrdt.load_rows(table, torch.tensor([3, 4]), vals, lengths=torch.tensor([8, 9]))
    pcrdt.load_rows(table, torch.tensor([3, 4]), vals, (2, 1, 0), torch.tensor([8, 3]))
    assert table.get(["k3", "k4"]) == [b"\0" * 8, b"\0" * 3]
    assert table.version_of("k4") == pcrdt.Version(2, 1, 0)


@pytest.mark.gpu
def test_the_cards_digest_equals_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    tables = {}
    for dev in ("cpu", "cuda"):
        g = pwl.TPCCGenerator(pwl.TPCCConfig(n_warehouses=30, items_per_warehouse=1000), 5)
        t = g.table(dev)
        g.load(t, seed=2)
        tables[dev] = t
    for _ in range(3):
        rows = torch.from_numpy(rng.choice(tables["cpu"].n_rows, 5000, replace=False))
        vals = torch.from_numpy(rng.integers(-2**31, 2**31, (5000, 30)).astype(np.int32))
        lens = torch.from_numpy(rng.choice([80, 100, 120], 5000))
        vers = torch.from_numpy(rng.integers(0, 50, (5000, 3)))
        for t in tables.values():
            t.merge_rows(rows.to(t.device), vals.to(t.device), vers.to(t.device),
                         lens.to(t.device))
    for c in (1 << 20, pcrdt.DIGEST_CHUNK_BYTES):
        assert digests_at(tables["cuda"], c) == digests_at(tables["cpu"], c)
