"""The CUDA CRDT merge kernels against their plain PyTorch versions, on the
card, bit for bit: the dense merge, and the joins straight into a table's
rows (``crdt_merge_rows`` by int32 ranks, ``crdt_join_rows`` into the
table's version, length and presence columns).

The kernel has no CPU or interpret mode, so these tests skip without a
card; each decides that when it runs.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_crdt_merge_gpu.py
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.crdt_merge import ops
from repro_torch.kernels.crdt_merge.ref import (crdt_join_rows_ref, crdt_merge_ref,
                                                crdt_merge_rows_ref)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _payload(shape, dtype, gen, device):
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=device,
                             dtype=torch.int32)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _versions(m, gen, device, top=8):
    return torch.randint(0, top, (m,), generator=gen, device=device, dtype=torch.int32)


def _check(va, ra, vb, rb):
    before = ops.crdt_merge.launches
    out_val, out_ver = ops.crdt_merge(va, ra, vb, rb)
    torch.cuda.synchronize()
    assert ops.crdt_merge.launches == before + 1
    want_val, want_ver = crdt_merge_ref(va, ra.int(), vb, rb.int())
    assert out_val.dtype == va.dtype and out_ver.dtype == torch.int32
    assert torch.equal(_bits(out_val), _bits(want_val))
    assert torch.equal(out_ver, want_ver)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n", [(7, 250), (64, 100), (65536, 256), (7, 128), (33, 3),
                                 (1, 1), (1000, 0)])
def test_kernel_matches_plain(card, m, n, dtype):
    gen = torch.Generator(card).manual_seed(m + n)
    va, vb = (_payload((m, n), DTYPES[dtype], gen, card) for _ in range(2))
    _check(va, _versions(m, gen, card), vb, _versions(m, gen, card))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [250, 7])
@pytest.mark.parametrize("m", [1, 31, 33, 3400])
def test_kernel_at_small_m(card, m, n, dtype):
    """Below ~4 blocks an SM of 32-row groups the launcher gives a warp
    fewer rows, down to one."""
    gen = torch.Generator(card).manual_seed(m * n)
    va, vb = (_payload((m, n), DTYPES[dtype], gen, card) for _ in range(2))
    _check(va, _versions(m, gen, card), vb, _versions(m, gen, card))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("offset", [1, 2, 3, 250])
def test_payloads_at_odd_offsets(card, dtype, offset):
    """Payload views starting ``offset`` elements into a buffer: the kernel
    falls back to narrower words where the rows lose their alignment."""
    m, n = 129, 250
    gen = torch.Generator(card).manual_seed(offset)
    bufs = [_payload((m * n + 512,), DTYPES[dtype], gen, card) for _ in range(2)]
    va = bufs[0][offset:offset + m * n].view(m, n)
    vb = bufs[1][2 * offset:2 * offset + m * n].view(m, n)
    _check(va, _versions(m, gen, card), vb, _versions(m, gen, card))


@pytest.mark.gpu
def test_ties_keep_a_and_int64_versions(card):
    gen = torch.Generator(card).manual_seed(1)
    va, vb = (_payload((300, 250), torch.int32, gen, card) for _ in range(2))
    ver = _versions(300, gen, card)
    out_val, out_ver = ops.crdt_merge(va, ver, vb, ver)
    assert torch.equal(out_val, va) and torch.equal(out_ver, ver)
    ra = torch.randint(-2**40, 2**40, (300,), generator=gen, device=card)
    rb = torch.randint(-2**40, 2**40, (300,), generator=gen, device=card)
    _check(va, ra, vb, rb)


@pytest.mark.gpu
def test_more_than_2_pow_31_elements(card):
    """8.6M rows of 250 int32 words (a YCSB record each): 2.15e9 elements
    per side, so every offset has to be 64-bit."""
    m, n = 8_600_000, 250
    gen = torch.Generator(card).manual_seed(2)
    va, vb = (_payload((m, n), torch.int32, gen, card) for _ in range(2))
    assert va.numel() > 2**31
    ra, rb = _versions(m, gen, card, top=1000), _versions(m, gen, card, top=1000)
    out_val, out_ver = ops.crdt_merge(va, ra, vb, rb)
    torch.cuda.synchronize()
    take_a = ra >= rb
    assert torch.equal(out_ver, torch.maximum(ra, rb))
    for lo in range(0, m, 1_000_000):
        sl = slice(lo, lo + 1_000_000)
        assert torch.equal(out_val[sl], torch.where(take_a[sl, None], va[sl], vb[sl]))


@pytest.mark.gpu
def test_merge_many_on_the_card(card):
    gen = torch.Generator(card).manual_seed(3)
    batches = [(_payload((500, 250), torch.float32, gen, card), _versions(500, gen, card))
               for _ in range(3)]
    before = ops.crdt_merge.launches
    out_val, out_ver = ops.crdt_merge_many(batches)
    assert ops.crdt_merge.launches == before + 2
    want_val, want_ver = batches[0]
    for vb, rb in batches[1:]:
        want_val, want_ver = crdt_merge_ref(want_val, want_ver, vb, rb)
    assert torch.equal(_bits(out_val), _bits(want_val)) and torch.equal(out_ver, want_ver)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    gen = torch.Generator(card).manual_seed(0)
    va, vb = (_payload((8, 32), torch.float32, gen, card) for _ in range(2))
    ra, rb = _versions(8, gen, card), _versions(8, gen, card)
    with pytest.raises(TypeError):
        ops.crdt_merge(va.double(), ra, vb.double(), rb)
    with pytest.raises(TypeError):
        ops.crdt_merge(va.half(), ra, vb.half(), rb)
    with pytest.raises(ValueError, match="contiguous"):
        ops.crdt_merge(va.t().contiguous().t(), ra, vb, rb)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge(va, ra, vb.cpu(), rb)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge(va, ra.cpu(), vb, rb)


# ---------------------------------------------------------------------------
# the join straight into a table's rows
# ---------------------------------------------------------------------------


def _distinct_rows(r, k, gen, device):
    return torch.randperm(r, generator=gen, device=device)[:k]


def _check_rows(table, rows, cur, new_val, new):
    """The kernel on ``table`` against the plain version on a copy: the
    whole table and out_rank bit for bit, one launch."""
    want_table = table.clone()
    want_rank = crdt_merge_rows_ref(want_table, rows, cur.int(), new_val, new.int())
    before = ops.crdt_merge_rows.launches
    out_rank = ops.crdt_merge_rows(table, rows, cur, new_val, new)
    torch.cuda.synchronize()
    assert ops.crdt_merge_rows.launches == before + 1
    assert out_rank.dtype == torch.int32 and torch.equal(out_rank, want_rank)
    assert torch.equal(_bits(table), _bits(want_table))
    return out_rank


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [7, 100, 250])
@pytest.mark.parametrize("k", [1, 31, 33, 3400, 65536])
def test_join_matches_plain(card, k, n, dtype):
    """Rows of 7 bf16 (14 B: 2-byte words), 100 (16-byte words in f32 and
    int32, 8 in bf16) and 250 (8-byte words in f32 and int32, 4 in bf16)."""
    r = 100_000
    gen = torch.Generator(card).manual_seed(k + n)
    table = _payload((r, n), DTYPES[dtype], gen, card)
    rows = _distinct_rows(r - 1, k, gen, card)
    rows[0] = r - 1
    _check_rows(table, rows, _versions(k, gen, card), _payload((k, n), DTYPES[dtype], gen, card),
                _versions(k, gen, card))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("offset", [1, 3])
def test_join_into_a_table_at_an_odd_offset(card, dtype, offset):
    """The table a view ``offset`` elements into a buffer: narrower words,
    and nothing of the buffer outside the table written."""
    r, k, n = 5000, 700, 250
    gen = torch.Generator(card).manual_seed(offset)
    buf = _payload((r * n + 16,), DTYPES[dtype], gen, card)
    before = buf.clone()
    table = buf[offset:offset + r * n].view(r, n)
    _check_rows(table, _distinct_rows(r, k, gen, card), _versions(k, gen, card),
                _payload((k, n), DTYPES[dtype], gen, card), _versions(k, gen, card))
    assert torch.equal(_bits(buf[:offset]), _bits(before[:offset]))
    assert torch.equal(_bits(buf[offset + r * n:]), _bits(before[offset + r * n:]))


@pytest.mark.gpu
def test_join_ties_keep_the_table_and_int64_ranks(card):
    gen = torch.Generator(card).manual_seed(4)
    table = _payload((2000, 250), torch.int32, gen, card)
    rows = _distinct_rows(2000, 300, gen, card)
    ver = _versions(300, gen, card)
    want = table.clone()
    out_rank = ops.crdt_merge_rows(table, rows, ver, _payload((300, 250), torch.int32, gen, card),
                                   ver.clone())
    assert torch.equal(out_rank, ver) and torch.equal(table, want)
    cur = torch.randint(-2**40, 2**40, (300,), generator=gen, device=card)
    new = torch.randint(-2**40, 2**40, (300,), generator=gen, device=card)
    _check_rows(table, rows, cur, _payload((300, 250), torch.int32, gen, card), new)


@pytest.mark.gpu
def test_join_into_the_last_row_of_a_10m_row_table(card):
    """Row 10^7 - 1 of 10^7 rows of 250 int32 words starts past 2^31
    elements: every offset has to be 64-bit."""
    r, n = 10_000_000, 250
    table = torch.zeros((r, n), dtype=torch.int32, device=card)
    gen = torch.Generator(card).manual_seed(5)
    rows = torch.tensor([r - 1, 0, 8_600_000], device=card)
    new_val = _payload((3, n), torch.int32, gen, card)
    cur = torch.zeros(3, dtype=torch.int32, device=card)
    ops.crdt_merge_rows(table, rows, cur, new_val, cur + 1)
    torch.cuda.synchronize()
    assert torch.equal(table[rows], new_val)
    assert int((table != 0).any(dim=1).sum()) == int((new_val != 0).any(dim=1).sum())


@pytest.mark.gpu
def test_join_refuses_what_it_does_not_take(card):
    gen = torch.Generator(card).manual_seed(0)
    table = _payload((8, 32), torch.float32, gen, card)
    rows = torch.tensor([1, 5], device=card)
    new_val = _payload((2, 32), torch.float32, gen, card)
    cur, new = _versions(2, gen, card), _versions(2, gen, card)
    with pytest.raises(TypeError):
        ops.crdt_merge_rows(table.double(), rows, cur, new_val.double(), new)
    with pytest.raises(TypeError):
        ops.crdt_merge_rows(table.half(), rows, cur, new_val.half(), new)
    with pytest.raises(ValueError, match="contiguous"):
        ops.crdt_merge_rows(table, rows, cur, new_val.t().contiguous().t(), new)
    with pytest.raises(ValueError, match="contiguous"):
        ops.crdt_merge_rows(table[:, :16], rows, cur, new_val[:, :16].contiguous(), new)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge_rows(table, rows.cpu(), cur, new_val, new)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge_rows(table, rows, cur, new_val.cpu(), new)


# ---------------------------------------------------------------------------
# the join into a table's columns, (epoch, seq, node) compared in the kernel
# ---------------------------------------------------------------------------

# a few values a component, so that every component ties; -1 (Version.ZERO)
# and values past 2^31
PARTS = ((-1, 0, 1, 2**33), (-1, 0, 5, 2**31 + 3), (-1, 0, 1, 4))


def _triples(m, gen, device):
    cols = [torch.tensor(p, device=device)[torch.randint(0, len(p), (m,), generator=gen,
                                                         device=device)] for p in PARTS]
    ver = torch.stack(cols, 1)
    ver[torch.rand(m, generator=gen, device=device) < 1 / 16] = torch.tensor(
        [-1, 0, 0], device=device)                              # LOAD_VERSION
    return ver


def _table(r, n, dtype, gen, device, payload=None):
    """Values, versions, lengths and presence; a tenth of the rows absent
    (Version.ZERO, length 0)."""
    val = _payload((r, n), dtype, gen, device) if payload is None else payload
    ver = _triples(r, gen, device)
    length = torch.randint(0, 4 * n + 1, (r,), generator=gen, device=device)
    present = torch.rand(r, generator=gen, device=device) >= 0.1
    ver[~present] = -1
    length[~present] = 0
    return [val, ver, length, present]


def _batch(table, rows, dtype, gen, device):
    """A batch for ``rows``: a quarter of the triples the row's own, a
    sixteenth Version.ZERO."""
    k, n = rows.numel(), table[0].shape[1]
    new_ver = _triples(k, gen, device)
    same = torch.rand(k, generator=gen, device=device) < 0.25
    new_ver[same] = table[1][rows[same]]
    new_ver[torch.rand(k, generator=gen, device=device) < 1 / 16] = -1
    return (rows, _payload((k, n), dtype, gen, device), new_ver,
            torch.randint(0, 4 * n + 1, (k,), generator=gen, device=device))


def _check_join(table, batch):
    """The kernel on ``table`` against the plain version on a copy: every
    column and took, one launch."""
    want = [c.clone() for c in table]
    want_took = crdt_join_rows_ref(*want, *batch)
    before = ops.crdt_join_rows.launches
    took = ops.crdt_join_rows(*table, *batch)
    torch.cuda.synchronize()
    assert ops.crdt_join_rows.launches == before + 1
    assert took.dtype == torch.bool and torch.equal(took, want_took)
    assert torch.equal(_bits(table[0]), _bits(want[0]))
    for got, ref in zip(table[1:], want[1:]):
        assert torch.equal(got, ref)
    return took


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [3, 7, 30, 250])
@pytest.mark.parametrize("k", [1, 31, 33, 3400, 34000, 65536])
def test_join_rows_matches_plain(card, k, n, dtype):
    """Rows of 3 and 7 elements (2- or 4-byte words, 4 lanes a row), 30
    (8-byte words in f32 and int32: 15, 8 lanes; 4-byte in bf16) and 250
    (8-byte words in f32 and int32: 125, the whole warp)."""
    r = 100_000
    gen = torch.Generator(card).manual_seed(k + n)
    table = _table(r, n, DTYPES[dtype], gen, card)
    rows = _distinct_rows(r - 1, k, gen, card)
    rows[0] = r - 1
    took = _check_join(table, _batch(table, rows, DTYPES[dtype], gen, card))
    if k >= 3400:
        assert 0 < int(took.sum()) < k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("offset", [1, 3])
def test_join_rows_into_a_table_at_an_odd_offset(card, dtype, offset):
    r, k, n = 5000, 700, 250
    gen = torch.Generator(card).manual_seed(offset)
    buf = _payload((r * n + 16,), DTYPES[dtype], gen, card)
    before = buf.clone()
    table = _table(r, n, DTYPES[dtype], gen, card, payload=buf[offset:offset + r * n].view(r, n))
    _check_join(table, _batch(table, _distinct_rows(r, k, gen, card), DTYPES[dtype], gen, card))
    assert torch.equal(_bits(buf[:offset]), _bits(before[:offset]))
    assert torch.equal(_bits(buf[offset + r * n:]), _bits(before[offset + r * n:]))


@pytest.mark.gpu
def test_join_rows_ties_keep_the_table_and_absent_rows_take_any_version(card):
    """Equal triples keep the table's row; an absent row takes the batch's,
    Version.ZERO included; a triple above in its last component alone
    wins."""
    gen = torch.Generator(card).manual_seed(6)
    r, k, n = 2000, 300, 30
    table = _table(r, n, torch.int32, gen, card)
    table[3][:] = True
    rows = _distinct_rows(r, k, gen, card)
    batch = (rows, _payload((k, n), torch.int32, gen, card), table[1][rows].clone(),
             torch.randint(0, 4 * n + 1, (k,), generator=gen, device=card))
    want = [c.clone() for c in table]
    took = ops.crdt_join_rows(*table, *batch)
    assert not bool(took.any())
    assert all(torch.equal(a, b) for a, b in zip(table, want))
    table[3][rows[:100]] = False
    table[1][rows[:100]] = -1
    batch[2][:50] = -1
    batch[2][100:200, 2] += 1
    took = _check_join(table, batch)
    assert took[:200].all() and not took[200:].any()


@pytest.mark.gpu
def test_join_rows_into_the_last_row_of_a_10m_row_table(card):
    """Row 10^7 - 1 of 10^7 rows of 250 int32 words starts past 2^31
    elements: every offset has to be 64-bit."""
    r, n = 10_000_000, 250
    gen = torch.Generator(card).manual_seed(7)
    table = [torch.zeros((r, n), dtype=torch.int32, device=card),
             torch.full((r, 3), -1, dtype=torch.int64, device=card),
             torch.zeros(r, dtype=torch.int64, device=card),
             torch.zeros(r, dtype=torch.bool, device=card)]
    rows = torch.tensor([r - 1, 0, 8_600_000], device=card)
    new_val = _payload((3, n), torch.int32, gen, card)
    new_ver = torch.tensor([[0, 1, 2], [-1, -1, -1], [2**33, 0, 0]], device=card)
    took = ops.crdt_join_rows(*table, rows, new_val, new_ver,
                              torch.tensor([1000, 3, 7], device=card))
    torch.cuda.synchronize()
    assert took.all() and torch.equal(table[0][rows], new_val)
    assert torch.equal(table[1][rows], new_ver) and table[3][rows].all()
    assert table[2][rows].tolist() == [1000, 3, 7] and int(table[3].sum()) == 3


@pytest.mark.gpu
def test_join_rows_refuses_what_it_does_not_take(card):
    gen = torch.Generator(card).manual_seed(0)
    table = _table(8, 32, torch.float32, gen, card)
    batch = _batch(table, torch.tensor([1, 5], device=card), torch.float32, gen, card)
    with pytest.raises(TypeError):
        ops.crdt_join_rows(table[0].double(), *table[1:], batch[0], batch[1].double(),
                           *batch[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.crdt_join_rows(*table, batch[0], batch[1].t().contiguous().t(), *batch[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.crdt_join_rows(*table, batch[0], batch[1], batch[2].t().contiguous().t(), batch[3])
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_join_rows(*table, batch[0].cpu(), *batch[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_join_rows(table[0], table[1], table[2], table[3].cpu(), *batch)


@pytest.mark.gpu
def test_join_rows_traps_on_a_row_out_of_range(card):
    """A row outside [0, R) stops the kernel (a trap) before it writes: the
    process's next synchronise raises.  In a child process, whose CUDA
    context the trap ends."""
    child = (
        "import torch\n"
        "from repro_torch.kernels.crdt_merge import ops\n"
        "d = torch.device('cuda')\n"
        "t = [torch.zeros(8, 4, dtype=torch.int32, device=d), torch.zeros(8, 3, dtype=torch.int64,"
        " device=d), torch.zeros(8, dtype=torch.int64, device=d), torch.zeros(8, dtype=torch.bool,"
        " device=d)]\n"
        "ops.crdt_join_rows(*t, torch.tensor([1, 8], device=d), torch.ones(2, 4, dtype=torch.int32,"
        " device=d), torch.ones(2, 3, dtype=torch.int64, device=d), torch.ones(2, dtype=torch.int64,"
        " device=d))\n"
        "torch.cuda.synchronize()\n"
        "print('joined')\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                         timeout=300, cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode != 0 and "joined" not in out.stdout, out.stdout + out.stderr
