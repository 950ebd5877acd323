"""The port's indexed join (``crdt_merge_rows``: a batch joined straight into
a table's rows, in place) against the JAX package's merge: the table's rows
gathered with numpy, merged by JAX ``crdt_merge_ref`` and by the Pallas
kernel in interpret mode, and scattered back with numpy.  Also the
wrapper's refusals, its meta branch and its work count.
``test_torch_crdt_merge_gpu.py`` holds the CUDA kernel against the plain
version on the card.

Inputs are numpy arrays from a seed, handed to both sides.  The join moves
bits, so equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crdt_merge import ops as jax_ops
from repro_torch.kernels import work
from repro_torch.kernels.crdt_merge import ops
from repro_torch.kernels.crdt_merge.ref import crdt_merge_rows_ref
from test_torch_crdt_merge import DTYPES, _bits, _to_jax

# (R, K, N): table rows, batch rows, elements a row
SHAPES = [(64, 7, 250), (1000, 1000, 100), (300, 1, 7)]
CASES = ["random", "ties", "batch_wins", "table_wins"]


def _payload(shape, dtype, rng) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32))
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def _rows(r: int, k: int, rng) -> torch.Tensor:
    """k distinct rows of [0, r), holding row r - 1 and, for k > 1, row 0."""
    rows = rng.permutation(r)[:k]
    rows[-1] = r - 1
    if k > 1:
        rows[0] = 0
        rows[1:-1] = rng.permutation(np.arange(1, r - 1))[:k - 2]
    return torch.from_numpy(rows.astype(np.int64))


def _ranks(k: int, case: str, rng) -> tuple[torch.Tensor, torch.Tensor]:
    cur = rng.integers(0, 6, size=k).astype(np.int32)
    new = {"random": rng.integers(0, 6, size=k).astype(np.int32), "ties": cur.copy(),
           "batch_wins": cur + 1, "table_wins": cur - 1}[case]
    return torch.from_numpy(cur), torch.from_numpy(new)


def _jax_join(table, rows, cur, new_val, new_rank, *, use_kernel: bool):
    """The table's rows gathered with numpy, merged by the JAX package,
    scattered back with numpy: (table, out_rank) as numpy."""
    np_table = np.asarray(_to_jax(table)).copy()
    np_rows = rows.numpy()
    out_val, out_rank = jax_ops.crdt_merge(
        jnp.asarray(np_table[np_rows]), jnp.asarray(cur.numpy()), _to_jax(new_val),
        jnp.asarray(new_rank.numpy()), use_kernel=use_kernel, interpret=True)
    np_table[np_rows] = np.asarray(out_val)
    return np_table, np.asarray(out_rank)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,k,n", SHAPES)
def test_join_matches_jax_ref_and_interpret_kernel(r, k, n, dtype, case):
    rng = np.random.default_rng(r + k + n)
    t_dt = DTYPES[dtype][0]
    table, new_val = _payload((r, n), t_dt, rng), _payload((k, n), t_dt, rng)
    rows = _rows(r, k, rng)
    cur, new = _ranks(k, case, rng)
    got = table.clone()
    out_rank = ops.crdt_merge_rows(got, rows, cur, new_val, new)
    assert out_rank.dtype == torch.int32 and got.dtype == t_dt
    for use_kernel in (False, True):
        want_table, want_rank = _jax_join(table, rows, cur, new_val, new, use_kernel=use_kernel)
        np.testing.assert_array_equal(_bits(got), _bits(want_table))
        np.testing.assert_array_equal(out_rank.numpy(), want_rank)
    # rows outside the batch, and rows the table keeps, are untouched
    kept = torch.ones(r, dtype=torch.bool)
    kept[rows[new > cur]] = False
    assert torch.equal(_bits_t(got[kept]), _bits_t(table[kept]))
    if case in ("ties", "table_wins"):
        assert torch.equal(_bits_t(got), _bits_t(table))
    if case == "batch_wins":
        assert torch.equal(_bits_t(got[rows]), _bits_t(new_val))


def _bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_join_is_gather_merge_scatter(dtype):
    rng = np.random.default_rng(5)
    t_dt = DTYPES[dtype][0]
    table, new_val = _payload((50, 9), t_dt, rng), _payload((20, 9), t_dt, rng)
    rows = _rows(50, 20, rng)
    cur, new = _ranks(20, "random", rng)
    want = table.clone()
    out_val, want_rank = ops.crdt_merge(want[rows], cur, new_val, new)
    want[rows] = out_val
    got = table.clone()
    assert torch.equal(crdt_merge_rows_ref(got, rows, cur, new_val, new), want_rank)
    assert torch.equal(_bits_t(got), _bits_t(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_empty_batch_changes_nothing(dtype):
    rng = np.random.default_rng(6)
    t_dt = DTYPES[dtype][0]
    table = _payload((10, 7), t_dt, rng)
    got = table.clone()
    empty = torch.zeros(0, dtype=torch.int32)
    out = ops.crdt_merge_rows(got, torch.zeros(0, dtype=torch.int64), empty,
                              _payload((0, 7), t_dt, rng), empty)
    assert out.shape == (0,) and out.dtype == torch.int32
    assert torch.equal(_bits_t(got), _bits_t(table))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_table_as_a_view_at_an_offset(dtype):
    """The table is a view 3 elements into a larger buffer: the join writes
    its rows and nothing of the buffer around it."""
    rng = np.random.default_rng(7)
    t_dt = DTYPES[dtype][0]
    r, k, n = 40, 12, 250
    buf = _payload((r * n + 10,), t_dt, rng)
    table = buf[3:3 + r * n].view(r, n)
    new_val = _payload((k, n), t_dt, rng)
    rows = _rows(r, k, rng)
    cur, new = _ranks(k, "random", rng)
    before = buf.clone()
    want_table, want_rank = _jax_join(table, rows, cur, new_val, new, use_kernel=True)
    out_rank = ops.crdt_merge_rows(table, rows, cur, new_val, new)
    np.testing.assert_array_equal(_bits(table), _bits(want_table))
    np.testing.assert_array_equal(out_rank.numpy(), want_rank)
    assert torch.equal(_bits_t(buf[:3]), _bits_t(before[:3]))
    assert torch.equal(_bits_t(buf[3 + r * n:]), _bits_t(before[3 + r * n:]))


def test_int64_ranks_are_cast_to_int32():
    """As ``crdt_merge`` casts versions: 2**32 + 5 -> 5, 2**31 + 7 -> negative."""
    rng = np.random.default_rng(8)
    table, new_val = _payload((6, 4), torch.int32, rng), _payload((3, 4), torch.int32, rng)
    rows = torch.tensor([5, 0, 2])
    cur = torch.tensor([2**32 + 5, 2**31 + 7, 3], dtype=torch.int64)
    new = torch.tensor([6, 0, 2**33 + 3], dtype=torch.int64)
    got = table.clone()
    out_rank = ops.crdt_merge_rows(got, rows, cur, new_val, new)
    assert out_rank.tolist() == [6, 0, 3]
    want_table, want_rank = _jax_join(table, rows, cur.to(torch.int32), new_val,
                                      new.to(torch.int32), use_kernel=True)
    np.testing.assert_array_equal(got.numpy(), want_table)
    np.testing.assert_array_equal(out_rank.numpy(), want_rank)


def test_meta_branch_returns_out_rank_and_touches_nothing():
    table = torch.empty(100, 250, dtype=torch.int32, device="meta")
    rows = torch.empty(30, dtype=torch.int64, device="meta")
    rank = torch.empty(30, dtype=torch.int32, device="meta")
    before = ops.crdt_merge_rows.launches
    out = ops.crdt_merge_rows(table, rows, rank, torch.empty(30, 250, dtype=torch.int32,
                                                             device="meta"), rank)
    assert (out.device.type, out.shape, out.dtype) == ("meta", (30,), torch.int32)
    assert ops.crdt_merge_rows.launches == before


def test_work_counts_every_row_taken_unless_told():
    assert work.crdt_merge_rows(3400, 250, 4) == work.Work(3400, 2 * 3400 * 1000 + 20 * 3400)
    assert work.crdt_merge_rows(3400, 250, 4, taken=100) == work.Work(
        3400, 2 * 100 * 1000 + 20 * 3400)
    assert work.crdt_merge_rows(0, 250, 2) == work.Work(0, 0)


def test_wrapper_refuses_what_it_does_not_take():
    rng = np.random.default_rng(0)
    table, new_val = _payload((8, 4), torch.float32, rng), _payload((3, 4), torch.float32, rng)
    rows = torch.tensor([1, 4, 7])
    cur, new = _ranks(3, "random", rng)
    with pytest.raises(ValueError, match=r"\(R, N\) and \(K, N\)"):
        ops.crdt_merge_rows(table, rows, cur, new_val[:, :3], new)
    with pytest.raises(ValueError, match=r"\(R, N\) and \(K, N\)"):
        ops.crdt_merge_rows(table[0], rows, cur, new_val, new)
    with pytest.raises(ValueError, match=r"rows and ranks must be \(3,\)"):
        ops.crdt_merge_rows(table, rows[:2], cur, new_val, new)
    with pytest.raises(ValueError, match=r"rows and ranks must be \(3,\)"):
        ops.crdt_merge_rows(table, rows, cur[:2], new_val, new)
    with pytest.raises(TypeError, match="int64"):
        ops.crdt_merge_rows(table, rows.to(torch.int32), cur, new_val, new)
    with pytest.raises(TypeError, match="two dtypes"):
        ops.crdt_merge_rows(table, rows, cur, new_val.to(torch.bfloat16), new)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge_rows(table, rows, cur, new_val.to("meta"), new)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge_rows(table.to("meta"), rows, cur, new_val, new)
    for bad in ([1, 8, 2], [-1, 0, 2]):
        got = table.clone()
        with pytest.raises(IndexError, match=r"\[0, 8\)"):
            ops.crdt_merge_rows(got, torch.tensor(bad), cur, new_val, new)
        assert torch.equal(got, table)
    meta = torch.empty(8, 4, dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="float32, bfloat16 or int32"):
        ops.crdt_merge_rows(meta, rows.to("meta"), cur.to("meta"),
                            torch.empty(3, 4, dtype=torch.float64, device="meta"), new.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        ops.crdt_merge_rows(torch.empty(4, 8, device="meta").t(), rows.to("meta"),
                            cur.to("meta"), new_val.to("meta"), new.to("meta"))
