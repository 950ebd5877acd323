"""The port's CRDT merge against the JAX package's: the plain version
(``repro_torch.kernels.crdt_merge``) against JAX ``crdt_merge_ref`` and the
Pallas kernel in interpret mode, the fold over many batches in both orders,
the version casts, ties, the ACI properties and the wrapper's checks.
``test_torch_crdt_merge_gpu.py`` holds the CUDA kernel against the plain
version on the card.

Inputs are numpy arrays from a seed, handed to both sides.  The merge moves
bits, so equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crdt_merge import ops as jax_ops
from repro_torch.kernels.crdt_merge import ops

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _bits(x) -> np.ndarray:
    """The bits of a torch or JAX array, as integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view(torch.int32).numpy() if x.dtype == torch.float32 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _batch(m, n, dtype, rng, max_ver=50):
    if dtype == torch.int32:
        val = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(m, n), dtype=np.int32))
    else:
        val = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dtype)
    return val, torch.from_numpy(rng.integers(0, max_ver, size=(m,)).astype(np.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n", [(256, 256), (64, 100), (7, 128), (7, 250)])
def test_plain_matches_jax_ref_and_interpret_kernel(m, n, dtype):
    rng = np.random.default_rng(3)
    t_dt, j_dt = DTYPES[dtype]
    (va, ra), (vb, rb) = _batch(m, n, t_dt, rng), _batch(m, n, t_dt, rng)
    out_val, out_ver = ops.crdt_merge(va, ra, vb, rb)
    assert out_val.dtype == t_dt and out_ver.dtype == torch.int32
    args = [_to_jax(x) for x in (va, ra, vb, rb)]
    for want_val, want_ver in (jax_ops.crdt_merge_ref(*args),
                               jax_ops.crdt_merge(*args, use_kernel=True, interpret=True)):
        assert want_val.dtype == j_dt
        np.testing.assert_array_equal(_bits(out_val), _bits(want_val))
        np.testing.assert_array_equal(out_ver.numpy(), np.asarray(want_ver))


def test_ties_keep_side_a():
    rng = np.random.default_rng(8)
    (va, _), (vb, _) = _batch(16, 33, torch.float32, rng), _batch(16, 33, torch.float32, rng)
    ver = torch.arange(16, dtype=torch.int32)
    out_val, out_ver = ops.crdt_merge(va, ver, vb, ver.clone())
    assert torch.equal(out_val, va) and torch.equal(out_ver, ver)
    out_val, _ = ops.crdt_merge(vb, ver, va, ver)
    assert torch.equal(out_val, vb)
    want = jax_ops.crdt_merge(*[_to_jax(x) for x in (va, ver, vb, ver)], interpret=True)[0]
    np.testing.assert_array_equal(_bits(ops.crdt_merge(va, ver, vb, ver)[0]), _bits(want))


def test_versions_are_cast_to_int32_as_the_reference_casts_them():
    """int64 versions wrap to int32 on both sides (2**32 + 5 -> 5,
    2**31 + 7 -> negative), so the winners are the reference's."""
    rng = np.random.default_rng(9)
    (va, _), (vb, _) = _batch(6, 40, torch.int32, rng), _batch(6, 40, torch.int32, rng)
    ra = torch.tensor([2**32 + 5, 2**31 + 7, -3, 10, 2**40, 7], dtype=torch.int64)
    rb = torch.tensor([6, 0, -4, 10, 1, 2**33 + 8], dtype=torch.int64)
    out_val, out_ver = ops.crdt_merge(va, ra, vb, rb)
    assert out_ver.dtype == torch.int32
    want_val, want_ver = jax_ops.crdt_merge(_to_jax(va), jnp.asarray(ra.numpy()), _to_jax(vb),
                                            jnp.asarray(rb.numpy()), interpret=True)
    np.testing.assert_array_equal(out_val.numpy(), np.asarray(want_val))
    np.testing.assert_array_equal(out_ver.numpy(), np.asarray(want_ver))
    assert out_ver.tolist() == [6, 0, -3, 10, 1, 8]


def _jax_batches(batches):
    return [(_to_jax(v), _to_jax(r)) for v, r in batches]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_merge_many_matches_jax_in_both_orders(dtype):
    rng = np.random.default_rng(10)
    batches = [_batch(64, 100, DTYPES[dtype][0], rng, max_ver=8) for _ in range(4)]
    for order in (batches, batches[::-1]):
        out_val, out_ver = ops.crdt_merge_many(order)
        for use_kernel in (False, True):
            want_val, want_ver = jax_ops.crdt_merge_many(_jax_batches(order),
                                                         use_kernel=use_kernel)
            np.testing.assert_array_equal(_bits(out_val), _bits(want_val))
            np.testing.assert_array_equal(out_ver.numpy(), np.asarray(want_ver))


def test_merge_many_casts_the_first_batch_versions():
    rng = np.random.default_rng(11)
    (va, ra), (vb, rb) = _batch(8, 16, torch.float32, rng), _batch(8, 16, torch.float32, rng)
    assert ops.crdt_merge_many([(va, ra.long())])[1].dtype == torch.int32
    out = ops.crdt_merge_many([(va, ra.long()), (vb, rb.long())])
    assert torch.equal(out[0], ops.crdt_merge(va, ra, vb, rb)[0])


def test_crdt_merge_is_aci():
    """The ACI test of the reference's tests/test_kernels.py on the port:
    commutative on value-identical ties, associative, idempotent."""
    rng = np.random.default_rng(4)
    m, n = 64, 128
    batches = [(torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 20, size=(m,)).astype(np.int32)))
               for _ in range(4)]
    v1, r1 = ops.crdt_merge_many(batches)
    v2, r2 = ops.crdt_merge_many(batches[::-1])
    # versions agree in any order; values agree where versions were unique
    assert torch.equal(r1, r2)
    vers = torch.stack([b[1] for b in batches])
    unique = (vers == vers.max(dim=0).values).sum(dim=0) == 1
    assert 0 < int(unique.sum()) < m
    assert torch.equal(v1[unique], v2[unique])
    # idempotence: re-merging the result is a no-op
    v3, r3 = ops.crdt_merge(v1, r1, v1, r1)
    assert torch.equal(v3, v1) and torch.equal(r3, r1)
    # duplicated delivery of one batch changes nothing
    v4, r4 = ops.crdt_merge_many(batches + [batches[0]])
    assert torch.equal(r4, r1) and torch.equal(v4, v1)
    # associativity: (a . b) . (c . d) == ((a . b) . c) . d on unique rows
    ab = ops.crdt_merge(*batches[0], *batches[1])
    cd = ops.crdt_merge(*batches[2], *batches[3])
    v5, r5 = ops.crdt_merge(*ab, *cd)
    assert torch.equal(r5, r1) and torch.equal(v5[unique], v1[unique])


def test_wrapper_refuses_what_it_does_not_take():
    rng = np.random.default_rng(0)
    (va, ra), (vb, rb) = _batch(4, 8, torch.float32, rng), _batch(4, 8, torch.float32, rng)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        ops.crdt_merge(va, ra, vb[:, :4], rb)
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        ops.crdt_merge(va[0], ra, vb[0], rb)
    with pytest.raises(ValueError, match="versions"):
        ops.crdt_merge(va, ra[:3], vb, rb)
    with pytest.raises(TypeError, match="two dtypes"):
        ops.crdt_merge(va, ra, vb.to(torch.bfloat16), rb)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.crdt_merge(va, ra, vb.to("meta"), rb)
