"""The port's white-data filter against the JAX package's: the plain version
(``repro_torch.kernels.whitedata_filter``) against JAX ``whitedata_filter_ref``
and the Pallas kernel in interpret mode, over single arrays and over the
rwkv6 smoke config's parameter tree; the wrapper's checks.
``test_torch_whitedata_filter_gpu.py`` holds the CUDA kernel against the
plain version on the card.

Inputs are numpy arrays from a seed, handed to both sides.  Equality is
exact, bit for bit: one f32 add, a compare and round-to-nearest-even casts
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.whitedata_filter import ops as jax_ops
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.whitedata_filter import ops
from repro_torch.kernels.whitedata_filter.ref import whitedata_filter_ref
from repro_torch.models.model import _leaves, init_params

TAU_10PCT = 1.6449      # keeps 10% of N(0, 1)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# dtype -> (JAX dtype, torch and numpy integer views of its bits)
_BITS = {torch.float32: (jnp.float32, torch.int32, np.int32),
         torch.bfloat16: (jnp.bfloat16, torch.int16, np.int16),
         torch.int32: (jnp.int32, torch.int32, np.int32)}


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _assert_same_bits(got: torch.Tensor, want) -> None:
    """``got`` (torch) and ``want`` (torch or JAX) hold the same dtype, shape
    and bits."""
    jax_dt, int_t, int_np = _BITS[got.dtype]
    if isinstance(want, torch.Tensor):
        assert want.dtype == got.dtype
        want_bits = want.view(int_t).numpy()
    else:
        assert want.dtype == jax_dt
        want_bits = np.asarray(want).view(int_np)
    np.testing.assert_array_equal(got.view(int_t).numpy(), want_bits)


def _inputs(shape, g_dtype, r_dtype, seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(g_dtype)
    r = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(r_dtype)
    return g, r


@pytest.mark.parametrize("tau", [0.5, TAU_10PCT, 1e9])
@pytest.mark.parametrize("dtypes", ["f32,f32", "bf16,bf16", "bf16,f32"])
@pytest.mark.parametrize("shape", [(256, 256), (37, 53), (1000,), (3, 5, 7), (129,)])
def test_plain_matches_jax_ref_and_interpret_kernel(shape, dtypes, tau):
    g_dt, r_dt = (DTYPES[d] for d in dtypes.split(","))
    g, r = _inputs(shape, g_dt, r_dt, seed=sum(shape))
    send, new_r, kept = ops.whitedata_filter(g, r, tau)
    assert send.dtype == g_dt and new_r.dtype == r_dt and kept.dtype == torch.int32
    jg, jr = _to_jax(g), _to_jax(r)
    for want in (jax_ops.whitedata_filter_ref(jg, jr, tau),
                 jax_ops.whitedata_filter(jg, jr, tau, use_kernel=True, interpret=True)):
        _assert_same_bits(send, want[0])
        _assert_same_bits(new_r, want[1])
        assert int(kept) == int(want[2])


def test_conserves_mass_exactly_in_f32():
    """send + new_r == g + r: filtering defers, never destroys."""
    g, r = _inputs((128, 256), torch.float32, torch.float32, seed=1)
    send, new_r, kept = ops.whitedata_filter(g, r, 0.7)
    assert torch.equal(send + new_r, g + r)
    assert 0 < int(kept) < g.numel()
    assert torch.equal((send != 0).sum(dtype=torch.int32), kept)


def test_nan_and_inf_inputs():
    """|NaN| >= tau is false, so a NaN stays in the residual; +-inf is kept;
    inf + -inf is a NaN.  Both sides agree value for value."""
    g = torch.tensor([np.nan, np.inf, -np.inf, np.inf, 0.5, 3.0, -2.0, np.nan])
    r = torch.tensor([0.0, 1.0, 0.0, -np.inf, np.nan, 0.0, 0.1, np.inf])
    send, new_r, kept = ops.whitedata_filter(g, r, 1.0)
    want = jax_ops.whitedata_filter_ref(jnp.asarray(g.numpy()), jnp.asarray(r.numpy()), 1.0)
    np.testing.assert_array_equal(send.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(new_r.numpy(), np.asarray(want[1]))
    assert int(kept) == int(want[2]) == 4
    nan = torch.isnan(g + r)
    assert (send[nan] == 0).all() and torch.isnan(new_r[nan]).all()
    for g_dt, r_dt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)):
        s, nr, k = ops.whitedata_filter(g.to(g_dt), r.to(r_dt), 1.0)
        ws, wr, wk = jax_ops.whitedata_filter_ref(_to_jax(g.to(g_dt)), _to_jax(r.to(r_dt)), 1.0)
        np.testing.assert_array_equal(s.float().numpy(), np.asarray(ws, np.float32))
        np.testing.assert_array_equal(nr.float().numpy(), np.asarray(wr, np.float32))
        assert int(k) == int(wk)


def test_reference_kernel_path_counts_its_padding_the_port_does_not():
    """ROADMAP fault 3: at tau = 0 the reference's kernel path pads 1000
    elements to 1024 and counts the padding as kept; its ref.py and the port
    count 1000."""
    g, r = np.ones(1000, np.float32), np.zeros(1000, np.float32)
    jg, jr = jnp.asarray(g), jnp.asarray(r)
    assert int(jax_ops.whitedata_filter(jg, jr, 0.0, use_kernel=True, interpret=True)[2]) == 1024
    assert int(jax_ops.whitedata_filter_ref(jg, jr, 0.0)[2]) == 1000
    assert int(ops.whitedata_filter(torch.from_numpy(g), torch.from_numpy(r), 0.0)[2]) == 1000


@pytest.mark.parametrize("tau", [0.0, -1.0, TAU_10PCT, float("inf")])
def test_tau_as_tensor_or_float(tau):
    g, r = _inputs((3, 5, 7), torch.float32, torch.bfloat16, seed=4)
    by_float = ops.whitedata_filter(g, r, tau)
    by_tensor = ops.whitedata_filter(g, r, torch.tensor(tau))
    for a, b in zip(by_float, by_tensor):
        _assert_same_bits(a, b)
    if tau <= 0:
        assert int(by_float[2]) == g.numel()
    elif tau == float("inf"):
        assert int(by_float[2]) == 0


def _tree_paths(tree):
    return {path: t[k] for t, k, path in _leaves(tree)}


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path): leaf
            for path, leaf in flat}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("g_dtype", ["f32", "bf16"])
def test_filter_gradient_matches_jax_over_the_smoke_tree(g_dtype):
    """Two rounds of error feedback over the rwkv6 smoke config's parameter
    tree (the port's init_params), g in f32 or bf16 and residuals in f32 as
    sync_gradients holds them, against JAX ``filter_gradient`` leaf by leaf,
    matched by path (jax.tree sorts dict keys; the port keeps their order)."""
    cfg = get_smoke_config("rwkv6-7b")
    shapes = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    g_dt = DTYPES[g_dtype]

    def grads():
        return _map(shapes, lambda p: torch.from_numpy(
            rng.normal(0, 1, tuple(p.shape)).astype(np.float32)).to(g_dt))

    residual = _map(shapes, lambda p: torch.zeros(p.shape))
    n_leaves = len(list(_leaves(shapes)))
    for _ in range(2):
        g = grads()
        send, new_r, stats = ops.filter_gradient(g, residual, TAU_10PCT)
        jsend, jnew_r, jstats = jax_ops.filter_gradient(
            _map(g, _to_jax), _map(residual, _to_jax), TAU_10PCT, use_kernel=False)
        got_s, got_r = _tree_paths(send), _tree_paths(new_r)
        want_s, want_r = _jax_paths(jsend), _jax_paths(jnew_r)
        assert set(got_s) == set(want_s) == set(got_r) == set(want_r)
        assert len(got_s) == n_leaves
        for path in got_s:
            _assert_same_bits(got_s[path], want_s[path])
            _assert_same_bits(got_r[path], want_r[path])
        for key in ("kept", "total", "density"):
            assert stats[key].dtype == {"density": torch.float32}.get(key, torch.int32)
            np.testing.assert_array_equal(stats[key].numpy(), np.asarray(jstats[key]))
        # a few leaves through the reference's Pallas kernel in interpret mode
        g_paths, r_paths = _tree_paths(g), _tree_paths(residual)
        for path in (("embed", "table"), ("layers", 1, "ffn", "wk", "w"),
                     ("layers", 0, "mixer", "u")):
            ks, kr, _ = jax_ops.whitedata_filter(_to_jax(g_paths[path]), _to_jax(r_paths[path]),
                                                 TAU_10PCT, use_kernel=True, interpret=True)
            _assert_same_bits(got_s[path], ks)
            _assert_same_bits(got_r[path], kr)
        residual = new_r
    assert 0.1 < float(stats["density"]) < 0.3


def test_filter_gradient_keeps_structure_and_sums():
    tree = {"a": torch.randn(32, 64), "b": [torch.randn(129), {"c": torch.randn(3, 5, 7)}]}
    res = _map(tree, torch.zeros_like)
    send, new_r, stats = ops.filter_gradient(tree, res, 1.0)
    for out in (send, new_r):
        assert isinstance(out["b"], list) and isinstance(out["b"][1], dict)
        assert out["b"][1]["c"].shape == (3, 5, 7)
    leaves = [tree["a"], tree["b"][0], tree["b"][1]["c"]]
    kept = sum(int(whitedata_filter_ref(x, torch.zeros_like(x), 1.0)[2]) for x in leaves)
    assert int(stats["kept"]) == kept
    assert int(stats["total"]) == sum(x.numel() for x in leaves)
    assert float(stats["density"]) == np.float32(kept) / np.float32(int(stats["total"]))


def test_wrapper_refuses_what_it_does_not_take():
    g, r = _inputs((4, 8), torch.float32, torch.float32, seed=0)
    with pytest.raises(ValueError, match="shape"):
        ops.whitedata_filter(g, r[:, :4], 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.whitedata_filter(g, r.to("meta"), 1.0)
    with pytest.raises(ValueError, match="structure"):
        ops.filter_gradient({"a": g}, {"b": r}, 1.0)
    with pytest.raises(ValueError, match="structure"):
        ops.filter_gradient([g, g], [r], 1.0)
    with pytest.raises(ValueError, match="one device"):
        ops.filter_gradient([g, g], [r, r.to("meta")], 1.0)
    # the reference's stats["total"] is int32: a larger tree raises there too
    big = [torch.empty(2**30, device="meta"), torch.empty(2**30, device="meta")]
    with pytest.raises(OverflowError, match="int32"):
        ops.filter_gradient(big, big, 1.0)
