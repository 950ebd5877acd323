"""The CUDA white-data filter kernel against its plain PyTorch version, on
the card, bit for bit.

The kernel has no CPU or interpret mode, so these tests skip without a
card; each decides that when it runs.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_whitedata_filter_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.whitedata_filter import ops
from repro_torch.kernels.whitedata_filter.ref import whitedata_filter_ref

TAUS = [0.0, -1.0, 1.6449, float("inf")]
DTYPES = {"f32,f32": (torch.float32, torch.float32), "bf16,bf16": (torch.bfloat16, torch.bfloat16),
          "bf16,f32": (torch.bfloat16, torch.float32), "f32,bf16": (torch.float32, torch.bfloat16)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _assert_same(got, want) -> None:
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert torch.equal(_bits(a), _bits(b))


def _inputs(shape, dtypes, seed, device, nan=False):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
    if nan:
        g.view(-1)[::7] = float("nan")
        r.view(-1)[3::11] = float("inf")
        g.view(-1)[5::13] = float("-inf")
    return g.to(device, dtypes[0]), r.to(device, dtypes[1])


def _run(g, r, tau):
    before = ops.whitedata_filter.launches
    got = ops.whitedata_filter(g, r, tau)
    torch.cuda.synchronize()
    assert ops.whitedata_filter.launches == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("shape", [(1000,), (3, 5, 7), (129,), (1,), (37, 53), (4096, 14336)])
def test_kernel_matches_plain(card, shape, dtypes, tau):
    g, r = _inputs(shape, DTYPES[dtypes], seed=sum(shape), device=card)
    _assert_same(_run(g, r, tau), whitedata_filter_ref(g, r, tau))


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_nan_and_inf(card, dtypes):
    g, r = _inputs((1000,), DTYPES[dtypes], seed=3, device=card, nan=True)
    got = _run(g, r, 1.6449)
    _assert_same(got, whitedata_filter_ref(g, r, 1.6449))
    nan = torch.isnan(g.float() + r.float())
    assert nan.any() and (got[0][nan] == 0).all() and torch.isnan(got[1][nan]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("g_off,r_off", [(1, 1), (1, 2), (3, 0), (5, 7), (0, 9)])
def test_views_at_odd_offsets(card, dtypes, g_off, r_off):
    """Contiguous views whose starts lie off the 16-byte boundary, each by
    its own amount: the kernel's scalar head and tail, or its all-scalar
    path where no head aligns both."""
    n = 4099
    g, r = _inputs((n + 16,), DTYPES[dtypes], seed=g_off * 10 + r_off, device=card)
    gv, rv = g[g_off:g_off + n], r[r_off:r_off + n]
    _assert_same(_run(gv, rv, 0.5), whitedata_filter_ref(gv, rv, 0.5))


@pytest.mark.gpu
def test_counts_are_exact_at_size(card):
    """kept over 268M elements (the embedding of rwkv6-7b) against the
    plain count, and against tau <= 0 (every element)."""
    g = torch.randn((65536, 4096), device=card, generator=torch.Generator(card).manual_seed(0))
    r = torch.zeros_like(g)
    for tau in (1.6449, 0.0):
        got = _run(g, r, tau)
        _assert_same(got, whitedata_filter_ref(g, r, tau))
    assert int(got[2]) == g.numel()


@pytest.mark.gpu
def test_tau_on_the_card(card):
    g, r = _inputs((37, 53), DTYPES["bf16,f32"], seed=2, device=card)
    _assert_same(_run(g, r, torch.tensor(1.6449, device=card)), _run(g, r, 1.6449))
    _assert_same(_run(g, r, torch.tensor(0.5, dtype=torch.float64, device=card)),
                 whitedata_filter_ref(g, r, 0.5))


def _leaves(tree):
    return [tree["a"], tree["b"][0], tree["b"][1]["c"]]


def _tree(leaves):
    return {"a": leaves[0], "b": [leaves[1], {"c": leaves[2]}]}


@pytest.mark.gpu
def test_filter_gradient_on_the_card(card):
    """Over a small nested tree, bf16 g and f32 residuals: the kernel's
    trees and stats against the CPU's plain path, one launch per leaf."""
    gen = torch.Generator(card).manual_seed(0)
    shapes = [(32, 64), (129,), (3, 5, 7)]
    g = _tree([torch.randn(s, generator=gen, device=card).bfloat16() for s in shapes])
    r = _tree([torch.randn(s, generator=gen, device=card) for s in shapes])
    before = ops.whitedata_filter.launches
    send, new_r, stats = ops.filter_gradient(g, r, 1.0)
    torch.cuda.synchronize()
    assert ops.whitedata_filter.launches == before + 3
    cpu_send, cpu_new_r, cpu_stats = ops.filter_gradient(
        _tree([x.cpu() for x in _leaves(g)]), _tree([x.cpu() for x in _leaves(r)]), 1.0)
    _assert_same(_leaves(send), [x.to(card) for x in _leaves(cpu_send)])
    _assert_same(_leaves(new_r), [x.to(card) for x in _leaves(cpu_new_r)])
    for key in ("kept", "total", "density"):
        assert stats[key].device.type == "cuda"
        assert torch.equal(stats[key].cpu(), cpu_stats[key])


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    g, r = _inputs((8, 32), DTYPES["f32,f32"], seed=0, device=card)
    with pytest.raises(TypeError):
        ops.whitedata_filter(g.double(), r, 1.0)
    with pytest.raises(TypeError):
        ops.whitedata_filter(g, r.half(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.whitedata_filter(g.t(), r.t(), 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.whitedata_filter(g, r.cpu(), 1.0)
    with pytest.raises(ValueError, match="one device"):
        ops.filter_gradient([g, g], [r, r.cpu()], 1.0)
