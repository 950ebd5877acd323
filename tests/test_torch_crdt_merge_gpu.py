"""The CUDA CRDT merge kernel against its plain PyTorch version, on the
card, bit for bit.

The kernel has no CPU or interpret mode, so these tests skip without a
card; each decides that when it runs.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_crdt_merge_gpu.py
"""

import pytest
import torch

from repro_torch.kernels.crdt_merge import ops
from repro_torch.kernels.crdt_merge.ref import crdt_merge_ref

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
