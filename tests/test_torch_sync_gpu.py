"""The pod exchange with its tensors on the card: the host staging through
pinned buffers (``dist.collectives.PodGroup``) and the device-side top-k,
against the same exchange on the CPU, and the train step across two pods
on one card.

Two gloo ranks share ``cuda:0``.  These tests skip without a card; each
decides that when it runs.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sync_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import collectives as col
from repro_torch.launch.mesh import make_mesh, run_local_ranks
from repro_torch.launch.train import train
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig

RANK_TIMEOUT = 300
SHAPES = {"w": (3, 5000), "b": (37,), "s": (7, 11, 300)}
CFGS = {"flat": dict(strategy="flat"), "hier-ring": dict(strategy="hier", ring_order=(1, 0)),
        "geococo": dict(strategy="geococo", density=0.1, chunk=256, min_leaf_size=100),
        "geococo-ring": dict(strategy="geococo", density=0.1, chunk=256, min_leaf_size=100,
                             ring_order=(1, 0))}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the exchange's device staging runs only there")
    return torch.device("cuda", 0)


def inputs(rank):
    rng = np.random.default_rng(7 + rank)
    return {k: (rng.normal(size=s).astype(np.float32), rng.normal(size=s).astype(np.float32))
            for k, s in SHAPES.items()}


def exchange_rank(rank: int, device: str) -> dict:
    if device == "cuda":
        torch.cuda.set_device(0)
    group = col.PodGroup()
    mine = inputs(rank)
    out = {}
    for name, kw in CFGS.items():
        cfg = col.SyncConfig(**kw)
        g = {k: torch.from_numpy(v[0]).to(device) for k, v in mine.items()}
        r = {k: torch.from_numpy(v[1]).to(device) for k, v in mine.items()}
        synced, res = col.sync_gradients(g, r if cfg.needs_residuals else None, cfg, group=group)
        out[name] = ({k: v.cpu().numpy() for k, v in synced.items()},
                     {k: v.cpu().numpy() for k, v in (res or {}).items()})
    return out


@pytest.mark.gpu
def test_exchange_on_the_card_equals_the_cpu(card):
    on_card = run_local_ranks(exchange_rank, 2, ("cuda",), timeout=RANK_TIMEOUT)
    on_cpu = run_local_ranks(exchange_rank, 2, ("cpu",), timeout=RANK_TIMEOUT)
    for a, b in zip(on_card, on_cpu):
        for name in CFGS:
            for part in (0, 1):
                for key, want in b[name][part].items():
                    got = a[name][part][key]
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                               err_msg=f"{name} {key}")
                    if part == 1:
                        np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.1, 1.0])
def test_topk_select_on_the_card_equals_the_cpu(card, density):
    gen = torch.Generator().manual_seed(0)
    g, r = torch.randn(1000, 999, generator=gen), torch.randn(1000, 999, generator=gen)
    want = col.topk_select(g, r, density=density, chunk=2048)
    got = col.topk_select(g.to(card), r.to(card), density=density, chunk=2048)
    for w, x in zip(want, got):
        assert torch.equal(x.cpu(), w)


def train_rank(rank: int) -> list:
    mesh, _ = make_mesh((2, 1, 1), device="cuda")
    cfg = get_smoke_config("rwkv6-7b")
    tcfg = TrainConfig(sync=col.SyncConfig(**CFGS["geococo-ring"]),
                       optim=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    return train(cfg, tcfg, data, 4, device="cuda", mesh=mesh)


@pytest.mark.gpu
def test_train_across_two_pods_on_one_card(card):
    hist = run_local_ranks(train_rank, 2, timeout=RANK_TIMEOUT)
    for rank in hist:
        assert [r["step"] for r in rank] == [1, 2, 3, 4]
        assert all(np.isfinite(r["loss"]) and r["pods_agree"] == 1.0 for r in rank)
        assert all(r["sparse_values"] > 0 and r["exchange_host_s"] > 0 for r in rank)
    assert [r["loss"] for r in hist[0]] == [r["loss"] for r in hist[1]]
