"""The port's training pieces against the JAX package on the CPU: AdamW
(``optim/adamw.py``), ``loss_fn``, the synthetic data pipeline, gradient
accumulation, remat, checkpoints and the training CLI.

Inputs are numpy arrays from a seed, handed to both sides.  Tolerances:

* AdamW: m and v bit for bit without clipping (the same f32 operations in
  the same order); the learning rate and the parameters, and m and v with
  the clip, at rtol = atol = 1e-6: XLA's and torch's f32 cos differ by an
  ulp at some steps of the cosine (3e-7 of the rate at step 7 of 8), and
  the global norm sums its leaves in another order, which moves the clip
  scale by an ulp;
* ``loss_fn``: rtol = 1e-5 (f32; the two frameworks' matmuls sum in other
  orders);
* microbatches 1 vs 2: rtol = atol = 1e-5 on the loss and every gradient
  (the mean over the batch is taken in two halves);
* remat on vs off, the data pipeline, checkpoints and a resumed run: bit
  for bit.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro.train import train_step as jax_train_step
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, build_train_step, grads_and_loss, loss_fn
from repro_torch.tree import leaves

SHAPES = {"a": (7, 5), "b": [(3,), (4, 6)], "c": {"x": (2, 2, 3)}}


def _tree(fn):
    return {"a": fn(SHAPES["a"]), "b": [fn(s) for s in SHAPES["b"]], "c": {"x": fn(SHAPES["c"]["x"])}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clip", "no-clip"])
def test_adamw_matches_reference_over_8_steps(state, clip):
    """Warm-up over 3 of 8 steps, then the cosine; gradients N(0, 3^2) so the
    clip at 1.0 bites on every step."""
    rng = np.random.default_rng(0)
    p0 = _tree(lambda s: rng.normal(0, 1, s).astype(np.float32))
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=8, grad_clip=clip)
    jcfg = jax_adamw.AdamWConfig(**kw, state_dtype=getattr(jnp, state))
    tcfg = adamw.AdamWConfig(**kw, state_dtype=getattr(torch, state))
    jp = jax.tree.map(jnp.asarray, p0)
    js = jax_adamw.adamw_init(jp, jcfg)
    tp = _torch_tree(p0)
    ts = adamw.adamw_init(tp, tcfg)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    grng = np.random.default_rng(1)
    tol = dict(rtol=1e-6, atol=1e-6)
    state_tol = dict(rtol=0, atol=0) if clip > 1e3 else tol
    for _ in range(8):
        g = _tree(lambda s: grng.normal(0, 3, s).astype(np.float32))
        jp, js, jm = jax_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        leaves_before = leaves(tp)
        tp, ts, tm = adamw.adamw_update(tp, _torch_tree(g), ts, tcfg)
        assert all(a is b for a, b in zip(leaves_before, leaves(tp)))   # in place
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for key in ("m", "v"):
            for a, b in zip(jax.tree.leaves(js[key]), leaves(ts[key])):
                assert str(b.dtype).removeprefix("torch.") == state
                np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                           **state_tol)
        for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)
        assert int(ts["step"]) == int(js["step"])


@pytest.mark.parametrize("step", [0, 1, 2, 5, 50, 99, 100, 101, 5000, 10_000, 20_000])
def test_cosine_lr_matches_reference(step):
    jcfg, tcfg = jax_adamw.AdamWConfig(), adamw.AdamWConfig()
    want = float(jax_adamw.cosine_lr(jcfg, jnp.asarray(step, jnp.int32)))
    got = float(adamw.cosine_lr(tcfg, torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_loss_fn_matches_reference():
    cfg_j = jax_get_smoke_config("minitron-8b")
    tree = jax.tree.map(np.asarray, jax_model.init_params(cfg_j, jax.random.PRNGKey(0)))
    batch = SyntheticLM(DataConfig(vocab_size=cfg_j.vocab_size, seq_len=16, global_batch=2)).batch(0)
    want = float(jax_train_step.loss_fn(cfg_j, jax.tree.map(jnp.asarray, tree),
                                        jax.tree.map(jnp.asarray, batch), jnp.float32))
    params = params_from_jax(get_smoke_config("minitron-8b"), tree, device="cpu")
    got = float(loss_fn(get_smoke_config("minitron-8b"), params,
                        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed,step,vocab,seq,batch",
                         [(0, 0, 512, 16, 2), (3, 7, 32_000, 64, 4), (1, 123, 65_536, 33, 3),
                          (2, 5, 129_280, 24, 2), (0, 1, 256_000, 16, 1)])
def test_synthetic_batches_are_the_references(seed, step, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    want = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(**kw)).batch(step)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    tensors = make_batch(DataConfig(**kw), step)
    np.testing.assert_array_equal(tensors["tokens"].numpy(), want["tokens"])


def _smoke(arch, **kw):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=12, global_batch=4)).batch(0)
    return dataclasses.replace(cfg, **kw), params, {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b", "granite-moe-3b-a800m"])
def test_microbatches_1_and_2_agree(arch):
    cfg, params, batch = _smoke(arch)
    out = [grads_and_loss(cfg, TrainConfig(compute_dtype=torch.float32, microbatches=m),
                          params, batch) for m in (1, 2)]
    (g1, l1), (g2, l2) = out
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for a, b in zip(g1, g2):
        assert a.dtype == b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        grads_and_loss(cfg, TrainConfig(microbatches=3), params, batch)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b", "granite-moe-3b-a800m",
                                  "minitron-8b"])
def test_remat_on_and_off_agree_bit_for_bit(arch):
    results = []
    for remat in (True, False):
        cfg, params, batch = _smoke(arch, remat=remat)
        results.append(grads_and_loss(cfg, TrainConfig(compute_dtype=torch.float32), params, batch))
    (g_on, l_on), (g_off, l_off) = results
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


def test_remat_recomputes_each_block(monkeypatch):
    """With remat each block's forward runs twice per training step (once
    more in the backward); without it once; never under no_grad."""
    from repro_torch.models import model as model_mod

    calls = []
    real = model_mod._block_apply
    monkeypatch.setattr(model_mod, "_block_apply", lambda *a: calls.append(1) or real(*a))
    for remat, want in ((True, 4), (False, 2)):
        calls.clear()
        cfg, params, batch = _smoke("rwkv6-7b", remat=remat)
        grads_and_loss(cfg, TrainConfig(compute_dtype=torch.float32), params, batch)
        assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        loss_fn(cfg, params, batch, torch.float32)
    assert len(calls) == 2


def _ckpt_tree(rng):
    return {"params": _tree(lambda s: rng.normal(0, 1, s).astype(np.float32)),
            "opt": {"step": np.asarray(3, np.int32)}, "step": 7}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    tree = _ckpt_tree(rng)
    port_tree = {"params": _torch_tree(tree["params"]),
                 "opt": {"step": torch.tensor(3, dtype=torch.int32)}, "step": 7}
    ckpt.save(str(tmp_path), 7, port_tree)
    like = jax.tree.map(jnp.asarray, tree)
    got = jax_ckpt.restore(str(tmp_path), 7, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax_ckpt.latest_step(str(tmp_path)) == 7


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    tree = _ckpt_tree(rng)
    jax_ckpt.save(str(tmp_path), 5, jax.tree.map(jnp.asarray, tree))
    like = {"params": _torch_tree(jax.tree.map(np.zeros_like, tree["params"])),
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}, "step": 0}
    got = ckpt.restore(str(tmp_path), 5, like)
    assert got["step"] == 7 and isinstance(got["step"], int)
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 3
    for a, b in zip(leaves(got["params"]), jax.tree.leaves(tree["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    like["params"]["a"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 5, like)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """A bf16 leaf: the reference writes it as an ml_dtypes array; the port
    reads it by its 16-bit pattern and writes the same bytes back, with
    "bfloat16" in meta.json."""
    vals = np.random.default_rng(2).normal(0, 1, (5, 3)).astype(np.float32)
    jax_ckpt.save(str(tmp_path / "ref"), 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    got = ckpt.restore(str(tmp_path / "ref"), 1, {"w": torch.zeros(5, 3, dtype=torch.bfloat16)})
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    ckpt.save(str(tmp_path / "port"), 1, {"w": want})
    meta = json.loads((tmp_path / "port" / "step_1" / "meta.json").read_text())
    assert meta["leaves"][0]["dtype"] == "bfloat16"
    ref_meta = json.loads((tmp_path / "ref" / "step_1" / "meta.json").read_text())
    assert ref_meta["leaves"][0]["dtype"] == "bfloat16"
    a = np.load(tmp_path / "port" / "step_1" / "arr_0.npy")
    b = np.load(tmp_path / "ref" / "step_1" / "arr_0.npy")
    assert a.tobytes() == b.tobytes() and a.dtype.itemsize == 2
    back = ckpt.restore(str(tmp_path / "port"), 1, {"w": torch.zeros(5, 3, dtype=torch.bfloat16)})
    assert torch.equal(back["w"], want)


def test_steps_tmp_directories_and_gc(tmp_path):
    d = str(tmp_path)
    assert ckpt.available_steps(d) == [] and ckpt.latest_step(d) is None
    for step in (2, 10, 4):
        ckpt.save(d, step, {"x": torch.ones(2)})
    os.makedirs(os.path.join(d, "step_12.tmp"))
    os.makedirs(os.path.join(d, "step_bad"))
    assert ckpt.available_steps(d) == [2, 4, 10] and ckpt.latest_step(d) == 10
    assert ckpt.gc_incomplete(d) == 1 and not os.path.exists(os.path.join(d, "step_12.tmp"))
    assert ckpt.gc_incomplete(str(tmp_path / "missing")) == 0


def test_save_async_snapshots_before_the_in_place_update(tmp_path):
    tree = {"x": torch.arange(6, dtype=torch.float32)}
    t = ckpt.save_async(str(tmp_path), 1, tree)
    tree["x"].add_(100.0)                        # the next step updates in place
    t.join(timeout=60)
    assert not t.is_alive()
    got = ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(6)})
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))


def test_resume_at_step_4_of_8_ends_bit_identical(tmp_path):
    cfg = get_smoke_config("rwkv6-7b")
    tcfg = TrainConfig(optim=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=12, global_batch=2, seed=3)
    run = lambda d, steps: train_mod.train(cfg, tcfg, data, steps, ckpt_dir=str(d),  # noqa: E731
                                           ckpt_every=4, seed=3, device="cpu")
    whole = run(tmp_path / "whole", 8)
    first = run(tmp_path / "cut", 4)
    second = run(tmp_path / "cut", 8)
    assert [r["step"] for r in first + second] == list(range(1, 9))
    for a, b in zip(whole, first + second):
        assert (a["loss"], a["grad_norm"], a["lr"]) == (b["loss"], b["grad_norm"], b["lr"])
    for key in ("whole", "cut"):
        assert ckpt.available_steps(str(tmp_path / key)) == [4, 8]
    meta = [json.loads((tmp_path / key / "step_8" / "meta.json").read_text())
            for key in ("whole", "cut")]
    assert meta[0] == meta[1]
    assert {leaf["key"] for leaf in meta[0]["leaves"]} >= {"step", "opt/step", "params/embed/table"}
    for leaf in meta[0]["leaves"]:
        a, b = (np.load(tmp_path / key / "step_8" / leaf["file"]) for key in ("whole", "cut"))
        assert a.tobytes() == b.tobytes(), leaf["key"]


def test_train_cli_on_the_cpu(capsys):
    hist = train_mod.main(["--arch", "minitron-8b", "--smoke", "--device", "cpu", "--steps", "3",
                           "--seq-len", "8", "--global-batch", "2"])
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert "done: loss" in capsys.readouterr().out


@pytest.mark.parametrize("n_pods", [2, 4])
def test_train_cli_control_on_gloo_ranks(n_pods):
    """``--control`` at its default probe noise (0.10) on two and four pods:
    the reference's control-plane summary on the same seed."""
    from test_torch_train_sync import check_control_cli

    check_control_cli(n_pods, ["--control"], 0.10)


def moe_cli_rank(rank: int, argv: list) -> list[float]:
    return [r["loss"] for r in train_mod.main(argv)]


@pytest.mark.parametrize("mesh", ["1,1,2", "2,1,2"])
def test_train_cli_trains_an_moe_split_over_model(mesh):
    """granite-moe-3b-a800m's experts and heads split over ``model`` from
    the command line: every rank reports the same finite losses."""
    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu", "--mesh", mesh,
            "--steps", "2", "--seq-len", "8", "--global-batch", "2"]
    ranks = run_local_ranks(moe_cli_rank, math.prod(map(int, mesh.split(","))), (argv,),
                            timeout=120)
    assert all(len(r) == 2 and np.all(np.isfinite(r)) and r == ranks[0] for r in ranks)


def test_train_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_smoke_config("rwkv6-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(cfg, TrainConfig())
