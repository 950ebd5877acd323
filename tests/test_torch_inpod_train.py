"""Training on meshes that shard within a pod, on the CPU: the port's
``train()`` on (2, 2, 1), (2, 1, 2) and (2, 2, 2) meshes of gloo ranks
against the reference's ``build_train_step``, and on (1, 2, 1), (1, 1, 2),
(1, 2, 2) and (1, 1, 3), where it splits attention heads and experts over
``model``; checkpoints moved between meshes, and the CLI.

The reference runs in a child process with 8 forced host devices, its
meshes built with ``Auto`` axes (fault 1), and writes 3 steps of its
``build_train_step`` in f32 for: rwkv6-7b's smoke config under flat and
hier on (2, 2, 1) and geococo at density 1.0 on (2, 1, 2);
minitron-8b's under hier on (2, 1, 2); granite-moe-3b-a800m's under hier
on (2, 2, 1) (``model`` 1: the reference's dense dispatch, capacity factor
8.0, which drops nothing at this size, so the rows a device sees do not
decide the drops); and with ``model`` above 1 or the published capacity
factor, each on its own mesh: granite-moe-3b-a800m's at capacity factor
1.25 on (1, 2, 1) (dense dispatch over the rows ``data`` splits: fault 10),
(1, 1, 2), (1, 2, 2) (each ``data`` shard's experts see its tokens alone)
and (1, 1, 3) (padded experts and q heads); minitron-8b's on (1, 1, 3)
(padded heads); recurrentgemma-9b's on (1, 1, 2) (banded attention, one kv
head).  On one controller the reference's gradient is the
global batch's mean on every mesh and its pod exchange of these three
strategies averages pod-identical values, so a strategy's trajectory is
the same on every mesh up to float reassociation, where the MoE drops
nothing: each of the port's meshes is held against the reference's run of
its strategy, or of its mesh where there is one.  Not on
(2, 2, 2): there the reference's step computes another gradient on the
CPU (fault 9, ``ROADMAP.md`` §3), which a test pins.

Tolerances are those of ``test_torch_train_sync.py`` for flat: losses rtol
1e-4; parameters within 1e-5 for all but 1% of each leaf's elements and
within 2 x the summed learning rates everywhere (AdamW moves an element by
about lr sign(g) while m and v are young, so an element whose gradient is
near its rounding noise may move the other way).  Checkpoints: bit for bit.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.collectives import SyncConfig
from repro_torch.dist.grouping import leaf_specs
from repro_torch.dist.sharding import local_shard
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import AXES, make_mesh, run_local_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import region_leaves
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig
from repro_torch.tree import leaf_paths

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
MESHES = [(2, 2, 1), (2, 1, 2), (2, 2, 2)]
TP_MESHES = [(1, 2, 1), (1, 1, 2), (1, 2, 2), (1, 1, 3)]
# granite at the published capacity factor: the drops depend on the rows routed together
GRANITE_125 = "granite-moe-3b-a800m@1.25"
STEPS, SEQ, BATCH = 3, 16, 4
LR, WARMUP = 1e-3, 2
STRATEGIES = {"flat": dict(strategy="flat"), "hier": dict(strategy="hier", ring_order=(1, 0)),
              "geococo-1.0": dict(strategy="geococo", density=1.0, chunk=256, min_leaf_size=100)}
# (arch, strategy, the mesh the reference runs it on)
REFERENCE_RUNS = [("rwkv6-7b", "flat", (2, 2, 1)), ("rwkv6-7b", "hier", (2, 2, 1)),
                  ("rwkv6-7b", "geococo-1.0", (2, 1, 2)), ("minitron-8b", "hier", (2, 1, 2)),
                  ("granite-moe-3b-a800m", "hier", (2, 2, 1))]
# the runs whose result depends on the mesh, or that exercise the reference's
# model-parallel paths: the port's run on that mesh is held against them
TP_RUNS = ([(GRANITE_125, "hier", m) for m in TP_MESHES]
           + [("minitron-8b", "hier", (1, 1, 3)), ("recurrentgemma-9b", "hier", (1, 1, 2))])
# fault 9: the reference's step on a (2, 2, 2) mesh computes another gradient
FAULT_9_RUN = ("rwkv6-7b", "hier", (2, 2, 2))
# (arch, strategy, mesh) of the port: rwkv6 under each strategy on each mesh
PORT_RUNS = ([("rwkv6-7b", s, m) for s in STRATEGIES for m in MESHES]
             + [("minitron-8b", "hier", (2, 1, 2)), ("granite-moe-3b-a800m", "hier", (2, 2, 1))]
             + TP_RUNS)
TOL = dict(loss=1e-4, param=1e-5, flip_share=0.01)
CKPT_SYNC = dict(strategy="geococo", density=0.25, chunk=256, min_leaf_size=100)


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def opt_cfg():
    return dict(lr=LR, warmup_steps=WARMUP, total_steps=STEPS)


def smoke(arch: str, get=get_smoke_config):
    """The smoke config of ``arch``, ``name@cf`` with its MoE's capacity
    factor set to ``cf``; ``get`` the package's ``get_smoke_config``."""
    name, _, cf = arch.partition("@")
    cfg = get(name)
    if cf:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cf)))
    return cfg


def run_key(arch: str, strategy: str, shape) -> str:
    """Where the reference's run that a port run on ``shape`` is held
    against is kept: the run on that mesh if the reference made one, else
    its run of the strategy."""
    own = (arch, strategy, tuple(shape))
    if own in TP_RUNS:
        return f"{arch}/{strategy}/{mesh_key(shape)}"
    return f"{arch}/{strategy}"


def global_batches(arch: str):
    data = SyntheticLM(DataConfig(vocab_size=smoke(arch).vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return [data.batch(i) for i in range(STEPS)]


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def reference_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.dist import collectives as rcol
    from repro.models import model as jax_model
    from repro.optim import adamw as jadamw
    from repro.train import train_step as jts

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    opt = jadamw.AdamWConfig(**opt_cfg())
    for arch, strategy, shape in REFERENCE_RUNS + [FAULT_9_RUN] + TP_RUNS:
        jcfg = smoke(arch, jax_smoke)
        params0 = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
        out.update({f"{arch}/init/{k}": v for k, v in flat(params0).items()})
        mesh = jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:math.prod(shape)])
        tcfg = jts.TrainConfig(sync=rcol.SyncConfig(**STRATEGIES[strategy]), optim=opt,
                               compute_dtype=jnp.float32)
        make_jit, sh = jts.build_train_step(jcfg, mesh, tcfg)
        p = jax.device_put(params0, sh["params"])
        st = jax.device_put(jadamw.adamw_init(p, opt), sh["opt"])
        res = None
        if sh["residuals"] is not None:
            res = jax.device_put(jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p),
                                 sh["residuals"])
        batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in global_batches(arch)]
        step = make_jit(batches[0])
        losses, norms = [], []
        for b in batches:
            p, st, res, m = step(p, st, res, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        if (arch, strategy, shape) == FAULT_9_RUN:
            out["fault9/grad_norms"] = np.array(norms)
            continue
        key = run_key(arch, strategy, shape)
        out[f"{key}/losses"] = np.array(losses)
        out[f"{key}/grad_norms"] = np.array(norms)
        out.update({f"{key}/params/{k}": v for k, v in flat(p).items()})
    np.savez(os.path.join(out_dir, "runs.npz"), **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, __file__, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return str(out_dir / "runs.npz")


def sub(runs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------


def trajectory_rank(rank: int, shape: tuple, runs_path: str) -> dict:
    mesh, _ = make_mesh(shape, device="cpu")
    runs = dict(np.load(runs_path))
    out = {"coords": dict(mesh.coords)}
    for arch, strategy, where in PORT_RUNS:
        if where != shape:
            continue
        cfg = smoke(arch)
        tcfg = TrainConfig(sync=SyncConfig(**STRATEGIES[strategy]),
                           optim=adamw.AdamWConfig(**opt_cfg()), compute_dtype=torch.float32)
        placement = train_mod.StatePlacement(cfg, tcfg, torch.device("cpu"), mesh)
        whole = params_from_jax(cfg, sub(runs, f"{arch}/init/"), device="cpu")
        state = {"params": placement.place(whole, "params"), "step": 0}
        state["opt"] = adamw.adamw_init(state["params"], tcfg.optim)
        if tcfg.sync.needs_residuals:
            state["residuals"] = placement.initial(0)["residuals"]
        step = train_mod.build_train_step(cfg, tcfg, "cpu", mesh)
        batches = [{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
                   for b in global_batches(arch)]
        metrics = [step(state["params"], state["opt"], b, state.get("residuals"))
                   for b in batches]
        out[(arch, strategy)] = {
            "losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "pods_agree": [m["pods_agree"] for m in metrics],
            "inpod_bytes": [m["inpod_bytes"] for m in metrics],
            "tp_bytes": [m["tp_bytes"] for m in metrics],
            "blocks": {k: v.detach().numpy() for k, v in leaf_paths(state["params"])}}
    return out


@pytest.fixture(scope="module")
def port(reference):
    return {mesh_key(s): run_local_ranks(trajectory_rank, math.prod(s), (s, reference),
                                         timeout=RANK_TIMEOUT) for s in MESHES + TP_MESHES}


def check_blocks(arch, strategy, shape, got: dict, coords: dict, want_flat: dict):
    cfg = smoke(arch)
    want = params_from_jax(cfg, want_flat, device="cpu")
    sizes = dict(zip(AXES, shape))
    bound = 2 * sum(float(adamw.cosine_lr(adamw.AdamWConfig(**opt_cfg()), torch.tensor(i)))
                    for i in range(1, STEPS + 1))
    what = f"{strategy} on {shape}"
    specs = leaf_specs(cfg, sizes, STRATEGIES[strategy]["strategy"])
    for key, w in leaf_paths(want):
        spec = specs[key]
        block = local_shard(w, spec, coords, sizes).numpy()
        assert got[key].shape == block.shape, (what, key)
        diff = np.abs(got[key] - block)
        assert diff.max() <= bound + TOL["param"], f"{what} {key}"
        assert (diff > TOL["param"]).mean() <= TOL["flip_share"], f"{what} {key}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,strategy,shape", PORT_RUNS,
                         ids=[f"{a}-{s}-{mesh_key(m)}" for a, s, m in PORT_RUNS])
def test_trajectory_matches_the_reference_train_step(arch, strategy, shape, port, reference):
    runs = dict(np.load(reference))
    ranks = port[mesh_key(shape)]
    key = run_key(arch, strategy, shape)
    for got in ranks:
        mine = got[(arch, strategy)]
        np.testing.assert_allclose(mine["losses"], runs[f"{key}/losses"], rtol=TOL["loss"])
        assert mine["pods_agree"] == [1.0] * STEPS
        check_blocks(arch, strategy, shape, mine["blocks"], got["coords"],
                     sub(runs, f"{key}/params/"))
    # every rank reports the same mean loss; the ranks of a pod group hold the same blocks
    assert all(got[(arch, strategy)]["losses"] == ranks[0][(arch, strategy)]["losses"]
               for got in ranks)
    per_pod = math.prod(shape[1:])
    for r in range(per_pod if shape[0] > 1 else 0):
        a, b = ranks[r][(arch, strategy)]["blocks"], ranks[r + per_pod][(arch, strategy)]["blocks"]
        assert all(np.array_equal(a[k], b[k]) for k in a)
    inpod = ranks[0][(arch, strategy)]["inpod_bytes"]
    assert all(v > 0 for v in inpod) and len(set(inpod)) == 1
    # the regions' sums (attention or experts, model above 1) and the MoE's
    # count prefix (rows split over data) cross gloo
    tp = ranks[0][(arch, strategy)]["tp_bytes"]
    cfg = smoke(arch)
    crossed = ((shape[2] > 1 and bool(region_leaves(cfg)))
               or (cfg.moe is not None and shape[1] > 1))
    assert all((v > 0) == crossed for v in tp) and len(set(tp)) == 1


def test_the_reference_step_on_2_2_2_computes_another_gradient(port, reference):
    """Fault 9, pinned: on the CPU the reference's ``build_train_step``
    on a (2, 2, 2) mesh clips by another step-1 gradient norm than on
    every other mesh; the port's (2, 2, 2) ranks give the others'."""
    runs = dict(np.load(reference))
    want = runs["rwkv6-7b/hier/grad_norms"][0]
    wrong = runs["fault9/grad_norms"][0]
    assert abs(wrong - want) > 0.05 * want
    for got in port["2x2x2"]:
        np.testing.assert_allclose(got[("rwkv6-7b", "hier")]["grad_norms"][0], want, rtol=1e-5)


def resume_rank(rank: int, shape: tuple, root: str) -> dict:
    cfg = get_smoke_config("rwkv6-7b")
    mesh, _ = make_mesh(shape, device="cpu")
    tcfg = TrainConfig(sync=SyncConfig(**CKPT_SYNC), optim=adamw.AdamWConfig(**opt_cfg()))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=12, global_batch=4, seed=3)
    run = lambda d, steps: train_mod.train(cfg, tcfg, data, steps,  # noqa: E731
                                           ckpt_dir=os.path.join(root, d), ckpt_every=2, seed=3,
                                           device="cpu", mesh=mesh)
    whole = run("whole", 4)
    cut = run("cut", 2) + run("cut", 4)
    keep = ("step", "loss", "grad_norm", "lr")
    return {"whole": [{k: r[k] for k in keep} for r in whole],
            "cut": [{k: r[k] for k in keep} for r in cut]}


def same_files(a: Path, b: Path) -> None:
    files = sorted(p.name for p in a.iterdir())
    assert files == sorted(p.name for p in b.iterdir()), (a, b)
    for name in files:
        assert (a / name).read_bytes() == (b / name).read_bytes(), (a, b, name)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """geococo runs with checkpoints every 2 steps: on (2, 2, 1) whole and
    cut at step 2 and resumed, and on (2, 1, 1) whole."""
    root = tmp_path_factory.mktemp("ckpt")
    got = run_local_ranks(resume_rank, 4, ((2, 2, 1), str(root / "2x2x1")), timeout=RANK_TIMEOUT)
    run_local_ranks(resume_rank, 2, ((2, 1, 1), str(root / "2x1x1")), timeout=RANK_TIMEOUT)
    return root, got


def test_resume_on_a_sharded_mesh_is_bit_identical(saved):
    root, got = saved
    for rank in got:
        assert [r["step"] for r in rank["cut"]] == [1, 2, 3, 4]
        assert rank["cut"] == rank["whole"]
    for where in ("", "pod1"):
        for step in (2, 4):
            same_files(root / "2x2x1" / "whole" / where / f"step_{step}",
                       root / "2x2x1" / "cut" / where / f"step_{step}")
    meta = json.loads((root / "2x2x1" / "whole" / "step_4" / "meta.json").read_text())
    shapes = {leaf["key"]: leaf["shape"] for leaf in meta["leaves"]}
    assert shapes["params/embed/table"] == [512, 64]                 # whole, not a block
    assert shapes["residuals/scan/0/mixer/wk/w"] == [2, 64, 64]
    assert shapes["opt/m/layers/1/ffn/wk/w"] == [64, 128]


def roundtrip_rank(rank: int, shape: tuple, src: str, dst: str) -> None:
    cfg = get_smoke_config("rwkv6-7b")
    mesh = make_mesh(shape, device="cpu")[0] if math.prod(shape) > 1 else None
    tcfg = TrainConfig(sync=SyncConfig(**CKPT_SYNC), optim=adamw.AdamWConfig(**opt_cfg()))
    placement = train_mod.StatePlacement(cfg, tcfg, torch.device("cpu"), mesh)
    state = placement.restore(src, placement.latest(src))
    thread = placement.save_async(dst, state)
    if thread is not None:
        thread.join()
    if mesh is not None:
        torch.distributed.barrier()


@pytest.mark.parametrize("saved_on,read_on", [((2, 2, 1), (2, 1, 1)), ((2, 2, 1), (1, 1, 1)),
                                              ((2, 2, 1), (2, 1, 2)), ((2, 2, 1), (2, 2, 2)),
                                              ((2, 1, 1), (2, 2, 1))],
                         ids=lambda s: mesh_key(s))
def test_checkpoint_moves_between_meshes_bit_for_bit(saved_on, read_on, saved, tmp_path):
    """A checkpoint written on one mesh, read on another and written again
    holds the same bytes: the state a rank restores is its blocks of the
    saved leaves, bit for bit, whatever mesh wrote them."""
    root, _ = saved
    src = root / mesh_key(saved_on) / "whole"
    n = math.prod(read_on)
    if n == 1:
        roundtrip_rank(0, read_on, str(src), str(tmp_path))
    else:
        run_local_ranks(roundtrip_rank, n, (read_on, str(src), str(tmp_path)),
                        timeout=RANK_TIMEOUT)
    same_files(src / "step_4", tmp_path / "step_4")
    if read_on[0] > 1:
        same_files(src / "pod1" / "step_4", tmp_path / "pod1" / "step_4")


def cli_rank(rank: int, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = train_mod.main(argv)
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert all(r["inpod_bytes"] > 0 for r in hist)
    return out.getvalue()


@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_cli_trains_on_a_sharded_mesh(shape):
    mesh = ",".join(map(str, shape))
    argv = ["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", "--mesh", mesh, "--sync",
            "geococo", "--steps", "3", "--seq-len", "8", "--global-batch", "4"]
    printed = run_local_ranks(cli_rank, math.prod(shape), (argv,), timeout=RANK_TIMEOUT)
    assert "done: loss" in printed[0] and f"2 pod(s), sync geococo, mesh {mesh}" in printed[0]
    assert printed[1:] == [""] * (math.prod(shape) - 1)


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
