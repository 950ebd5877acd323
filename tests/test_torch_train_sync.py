"""Training across pods on the CPU: the port's ``build_train_step`` and
``train()`` on a ``(2, 1, 1)`` mesh of two gloo ranks against the
reference, at rwkv6-7b's smoke size (so the WKV6 wrapper's plain path is on
the path), in f32.

The reference runs in a child process with 8 forced host devices and
writes ``.npz`` files: its initial parameters (the port starts from them
through ``params_from_jax``), its leaf paths for every arch, and 4 steps of

* ``flat``: its ``build_train_step`` on a ``(2, 1, 1)`` mesh with ``Auto``
  axes (fault 1), whose GSPMD gradient is the global batch's mean;
* every strategy: the composition the multi-controller port performs, per
  pod ``jax.value_and_grad(loss_fn)`` on the pod's rows of the global
  batch, then ``sync_gradients`` in a fully manual ``shard_map`` on the
  pod-stacked gradients and residuals (fault 2), then ``adamw_update``.

Tolerances are those of ``test_torch_train_rwkv6.py`` in f32: losses rtol
1e-4; parameters within 1e-5 for all but 1% of each leaf's elements and
within 2 x the summed learning rates everywhere; the pods' parameters bit
for bit equal.  geococo's residuals per pod: the kept set (the entries
that are 0) differs in at most 3% of each leaf's elements, and the
residuals' L1 distance is at most 5% of their L1 norm.  The two frameworks'
f32 gradients differ by up to 1e-3 of a leaf's norm on this model
(``test_torch_train_rwkv6.py``), which moves an entry across its chunk's
top-k boundary now and then; an entry sent by one and kept by the other
then differs by its whole value in the following steps' residuals
(measured: at most 1.6% of a leaf, 1.8% in L1).  The exchange itself is
held exactly in ``test_torch_dist_collectives.py``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import ARCHS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.collectives import SyncConfig
from repro_torch.dist.grouping import group_like_reference, ungroup, zero_residuals
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_mesh, run_local_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, build_train_step
from repro_torch.tree import leaf_paths, leaves

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
ARCH = "rwkv6-7b"
STEPS, SEQ, BATCH = 4, 16, 4
LR, WARMUP = 1e-3, 2
# norms hold 64 values a layer, 128 stacked: filtered when stacked
SYNC = dict(density=0.25, chunk=256, min_leaf_size=100)
VARIANTS = {"flat": dict(strategy="flat"), "hier-ring": dict(strategy="hier", ring_order=(1, 0)),
            "geococo": dict(strategy="geococo", **SYNC),
            "geococo-ring": dict(strategy="geococo", ring_order=(1, 0), **SYNC)}
TOL = dict(loss=1e-4, param=1e-5, flip_share=0.01, mask_flips=0.03, res_l1=0.05)


def opt_cfg():
    return dict(lr=LR, warmup_steps=WARMUP, total_steps=STEPS)


def global_batches():
    data = SyntheticLM(DataConfig(vocab_size=get_smoke_config(ARCH).vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return [data.batch(i) for i in range(STEPS)]


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def reference_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.dist import collectives as rcol
    from repro.models import model as jax_model
    from repro.optim import adamw as jadamw
    from repro.train import train_step as jts

    def paths(tree):
        return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]

    def flat(tree):
        return {k: np.asarray(v) for k, v in paths(tree)}

    shapes = {}
    for arch in ARCHS:
        tree = jax.eval_shape(lambda a=arch: jax_model.init_params(jax_smoke(a), jax.random.PRNGKey(0)))
        shapes[arch] = [(k, list(v.shape)) for k, v in paths(tree)]
    with open(os.path.join(out_dir, "keys.json"), "w") as f:
        json.dump(shapes, f)

    jcfg = jax_smoke(ARCH)
    # on the host: the reference's step donates the arrays it is given
    params0 = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    np.savez(os.path.join(out_dir, "tree.npz"), **flat(params0))
    opt = jadamw.AdamWConfig(**opt_cfg())
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3,
                         devices=jax.devices()[:2])
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in global_batches()]
    out = {}

    # flat through the reference's own train step (GSPMD over pod)
    tcfg = jts.TrainConfig(sync=rcol.SyncConfig("flat"), optim=opt, compute_dtype=jnp.float32)
    make_jit, sh = jts.build_train_step(jcfg, mesh, tcfg)
    p = jax.device_put(params0, sh["params"])
    st = jax.device_put(jadamw.adamw_init(p, opt), sh["opt"])
    step = make_jit(batches[0])
    losses = []
    for b in batches:
        p, st, _, m = step(p, st, None, b)
        losses.append(float(m["loss"]))
    out["step/losses"] = np.array(losses)
    out.update({f"step/params/{k}": v for k, v in flat(p).items()})

    # the multi-controller composition, for every variant
    vg = jax.jit(jax.value_and_grad(lambda pp, b: jts.loss_fn(jcfg, pp, b, jnp.float32)))
    for name, kw in VARIANTS.items():
        cfg = rcol.SyncConfig(**kw)

        def body(g, r, cfg=cfg):
            g = jax.tree.map(lambda x: x[0], g)
            r = jax.tree.map(lambda x: x[0], r) if cfg.needs_residuals else None
            s, nr = rcol.sync_gradients(g, r, cfg, axis="pod", n_pods=2)
            nr = nr if nr is not None else g
            return jax.tree.map(lambda x: x[None], s), jax.tree.map(lambda x: x[None], nr)

        sync = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
                                     check_vma=False))
        p = jax.tree.map(jnp.asarray, params0)
        st = jadamw.adamw_init(p, opt)
        res = jax.tree.map(lambda x: jnp.zeros((2,) + x.shape, jnp.float32), p)
        losses = []
        for b in batches:
            pods = [vg(p, {k: v[i * 2:(i + 1) * 2] for k, v in b.items()}) for i in range(2)]
            g = jax.tree.map(lambda *xs: jnp.stack(xs), *[gp for _, gp in pods])
            synced, new_res = sync(g, res)
            if cfg.needs_residuals:
                res = new_res
            one = jax.tree.map(lambda x: x[0], synced)
            p, st, _ = jadamw.adamw_update(p, one, st, opt)
            losses.append(float(sum(lp for lp, _ in pods) / 2))
        out[f"{name}/losses"] = np.array(losses)
        out.update({f"{name}/params/{k}": v for k, v in flat(p).items()})
        out.update({f"{name}/res/{k}": v for k, v in flat(res).items()})
    np.savez(os.path.join(out_dir, "runs.npz"), **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, __file__, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    keys = {arch: [tuple(kv) for kv in v]
            for arch, v in json.loads((out_dir / "keys.json").read_text()).items()}
    return (keys, str(out_dir / "tree.npz"), dict(np.load(out_dir / "runs.npz")))


def sub(runs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the port, on two gloo ranks
# ---------------------------------------------------------------------------


def port_train_rank(rank: int, tree_path: str) -> dict:
    cfg = get_smoke_config(ARCH)
    tree = dict(np.load(tree_path))
    mesh, _ = make_mesh((2, 1, 1), device="cpu")
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
               for b in global_batches()]
    opt = adamw.AdamWConfig(**opt_cfg())
    out = {}
    for name, kw in VARIANTS.items():
        tcfg = TrainConfig(sync=SyncConfig(**kw), optim=opt, compute_dtype=torch.float32)
        params = params_from_jax(cfg, tree, device="cpu")
        state = adamw.adamw_init(params, opt)
        res = zero_residuals(cfg, "cpu") if tcfg.sync.needs_residuals else None
        step = build_train_step(cfg, tcfg, "cpu", mesh)
        metrics = [step(params, state, b, res) for b in batches]
        out[name] = {"losses": [float(m["loss"]) for m in metrics],
                     "params": {k: v.detach().numpy() for k, v in leaf_paths(params)},
                     "res": {k: v.numpy() for k, v in res.items()} if res is not None else None,
                     "sparse_values": [m["sparse_values"] for m in metrics],
                     "pods_agree": [m["pods_agree"] for m in metrics]}
    return out


@pytest.fixture(scope="module")
def port(reference):
    return run_local_ranks(port_train_rank, 2, (reference[1],), timeout=RANK_TIMEOUT)


def check_params(got: dict, want_flat: dict, what: str):
    cfg = get_smoke_config(ARCH)
    want = params_from_jax(cfg, want_flat, device="cpu")
    bound = 2 * sum(float(adamw.cosine_lr(adamw.AdamWConfig(**opt_cfg()), torch.tensor(i)))
                    for i in range(1, STEPS + 1))
    for key, w in leaf_paths(want):
        diff = np.abs(got[key] - w.numpy())
        assert diff.max() <= bound + TOL["param"], f"{what} {key}"
        assert (diff > TOL["param"]).mean() <= TOL["flip_share"], f"{what} {key}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_group_then_ungroup_is_the_identity(arch):
    cfg = get_smoke_config(arch)
    per_layer = leaves(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    grouped = group_like_reference(cfg, per_layer)
    back = ungroup(cfg, grouped)
    assert len(back) == len(per_layer)
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(back, per_layer))
    assert sum(g.numel() for g in grouped.values()) == sum(p.numel() for p in per_layer)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_keys_are_the_reference_leaf_paths(arch, reference):
    keys, _, _ = reference
    cfg = get_smoke_config(arch)
    grouped = group_like_reference(cfg, leaves(init_params(cfg, None, "meta")))
    assert [(k, list(v.shape)) for k, v in grouped.items()] == keys[arch]


def test_flat_matches_the_reference_train_step(port, reference):
    _, _, runs = reference
    want = runs["step/losses"]
    for pod in port:
        np.testing.assert_allclose(pod["flat"]["losses"], want, rtol=TOL["loss"])
        check_params(pod["flat"]["params"], sub(runs, "step/params/"), "flat vs build_train_step")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_training_matches_the_reference_composition(name, port, reference):
    _, _, runs = reference
    np.testing.assert_allclose(port[0][name]["losses"], runs[f"{name}/losses"], rtol=TOL["loss"])
    check_params(port[0][name]["params"], sub(runs, f"{name}/params/"), name)
    for key in port[0][name]["params"]:           # every pod ends with the same parameters
        assert (port[0][name]["params"][key] == port[1][name]["params"][key]).all(), key
    assert port[0][name]["pods_agree"] == port[1][name]["pods_agree"] == [1.0] * STEPS
    if port[0][name]["res"] is None:
        assert not VARIANTS[name]["strategy"] == "geococo"
        return
    want_res = sub(runs, f"{name}/res/")
    for pod, mine in enumerate(port):
        got = mine[name]["res"]
        assert list(got) == list(want_res)
        for key, want in want_res.items():
            flips = ((got[key] == 0) != (want[pod] == 0)).mean()
            assert flips <= TOL["mask_flips"], f"pod {pod} {key}: {flips:.2%} of the mask differs"
        l1 = sum(np.abs(got[k] - w[pod]).sum() for k, w in want_res.items())
        assert l1 <= TOL["res_l1"] * sum(np.abs(w[pod]).sum() for w in want_res.values()), pod
        assert any(np.abs(r).max() > 0 for r in got.values())
    # the pods hold different residuals: each filtered its own gradient
    assert any(not np.array_equal(port[0][name]["res"][k], port[1][name]["res"][k])
               for k in port[0][name]["res"])
    assert all(v > 0 for v in port[0][name]["sparse_values"])


def resume_rank(rank: int, root: str) -> dict:
    cfg = get_smoke_config(ARCH)
    mesh, _ = make_mesh((2, 1, 1), device="cpu")
    tcfg = TrainConfig(sync=SyncConfig(**VARIANTS["geococo"]),
                       optim=adamw.AdamWConfig(**opt_cfg()))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=12, global_batch=4, seed=3)
    run = lambda d, steps: train_mod.train(cfg, tcfg, data, steps, ckpt_dir=os.path.join(root, d),  # noqa: E731
                                           ckpt_every=2, seed=3, device="cpu", mesh=mesh)
    whole = run("whole", STEPS)
    cut = run("cut", 2) + run("cut", STEPS)
    keep = ("step", "loss", "grad_norm", "lr")
    return {"whole": [{k: r[k] for k in keep} for r in whole],
            "cut": [{k: r[k] for k in keep} for r in cut]}


def test_resume_across_pods_is_bit_identical(tmp_path):
    got = run_local_ranks(resume_rank, 2, (str(tmp_path),), timeout=RANK_TIMEOUT)
    for pod in got:
        assert [r["step"] for r in pod["cut"]] == list(range(1, STEPS + 1))
        assert pod["cut"] == pod["whole"]
    for where in ("", "pod1"):
        for step in (2, 4):
            a, b = (tmp_path / d / where / f"step_{step}" for d in ("whole", "cut"))
            files = sorted(p.name for p in a.iterdir())
            assert files == sorted(p.name for p in b.iterdir())
            for name in files:
                assert (a / name).read_bytes() == (b / name).read_bytes(), (where, step, name)
    meta = json.loads((tmp_path / "whole" / "step_4" / "meta.json").read_text())
    keys = {leaf["key"] for leaf in meta["leaves"]}
    assert {"step", "opt/step", "params/embed/table", "residuals/embed/table",
            "residuals/scan/0/mixer/u"} <= keys
    pod1 = json.loads((tmp_path / "whole" / "pod1" / "step_4" / "meta.json").read_text())
    assert {leaf["key"] for leaf in pod1["leaves"]} == {"step"} | {
        k for k in keys if k.startswith("residuals/")}


def three_pod_rank(rank: int, variant: str) -> list:
    cfg = get_smoke_config(ARCH)
    mesh, _ = make_mesh((3, 1, 1), device="cpu")
    kw = dict(VARIANTS[variant], ring_order=(2, 0, 1))
    tcfg = TrainConfig(sync=SyncConfig(**kw), optim=adamw.AdamWConfig(**opt_cfg()),
                       compute_dtype=torch.float32)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=3, seed=5)
    hist = train_mod.train(cfg, tcfg, data, STEPS, seed=5, device="cpu", mesh=mesh)
    return [(r["loss"], r["pods_agree"]) for r in hist]


@pytest.mark.parametrize("variant", ["hier-ring", "geococo-ring"])
def test_three_pods_on_a_ring_end_every_step_alike(variant):
    """With three pods on the relay ring (2, 0, 1), every pod adds the
    ring's messages in one order, so the pods' parameters agree bit for bit
    after every step (the step raises where they do not)."""
    got = run_local_ranks(three_pod_rank, 3, (variant,), timeout=RANK_TIMEOUT)
    assert got[0] == got[1] == got[2]
    assert [agree for _, agree in got[0]] == [1.0] * STEPS
    assert all(np.isfinite(loss) for loss, _ in got[0])


def cli_rank(rank: int, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = train_mod.main(argv)
    assert [r["step"] for r in hist] == [1, 2, 3]
    return out.getvalue()


def test_cli_trains_across_two_pods():
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2,1,1", "--sync", "geococo",
            "--steps", "3", "--seq-len", "8", "--global-batch", "2"]
    printed = run_local_ranks(cli_rank, 2, (argv,), timeout=RANK_TIMEOUT)
    assert "done: loss" in printed[0] and "2 pod(s), sync geococo" in printed[0]
    assert printed[1] == ""


def control_cli_rank(rank: int, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_mod.main(argv)
    return out.getvalue()


def reference_control_line(n_pods: int, steps: int, seed: int, noise: float) -> str:
    """The reference CLI's summary of its control plane (``repro.launch.train``:
    the first ``n_pods`` AWS regions under jitter, probed with ``noise``),
    the plane replayed alone for ``steps`` rounds, one a step; under hier
    each ``RelayOrderChanged`` rebuilds the step once."""
    import repro.control as rctl
    from repro.core.latency import aws_latency_matrix, jitter_trace

    trace = jitter_trace(aws_latency_matrix()[:n_pods, :n_pods], max(steps, 2),
                         np.random.default_rng(seed))
    plane = rctl.ControlPlane(rctl.MonitorView(rctl.TraceView(trace), noise=noise,
                                               rng=np.random.default_rng(seed + 1)))
    for _ in range(steps):
        plane.step()
    rebuilds = plane.event_counts().get("RelayOrderChanged", 0)
    return (f"control plane: {plane.round} rounds, {plane.replan_count} replans, relay order "
            f"{plane.relay_order}, events {plane.event_counts()}, probe traffic "
            f"{plane.probe_bytes} B; step rebuilds {rebuilds}")


def check_control_cli(n_pods: int, flags: list, noise: float) -> None:
    """``--control`` on ``n_pods`` gloo ranks: rank 0 prints the reference's
    summary line for the same seed, the others print nothing."""
    steps, seed = 4, 2
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", f"{n_pods},1,1",
            "--steps", str(steps), "--seq-len", "8", "--global-batch", str(n_pods),
            "--seed", str(seed), *flags]
    printed = run_local_ranks(control_cli_rank, n_pods, (argv,), timeout=RANK_TIMEOUT)
    lines = [line for line in printed[0].splitlines() if line.startswith("control plane:")]
    assert lines == [reference_control_line(n_pods, steps, seed, noise)]
    assert f"{n_pods} pod(s), sync hier" in printed[0]
    assert all(p == "" for p in printed[1:])


@pytest.mark.parametrize("n_pods", [2, 4])
def test_cli_control_noise_on_gloo_ranks(n_pods):
    check_control_cli(n_pods, ["--control", "--control-noise", "0.2"], 0.2)


@pytest.mark.parametrize("flag,named", [(["--mesh", "2,1,1"], "the world has 1"),
                                        (["--sync", "bogus"], "unknown sync strategy")])
def test_cli_refuses_by_name(flag, named, capsys):
    with pytest.raises(SystemExit) as err:
        train_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", *flag])
    assert err.value.code == 2
    assert named in capsys.readouterr().err


def test_geococo_on_one_pod_keeps_zero_residuals(tmp_path):
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(sync=SyncConfig("geococo"), optim=adamw.AdamWConfig(**opt_cfg()))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    hist = train_mod.train(cfg, tcfg, data, 2, ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    assert len(hist) == 2 and "sparse_values" not in hist[0]
    like = {"residuals": zero_residuals(cfg, "cpu")}
    res = ckpt.restore(str(tmp_path), 2, like)["residuals"]
    assert list(res) == list(group_like_reference(cfg, leaves(init_params(cfg, None, "meta"))))
    assert all(not r.any() for r in res.values())


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
