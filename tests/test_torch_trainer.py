"""The port's trainer (``repro_torch.train.trainer``) on the CPU, at the
sizes of the reference's trainer tests (minitron-8b's smoke config, seq 32,
global batch 8; geococo at density 0.25, chunk 64, ``min_leaf_size`` 64),
on gloo ranks:

* the five behaviours of ``tests/test_train_integration.py``: the loss
  falls and checkpoints land at [4, 8]; a restart resumes identically, here
  bit for bit; a fault rolls back and replays, the replayed step bit for
  bit; a checkpoint written on (2, 2, 1) restores on (1, 2, 2); the
  deprecated straggler hook fires and warns;
* ``StragglerMonitor`` against the reference's on the same step times;
* 8 steps of ``hier`` on (2, 1, 1) against the reference's ``Trainer``,
  run in a child process with 8 forced host devices on a mesh built with
  ``Auto`` axes (fault 1), the port starting from its initial parameters
  through ``params_from_jax``; geococo at density 1.0 equal to hier bit for
  bit, and at 0.25 against the reference's functions composed per pod (the
  reference's single-controller geococo is another algorithm: ``ROADMAP.md``
  §3's note), as ``test_torch_train_sync.py`` composes them;
* on (4, 1, 1) ranks, the reference test's square-then-spiked latency
  frames (``tests/test_control_plane.py:471-518``): the same
  ``RelayOrderChanged`` events at the same steps as the reference's
  ``ControlPlane`` replayed alone, the step rebuilt on each, and every rank
  with the same events, ring, records and parameters; a straggler trip
  replans before the next step.

Tolerances are ``test_torch_train_sync.py``'s in f32: losses rtol 1e-4;
parameters within 1e-5 for all but 1% of each leaf's elements and within
2 x the summed learning rates everywhere.
"""

import contextlib
import io
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.control as rctl
from repro_torch.checkpoint.checkpoint import available_steps
from repro_torch.configs.registry import get_smoke_config
from repro_torch.control import ControlPlane, PlanChanged, TraceView
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.collectives import SyncConfig
from repro_torch.launch.mesh import make_mesh, run_local_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import FaultInjected, StragglerMonitor, Trainer, TrainerConfig
from repro_torch.tree import leaf_paths

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
ARCH = "minitron-8b"
STEPS, SEQ, BATCH = 8, 32, 8
LR, WARMUP = 1e-3, 2
SYNC = dict(density=0.25, chunk=64, min_leaf_size=64)
TOL = dict(loss=1e-4, param=1e-5, flip_share=0.01)
# the records every rank of a mesh holds alike: a step's mean loss, the
# global gradient norm, the learning rate and the wire's counts (not the
# host times, nor the nonzero values each pod sent of its own gradient)
SHARED = ("step", "loss", "grad_norm", "lr", "pods_agree", "dense_values", "sparse_values",
          "bytes_sent")

SQUARE = np.array([[0.0, 10.0, 14.0, 10.0],
                   [10.0, 0.0, 10.0, 14.0],
                   [14.0, 10.0, 0.0, 10.0],
                   [10.0, 14.0, 10.0, 0.0]])
SPIKED = SQUARE.copy()
SPIKED[0, 1] = SPIKED[1, 0] = SPIKED[2, 3] = SPIKED[3, 2] = 100.0
SQUARE_FRAMES = [SQUARE] * 2 + [SPIKED] * 8


def opt_cfg() -> dict:
    # a fixed horizon: the schedule does not depend on how many steps a run takes
    return dict(lr=LR, warmup_steps=WARMUP, total_steps=STEPS)


def data_cfg(seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size=get_smoke_config(ARCH).vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=seed)


def make_trainer(mesh, *, steps: int = STEPS, sync: str = "hier", ckpt_dir=None,
                 ckpt_async: bool = False, control=None, compute=torch.bfloat16,
                 **sync_kw) -> Trainer:
    """The reference test's ``_mk_trainer`` on the port."""
    tcfg = TrainConfig(sync=SyncConfig(strategy=sync, **{**SYNC, **sync_kw}),
                       optim=adamw.AdamWConfig(**opt_cfg()), compute_dtype=compute)
    run_cfg = TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=4, ckpt_async=ckpt_async,
                            log_every=100)
    return Trainer(get_smoke_config(ARCH), mesh, tcfg, run_cfg, data_cfg(), control=control,
                   device="cpu")


def shared(history: list) -> list:
    return [tuple(r[k] for k in SHARED if k in r) for r in history]


def params_of(trainer: Trainer) -> dict:
    return {k: v.detach().numpy().copy() for k, v in leaf_paths(trainer.params)}


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def reference_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
    from repro.dist import collectives as rcol
    from repro.optim import adamw as jadamw
    from repro.train import train_step as jts
    from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    jcfg = jax_smoke(ARCH)
    opt = jadamw.AdamWConfig(**opt_cfg())
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3,
                         devices=jax.devices()[:2])
    data = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    out = {}
    # hier through the reference's own Trainer
    tcfg = jts.TrainConfig(sync=rcol.SyncConfig("hier", **SYNC), optim=opt,
                           compute_dtype=jnp.float32)
    trainer = JTrainer(jcfg, mesh, tcfg, JTrainerConfig(steps=STEPS, log_every=100), data)
    params0 = jax.tree.map(np.asarray, trainer.params)   # on the host: the step donates
    np.savez(os.path.join(out_dir, "init.npz"), **flat(params0))
    hist = trainer.run()
    out["hier/losses"] = np.array([r["loss"] for r in hist])
    out["hier/grad_norms"] = np.array([r["grad_norm"] for r in hist])
    out.update({f"hier/params/{k}": v for k, v in flat(trainer.params).items()})

    # geococo: per pod value_and_grad on the pod's rows, sync_gradients in a
    # fully manual shard_map on the pod-stacked gradients (fault 2), AdamW
    cfg = rcol.SyncConfig("geococo", **SYNC)
    vg = jax.jit(jax.value_and_grad(lambda pp, b: jts.loss_fn(jcfg, pp, b, jnp.float32)))

    def body(g, r):
        g = jax.tree.map(lambda x: x[0], g)
        r = jax.tree.map(lambda x: x[0], r)
        s, nr = rcol.sync_gradients(g, r, cfg, axis="pod", n_pods=2)
        return jax.tree.map(lambda x: x[None], s), jax.tree.map(lambda x: x[None], nr)

    sync = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
                                 check_vma=False))
    p = jax.tree.map(jnp.asarray, params0)
    st = jadamw.adamw_init(p, opt)
    res = jax.tree.map(lambda x: jnp.zeros((2,) + x.shape, jnp.float32), p)
    stream, losses, half = JSyntheticLM(data), [], BATCH // 2
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in stream.batch(i).items()}
        pods = [vg(p, {k: v[j * half:(j + 1) * half] for k, v in b.items()}) for j in range(2)]
        synced, res = sync(jax.tree.map(lambda *xs: jnp.stack(xs), *[g for _, g in pods]), res)
        p, st, _ = jadamw.adamw_update(p, jax.tree.map(lambda x: x[0], synced), st, opt)
        losses.append(float(sum(lp for lp, _ in pods) / 2))
    out["geococo/losses"] = np.array(losses)
    out.update({f"geococo/params/{k}": v for k, v in flat(p).items()})
    np.savez(os.path.join(out_dir, "runs.npz"), **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, __file__, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return str(out_dir / "init.npz"), dict(np.load(out_dir / "runs.npz"))


def sub(runs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs.items() if k.startswith(prefix)}


def check_params(got: dict, want_flat: dict, what: str):
    want = params_from_jax(get_smoke_config(ARCH), want_flat, device="cpu")
    bound = 2 * sum(float(adamw.cosine_lr(adamw.AdamWConfig(**opt_cfg()), torch.tensor(i)))
                    for i in range(1, STEPS + 1))
    for key, w in leaf_paths(want):
        diff = np.abs(got[key] - w.numpy())
        assert diff.max() <= bound + TOL["param"], f"{what} {key}"
        assert (diff > TOL["param"]).mean() <= TOL["flip_share"], f"{what} {key}"


# ---------------------------------------------------------------------------
# two pods: against the reference, geococo at density 1.0, resume, rollback
# ---------------------------------------------------------------------------


def from_reference_rank(rank: int, init_path: str) -> dict:
    cfg = get_smoke_config(ARCH)
    mesh, _ = make_mesh((2, 1, 1), device="cpu")
    out = {}
    for name, kw in (("hier", dict(sync="hier")), ("geococo", dict(sync="geococo")),
                     ("geococo-1.0", dict(sync="geococo", density=1.0))):
        tr = make_trainer(mesh, compute=torch.float32, **kw)
        params = params_from_jax(cfg, dict(np.load(init_path)), device="cpu")
        tr.state.update(params=params, opt=adamw.adamw_init(params, tr.tcfg.optim))
        hist = tr.run()
        out[name] = {"history": shared(hist), "params": params_of(tr)}
    return out


@pytest.fixture(scope="module")
def from_reference(reference):
    return run_local_ranks(from_reference_rank, 2, (reference[0],), timeout=RANK_TIMEOUT)


def test_hier_matches_the_reference_trainer(from_reference, reference):
    _, runs = reference
    for pod in from_reference:
        got = pod["hier"]["history"]
        np.testing.assert_allclose([r[1] for r in got], runs["hier/losses"], rtol=TOL["loss"])
        np.testing.assert_allclose([r[2] for r in got], runs["hier/grad_norms"], rtol=TOL["loss"])
        check_params(pod["hier"]["params"], sub(runs, "hier/params/"), "hier vs Trainer")
    one, two = (pod["hier"] for pod in from_reference)
    assert one["history"] == two["history"]
    assert all(v.tobytes() == two["params"][k].tobytes() for k, v in one["params"].items())


def test_geococo_matches_the_reference_composition(from_reference, reference):
    _, runs = reference
    got = from_reference[0]["geococo"]
    np.testing.assert_allclose([r[1] for r in got["history"]], runs["geococo/losses"],
                               rtol=TOL["loss"])
    check_params(got["params"], sub(runs, "geococo/params/"), "geococo vs composition")
    assert all(r[SHARED.index("sparse_values")] > 0 for r in got["history"])


def test_geococo_at_density_one_is_hier(from_reference):
    for pod in from_reference:
        hier, dense = pod["hier"], pod["geococo-1.0"]
        assert [r[1:3] for r in dense["history"]] == [r[1:3] for r in hier["history"]]
        for key, value in hier["params"].items():
            assert value.tobytes() == dense["params"][key].tobytes(), key


def pods_rank(rank: int, root: str) -> dict:
    mesh, _ = make_mesh((2, 1, 1), device="cpu")
    out = {}
    # a restart: 8 steps straight through; 4, then a fresh trainer resumed to 8
    whole = make_trainer(mesh, ckpt_dir=os.path.join(root, "whole")).run()
    make_trainer(mesh, steps=4, ckpt_dir=os.path.join(root, "cut")).run()
    resumed = make_trainer(mesh, ckpt_dir=os.path.join(root, "cut"))
    out["resumed_at"] = resumed.step_idx if resumed.maybe_resume() else None
    out["whole"], out["cut"] = shared(whole), shared(resumed.run())
    # a fault before step 6 on every rank, saves asynchronous: back to step 4
    fired = []

    def injector(step: int) -> None:
        if step == 5 and not fired:
            fired.append(step)
            raise FaultInjected("simulated device loss")

    tr = make_trainer(mesh, ckpt_dir=os.path.join(root, "fault"), ckpt_async=True)
    out["fault"] = shared(tr.run(fault_injector=injector))
    out["fault_step_idx"], out["fired"] = tr.step_idx, fired
    out["fault_ckpts"] = available_steps(os.path.join(root, "fault"))
    return out


@pytest.fixture(scope="module")
def two_pods(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pods"))
    return run_local_ranks(pods_rank, 2, (root,), timeout=RANK_TIMEOUT)


def test_restart_resumes_bit_for_bit(two_pods):
    for pod in two_pods:
        assert pod["resumed_at"] == 4
        assert [r[0] for r in pod["cut"]] == [5, 6, 7, 8]
        assert pod["cut"] == pod["whole"][4:]
    assert two_pods[0]["whole"] == two_pods[1]["whole"]


def test_fault_rolls_back_and_replays(two_pods):
    for pod in two_pods:
        assert pod["fired"] == [5] and pod["fault_step_idx"] == STEPS
        assert [r[0] for r in pod["fault"]] == [1, 2, 3, 4, 5, 5, 6, 7, 8]
        assert pod["fault"][4] == pod["fault"][5]          # the replay, bit for bit
        assert pod["fault"][5:] == pod["whole"][4:]        # and the run after it
        assert pod["fault"][-1][1] < pod["fault"][0][1]
        assert pod["fault_ckpts"] == [4, 8]


# ---------------------------------------------------------------------------
# four ranks: the loss falls with checkpoints at [4, 8]; elastic reshard
# ---------------------------------------------------------------------------


def sharded_rank(rank: int, root: str, shape: tuple) -> dict:
    mesh, _ = make_mesh(shape, device="cpu")
    if shape == (2, 2, 1):
        hist = make_trainer(mesh, ckpt_dir=os.path.join(root, "full")).run()
        make_trainer(mesh, steps=4, ckpt_dir=os.path.join(root, "elastic")).run()
        return {"history": shared(hist), "ckpts": available_steps(os.path.join(root, "full"))}
    tr = make_trainer(mesh, steps=6, ckpt_dir=os.path.join(root, "elastic"))
    resumed = tr.maybe_resume()
    return {"resumed_at": tr.step_idx if resumed else None, "history": shared(tr.run()),
            "step_idx": tr.step_idx}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded"))
    return {shape: run_local_ranks(sharded_rank, 4, (root, shape), timeout=RANK_TIMEOUT)
            for shape in ((2, 2, 1), (1, 2, 2))}


def test_loss_decreases_and_checkpoints(sharded):
    ranks = sharded[(2, 2, 1)]
    hist = ranks[0]["history"]
    assert len(hist) == STEPS and hist[-1][1] < hist[0][1]
    assert all(r["ckpts"] == [4, 8] for r in ranks)
    assert all(r["history"] == hist for r in ranks)


def test_elastic_reshard_across_meshes(sharded):
    ranks = sharded[(1, 2, 2)]
    for got in ranks:
        assert got["resumed_at"] == 4 and got["step_idx"] == 6
        assert [r[0] for r in got["history"]] == [5, 6]
        assert all(np.isfinite(r[1]) for r in got["history"])
    assert all(r["history"] == ranks[0]["history"] for r in ranks)


# ---------------------------------------------------------------------------
# four pods under the control plane
# ---------------------------------------------------------------------------


def control_rank(rank: int) -> dict:
    mesh, _ = make_mesh((4, 1, 1), device="cpu")
    plane = ControlPlane(TraceView(SQUARE_FRAMES, loop=False), replan_sustain=2,
                         degrade_sustain=2)
    tr = make_trainer(mesh, sync="geococo", control=plane)
    seen = []

    def watch(step: int) -> None:      # before each step: the ring it runs on
        seen.append((step, tr.tcfg.sync.ring_order, len(tr.network_events)))

    hist = tr.run(fault_injector=watch)
    out = {"history": shared(hist), "seen": seen, "sync_rebuilds": tr.sync_rebuilds,
           "events": [(type(e).__name__, e.round, e.reason, getattr(e, "order", None))
                      for e in tr.network_events],
           "ring": tr.tcfg.sync.ring_order, "params": params_of(tr),
           "plane_rounds": plane.round}
    # a straggler trip on every observed step (threshold 0, sustain 1)
    plane = ControlPlane(TraceView([SQUARE] * 12, loop=False), replan_sustain=3)
    tr = make_trainer(mesh, steps=4, sync="geococo", control=plane)
    tr.monitor.threshold, tr.monitor.sustain = 0.0, 1
    before = []
    tr.run(fault_injector=lambda step: before.append(
        (step, [e.reason for e in tr.network_events if isinstance(e, PlanChanged)])))
    out["straggler"] = {"before": before, "trips": tr.monitor.trips}
    return out


@pytest.fixture(scope="module")
def four_pods():
    return run_local_ranks(control_rank, 4, timeout=RANK_TIMEOUT)


def replayed_alone() -> list:
    """The reference's ControlPlane on the same frames, one round a step."""
    plane = rctl.ControlPlane(rctl.TraceView(SQUARE_FRAMES, loop=False), replan_sustain=2,
                              degrade_sustain=2)
    for _ in range(STEPS):
        plane.step()
    return plane.events


def test_relay_order_follows_the_reference_plane(four_pods):
    want = [(type(e).__name__, e.round, e.reason, getattr(e, "order", None))
            for e in replayed_alone()]
    orders = [(e[1], e[3]) for e in want if e[0] == "RelayOrderChanged"]
    assert [o for _, o in orders] == [(0, 1, 2, 3), rctl.relay_ring_order(SPIKED)]
    assert rctl.relay_ring_order(SPIKED) == (0, 2, 1, 3)
    for got in four_pods:
        assert got["events"] == want
        assert got["sync_rebuilds"] >= 2
        assert got["ring"] == (0, 2, 1, 3)
        # the event of round r applies from step r + 1 on
        for step, ring, _ in got["seen"]:
            applied = [o for r, o in orders if r <= step]
            assert ring == (applied[-1] if applied else None), step
    assert four_pods[0]["plane_rounds"] == STEPS


def test_four_pods_agree(four_pods):
    first = four_pods[0]
    assert len(first["history"]) == STEPS and first["history"][-1][1] < first["history"][0][1]
    for got in four_pods[1:]:
        assert got["history"] == first["history"]
        assert got["seen"] == first["seen"]
        for key, value in first["params"].items():
            assert value.tobytes() == got["params"][key].tobytes(), key


def test_straggler_trip_replans_before_the_next_step(four_pods):
    for got in four_pods:
        before = dict(got["straggler"]["before"])
        assert got["straggler"]["trips"] == 3            # steps 2, 3, 4
        assert before[1] == ["initial"]                  # the plane's first round
        assert before[2] == ["initial", "straggler@step2"]
        assert before[3][-1] == "straggler@step3"


# ---------------------------------------------------------------------------
# one process: the straggler hook and the monitor
# ---------------------------------------------------------------------------


def test_straggler_hook_fires_and_is_deprecated(tmp_path):
    events = []
    with pytest.warns(DeprecationWarning, match="on_straggler"):
        tr = Trainer(get_smoke_config(ARCH), None, TrainConfig(), TrainerConfig(steps=4),
                     data_cfg(), on_straggler=lambda t: events.append(t.step_idx),
                     device="cpu")
    tr.monitor = StragglerMonitor(threshold=0.0, sustain=1)  # trip every step
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        tr.run()
    assert events == [2, 3, 4]


@pytest.mark.parametrize("dts", [
    [1.0, 5.0, 5.0, 1.0, 10.0, 10.0, 10.0],
    [0.5, 0.52, 0.49, 0.9, 0.95, 1.1, 1.3, 0.4, 2.0, 2.5, 3.0, 3.5, 4.0],
    list(np.random.default_rng(0).lognormal(0.0, 0.6, size=64)),
], ids=["reference-test", "drift", "lognormal"])
@pytest.mark.parametrize("threshold,sustain", [(1.5, 3), (1.2, 1), (0.0, 1)])
def test_straggler_monitor_matches_the_reference(dts, threshold, sustain):
    from repro.train.trainer import StragglerMonitor as RStragglerMonitor

    got, want = StragglerMonitor(threshold, sustain), RStragglerMonitor(threshold, sustain)
    assert [got.observe(float(d)) for d in dts] == [want.observe(float(d)) for d in dts]
    assert (got.trips, got.ewma) == (want.trips, want.ewma)


def test_trainer_config_defaults_are_the_reference_ones():
    import dataclasses

    from repro.train.trainer import TrainerConfig as RTrainerConfig

    assert [(f.name, f.default) for f in dataclasses.fields(TrainerConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(RTrainerConfig)]


def test_default_data_and_log_lines():
    """Without ``data_cfg`` the trainer draws the reference's default
    stream (seq 128, batch 8, the run's seed); rank 0 prints a line every
    ``log_every`` steps and at the last."""
    cfg = get_smoke_config(ARCH)
    tr = Trainer(cfg, None, TrainConfig(), TrainerConfig(steps=3, log_every=2, seed=3),
                 device="cpu")
    assert tr.data_cfg == DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                                     seed=3)
    tr.data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2, seed=3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = tr.run()
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert [line.split()[1] for line in out.getvalue().splitlines()] == ["2", "3"]


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
