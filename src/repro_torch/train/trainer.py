"""Fault-tolerant training loop (counterpart of ``repro.train.trainer``).

Composes the train step (``train.train_step.build_train_step``) with:

* periodic and asynchronous checkpoints (restart-safe; a checkpoint written
  on one mesh restores on another, :class:`StatePlacement`),
* **network-adaptive synchronization**: the trainer subscribes to a
  :class:`~repro_torch.control.plane.ControlPlane`.  On
  :class:`~repro_torch.control.events.RelayOrderChanged` (or any event the
  configured ``device_sync`` strategy declares a reaction to in the
  registry) it rebuilds the step with the new ``relay_psum`` ring order /
  :class:`SyncConfig`.  Sustained straggler trips feed
  ``ControlPlane.force_replan``, the immediate, event-driven replan path,
* **failure handling**: a step that raises :class:`FaultInjected` rolls
  back to the last checkpoint and replays; replaying a step from the same
  checkpoint gives the same state.

The reference has one controller; the port runs one process a rank
(``launch.mesh``), so four rules keep the ranks in lockstep:

* **One plane decides.**  Only world rank 0 pumps its plane and forces
  replans.  At each step boundary it broadcasts the events emitted since
  the last one to every rank (``broadcast_object_list`` over the world's
  gloo group), and every rank applies them through
  :meth:`Trainer._on_network_event` in that order: ``tcfg.sync``,
  ``network_events`` and ``sync_rebuilds`` agree on every rank, and no step
  starts with two ring orders.
* **The straggler is the step's.**  The monitor observes the largest step
  time over the ranks (one all-reduce ``MAX``); the records keep each
  rank's own ``dt``.
* **A rebuild reuses the mesh's groups.**  It drops the old step, and with
  it the pinned staging buffers of its groups, before the next step builds
  the new one; it creates no process group.
* **A rollback is collective.**  A fault is injected on every rank at the
  same step; :meth:`Trainer.maybe_resume` joins this rank's pending save and
  waits for the other ranks' at a barrier before it picks the step to
  restore (agreed by ``MIN`` over the ranks), so it never reads a
  checkpoint still being written.

The pre-control ``on_straggler`` callback is deprecated, as in the
reference: pass ``control=`` a ``ControlPlane`` instead.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..checkpoint.checkpoint import available_steps, gc_incomplete, restore, save_async
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, make_batch
from ..device import resolve_device, synchronize
from ..dist.grouping import grouped_specs, leaf_specs, zero_residuals
from ..dist.inpod import InPodGroup
from ..dist.sharding import Spec, local_shard
from ..models.model import cast_params_, init_params
from ..optim.adamw import adamw_init
from ..tree import map_paths
from .train_step import TrainConfig, build_train_step

__all__ = ["TrainerConfig", "Trainer", "StragglerMonitor", "StatePlacement", "FaultInjected"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    seed: int = 0
    straggler_threshold: float = 1.5   # step time vs EWMA
    straggler_sustain: int = 3
    control_every: int = 1             # pump the ControlPlane every N steps


class StragglerMonitor:
    """EWMA step-time tracker with sustained-deviation detection —
    the same damping policy as the WAN replanner (Sec 4.2)."""

    def __init__(self, threshold: float = 1.5, sustain: int = 3, alpha: float = 0.2):
        self.threshold = threshold
        self.sustain = sustain
        self.alpha = alpha
        self.ewma: float | None = None
        self._over = 0
        self.trips = 0

    def observe(self, dt: float) -> bool:
        """Feed one step time; returns True when mitigation should trigger."""
        if self.ewma is None:
            self.ewma = dt
            return False
        trigger = False
        if dt > self.threshold * self.ewma:
            self._over += 1
            if self._over >= self.sustain:
                trigger = True
                self.trips += 1
                self._over = 0
        else:
            self._over = 0
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return trigger


# ---------------------------------------------------------------------------
# where the state lives
# ---------------------------------------------------------------------------


def _multi(mesh) -> bool:
    """Whether ``mesh`` holds more than one rank."""
    return mesh is not None and mesh.size > 1


def _resume_step(ckpt_dirs: list[str], mesh) -> int | None:
    """The latest step complete in every directory this rank reads, agreed
    over the ranks (the least of their latest)."""
    common = set.intersection(*(set(available_steps(d)) for d in ckpt_dirs))
    last = max(common, default=-1)
    if _multi(mesh):
        t = torch.tensor([last])
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        last = int(t)
    return None if last < 0 else last


def _state_specs(cfg: ModelConfig, mesh, strategy: str) -> dict[str, Spec]:
    """The spec of every tensor leaf of the trainer's state, by its key."""
    specs = {f"{part}/{key}": spec for part in ("params", "opt/m", "opt/v")
             for key, spec in leaf_specs(cfg, mesh.shape, strategy).items()}
    specs["opt/step"] = ()
    specs.update({f"residuals/{key}": spec
                  for key, spec in grouped_specs(cfg, mesh.shape, strategy).items()})
    return specs


class StatePlacement:
    """Where this rank's share of the trainer's state lives, and how it is
    drawn, saved and restored.

    The state is the reference trainer's tree {"params", "opt", "step"},
    with "residuals" (f32, in the reference's grouped layout) when
    ``tcfg.sync`` carries them.  On a mesh whose pods hold several ranks
    each rank keeps its blocks of every leaf (``dist.sharding``); a
    checkpoint holds every leaf whole, in the layout of one process: pod
    0's first rank (``data`` 0, ``model`` 0) writes {"params", "opt",
    "step"} and pod 0's residuals to ``ckpt_dir``, the first rank of pod
    p > 0 its pod's {"residuals", "step"} to ``ckpt_dir/pod{p}``, each
    gathered over its pod's ranks.  So a checkpoint written on one mesh is
    read on another."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device: torch.device, mesh=None):
        self.cfg, self.tcfg, self.device, self.mesh = cfg, tcfg, device, mesh
        self.pod = 0 if mesh is None else mesh.coords["pod"]
        self.inpod = InPodGroup(mesh) if _multi(mesh) else None
        self.split = self.inpod is not None and self.inpod.size > 1
        self.specs = _state_specs(cfg, mesh, tcfg.sync.strategy) if self.split else {}
        # the rank that writes this pod's checkpoint
        self.writer = self.inpod is None or self.inpod.counts_once(())

    def own_dir(self, ckpt_dir: str) -> str:
        """The directory this rank's pod writes and reads its residuals in."""
        return ckpt_dir if self.pod == 0 else os.path.join(ckpt_dir, f"pod{self.pod}")

    def place(self, tree, prefix: str):
        """``tree``'s whole leaves (keys under ``prefix``) as this rank's
        blocks on its device."""
        if not self.split:
            return map_paths(tree, lambda key, leaf: leaf.to(self.device), prefix)
        mesh = self.mesh
        return map_paths(tree, lambda key, leaf: local_shard(leaf, self.specs[key], mesh.coords,
                                                              mesh.shape).to(self.device), prefix)

    def initial(self, seed: int) -> dict:
        """The state at step 0: parameters drawn whole on the device from
        ``seed`` (the same on every rank), this rank's blocks kept."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.place(cast_params_(init_params(self.cfg, gen, self.device),
                                         self.tcfg.param_dtype), "params")
        state = {"params": params, "opt": adamw_init(params, self.tcfg.optim), "step": 0}
        if self.tcfg.sync.needs_residuals:
            state["residuals"] = zero_residuals(self.cfg, self.device,
                                                self.mesh.shape if self.split else None,
                                                self.tcfg.sync.strategy)
        return state

    def latest(self, ckpt_dir: str) -> int | None:
        """The latest step complete in every directory this rank reads,
        agreed over the ranks, after this pod's writer removed what an
        interrupted save left."""
        if self.writer:
            gc_incomplete(self.own_dir(ckpt_dir))
        return _resume_step([ckpt_dir, self.own_dir(ckpt_dir)], self.mesh)

    def restore(self, ckpt_dir: str, step: int) -> dict:
        """Checkpoint ``step`` as this rank's state."""
        meta = init_params(self.cfg, None, "meta")
        like = {"params": meta, "opt": adamw_init(meta, self.tcfg.optim), "step": 0}
        residuals = self.tcfg.sync.needs_residuals
        if residuals and self.pod == 0:
            like["residuals"] = zero_residuals(self.cfg, "meta")
        read = restore(ckpt_dir, step, like, device="cpu")
        if residuals and self.pod > 0:
            read.update(restore(self.own_dir(ckpt_dir), step,
                                {"residuals": zero_residuals(self.cfg, "meta")}, device="cpu"))
        return {"step": read.pop("step"), **{k: self.place(v, k) for k, v in read.items()}}

    def save_async(self, ckpt_dir: str, state: dict):
        """Write ``state``'s checkpoint (every rank calls this; each pod's
        writer writes).  Returns the writer thread, or None on the others."""
        mine = state if self.pod == 0 else {"residuals": state.get("residuals"),
                                            "step": state["step"]}
        if self.split:
            mine = map_paths(mine, lambda key, leaf: (
                self.inpod.gather_to_first(leaf, self.specs[key])
                if isinstance(leaf, torch.Tensor) else leaf))
        if not self.writer:
            return None
        return save_async(self.own_dir(ckpt_dir), state["step"], mine)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class Trainer:
    """``Trainer(model_cfg, mesh, tcfg, run_cfg, data_cfg, *, control=None,
    on_straggler=None, device=None)``: ``mesh`` is a ``launch.mesh.Mesh``
    (one process a rank, every rank builds its own ``Trainer`` with the same
    arguments) or ``None`` for one process on one card; ``device`` defaults
    to ``cuda``.  The state is drawn from ``run_cfg.seed`` on construction
    (:class:`StatePlacement`); :meth:`maybe_resume` replaces it with the
    latest checkpoint, :meth:`run` trains to ``run_cfg.steps``.

    ``control`` is a ``repro_torch.control.ControlPlane``.  On world rank 0
    the trainer subscribes to it and, when the plane carries its own
    ``NetworkView``, pumps one control round every ``run_cfg.control_every``
    steps; a plane without a view is subscribe-only.  The other ranks
    receive rank 0's events (the module docstring's first rule), so their
    ``control`` is not read."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        mesh,
        tcfg: TrainConfig,
        run_cfg: TrainerConfig,
        data_cfg: DataConfig | None = None,
        *,
        control: Any | None = None,
        on_straggler: Callable[["Trainer"], None] | None = None,
        device: str | torch.device | None = None,
    ):
        self.model_cfg = model_cfg
        self.mesh = mesh
        self.tcfg = tcfg
        self.run_cfg = run_cfg
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=model_cfg.vocab_size, seq_len=128, global_batch=8, seed=run_cfg.seed,
        )
        self.device = resolve_device(device)
        self.rank = dist.get_rank() if _multi(mesh) else 0
        self.monitor = StragglerMonitor(run_cfg.straggler_threshold, run_cfg.straggler_sustain)
        if on_straggler is not None:
            warnings.warn(
                "Trainer(on_straggler=...) is deprecated; pass control= a "
                "repro_torch.control.ControlPlane and subscribe to its typed "
                "NetworkEvents instead",
                DeprecationWarning,
                stacklevel=2,
            )
        self.on_straggler = on_straggler
        self.control = control
        self.network_events: list[Any] = []
        self.sync_rebuilds = 0
        self._emitted: list[Any] = []      # rank 0: events not yet delivered to the ranks
        if control is not None and self.rank == 0:
            control.subscribe(self._emitted.append)
        self._pending_save = None
        # per checkpoint: its step, the blocking part (gathers, host copy) and
        # the writer thread's file writes (None on ranks that write nothing)
        self.saves: list[dict[str, Any]] = []
        self.history: list[dict[str, float]] = []

        self.placement = StatePlacement(model_cfg, tcfg, self.device, mesh)
        self.state = self.placement.initial(run_cfg.seed)
        self._step_fn = None

    # -- the state ---------------------------------------------------------------

    @property
    def params(self):
        return self.state["params"]

    @property
    def opt_state(self) -> dict:
        return self.state["opt"]

    @property
    def residuals(self) -> dict | None:
        return self.state.get("residuals")

    @property
    def step_idx(self) -> int:
        return self.state["step"]

    # -- control-plane plumbing --------------------------------------------------

    def _deliver_events(self) -> None:
        """The step boundary: rank 0's events since the last boundary, in
        the order they were emitted, applied on every rank."""
        events = self._emitted[:]
        self._emitted.clear()
        if _multi(self.mesh):
            box = [events]
            dist.broadcast_object_list(box, src=0)
            events = box[0]
        for event in events:
            self._on_network_event(event)

    def _on_network_event(self, event) -> None:
        """Apply the configured strategy's declared reaction to a network
        event: an updated ``SyncConfig`` rebuilds the step (new relay ring
        order, ...); ``None`` means no reaction."""
        self.network_events.append(event)
        spec = self.tcfg.sync.spec
        if spec.react is None:
            return
        new_sync = spec.react(self.tcfg.sync, event)
        if new_sync is None or new_sync == self.tcfg.sync:
            return
        n_pods = 1 if self.mesh is None else self.mesh.shape["pod"]
        if new_sync.ring_order is not None and len(new_sync.ring_order) != n_pods:
            return  # event from a view whose nodes are not this mesh's pods
        self.tcfg = dataclasses.replace(self.tcfg, sync=new_sync)
        self._step_fn = None  # the next step builds one on the new ring
        self.sync_rebuilds += 1

    # -- checkpoint plumbing -----------------------------------------------------

    def _join_save(self) -> None:
        if self._pending_save is not None:
            self._pending_save.join()
            self.saves[-1]["write_s"] = self._pending_save.write_s
            self._pending_save = None

    def save_ckpt(self) -> None:
        """Save the state (every rank calls this), asynchronously unless
        ``run_cfg.ckpt_async`` is False; a pending save is joined first."""
        if self.run_cfg.ckpt_dir is None:
            return
        self._join_save()
        synchronize(self.device)
        t0 = time.perf_counter()  # lint: allow[wallclock] the checkpoint's blocking part
        thread = self.placement.save_async(self.run_cfg.ckpt_dir, self.state)
        self.saves.append({"step": self.step_idx, "copy_s": time.perf_counter() - t0,  # lint: allow[wallclock] the checkpoint's blocking part
                           "write_s": None})
        self._pending_save = thread
        if not self.run_cfg.ckpt_async:
            self._join_save()

    def maybe_resume(self) -> bool:
        """Replace the state with the latest checkpoint complete for every
        pod, after every rank's pending save has landed; False when there is
        none (or no ``ckpt_dir``)."""
        if self.run_cfg.ckpt_dir is None:
            return False
        self._join_save()
        if _multi(self.mesh):
            dist.barrier()
        last = self.placement.latest(self.run_cfg.ckpt_dir)
        if last is None:
            return False
        self.state = {}                    # free this rank's state before reading the checkpoint
        self.state = self.placement.restore(self.run_cfg.ckpt_dir, last)
        return True

    # -- main loop ---------------------------------------------------------------

    def _build(self) -> Callable:
        if self._step_fn is None:
            self._step_fn = build_train_step(self.model_cfg, self.tcfg, self.device, self.mesh)
        return self._step_fn

    def _slowest(self, dt: float) -> float:
        """The largest step time over the ranks."""
        if not _multi(self.mesh):
            return dt
        t = torch.tensor([dt], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def run(self, *, fault_injector: Callable[[int], None] | None = None
            ) -> list[dict[str, float]]:
        """Train to ``run_cfg.steps`` and return the history: one record a
        step run, {"step", "loss", "grad_norm", "lr", "dt"} (on a mesh of
        several ranks also the step's parts and wire counts,
        ``build_train_step``), ``dt`` the host time of the step ending in a
        device synchronise, batch generation outside it.  A replayed step
        adds a record again.  ``fault_injector(step_idx)`` is called before
        every step; a :class:`FaultInjected` it (or the step) raises rolls
        back to the last checkpoint, or propagates when there is none."""
        cfg = self.run_cfg
        self._deliver_events()
        while self.step_idx < cfg.steps:
            if _multi(self.mesh):
                batch = make_batch(self.data_cfg, self.step_idx)   # the step moves its rank's rows
            else:
                batch = make_batch(self.data_cfg, self.step_idx, self.device)
            step = self._build()
            synchronize(self.device)
            t0 = time.perf_counter()  # lint: allow[wallclock] measured step time
            try:
                if fault_injector is not None:
                    fault_injector(self.step_idx)
                metrics = step(self.params, self.opt_state, batch, self.residuals)
                rec = {k: float(v) for k, v in metrics.items()}
                synchronize(self.device)
            except _RECOVERABLE:  # device failure: roll back + replay
                if not self.maybe_resume():
                    raise
                self._step_fn = None  # rebuild on (possibly new) topology
                continue
            dt = time.perf_counter() - t0  # lint: allow[wallclock] measured step time
            self.state["step"] += 1
            self.history.append({"step": self.step_idx, **rec, "dt": dt})
            self._after_step(self._slowest(dt))
            if cfg.ckpt_dir is not None and self.step_idx % cfg.ckpt_every == 0:
                self.save_ckpt()
            if cfg.log_every and self.rank == 0 and (self.step_idx % cfg.log_every == 0
                                                     or self.step_idx == cfg.steps):
                print(f"step {self.step_idx:5d}  loss {rec['loss']:.4f}  "
                      f"gnorm {rec['grad_norm']:.3f}  {dt * 1e3:.0f} ms")
        self._join_save()
        if _multi(self.mesh):  # every checkpoint is complete before any rank reads one
            dist.barrier()
        return self.history

    def _after_step(self, dt: float) -> None:
        """The control round, the straggler monitor (fed the slowest rank's
        ``dt``) and the step boundary's event delivery."""
        control = self.control if self.rank == 0 else None
        if (control is not None and control.view is not None
                and self.step_idx % max(1, self.run_cfg.control_every) == 0):
            control.step()  # probe -> damped replan -> events
        if self.monitor.observe(dt):
            if control is not None:
                # sustained step-time degradation: event-driven replan,
                # effective immediately (not at the next observation)
                control.force_replan(reason=f"straggler@step{self.step_idx}")
            if self.on_straggler is not None:
                self.on_straggler(self)
        self._deliver_events()


class FaultInjected(RuntimeError):
    """Raised by test fault injectors to simulate a device failure."""


_RECOVERABLE = (FaultInjected,)
