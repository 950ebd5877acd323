"""NetworkView: one estimation interface over every latency source (the
port's own copy of ``repro.control.network``).

The paper's delay-monitoring machinery exists at three fidelity/cost points —
ground-truth traces (simulation), full-mesh EWMA probing
(:class:`~repro_torch.core.monitor.LatencyMonitor`), and Vivaldi network
coordinates (:class:`~repro_torch.core.monitor.VivaldiSystem`, Sec 5's >=
hundreds-of-nodes regime).  :class:`NetworkView` unifies them behind one
``sample()/estimate()`` contract with probe-cost accounting, so the
ControlPlane and the trainer never care which regime produced the matrix:

* ``sample()`` advances time one control round (pays probe traffic) and
  returns a fresh estimate;
* ``estimate()`` returns the current estimate without probing;
* ``probe_bytes`` is the cumulative monitoring cost (Sec 6.4 "Cost of Delay
  Monitoring") — exactly 0 for ground-truth playback.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.latency import LatencyTrace
from ..core.monitor import LatencyMonitor, VivaldiConfig, VivaldiSystem

__all__ = [
    "NetworkView",
    "TraceView",
    "MonitorView",
    "VivaldiView",
    "as_view",
]


@runtime_checkable
class NetworkView(Protocol):
    """Protocol every latency source implements."""

    n: int

    def sample(self) -> np.ndarray:
        """Advance one control round (probing as needed); return the fresh
        (n, n) latency estimate in ms."""
        ...

    def estimate(self) -> np.ndarray:
        """Current (n, n) estimate without new probes."""
        ...

    @property
    def probe_bytes(self) -> int:
        """Cumulative monitoring traffic in bytes."""
        ...


class TraceView:
    """Ground-truth trace playback (the simulator's oracle view).

    Accepts a :class:`~repro_torch.core.latency.LatencyTrace`, a (t, n, n) frame
    stack, a single static (n, n) matrix, or a sequence of matrices.  By
    default the trace loops; with ``loop=False`` the final frame repeats.
    Probe cost is zero: this is the view the WAN simulator already paid for.
    """

    def __init__(
        self,
        frames: LatencyTrace | np.ndarray | Sequence[np.ndarray],
        *,
        loop: bool = True,
    ):
        if isinstance(frames, LatencyTrace):
            stack = np.asarray(frames.frames, dtype=float)
        else:
            stack = np.asarray(frames, dtype=float)
            if stack.ndim == 2:
                stack = stack[None]
        if stack.ndim != 3 or stack.shape[1] != stack.shape[2]:
            raise ValueError(f"need (t, n, n) frames, got {stack.shape}")
        self._frames = stack
        self._loop = loop
        self._idx = -1  # sample() advances to 0 first
        self.n = int(stack.shape[1])

    @property
    def rounds(self) -> int:
        return int(self._frames.shape[0])

    def sample(self) -> np.ndarray:
        if self._loop:
            self._idx = (self._idx + 1) % self.rounds
        else:
            self._idx = min(self._idx + 1, self.rounds - 1)
        return self._frames[self._idx].copy()

    def estimate(self) -> np.ndarray:
        return self._frames[max(self._idx, 0)].copy()

    @property
    def probe_bytes(self) -> int:
        return 0


def as_view(source) -> NetworkView:
    """Coerce a matrix / trace / view into a :class:`NetworkView`."""
    if isinstance(source, (LatencyTrace, np.ndarray, list, tuple)):
        return TraceView(source)
    if isinstance(source, NetworkView):
        return source
    raise TypeError(f"cannot interpret {type(source).__name__} as a NetworkView")


class MonitorView:
    """Full-mesh EWMA probing against a truth source.

    Each ``sample()`` advances the underlying truth one round and runs one
    full-mesh probing round through a :class:`LatencyMonitor` (optionally
    with multiplicative log-normal probe noise).  The estimate is the
    monitor's EWMA matrix — symmetric with zero diagonal whenever the truth
    is; probe traffic is ``n*(n-1)`` probes per round, accounted exactly.
    """

    def __init__(
        self,
        truth,
        *,
        alpha: float = 0.3,
        noise: float = 0.0,
        rng: np.random.Generator | None = None,
        monitor: LatencyMonitor | None = None,
    ):
        self._truth = as_view(truth)
        self.n = self._truth.n
        self.noise = noise
        self._rng = rng or np.random.default_rng(0)
        self.monitor = monitor or LatencyMonitor(self.n, alpha=alpha)
        if self.monitor.n != self.n:
            raise ValueError(
                f"monitor is sized for {self.monitor.n} nodes, truth has {self.n}"
            )

    def sample(self) -> np.ndarray:
        t = self._truth.sample()
        return self.monitor.probe_all(t, self._rng, self.noise).copy()

    def estimate(self) -> np.ndarray:
        return self.monitor.estimate()

    @property
    def probe_bytes(self) -> int:
        return self.monitor.probe_bytes


class VivaldiView:
    """Vivaldi network-coordinate estimation against a truth source.

    The large-scale regime (Sec 5): O(n * samples_per_node) probes per round
    instead of the monitor's O(n^2), with periodic verification sampling
    (every ``verify_every`` rounds) that pins drifting entries back to direct
    measurements.  The estimate is symmetrized with a zero diagonal so
    downstream planners see a valid latency matrix.

    ``warmup_rounds > 0`` enables the monitor-seeded warmup: the first K
    ``sample()`` calls run a full-mesh direct measurement (paying the
    monitor's ``n*(n-1)`` probes), seed the coordinate system from the
    measured matrix (classical-MDS placement,
    :meth:`~repro_torch.core.monitor.VivaldiSystem.seed_from_matrix`) and return
    the direct measurement itself.  This fixes the poor small-n relay-order
    agreement of randomly initialized coordinates: after warmup the spring
    system starts near-correct and the cheap sparse rounds only track drift.
    """

    def __init__(
        self,
        truth,
        *,
        samples_per_node: int = 8,
        verify_every: int = 10,
        verify_frac: float = 0.05,
        verify_tol: float = 0.25,
        warmup_rounds: int = 0,
        cfg: VivaldiConfig | None = None,
        seed: int = 0,
    ):
        self._truth = as_view(truth)
        self.n = self._truth.n
        self.samples_per_node = samples_per_node
        self.verify_every = max(1, verify_every)
        self.verify_frac = verify_frac
        self.verify_tol = verify_tol
        self.warmup_rounds = max(0, warmup_rounds)
        self._rng = np.random.default_rng(seed)
        self.system = VivaldiSystem(self.n, cfg, seed=seed)
        self._round = 0
        self._est = self.system.estimate()

    def _clean(self, est: np.ndarray) -> np.ndarray:
        est = (est + est.T) / 2.0
        np.fill_diagonal(est, 0.0)
        return np.maximum(est, 0.0)

    def sample(self) -> np.ndarray:
        t = self._truth.sample()
        self._round += 1
        if self._round <= self.warmup_rounds:
            # monitor-seeded warmup: full-mesh direct RTTs seed the
            # coordinates and ARE the estimate for this round
            self.system.seed_from_matrix(t)
            self.system.probe_count += self.n * (self.n - 1)
            self._est = self._clean(t.copy())
            return self._est.copy()
        self.system.fit(
            t, rounds=1, samples_per_node=self.samples_per_node, rng=self._rng
        )
        if self._round % self.verify_every == 0:
            est = self.system.verify_and_correct(
                t, sample_frac=self.verify_frac, rng=self._rng,
                tol=self.verify_tol,
            )
        else:
            est = self.system.estimate()
        self._est = self._clean(est)
        return self._est.copy()

    def estimate(self) -> np.ndarray:
        return self._est.copy()

    @property
    def probe_bytes(self) -> int:
        return self.system.probe_bytes
