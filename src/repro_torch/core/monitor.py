"""Real-time latency monitoring (paper Sec 4.2 + Sec 5 "Delay Monitoring"; the
port's own copy of ``repro.core.monitor``).

Two estimation regimes, matching the paper:

* :class:`LatencyMonitor` — full-mesh background probing with EWMA smoothing
  and sustained-deviation detection (the input to the damped Replanner).
  Tracks probe traffic so the "Cost of Delay Monitoring" numbers (Sec 6.4)
  are measurable.
* :class:`VivaldiSystem` — the Vivaldi network-coordinate system used at
  large scale (>= hundreds of nodes) to approximate the N x N matrix from
  O(N * samples) probes, with periodic verification sampling that corrects
  drift (the paper reports 96.4% probe reduction at 1024 nodes with <= 18%
  error).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LatencyMonitor", "VivaldiSystem"]

PROBE_BYTES = 64  # one RTT probe packet


class LatencyMonitor:
    """EWMA latency estimator over full-mesh probes."""

    def __init__(self, n: int, *, alpha: float = 0.3):
        self.n = n
        self.alpha = alpha
        self.est = np.zeros((n, n))
        self._have = np.zeros((n, n), dtype=bool)
        self.probe_count = 0

    def probe_all(self, truth: np.ndarray, rng: np.random.Generator | None = None,
                  noise: float = 0.0) -> np.ndarray:
        """One full-mesh probing round against the true matrix."""
        obs = truth.copy()
        if noise > 0.0 and rng is not None:
            obs = obs * np.exp(rng.normal(0.0, noise, size=obs.shape))
            obs = (obs + obs.T) / 2.0
            np.fill_diagonal(obs, 0.0)
        new = np.where(self._have, (1 - self.alpha) * self.est + self.alpha * obs, obs)
        self.est = new
        self._have[:] = True
        self.probe_count += self.n * (self.n - 1)
        return self.est

    def estimate(self) -> np.ndarray:
        """Current EWMA estimate (no probes) — the same accessor contract as
        :meth:`VivaldiSystem.estimate`, so ``repro_torch.control`` views treat
        both regimes uniformly."""
        return self.est.copy()

    @property
    def probe_bytes(self) -> int:
        return self.probe_count * PROBE_BYTES


@dataclasses.dataclass
class VivaldiConfig:
    dim: int = 3
    ce: float = 0.25      # adaptive timestep constant
    cc: float = 0.25      # error-weight constant
    height: bool = True   # height vector models access-link latency
    init_error: float = 1.0


class VivaldiSystem:
    """Decentralized network coordinates (Dabek et al., SIGCOMM'04)."""

    def __init__(self, n: int, cfg: VivaldiConfig | None = None, seed: int = 0):
        self.n = n
        self.cfg = cfg or VivaldiConfig()
        rng = np.random.default_rng(seed)
        self.x = rng.normal(0.0, 1.0, size=(n, self.cfg.dim))
        self.h = np.full(n, 1.0) if self.cfg.height else np.zeros(n)
        self.err = np.full(n, self.cfg.init_error)
        self.probe_count = 0

    def _dist(self, i: int, j: int) -> float:
        return float(np.linalg.norm(self.x[i] - self.x[j]) + self.h[i] + self.h[j])

    def observe(self, i: int, j: int, rtt: float) -> None:
        """One RTT sample (i probes j)."""
        self.probe_count += 1
        w = self.err[i] / max(self.err[i] + self.err[j], 1e-9)
        d = self._dist(i, j)
        e_sample = abs(d - rtt) / max(rtt, 1e-9)
        self.err[i] = e_sample * self.cfg.cc * w + self.err[i] * (1 - self.cfg.cc * w)
        delta = self.cfg.ce * w
        diff = self.x[i] - self.x[j]
        nrm = np.linalg.norm(diff)
        unit = diff / nrm if nrm > 1e-12 else np.random.default_rng(0).normal(size=diff.shape)
        if nrm <= 1e-12:
            unit = unit / np.linalg.norm(unit)
        self.x[i] += delta * (rtt - d) * unit
        if self.cfg.height:
            self.h[i] = max(1e-3, self.h[i] + delta * (rtt - d) * 0.1)

    def fit(
        self,
        truth: np.ndarray,
        *,
        rounds: int = 100,
        samples_per_node: int = 8,
        rng: np.random.Generator | None = None,
    ) -> np.ndarray:
        """Fit coordinates from sparse random probing; returns estimate."""
        rng = rng or np.random.default_rng(0)
        n = self.n
        for _ in range(rounds):
            for i in range(n):
                peers = rng.choice(n - 1, size=min(samples_per_node, n - 1), replace=False)
                peers = np.where(peers >= i, peers + 1, peers)
                for j in peers:
                    self.observe(i, int(j), float(truth[i, j]))
        return self.estimate()

    def estimate(self) -> np.ndarray:
        d = np.linalg.norm(self.x[:, None, :] - self.x[None, :, :], axis=-1)
        d = d + self.h[:, None] + self.h[None, :]
        np.fill_diagonal(d, 0.0)
        return d

    def seed_from_matrix(self, measured: np.ndarray) -> None:
        """Monitor-seeded warmup: place coordinates at the classical-MDS
        embedding of a directly measured latency matrix.

        Random initial coordinates need many sparse rounds to untangle at
        small n (the poor small-n relay-order agreement in Fig 5); seeding
        from one full-mesh measurement starts the spring system at a
        near-correct configuration, and subsequent sparse rounds only track
        drift.  Probe accounting for the measurement is the caller's job
        (the view knows how many probes it actually paid)."""
        m = np.maximum(np.asarray(measured, dtype=float), 0.0)
        m = (m + m.T) / 2.0
        np.fill_diagonal(m, 0.0)
        n = self.n
        d2 = m ** 2
        j = np.eye(n) - np.ones((n, n)) / n
        b = -0.5 * j @ d2 @ j
        w, v = np.linalg.eigh(b)
        idx = np.argsort(w)[::-1][: self.cfg.dim]
        w = np.clip(w[idx], 0.0, None)
        x = v[:, idx] * np.sqrt(w)[None, :]
        if x.shape[1] < self.cfg.dim:  # degenerate spectra: pad flat dims
            x = np.pad(x, ((0, 0), (0, self.cfg.dim - x.shape[1])))
        self.x = x
        if self.cfg.height:
            # per-node residual the embedding could not place goes into the
            # height (access-link) component, split between endpoints
            est = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
            off = ~np.eye(n, dtype=bool)
            resid = np.where(off, m - est, 0.0)
            self.h = np.maximum(resid.sum(axis=1) / max(n - 1, 1) / 2.0, 1e-3)
        # a seeded node is far more confident than a random one
        self.err = np.full(n, min(self.cfg.init_error, 0.25))

    def verify_and_correct(
        self,
        truth: np.ndarray,
        *,
        sample_frac: float = 0.05,
        rng: np.random.Generator | None = None,
        tol: float = 0.25,
    ) -> np.ndarray:
        """Verification mechanism (Sec 5): sample direct probes, pin entries
        whose predicted/measured deviation exceeds ``tol`` to the measurement."""
        rng = rng or np.random.default_rng(0)
        n = self.n
        est = self.estimate()
        iu = np.triu_indices(n, k=1)
        n_pairs = iu[0].size
        k = max(1, int(sample_frac * n_pairs))
        sel = rng.choice(n_pairs, size=k, replace=False)
        self.probe_count += k
        for s in sel:
            i, j = int(iu[0][s]), int(iu[1][s])
            t = float(truth[i, j])
            if t > 0 and abs(est[i, j] - t) / t > tol:
                est[i, j] = est[j, i] = t
        return est

    def median_rel_error(self, truth: np.ndarray) -> float:
        est = self.estimate()
        n = self.n
        iu = np.triu_indices(n, k=1)
        t = truth[iu]
        e = est[iu]
        mask = t > 0
        return float(np.median(np.abs(e[mask] - t[mask]) / t[mask]))

    @property
    def probe_bytes(self) -> int:
        return self.probe_count * PROBE_BYTES
