"""Deterministic synthetic token pipeline (the port's own copy of
``repro.data.pipeline``).

Batch ``i`` is a pure function of (seed, step), drawn with numpy exactly as
the reference draws it, so both packages see the same tokens: a Zipfian
unigram mixture where the next token copies a recent one with probability
``copy_prob``, which gives the loss a learnable signal.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    theta: float = 1.1          # unigram Zipf exponent
    copy_prob: float = 0.6      # P(next token copies a recent token)
    window: int = 8


class SyntheticLM:
    """Markov-ish synthetic LM stream: next token either copies a recent
    token (learnable structure) or draws from a Zipfian unigram."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.theta)
        p = p / p.sum()
        # Generator.choice(n, size, p=p) draws cdf.searchsorted(random(size),
        # "right") with cdf = p.cumsum() / its last entry, after checking and
        # summing p: O(vocab) a call, 9 s a 4096-token row at a vocabulary of
        # 256,000.  The cdf is built once here and drawn from the same way.
        cdf = p.cumsum()
        self._cdf = cdf / cdf[-1]

    def _unigram(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``rng.choice(vocab_size, size=size, p=p)``, bit for bit."""
        return self._cdf.searchsorted(rng.random(size), side="right")

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """{"tokens", "labels"}: int32 (global_batch, seq_len), labels the
        tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = self._unigram(rng, b)
        for t in range(1, s + 1):
            copy = rng.random(b) < cfg.copy_prob
            back = rng.integers(1, min(t, cfg.window) + 1, size=b)
            copied = toks[np.arange(b), t - back]
            fresh = self._unigram(rng, b)
            toks[:, t] = np.where(copy & (t > 1), copied, fresh)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=8)
def _stream(cfg: DataConfig) -> SyntheticLM:
    return SyntheticLM(cfg)


def make_batch(cfg: DataConfig, step: int,
               device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Batch ``step`` as int32 tensors on ``device`` (one ``SyntheticLM``
    per config, built at its first batch)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in _stream(cfg).batch(step).items()}
