"""Auto-generated single-rule mutants for the schedule verifier; the
port's own copy of ``repro.analysis.mutate`` (host code: with the same
``np.random.Generator`` a mutant equals the reference's, transfer for
transfer).

One mutation a verifier rule, as a *generator*: given any valid
schedule, ``mutate_schedule(sched, rule, rng)`` derives a fresh mutant
breaking exactly that rule — so the catch-rate gate runs over every
builder x topology base instead of one hand-picked schedule each, and the
model checker (:mod:`repro_torch.analysis.modelcheck`) can sample mutants from
its exhaustively enumerated DAG space to certify the *invalid* side of
verifier completeness.

Design notes:

* Mutants are built by cloning the schedule **without** re-running
  ``TransmissionSchedule.__post_init__`` (which would reject the very
  defects we are seeding, exactly like the constructor rejects forward
  deps) — the clone is a shallow copy with its own transfer list, so the
  base schedule is never touched (the 0-false-positive half of the gate
  re-verifies it after every mutation).
* A mutator returns ``None`` when the rule is not expressible on the base
  (e.g. ``clock-chain`` needs a stitched schedule with >= 2 clocks,
  ``phase-monotone`` needs an explicit ``phase_of``).  The test sweep
  asserts every rule is applicable *somewhere* in its base set.
* A mutant may trip secondary rules too (a back edge is both a ``cycle``
  and a ``topo-order`` defect); the contract is only that the *target*
  rule is among those reported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["MUTATORS", "mutate_schedule"]


def _clone(sched):
    """Copy a TransmissionSchedule without constructor validation."""
    out = type(sched).__new__(type(sched))
    out.transfers = list(sched.transfers)
    out.label = sched.label
    out.phase_of = None if sched.phase_of is None else list(sched.phase_of)
    return out


def _wire_indices(sched) -> list[int]:
    return [i for i, t in enumerate(sched.transfers) if t.src != t.dst]


def _pick(rng, seq):
    return seq[int(rng.integers(0, len(seq)))]


# -- one mutator per verifier rule -------------------------------------------


def _mut_cycle(sched, rng, n_nodes=None):
    m = len(sched.transfers)
    if m < 2:
        return None
    out = _clone(sched)
    i = int(rng.integers(0, m - 1))
    j = int(rng.integers(i + 1, m))
    ti, tj = out.transfers[i], out.transfers[j]
    out.transfers[i] = dataclasses.replace(ti, deps=ti.deps + (j,))
    out.transfers[j] = dataclasses.replace(tj, deps=tj.deps + (i,))
    return out


def _mut_dep_bounds(sched, rng, n_nodes=None):
    m = len(sched.transfers)
    if m == 0:
        return None
    out = _clone(sched)
    i = int(rng.integers(0, m))
    bad = m + int(rng.integers(0, 7)) if rng.integers(0, 2) else -1
    t = out.transfers[i]
    out.transfers[i] = dataclasses.replace(t, deps=t.deps + (bad,))
    return out


def _mut_topo_order(sched, rng, n_nodes=None):
    # a forward reference that is NOT part of a cycle: i depends on a later
    # j, j keeps its deps — the edge set stays acyclic, so only the
    # topological-order rule (and possibly phase rules) fires
    m = len(sched.transfers)
    if m < 2:
        return None
    out = _clone(sched)
    i = int(rng.integers(0, m - 1))
    j = int(rng.integers(i + 1, m))
    t = out.transfers[i]
    out.transfers[i] = dataclasses.replace(t, deps=t.deps + (j,))
    return out


def _mut_phase_shape(sched, rng, n_nodes=None):
    if sched.phase_of is None or len(sched.phase_of) == 0:
        return None
    out = _clone(sched)
    if rng.integers(0, 2) and len(out.phase_of) > 1:
        out.phase_of = out.phase_of[:-1]          # length mismatch
    else:
        out.phase_of[int(rng.integers(0, len(out.phase_of)))] = -1
    return out


def _mut_phase_monotone(sched, rng, n_nodes=None):
    if sched.phase_of is None:
        return None
    m = len(sched.transfers)
    cands = [
        (i, d)
        for i, t in enumerate(sched.transfers)
        for d in t.deps
        if 0 <= d < m and sched.phase_of[d] < sched.phase_of[i]
    ]
    if not cands:
        return None
    i, d = _pick(rng, cands)
    out = _clone(sched)
    out.phase_of[d] = out.phase_of[i]             # collapse the strict gap
    return out


def _mut_negative_payload(sched, rng, n_nodes=None):
    m = len(sched.transfers)
    if m == 0:
        return None
    out = _clone(sched)
    i = int(rng.integers(0, m))
    t = out.transfers[i]
    variant = int(rng.integers(0, 3))
    if variant == 0:
        out.transfers[i] = dataclasses.replace(t, nbytes=-1.0)
    elif variant == 1:
        out.transfers[i] = dataclasses.replace(t, nbytes=float("inf"))
    else:
        out.transfers[i] = dataclasses.replace(t, compute_ms=-0.5)
    return out


def _mut_node_bounds(sched, rng, n_nodes=None):
    if n_nodes is None:
        return None
    m = len(sched.transfers)
    if m == 0:
        return None
    out = _clone(sched)
    wires = _wire_indices(sched)
    if wires and rng.integers(0, 2):
        # relay via one of its own endpoints
        i = _pick(rng, wires)
        t = out.transfers[i]
        out.transfers[i] = dataclasses.replace(t, via=t.src)
    else:
        i = int(rng.integers(0, m))
        t = out.transfers[i]
        out.transfers[i] = dataclasses.replace(
            t, dst=n_nodes + int(rng.integers(0, 3))
        )
    return out


def _mut_local_stage(sched, rng, n_nodes=None):
    cands = [i for i, t in enumerate(sched.transfers)
             if t.src != t.dst and t.nbytes > 0.0]
    if not cands:
        return None
    # fold a payload-carrying wire transfer onto its own source: the bytes
    # would silently vanish from the wire and every byte counter
    i = _pick(rng, cands)
    out = _clone(sched)
    t = out.transfers[i]
    out.transfers[i] = dataclasses.replace(t, dst=t.src, via=-1)
    return out


def _mut_epoch_monotone(sched, rng, n_nodes=None):
    m = len(sched.transfers)
    cands = [
        (i, d)
        for i, t in enumerate(sched.transfers)
        for d in t.deps
        if 0 <= d < m
    ]
    if not cands:
        return None
    i, d = _pick(rng, cands)
    out = _clone(sched)
    td = out.transfers[d]
    out.transfers[d] = dataclasses.replace(
        td, epoch=out.transfers[i].epoch + 1
    )
    return out


def _mut_epoch_contiguity(sched, rng, n_nodes=None):
    m = len(sched.transfers)
    if m == 0:
        return None
    out = _clone(sched)
    i = int(rng.integers(0, m))
    t = out.transfers[i]
    if rng.integers(0, 2):
        out.transfers[i] = dataclasses.replace(t, epoch=-2)
    else:
        max_epoch = max(tr.epoch for tr in sched.transfers)
        out.transfers[i] = dataclasses.replace(t, epoch=max_epoch + 2)
    return out


def _mut_clock_chain(sched, rng, n_nodes=None):
    clocks = [i for i, t in enumerate(sched.transfers) if t.tag == "clock"]
    if len(clocks) < 2:
        return None
    out = _clone(sched)
    pos = int(rng.integers(1, len(clocks)))
    i = clocks[pos]
    t = out.transfers[i]
    if rng.integers(0, 2):
        # unhook from the previous clock
        prev = clocks[pos - 1]
        out.transfers[i] = dataclasses.replace(
            t, deps=tuple(d for d in t.deps if d != prev)
        )
    else:
        # duplicate the previous clock's epoch (must strictly increase)
        out.transfers[i] = dataclasses.replace(
            t, epoch=sched.transfers[clocks[pos - 1]].epoch
        )
    return out


MUTATORS: dict[str, Callable] = {
    "cycle": _mut_cycle,
    "dep-bounds": _mut_dep_bounds,
    "topo-order": _mut_topo_order,
    "phase-shape": _mut_phase_shape,
    "phase-monotone": _mut_phase_monotone,
    "negative-payload": _mut_negative_payload,
    "node-bounds": _mut_node_bounds,
    "local-stage": _mut_local_stage,
    "epoch-monotone": _mut_epoch_monotone,
    "epoch-contiguity": _mut_epoch_contiguity,
    "clock-chain": _mut_clock_chain,
}


def mutate_schedule(sched, rule: str, rng, *, n_nodes: Optional[int] = None):
    """Derive a mutant of ``sched`` breaking ``rule`` (a ``verify_schedule``
    rule slug), or ``None`` when the rule is not expressible on this base.
    ``sched`` itself is never modified."""
    try:
        fn = MUTATORS[rule]
    except KeyError:
        raise ValueError(
            f"unknown rule {rule!r}; expected one of {sorted(MUTATORS)}"
        ) from None
    return fn(sched, rng, n_nodes=n_nodes)
