"""Bounded explicit-state model checker for the engine's soundness theorems;
the port's counterpart of ``repro.analysis.modelcheck``.

The engine's correctness rests on four hand-proved theorems:

1. **Bandwidth admission**: for every dependency-tracked transfer DAG, the
   event engine's makespan never exceeds the barrier engine's phase-sum —
   ``event <= barrier`` on CPU-free DAGs, and the compute-augmented bound
   ``event <= barrier + sum(compute_ms)`` otherwise (the barrier engine
   ignores CPU by definition).
2. **OCC epoch atomicity + abort-set monotonicity**: committed
   transactions of an epoch are equivalent to one atomic snapshot
   application (at most one committed writer per key, committed reads are
   snapshot-exact, and the merged post-state is invariant under *every*
   apply order), and versioning the same transaction stream's reads
   against older snapshot views only ever *adds* aborts (no-reinstatement
   first-writer-wins keeps the write-write set fixed).
3. **Streaming-frontier eviction safety**: under every reachable
   commit-delivery interleaving, view advancement never reads a timeline
   commit row below the eviction frontier, views advance contiguous epoch
   prefixes, and pending update batches are released only below every
   view's frontier.
4. **Serving prefix sufficiency**: the serving sink's merged-prefix
   pointers reproduce the batch full-matrix staleness numbers exactly, for
   every reachable commit interleaving.

This module checks them *exhaustively* over every instance inside small,
documented scopes (bounded model checking), and certifies
``verify_schedule`` completeness on the enumerated DAG space: every
enumerated valid DAG is accepted, every single-rule mutant
(:mod:`repro_torch.analysis.mutate`) and every instance of an exhaustively
enumerated invalid micro-box is rejected.  The same enumeration run with
``admission=False`` yields a corpus of pinned instances with a strict
``event > barrier`` loss, reproducible via :func:`rebuild_counterexample`.

The table theorems (confluence, OCC atomicity, abort monotonicity,
eviction) drive the port's own store, OCC and view code on the device of
the checker's tables (``cuda`` unless the caller names another): each
store is a :class:`~repro_torch.core.crdt.CRDTTable`, every join goes
through ``CRDTTable.top_rows`` / ``join_rows`` and so through the
``crdt_join_rows`` kernel, validation is the port's tensor pass
(``core/occ.py``), and views advance through the engine's own
:func:`~repro_torch.core.replication.advance_views`.  Two tables' states
are compared as tensors (values, lengths, versions, presence), which is
exact and equivalent to equal ``full_state()``, and so to equal digests.
The tables intern ``k{i}`` keys, so the reference's keys ``a``/``b`` and
``x``/``y`` are ``k0``/``k1`` here: the same order, the same instances.
The reference compares its python and numpy validation modes; the port
has one tensor pass, held against the independent rule spec.

What bounded scope does **not** cover: relayed transfers (``via >= 0``),
stochastic loss, n_nodes beyond the grid bounds, interleaved per-txn
serializability (write skew between committed transactions is *permitted*
by epoch OCC and only counted here — the guarantee is snapshot-epoch
atomicity, not strict serializability), and partial per-group view merges.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.modelcheck --tier quick
    PYTHONPATH=src python -m repro_torch.analysis.modelcheck --tier smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import math
import sys
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..core.crdt import CRDTTable, Update, Version, merge_updates
from ..core.occ import EpochBatch, Txn, ValidationResult, txn_updates, validate_epoch_detailed
from ..core.schedule import Transfer, TransmissionSchedule
from ..core.simulator import WANSimulator
from ..core.stream import StreamingTimeline
from ..device import resolve_device
from .mutate import MUTATORS
from .schedule_check import verify_schedule
from .violations import Violation

__all__ = [
    "DagGrid", "Scope", "scope_for",
    "TheoremReport", "ModelCheckReport",
    "check_admission", "check_confluence", "check_occ_atomicity",
    "check_abort_monotonicity", "check_eviction",
    "rebuild_counterexample", "run_selftest", "run_tier",
    "model_checked_count", "reset_model_checked_count", "same_state",
    "main",
]

_REL_TOL = 1e-9
_ABS_TOL = 1e-6

# the checker's tables: value bytes enough for every value it writes
_VALUE_BYTES = 16

# -- provenance counters (mirrors schedule_check.verified_schedule_count) ----

THEOREMS = (
    "admission", "confluence", "occ_atomicity", "abort_monotonicity",
    "eviction_prefix",
)

_CHECKED: dict[str, int] = {t: 0 for t in THEOREMS}


def model_checked_count(theorem: str | None = None) -> int:
    """Violation-free model-checked instances since process start / the
    last reset; the benchmark harness's provenance signal.  With
    ``theorem`` (one of :data:`THEOREMS`) the per-theorem count."""
    if theorem is not None:
        return _CHECKED[theorem]
    return sum(_CHECKED.values())


def reset_model_checked_count() -> None:
    for t in THEOREMS:
        _CHECKED[t] = 0


# -- scopes ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DagGrid:
    """One exhaustively enumerated slice of transfer-DAG space.

    Every combination of endpoint assignment (``endpoint_mode``:
    ``"all"`` = all n^2 ordered pairs including local compute stages,
    ``"wire"`` = off-diagonal only, ``"alternating"`` = the fixed
    0->1/1->0 pattern used to push transfer counts to 6), dependency
    structure (all subsets of earlier transfers, or the explicit
    ``dep_patterns`` slice), payload assignment (full cross product of
    ``payloads`` when ``cross_payloads``, else the cycled pattern) and
    compute pattern is enumerated — the grid is a cartesian box, so
    "exhaustive at scope" is a checkable claim, not a sample.
    """

    n: int
    m_min: int
    m_max: int
    payloads: tuple[float, ...]
    cross_payloads: bool
    compute_patterns: tuple[tuple[float, ...], ...]
    bw_names: tuple[str, ...]
    endpoint_mode: str = "all"
    dep_patterns: tuple[tuple[tuple[int, ...], ...], ...] | None = None
    greedy_arm: bool = False   # also run admission=False for the corpus


@dataclasses.dataclass(frozen=True)
class Scope:
    name: str
    dag_grids: tuple[DagGrid, ...]
    mutant_stride: int          # sample a mutant batch every k-th DAG (0=off)
    micro_completeness: bool    # exhaustive valid/invalid micro-box
    crdt_seqs: int              # versions per key = seqs * nodes
    crdt_nodes: int
    crdt_max_updates: int
    occ_full_max_txns: int      # all 36 txn shapes up to this many txns
    occ_reduced_txns: tuple[int, ...]   # reduced 12-shape space at these T
    mono_chain_len: int         # snapshot-prefix chain length (views = L+1)
    mono_txns: tuple[int, ...]
    evict_grids: tuple[tuple[int, int], ...]    # (n_nodes, epochs)


# the dependency-structure slice of the m=4 corpus grids: one fan-free
# two-root shape (where the worst greedy losses live), its mirror, a chain,
# and a full fan-in
_DEP_SLICE_M4 = (
    ((), (), (1,), (0,)),
    ((), (), (0,), (1,)),
    ((), (0,), (1,), (2,)),
    ((), (), (), (0, 1, 2)),
)

_PAYLOADS = (250_000.0, 25_000.0)
_CPU_BOTH = ((0.0,), (0.0, 0.4))
_CPU_OFF = ((0.0,),)

_SCOPES = {
    # the reference's CI tier: every grid fully enumerated
    "quick": Scope(
        name="quick",
        dag_grids=(
            DagGrid(2, 1, 3, _PAYLOADS, True, _CPU_BOTH,
                    ("uniform", "tri")),
            DagGrid(3, 1, 3, _PAYLOADS, False, _CPU_BOTH,
                    ("uniform", "tri")),
            DagGrid(3, 4, 4, _PAYLOADS, False, _CPU_OFF,
                    ("tri", "rand"), endpoint_mode="wire",
                    dep_patterns=_DEP_SLICE_M4, greedy_arm=True),
        ),
        mutant_stride=29,
        micro_completeness=True,
        crdt_seqs=2, crdt_nodes=2, crdt_max_updates=4,
        occ_full_max_txns=2, occ_reduced_txns=(3,),
        mono_chain_len=2, mono_txns=(1, 2),
        evict_grids=((2, 3), (3, 3), (2, 4)),
    ),
    # documented opt-in: pushes the DAG box to n=4 / m<=4 full deps and
    # m<=6 on the alternating-endpoint slice, full 36-shape OCC at T=3,
    # L=3 monotonicity chains, E=4 interleavings at n=3
    "deep": Scope(
        name="deep",
        dag_grids=(
            DagGrid(2, 1, 4, _PAYLOADS, True, _CPU_BOTH,
                    ("uniform", "tri")),
            DagGrid(3, 1, 3, _PAYLOADS, False, _CPU_BOTH,
                    ("uniform", "tri")),
            DagGrid(4, 1, 3, _PAYLOADS, False, _CPU_OFF,
                    ("uniform", "tri")),
            DagGrid(2, 5, 6, _PAYLOADS, False, _CPU_OFF,
                    ("uniform", "tri"), endpoint_mode="alternating"),
            DagGrid(3, 4, 4, _PAYLOADS, False, _CPU_OFF,
                    ("tri", "rand"), endpoint_mode="wire",
                    greedy_arm=True),
        ),
        mutant_stride=101,
        micro_completeness=True,
        crdt_seqs=2, crdt_nodes=2, crdt_max_updates=5,
        occ_full_max_txns=3, occ_reduced_txns=(4,),
        mono_chain_len=3, mono_txns=(1, 2, 3),
        evict_grids=((2, 3), (3, 3), (2, 4), (3, 4), (2, 5)),
    ),
    # the benchmark-provenance / test scope: same checks, tiny boxes
    "smoke": Scope(
        name="smoke",
        dag_grids=(
            DagGrid(2, 1, 2, _PAYLOADS, True, _CPU_BOTH,
                    ("uniform", "tri")),
            DagGrid(3, 4, 4, _PAYLOADS, False, _CPU_OFF,
                    ("tri",), endpoint_mode="wire",
                    dep_patterns=_DEP_SLICE_M4[:1], greedy_arm=True),
        ),
        mutant_stride=17,
        micro_completeness=False,
        crdt_seqs=2, crdt_nodes=1, crdt_max_updates=3,
        occ_full_max_txns=2, occ_reduced_txns=(),
        mono_chain_len=2, mono_txns=(2,),
        evict_grids=((2, 3),),
    ),
}


def scope_for(tier: str) -> Scope:
    try:
        return _SCOPES[tier]
    except KeyError:
        raise ValueError(
            f"unknown tier {tier!r}; expected one of {sorted(_SCOPES)}"
        ) from None


# -- reports -----------------------------------------------------------------


@dataclasses.dataclass
class TheoremReport:
    name: str
    instances: int
    violations: list[Violation]
    info: dict

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclasses.dataclass
class ModelCheckReport:
    tier: str
    theorems: list[TheoremReport]
    mutants_rejected: dict[str, bool]

    @property
    def ok(self) -> bool:
        return all(t.ok for t in self.theorems) and \
            all(self.mutants_rejected.values())

    def counts(self) -> dict[str, int]:
        return {t.name: t.instances for t in self.theorems}


# -- quantized network settings ----------------------------------------------


def _lat_matrix(n: int) -> np.ndarray:
    lat = np.zeros((n, n))
    for s in range(n):
        for d in range(n):
            if s != d:
                lat[s, d] = 1.0 + 0.25 * ((3 * s + d) % 4)
    return lat


def _bw_matrix(n: int, name: str) -> np.ndarray:
    """Quantized bandwidth settings: ``uniform`` (6 Mbps everywhere),
    ``tri`` (lower-triangle links starved at 4 Mbps vs 40 Mbps — the
    deterministic adversarial pattern), ``rand`` (seeded 4..10 Mbps, the
    adversarial-matrix family)."""
    if name == "uniform":
        return np.full((n, n), 6.0)
    if name == "tri":
        bw = np.full((n, n), 40.0)
        for s in range(n):
            for d in range(n):
                if s > d:
                    bw[s, d] = 4.0
        return bw
    if name == "rand":
        return np.random.default_rng(0).uniform(4.0, 10.0, size=(n, n))
    raise ValueError(f"unknown bandwidth setting {name!r}")


# -- DAG enumeration ---------------------------------------------------------


def _subsets(k: int) -> list[tuple[int, ...]]:
    return [tuple(j for j in range(k) if mask >> j & 1)
            for mask in range(2 ** k)]


def _iter_dags(grid: DagGrid) -> Iterable[tuple[TransmissionSchedule, float]]:
    """Yield ``(schedule, total_compute_ms)`` for every instance in the
    grid's cartesian box.  Every yielded schedule is valid by construction
    (deps precede, local stages carry no payload, epochs all 0)."""
    n = grid.n
    if grid.endpoint_mode == "wire":
        pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
    else:
        pairs = [(s, d) for s in range(n) for d in range(n)]
    for m in range(grid.m_min, grid.m_max + 1):
        if grid.endpoint_mode == "alternating":
            ep_choices: Iterable = [tuple(
                (0, 1) if i % 2 == 0 else (1, 0) for i in range(m)
            )]
        else:
            ep_choices = itertools.product(pairs, repeat=m)
        if grid.dep_patterns is not None:
            dep_choices = [p for p in grid.dep_patterns if len(p) == m]
        else:
            dep_choices = list(
                itertools.product(*[_subsets(i) for i in range(m)])
            )
        if grid.cross_payloads:
            pay_choices = list(itertools.product(grid.payloads, repeat=m))
        else:
            pay_choices = [tuple(
                grid.payloads[i % len(grid.payloads)] for i in range(m)
            )]
        for ep in ep_choices:
            for deps in dep_choices:
                for pays in pay_choices:
                    for cpat in grid.compute_patterns:
                        cpu = 0.0
                        transfers = []
                        for i, ((s, d), dp) in enumerate(zip(ep, deps)):
                            c = cpat[i % len(cpat)]
                            cpu += c
                            transfers.append(Transfer(
                                s, d, pays[i] if s != d else 0.0,
                                deps=dp, compute_ms=c,
                            ))
                        yield (
                            TransmissionSchedule(transfers, label="mc"),
                            cpu,
                        )


def _describe(sched: TransmissionSchedule, n: int, bw_name: str) -> str:
    ts = [(t.src, t.dst, t.nbytes, t.deps, t.compute_ms)
          for t in sched.transfers]
    return f"n={n} bw={bw_name} transfers={ts}"


# -- theorem 1: bandwidth admission + verifier completeness + corpus ---------


def check_admission(
    scope: Scope,
    *,
    simulator_factory: Callable[..., WANSimulator] | None = None,
    mutant_seed: int = 20250807,
    device: str | torch.device | None = None,
) -> TheoremReport:
    """Exhaustively machine-check ``event <= barrier + sum(compute_ms)``
    (and the plain ``event <= barrier`` on CPU-free instances) over every
    DAG in the scope's grids; certify verifier completeness on the same
    enumeration (valid side on every instance, invalid side on sampled
    single-rule mutants plus the exhaustive micro-box); and collect the
    ``admission=False`` greedy counterexample corpus on the adversarial
    grids.  Host code: the WAN simulator and the verifier run on the host
    (``device`` is taken for a uniform signature and not used)."""
    sim_f = simulator_factory or WANSimulator
    violations: list[Violation] = []
    instances = 0
    valid_accepted = 0
    mutants_total = mutants_caught = 0
    corpus: list[dict] = []
    rng = np.random.default_rng(mutant_seed)
    counter = 0
    for grid in scope.dag_grids:
        lat = _lat_matrix(grid.n)
        for bw_name in grid.bw_names:
            bw = _bw_matrix(grid.n, bw_name)
            sim = sim_f(lat, bw)
            greedy = WANSimulator(lat, bw, admission=False) \
                if grid.greedy_arm else None
            for sched, cpu in _iter_dags(grid):
                counter += 1
                instances += 1
                if verify_schedule(sched, n_nodes=grid.n):
                    violations.append(Violation(
                        "verifier-valid-rejected",
                        "enumerated valid DAG rejected by verify_schedule: "
                        + _describe(sched, grid.n, bw_name),
                    ))
                else:
                    valid_accepted += 1
                barrier = sim.barrier_makespan_ms(sched)
                event = sim.run(sched).makespan_ms
                bound = barrier + cpu
                if event > bound * (1.0 + _REL_TOL) + _ABS_TOL:
                    violations.append(Violation(
                        "admission",
                        f"event {event:.6f} > barrier {barrier:.6f} + "
                        f"compute {cpu:.3f}: "
                        + _describe(sched, grid.n, bw_name),
                    ))
                else:
                    _CHECKED["admission"] += 1
                if greedy is not None and cpu == 0.0:
                    g = greedy.run(sched).makespan_ms
                    if g > barrier * (1.0 + _REL_TOL) + _ABS_TOL:
                        corpus.append({
                            "n_nodes": grid.n,
                            "bw": bw_name,
                            "barrier_ms": barrier,
                            "greedy_ms": g,
                            "loss": g / barrier - 1.0,
                            "transfers": [
                                [t.src, t.dst, t.nbytes, list(t.deps)]
                                for t in sched.transfers
                            ],
                        })
                if scope.mutant_stride and counter % scope.mutant_stride == 0:
                    for rule, fn in MUTATORS.items():
                        mut = fn(sched, rng, n_nodes=grid.n)
                        if mut is None:
                            continue
                        mutants_total += 1
                        got = {v.rule for v in
                               verify_schedule(mut, n_nodes=grid.n)}
                        if rule in got:
                            mutants_caught += 1
                        else:
                            violations.append(Violation(
                                "verifier-mutant-missed",
                                f"single-rule mutant for {rule!r} not "
                                "caught on "
                                + _describe(mut, grid.n, bw_name),
                            ))
    info: dict = {
        "valid_accepted": valid_accepted,
        "mutants": f"{mutants_caught}/{mutants_total}",
        "corpus_size": len(corpus),
        "corpus_max_loss": max((c["loss"] for c in corpus), default=0.0),
        "corpus": corpus,
    }
    if scope.micro_completeness:
        micro_total, micro_valid, micro_viol = _micro_box()
        violations.extend(micro_viol)
        info["micro_box"] = {
            "instances": micro_total, "valid": micro_valid,
        }
    return TheoremReport("admission", instances, violations, info)


def rebuild_counterexample(entry: dict):
    """Reconstruct ``(schedule, lat, bw)`` from a corpus entry, so a test
    (or a reader) can replay the strict ``event > barrier`` loss."""
    n = entry["n_nodes"]
    transfers = [
        Transfer(src, dst, nbytes, deps=tuple(deps))
        for src, dst, nbytes, deps in entry["transfers"]
    ]
    return (
        TransmissionSchedule(transfers, label="counterexample"),
        _lat_matrix(n),
        _bw_matrix(n, entry["bw"]),
    )


# -- verifier completeness micro-box -----------------------------------------


def _raw_schedule(transfers) -> TransmissionSchedule:
    # bypass constructor validation: the box deliberately contains invalid
    # instances the constructor would reject
    s = TransmissionSchedule.__new__(TransmissionSchedule)
    s.transfers = list(transfers)
    s.label = "micro"
    s.phase_of = None
    return s


def _reference_valid(transfers: Sequence[Transfer], n: int) -> bool:
    """Independent re-statement of the verifier's rule set on the
    clock-free / phase-free micro-box (the model in model checking)."""
    seen: set[int] = set()
    for i, t in enumerate(transfers):
        if not (math.isfinite(t.nbytes) and t.nbytes >= 0.0):
            return False
        if not (math.isfinite(t.compute_ms) and t.compute_ms >= 0.0):
            return False
        if not (0 <= t.src < n and 0 <= t.dst < n):
            return False
        if t.via >= n:
            return False
        if t.via >= 0 and t.via in (t.src, t.dst):
            return False
        if t.src == t.dst and (t.nbytes != 0.0 or t.via >= 0):
            return False
        if t.epoch < 0:
            return False
        for d in t.deps:
            if not 0 <= d < i:
                return False
            if transfers[d].epoch > t.epoch:
                return False
        seen.add(t.epoch)
    if seen and set(range(max(seen) + 1)) - seen:
        return False
    return True


def _micro_box() -> tuple[int, int, list[Violation]]:
    """Exhaustively compare ``verify_schedule`` against the independent
    reference predicate on a micro-box that crosses *valid and invalid*
    field values: n=2, m<=2, deps in {(), (-1,), (0,), (1,), (2,), (0,1)},
    nbytes in {-1, 0, 250k}, epoch in {0, 1}; via in {-1, 0, 1} at m=1."""
    n = 2
    endpoints = [(s, d) for s in range(n) for d in range(n)]
    dep_opts = [(), (-1,), (0,), (1,), (2,), (0, 1)]
    nbytes_opts = [-1.0, 0.0, 250_000.0]
    epoch_opts = [0, 1]
    violations: list[Violation] = []
    total = valid = 0

    def _one(transfers):
        nonlocal total, valid
        total += 1
        expected = _reference_valid(transfers, n)
        got = not verify_schedule(_raw_schedule(transfers), n_nodes=n)
        if expected:
            valid += 1
        if expected != got:
            ts = [(t.src, t.dst, t.nbytes, t.deps, t.via, t.epoch)
                  for t in transfers]
            violations.append(Violation(
                "verifier-completeness",
                f"micro-box disagreement (reference says "
                f"{'valid' if expected else 'invalid'}): {ts}",
            ))

    opts1 = [
        Transfer(s, d, nb, via=via, deps=dp, epoch=e)
        for (s, d) in endpoints for dp in dep_opts
        for nb in nbytes_opts for e in epoch_opts for via in (-1, 0, 1)
    ]
    for t in opts1:
        _one([t])
    opts2 = [
        Transfer(s, d, nb, deps=dp, epoch=e)
        for (s, d) in endpoints for dp in dep_opts
        for nb in nbytes_opts for e in epoch_opts
    ]
    for a in opts2:
        for b in opts2:
            _one([a, b])
    return total, valid, violations


# -- the checker's tables ----------------------------------------------------


def _new_table(n_keys: int, device: torch.device,
               cls: Callable[..., CRDTTable] = CRDTTable) -> CRDTTable:
    return cls(n_keys, _VALUE_BYTES, device=device)


def same_state(a: CRDTTable, b: CRDTTable) -> bool:
    """Two tables hold one state: equal values, lengths, versions and
    presence, row for row (exact; equivalent to equal ``full_state()``,
    hence to equal digests), read back with one synchronise."""
    diff = torch.stack([
        (a.values != b.values).any(), (a.lengths != b.lengths).any(),
        (a.versions != b.versions).any(), (a.present != b.present).any(),
    ]).any()
    return not bool(diff)


def _device_batch(table: CRDTTable, updates: Sequence[Update]) -> tuple[torch.Tensor, ...]:
    """Host :class:`Update`\\ s as a device batch ``(rows, values, versions,
    lengths)`` of ``table`` for :meth:`CRDTTable.top_rows`."""
    dev = table.device
    return (
        torch.tensor([table.row_of(u.key) for u in updates], dtype=torch.int64, device=dev),
        table.pack([u.value for u in updates]),
        torch.tensor([(u.version.epoch, u.version.seq, u.version.node) for u in updates],
                     dtype=torch.int64, device=dev).reshape(-1, 3),
        torch.tensor([len(u.value) for u in updates], dtype=torch.int64, device=dev),
    )


class _Batches:
    """:func:`_device_batch` of ``table``, each batch made once and kept by
    its updates (the checker applies the same few batches many times: no
    copy to the device for a batch seen before)."""

    def __init__(self, table: CRDTTable):
        self.table = table
        self._cache: dict[tuple[Update, ...], tuple[torch.Tensor, ...]] = {}

    def __call__(self, updates: Sequence[Update]) -> tuple[torch.Tensor, ...]:
        key = tuple(updates)
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = _device_batch(self.table, key)
        return hit


def _join(table: CRDTTable, batch: tuple[torch.Tensor, ...]) -> None:
    """Join a batch into ``table`` as ``apply_many`` does (its top row a
    key, then the join kernel), without reading a count back."""
    table.join_rows(*table.top_rows(*batch))


def _host_versions(table: CRDTTable, keys: Sequence[str]) -> dict[str, Version]:
    """The versions of ``keys`` in ``table``, read from the device once."""
    return dict(zip(keys, table.version_of(list(keys))))


# -- the epoch theorems' instances, side by side on one table ----------------
#
# The OCC and monotonicity theorems check thousands of tiny epochs (one or
# two keys, a few transactions).  Each snapshot's instances are laid side by
# side on one table: instance j's keys k0, k1 are its rows 2j, 2j + 1 and its
# transactions' ids are offset to be distinct across instances.  Validation
# and the join are per key (first-writer-wins by key, reads by key, the LWW
# join by row), so one validation of all instances' transactions, and one
# join of their writes at a time, give every instance exactly its own
# result, with one launch where the instances would make thousands.


def _spread(snap: CRDTTable, n: int) -> CRDTTable:
    """``n`` copies of a table's rows side by side: copy ``j``'s row ``r``
    is row ``j * snap.n_keys + r`` (key ``k{j * snap.n_keys + r}``)."""
    out = CRDTTable(snap.n_keys * n, snap.value_bytes, device=snap.device)
    out.values = snap.values.repeat(n, 1)
    out.lengths, out.present = snap.lengths.repeat(n), snap.present.repeat(n)
    out.versions = snap.versions.repeat(n, 1)
    return out


def _placed(txns: Sequence[Txn], j: int, width: int) -> list[Txn]:
    """Instance ``j``'s transactions on its rows of a :func:`_spread` table
    (keys ``k{i}`` to ``k{2j + i}``, ids ``t`` to ``j * width + t``: their
    order, and so every tie-break, kept)."""
    def key(k: str) -> str:
        return f"k{2 * j + int(k[1:])}"

    return [dataclasses.replace(
        t, txn_id=j * width + t.txn_id,
        read_set=tuple((key(k), v) for k, v in t.read_set),
        write_set=tuple((key(k), v) for k, v in t.write_set)) for t in txns]


def _outcomes(validate: Callable[[EpochBatch, CRDTTable], ValidationResult],
              instances: Sequence[Sequence[Txn]], snap: CRDTTable,
              ) -> tuple[CRDTTable, list[tuple[frozenset, ...]]]:
    """Validate every instance's epoch against ``snap`` in one batch on a
    :func:`_spread` table; returns that table and each instance's
    ``(committed, read_aborted, ww_aborted)`` id sets (its own ids), the
    two masks read back in one copy."""
    width = max((len(txns) for txns in instances), default=1)
    big = _spread(snap, len(instances))
    flat = [t for j, txns in enumerate(instances) for t in _placed(txns, j, width)]
    res = validate(EpochBatch.from_txns(flat, big), big)
    read, ww = torch.stack([res.read_mask, res.ww_mask]).tolist() if flat else ([], [])
    out, pos = [], 0
    for txns in instances:
        ids = [t.txn_id for t in txns]
        read_ab = frozenset(i for i, m in zip(ids, read[pos:pos + len(ids)]) if m)
        ww_ab = frozenset(i for i, m in zip(ids, ww[pos:pos + len(ids)]) if m)
        out.append((frozenset(ids) - read_ab - ww_ab, read_ab, ww_ab))
        pos += len(ids)
    return big, out


# -- theorem 2a: CRDT merge confluence ---------------------------------------


def _uval(key: str, ver: Version) -> bytes:
    return f"{key}|{ver.epoch}.{ver.seq}.{ver.node}".encode()


def check_confluence(
    scope: Scope,
    *,
    store_factory: Callable[..., CRDTTable] = CRDTTable,
    device: str | torch.device | None = None,
) -> TheoremReport:
    """All delivery orders converge: for every update subset at scope,
    every apply permutation, every redelivery, and every two-replica
    split/merge (both merge directions, :meth:`CRDTTable.merge_store`)
    produce one state, and ``merge_updates`` is permutation-invariant.
    ``store_factory`` makes the tables (``(n_keys, value_bytes,
    device=)``)."""
    dev = resolve_device(device)
    keys = ("k0", "k1")
    versions = [
        Version(0, s, nd)
        for s in range(scope.crdt_seqs) for nd in range(scope.crdt_nodes)
    ]
    universe = [Update(k, _uval(k, v), v) for k in keys for v in versions]

    def new() -> CRDTTable:
        return _new_table(len(keys), dev, store_factory)

    batch = _Batches(new())
    violations: list[Violation] = []
    instances = 0
    for r in range(1, scope.crdt_max_updates + 1):
        for combo in itertools.combinations(universe, r):
            instances += 1
            ref = new()
            _join(ref, batch(combo))
            ref_merge = merge_updates(combo)
            bad = None
            for perm in itertools.permutations(combo):
                s = new()
                _join(s, batch(perm))
                if not same_state(s, ref):
                    bad = f"apply order {perm} diverges"
                    break
                if merge_updates(perm) != ref_merge:
                    bad = f"merge_updates({perm}) diverges"
                    break
            if bad is None:
                s = new()
                _join(s, batch(combo))
                _join(s, batch(combo[:1]))      # duplicated redelivery
                if not same_state(s, ref):
                    bad = "redelivery changed the state"
            if bad is None:
                for mask in range(2 ** r):
                    a, b = new(), new()
                    for j, u in enumerate(combo):
                        _join(a if mask >> j & 1 else b, batch((u,)))
                    a.merge_store(b)
                    if not same_state(a, ref):
                        bad = f"replica split {mask:0{r}b} a<-b diverges"
                        break
                    c, d = new(), new()
                    for j, u in enumerate(combo):
                        _join(c if mask >> j & 1 else d, batch((u,)))
                    d.merge_store(c)
                    if not same_state(d, ref):
                        bad = f"replica split {mask:0{r}b} b<-a diverges"
                        break
            if bad is None:
                _CHECKED["confluence"] += 1
            else:
                violations.append(Violation(
                    "confluence",
                    f"{bad}; updates={[(u.key, u.version) for u in combo]}",
                ))
    return TheoremReport(
        "confluence", instances, violations,
        {"universe": len(universe)},
    )


# -- theorem 2b: OCC epoch atomicity -----------------------------------------


_OCC_KEYS = ("k0", "k1")


def _occ_snapshots(device: torch.device) -> list[tuple[str, CRDTTable]]:
    x, y = _OCC_KEYS
    empty = _new_table(2, device)
    low = _new_table(2, device)
    low.apply_many([Update(x, _uval(x, Version(0, 0, 0)), Version(0, 0, 0)),
                    Update(y, _uval(y, Version(0, 0, 1)), Version(0, 0, 1))])
    mixed = _new_table(2, device)
    mixed.apply_many([Update(x, _uval(x, Version(0, 1, 1)), Version(0, 1, 1)),
                      Update(y, _uval(y, Version(0, 0, 0)), Version(0, 0, 0))])
    return [("empty", empty), ("low", low), ("mixed", mixed)]


def _stale_version(fresh: Version) -> Version:
    return Version(fresh.epoch - 1, fresh.seq, fresh.node)


def _txn_shapes(keys, *, full: bool):
    """(reads, writes) shapes; reads are (key, kind) with kind in
    fresh|stale.  Full: all 3^|keys| read configs x all write subsets.
    Reduced (for larger T): single-key reads x single-key writes."""
    if full:
        read_cfgs = []
        for kinds in itertools.product(("none", "fresh", "stale"),
                                       repeat=len(keys)):
            read_cfgs.append(tuple(
                (k, kind) for k, kind in zip(keys, kinds) if kind != "none"
            ))
        write_cfgs = []
        for r in range(len(keys) + 1):
            write_cfgs.extend(itertools.combinations(keys, r))
    else:
        x, y = keys
        read_cfgs = [(), ((x, "fresh"),), ((x, "stale"),), ((y, "fresh"),)]
        write_cfgs = [(), (x,), (y,)]
    return [(r, tuple(w)) for r in read_cfgs for w in write_cfgs]


def _mk_txns(combo, snap_ver: dict[str, Version], seq_mode: str) -> list[Txn]:
    txns = []
    for t_idx, (reads, writes) in enumerate(combo):
        read_set = []
        for k, kind in reads:
            fresh = snap_ver[k]
            read_set.append((k, fresh if kind == "fresh"
                             else _stale_version(fresh)))
        txns.append(Txn(
            txn_id=t_idx, node=t_idx % 3, epoch=1,
            seq=0 if seq_mode == "colliding" else t_idx,
            read_set=tuple(read_set),
            write_set=tuple((k, f"w{t_idx}|{k}".encode()) for k in writes),
        ))
    return txns


def _occ_spec(txns, snap_ver: dict[str, Version]):
    """Independent restatement of the validation rules (the docstring
    spec of the reference's ``core/occ.py``, re-derived), over the
    snapshot's versions read from its table."""
    read_ab = frozenset(
        t.txn_id for t in txns
        if any(snap_ver[k] > v for k, v in t.read_set)
    )
    winners: dict[str, tuple[Version, int]] = {}
    for t in txns:
        for k in t.writes_keys():
            c = (t.version, t.txn_id)
            if k not in winners or c < winners[k]:
                winners[k] = c
    ww = frozenset(
        t.txn_id for t in txns
        if any((t.version, t.txn_id) != winners[k]
               for k in t.writes_keys())
    )
    committed = frozenset(t.txn_id for t in txns) - read_ab - ww
    return committed, read_ab, ww


def check_occ_atomicity(scope: Scope, *,
                        device: str | torch.device | None = None) -> TheoremReport:
    """Exhaustive epoch-OCC exploration at scope: the port's tensor
    validation against the independent rule spec, winner uniqueness,
    snapshot-exact committed reads, and order-invariant post-state (every
    apply permutation of the committed set joins into one state — the
    snapshot-epoch atomicity GeoGauss guarantees).  Write skew between
    committed transactions is permitted (counted, not flagged): the
    theorem is epoch atomicity, not strict per-txn serializability.  A
    snapshot's instances are checked side by side on one table."""
    dev = resolve_device(device)
    violations: list[Violation] = []
    instances = 0
    write_skew = 0
    shape_sets = [(T, _txn_shapes(_OCC_KEYS, full=True))
                  for T in range(1, scope.occ_full_max_txns + 1)]
    shape_sets += [(T, _txn_shapes(_OCC_KEYS, full=False))
                   for T in scope.occ_reduced_txns]
    for snap_name, snap in _occ_snapshots(dev):
        snap_ver = _host_versions(snap, _OCC_KEYS)
        cases = [(combo, seq_mode)
                 for T, shapes in shape_sets
                 for combo in itertools.product(shapes, repeat=T)
                 for seq_mode in ("distinct", "colliding")]
        epochs = [_mk_txns(combo, snap_ver, seq_mode) for combo, seq_mode in cases]
        for (combo, seq_mode), txns, (bad, committed) in zip(
                cases, epochs, _check_epochs(epochs, snap, snap_ver)):
            instances += 1
            if bad is None:
                _CHECKED["occ_atomicity"] += 1
                write_skew += _has_write_skew(committed)
            else:
                violations.append(Violation(
                    "occ-atomicity",
                    f"{bad}; snapshot={snap_name} "
                    f"seq_mode={seq_mode} shapes={combo}",
                ))
    return TheoremReport(
        "occ_atomicity", instances, violations,
        {"write_skew_instances": write_skew},
    )


def _check_epochs(epochs: Sequence[Sequence[Txn]], snap: CRDTTable,
                  snap_ver: dict[str, Version]) -> list[tuple[str | None, list[Txn]]]:
    """Each epoch's checks, in the reference's order; for each the first
    finding (``None`` when clean) and the committed transactions.  The
    epochs are validated together, and their post-states joined together
    one apply step at a time, on a :func:`_spread` table."""
    big, outcomes = _outcomes(validate_epoch_detailed, epochs, snap)
    out: list[tuple[str | None, list[Txn]]] = []
    orders: list[list[Txn]] = []
    perms: list[list[tuple[Txn, ...]]] = []
    for txns, got in zip(epochs, outcomes):
        committed = [t for t in txns if t.txn_id in got[0]]
        order = sorted(committed, key=lambda t: (t.version, t.txn_id))
        out.append((_epoch_finding(txns, committed, got, snap_ver), committed))
        live = out[-1][0] is None
        orders.append(order if live else [])
        # the sorted order's state is the reference state itself
        perms.append([p for p in itertools.permutations(committed) if list(p) != order]
                     if live else [])
    width = max((len(txns) for txns in epochs), default=1)

    def state(sequences: list[Sequence[Txn] | None]) -> CRDTTable:
        """``big`` with each epoch's transactions joined in its sequence
        (none where ``None``), one step of every epoch a join."""
        s = big.snapshot()
        for step in range(max((len(q) for q in sequences if q), default=0)):
            ups = [u for j, q in enumerate(sequences) if q and step < len(q)
                   for u in txn_updates(_placed([q[step]], j, width)[0])]
            if ups:
                _join(s, _device_batch(s, ups))
        return s

    ref = state(orders)
    for q in range(max((len(p) for p in perms), default=0)):
        seqs = [p[q] if q < len(p) else None for p in perms]
        s = state(seqs)
        diff = ((s.values != ref.values).any(1) | (s.lengths != ref.lengths)
                | (s.versions != ref.versions).any(1) | (s.present != ref.present))
        for j, d in enumerate(diff.reshape(len(epochs), -1).any(1).tolist()):
            if seqs[j] is not None and d and out[j][0] is None:
                out[j] = (f"apply order {[t.txn_id for t in seqs[j]]} diverges", out[j][1])
    return out


def _epoch_finding(txns: Sequence[Txn], committed: Sequence[Txn], got: tuple[frozenset, ...],
                   snap_ver: dict[str, Version]) -> str | None:
    """The host checks of one epoch's validation: the rule spec, winner
    uniqueness, snapshot-exact committed reads."""
    if got != _occ_spec(txns, snap_ver):
        return (f"result diverges from the rule spec: committed {sorted(got[0])}, "
                f"read-aborted {sorted(got[1])}, ww-aborted {sorted(got[2])}")
    writers: dict[str, int] = {}
    for t in committed:
        for k in t.writes_keys():
            writers[k] = writers.get(k, 0) + 1
    if any(c > 1 for c in writers.values()):
        return f"winner uniqueness violated: {writers}"
    for t in committed:
        for k, v in t.read_set:
            if v != snap_ver[k]:
                return f"committed txn {t.txn_id} read {k} off-snapshot"
    return None


def _has_write_skew(committed: Sequence[Txn]) -> bool:
    for a, b in itertools.combinations(committed, 2):
        a_reads = {k for k, _ in a.read_set}
        b_reads = {k for k, _ in b.read_set}
        if (set(a.writes_keys()) & b_reads) and \
                (set(b.writes_keys()) & a_reads):
            return True
    return False


# -- theorem 2c: abort-set monotonicity in staleness -------------------------


def check_abort_monotonicity(
    scope: Scope,
    *,
    validate: Callable[[EpochBatch, CRDTTable], ValidationResult] | None = None,
    device: str | torch.device | None = None,
) -> TheoremReport:
    """For every snapshot-prefix chain S0 c S1 c ... c SL and every txn
    shape combination, versioning the reads against an older view only
    ever adds aborts: aborted(Si) >= aborted(Sj) for i <= j, the
    read-abort set is monotone, and the write-write set is *identical*
    across views (no reinstatement keeps it a function of write sets
    alone).  ``validate(batch, snapshot)`` swaps the validation function
    (the seeded reinstatement mutant must be caught here).  A chain's
    instances are validated side by side, one batch a view."""
    dev = resolve_device(device)
    vf = validate or validate_epoch_detailed
    keys = _OCC_KEYS
    L = scope.mono_chain_len
    shapes = [(r, w)
              for r in _powerset(keys) for w in _powerset(keys)]
    violations: list[Violation] = []
    instances = 0
    for chain in itertools.product(keys, repeat=L):
        stores = [_new_table(len(keys), dev)]
        for j, k in enumerate(chain):
            s = stores[-1].snapshot()
            s.apply_many([Update(k, _uval(k, Version(0, j, 0)), Version(0, j, 0))])
            stores.append(s)
        snap = stores[-1]        # the epoch-start snapshot
        combos = [combo for T in scope.mono_txns
                  for combo in itertools.product(shapes, repeat=T)]
        by_view = []
        for view_ver in [_host_versions(view, keys) for view in stores]:
            epochs = [[Txn(
                txn_id=t_idx, node=t_idx % 3, epoch=1, seq=t_idx,
                read_set=tuple((k, view_ver[k]) for k in reads),
                write_set=tuple((k, f"w{t_idx}".encode()) for k in writes),
            ) for t_idx, (reads, writes) in enumerate(combo)] for combo in combos]
            by_view.append(_outcomes(vf, epochs, snap)[1])
        for c, combo in enumerate(combos):
            instances += 1
            results = [(read_ab | ww_ab, read_ab, ww_ab)
                       for _, read_ab, ww_ab in (view[c] for view in by_view)]
            bad = None
            for i in range(len(results)):
                for j in range(i + 1, len(results)):
                    ri, rj = results[i], results[j]
                    if not ri[0] >= rj[0]:
                        bad = (f"aborted(S{i}) !>= aborted(S{j}): "
                               f"{set(ri[0])} vs {set(rj[0])}")
                    elif not ri[1] >= rj[1]:
                        bad = f"read aborts not monotone (S{i}, S{j})"
                    elif ri[2] != rj[2]:
                        bad = (f"ww aborts differ across views "
                               f"(S{i}, S{j}): reinstatement?")
                    if bad:
                        break
                if bad:
                    break
            if bad is None:
                _CHECKED["abort_monotonicity"] += 1
            else:
                violations.append(Violation(
                    "abort-monotonicity",
                    f"{bad}; chain={chain} shapes={combo}",
                ))
    return TheoremReport(
        "abort_monotonicity", instances, violations, {"views": L + 1},
    )


def _powerset(keys):
    out = []
    for r in range(len(keys) + 1):
        out.extend(itertools.combinations(keys, r))
    return out


# -- theorems 3 + 4: eviction safety + serving prefix sufficiency ------------


def _monotone_columns(E: int, hi: int) -> list[tuple[int, ...]]:
    """All per-node commit-step columns: non-decreasing, c[k] >= k+1
    (epoch k commits no earlier than the step after it is appended),
    c[k] <= hi (hi = E+1 means 'after the run horizon')."""
    out: list[tuple[int, ...]] = []

    def rec(k: int, lo: int, acc: tuple[int, ...]):
        if k == E:
            out.append(acc)
            return
        for v in range(max(lo, k + 1), hi + 1):
            rec(k + 1, v, acc + (v,))

    rec(0, 1, ())
    return out


def check_eviction(
    scope: Scope,
    *,
    evict_floor: Callable[[np.ndarray], int] | None = None,
    device: str | torch.device | None = None,
) -> TheoremReport:
    """Explicit-state exploration of *every* reachable commit-delivery
    interleaving at scope, driving the real protocol pieces: a
    :class:`StreamingTimeline` whose measured commit matrix realizes the
    interleaving exactly (integer-valued exec stages; epoch_ms=1), the
    engine's :func:`repro_torch.core.replication.advance_views` over
    per-node view tables joined through ``crdt_join_rows``, and a real
    :class:`repro_torch.serve.plane.ServingSink`.

    Checked per interleaving: no view advancement ever reads a commit row
    below the eviction frontier (the frontier is evicted to
    ``view_next.min()`` after every epoch, exactly as the engine does);
    views advance the exact delivered epoch prefix with the exact merged
    CRDT content; pending update batches are released only below every
    view; the retained timeline surface is byte-identical to the full
    matrix; and the serving sink's per-epoch staleness mean/max equal the
    batch full-matrix computation exactly (prefix sufficiency).

    ``evict_floor`` swaps the eviction policy (the seeded over-eager
    ``min+1`` mutant must produce a frontier under-read here)."""
    from ..core.replication import advance_views
    from ..serve.config import ServeConfig
    from ..serve.plane import ServingSink

    dev = resolve_device(device)
    floor_fn = evict_floor or (lambda vn: int(vn.min()))
    serve_cfg = ServeConfig()
    violations: list[Violation] = []
    instances = 0
    for n, E in scope.evict_grids:
        hi = E + 1
        cols = _monotone_columns(E, hi)
        lat = np.zeros((n, n))
        # each epoch's committed rows as the engine keeps them pending:
        # reduced once by top_rows, joined into each view by join_rows
        acc = _new_table(E, dev)
        batch = _Batches(acc)
        deltas = [acc.top_rows(*batch([Update(f"k{k}", b"v", Version(k, 0, 0))]))
                  for k in range(E)]
        prefix = [acc.snapshot()]
        for k in range(E):
            acc.join_rows(*deltas[k])
            prefix.append(acc.snapshot())
        for matrix in itertools.product(cols, repeat=n):
            instances += 1
            C = np.array(matrix, dtype=float).T      # (E, n) commit steps
            bad = _drive_interleaving(
                n, E, C, lat, deltas, prefix, floor_fn, advance_views,
                ServingSink(serve_cfg, n, 1.0), dev,
            )
            if bad is None:
                _CHECKED["eviction_prefix"] += 1
            else:
                violations.append(Violation(
                    "eviction-prefix",
                    f"{bad}; n={n} E={E} commit_steps={matrix}",
                ))
    return TheoremReport(
        "eviction_prefix", instances, violations,
        {"grids": list(scope.evict_grids)},
    )


def _drive_interleaving(
    n, E, C, lat, deltas, prefix, floor_fn, advance_views, sink, device,
) -> str | None:
    tl = StreamingTimeline(n, epoch_ms=1.0)
    views = [_new_table(E, device) for _ in range(n)]
    view_next = np.zeros(n, dtype=int)
    pending: dict[int, tuple[torch.Tensor, ...]] = {}
    empty_round = TransmissionSchedule([], label="mc")
    appended = 0

    def advance_and_check(now: float, n_done: int) -> str | None:
        try:
            advance_views(n, views, view_next, pending, tl.commit_at,
                          n_done, now)
        except IndexError as e:
            return f"frontier under-read at now={now}: {e}"
        except KeyError as e:
            return f"pending batch read after release at now={now}: {e}"
        floor = int(view_next.min())
        expects = [int(sum(1 for k in range(n_done) if C[k, i] <= now))
                   for i in range(n)]
        for i in range(n):
            if int(view_next[i]) != expects[i]:
                return (f"view prefix of node {i} at now={now}: "
                        f"{int(view_next[i])} != {expects[i]}")
            if not same_state(views[i], prefix[expects[i]]):
                return f"view content of node {i} diverges at now={now}"
        if set(pending) != {k for k in range(appended) if k >= floor}:
            return (f"pending release wrong at now={now}: "
                    f"{sorted(pending)} vs floor {floor}")
        return None

    for e in range(E):
        bad = advance_and_check(float(e), tl.n_epochs)
        if bad:
            return bad
        # realize commit_at(e, i) == C[e, i] exactly: the exec stage of
        # node i starts at max(clock e, previous exec finish) — all small
        # integers, so the float arithmetic is exact
        execs = [
            C[e, i] - max(float(e), C[e - 1, i] if e else 0.0)
            for i in range(n)
        ]
        et = tl.append_epoch(empty_round, lat, node_exec_ms=execs)
        appended += 1
        sink.push(e, et.commit_ms, lat)
        pending[e] = deltas[e]
        tl.evict_commit_rows(floor_fn(view_next))
        for k in range(tl.evicted_epochs, appended):
            for i in range(n):
                if tl.commit_at(k, i) != C[k, i]:
                    return (f"retained surface diverges at ({k}, {i}): "
                            f"{tl.commit_at(k, i)} != {C[k, i]}")
    for now in range(E, E + 2):      # flush past the horizon
        bad = advance_and_check(float(now), appended)
        if bad:
            return bad
        tl.evict_commit_rows(floor_fn(view_next))
    # serving prefix sufficiency: the sink's pointer-derived staleness
    # equals the batch full-matrix computation, exactly
    st = sink.finish(wall_ms=float(E))
    for e, es in enumerate(st.epochs):
        now = float(e)
        ve = (C[: e + 1] <= now + 1e-9).sum(axis=0)
        stal = np.maximum(now - ve.astype(float), 0.0)
        if es.view_staleness_ms_mean != float(stal.mean()) or \
                es.view_staleness_ms_max != float(stal.max()):
            return (f"serving staleness diverges at epoch {e}: sink "
                    f"({es.view_staleness_ms_mean}, "
                    f"{es.view_staleness_ms_max}) vs batch "
                    f"({float(stal.mean())}, {float(stal.max())})")
    return None


# -- seeded mutants (checker self-test) --------------------------------------


class _ZeroRankSimulator(WANSimulator):
    """Broken admission ranking: every transfer gets rank 0, so admission
    never defers a later-phase flow — greedy behavior under the admission
    flag.  The sweep must find ``event > barrier`` on the adversarial
    grids."""

    def _admission_ranks(self, schedule):
        return np.zeros(schedule.n_transfers, dtype=int)


class _LastArrivalStore(CRDTTable):
    """Non-commutative merge: last *arrival* wins, ignoring the version
    order — a batch keeps each row's last update in batch order, and the
    join overwrites the table's row whatever its version (no
    ``crdt_join_rows``).  The confluence check must see permutation
    divergence."""

    def top_rows(self, rows, values, versions, lengths=None):
        rows = rows.to(torch.int64)
        if lengths is None:
            lengths = torch.full_like(rows, self.value_bytes)
        last = {r: i for i, r in enumerate(rows.tolist())}
        pick = torch.tensor(sorted(last.values()), dtype=torch.int64, device=rows.device)
        return rows[pick], values[pick].contiguous(), versions[pick], lengths[pick].to(torch.int64)

    def join_rows(self, keys, values, versions, lengths):
        self.values[keys] = values
        self.versions[keys] = versions
        self.lengths[keys] = lengths
        self.present[keys] = True
        return torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)


def _reinstating_validate(batch: EpochBatch, snap: CRDTTable) -> ValidationResult:
    """First-writer-wins *with* reinstatement: read-aborted writers are
    dropped from the winner map, so their write-write losers commit.
    Breaks abort-set monotonicity in staleness.  The port's result with
    its write-write mask replaced."""
    base = validate_epoch_detailed(batch, snap)
    txns = batch.to_txns(snap)
    read_ab = base.read_aborted
    alive = [t for t in txns if t.txn_id not in read_ab]
    winners: dict[str, tuple[Version, int]] = {}
    for t in alive:
        for k in t.writes_keys():
            c = (t.version, t.txn_id)
            if k not in winners or c < winners[k]:
                winners[k] = c
    ww = frozenset(
        t.txn_id for t in alive
        if any((t.version, t.txn_id) != winners[k]
               for k in t.writes_keys())
    )
    ww_mask = torch.tensor([t.txn_id in ww for t in txns], dtype=torch.bool,
                           device=base.ww_mask.device)
    return dataclasses.replace(base, ww_mask=ww_mask)


_SELFTEST_SCOPE = Scope(
    name="selftest",
    dag_grids=(
        DagGrid(3, 4, 4, _PAYLOADS, False, _CPU_OFF, ("tri",),
                endpoint_mode="wire", dep_patterns=_DEP_SLICE_M4[:1]),
    ),
    mutant_stride=0,
    micro_completeness=False,
    crdt_seqs=2, crdt_nodes=1, crdt_max_updates=3,
    occ_full_max_txns=2, occ_reduced_txns=(),
    mono_chain_len=2, mono_txns=(2,),
    evict_grids=((2, 3),),
)


def selftest_reports(device: str | torch.device | None = None) -> dict[str, TheoremReport]:
    """Each theorem check run against its seeded mutant, at the self-test
    scope: the reports, by mutant."""
    s = _SELFTEST_SCOPE
    return {
        "broken-admission-ranking": check_admission(
            s, simulator_factory=_ZeroRankSimulator, device=device),
        "non-commutative-merge": check_confluence(
            s, store_factory=_LastArrivalStore, device=device),
        "occ-reinstatement": check_abort_monotonicity(
            s, validate=_reinstating_validate, device=device),
        "frontier-under-read": check_eviction(
            s, evict_floor=lambda vn: int(vn.min()) + 1, device=device),
    }


def run_selftest(device: str | torch.device | None = None) -> dict[str, bool]:
    """Run each theorem check against its seeded mutant; ``True`` means
    the mutant was rejected (the checker found violations).  All four
    must be rejected for the checker itself to be trusted."""
    return {name: bool(r.violations) for name, r in selftest_reports(device).items()}


# -- driver ------------------------------------------------------------------

_CHECKS: dict[str, Callable[..., TheoremReport]] = {
    "admission": check_admission,
    "confluence": check_confluence,
    "occ_atomicity": check_occ_atomicity,
    "abort_monotonicity": check_abort_monotonicity,
    "eviction_prefix": check_eviction,
}


def run_tier(
    scope: Scope,
    *,
    only: Sequence[str] | None = None,
    selftest: bool = True,
    device: str | torch.device | None = None,
) -> ModelCheckReport:
    names = list(_CHECKS) if only is None else list(only)
    for nm in names:
        if nm not in _CHECKS:
            raise ValueError(
                f"unknown theorem {nm!r}; expected one of {sorted(_CHECKS)}"
            )
    reports = [_CHECKS[nm](scope, device=device) for nm in names]
    mutants = run_selftest(device) if selftest else {}
    return ModelCheckReport(scope.name, reports, mutants)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.modelcheck",
        description="Bounded explicit-state model checker for the "
                    "engine's soundness theorems.",
    )
    ap.add_argument("--tier", default="quick",
                    choices=sorted(_SCOPES),
                    help="quick: the reference's CI tier; deep: opt-in "
                         "larger boxes; smoke: the benchmark-provenance "
                         "scope")
    ap.add_argument("--only", default=None,
                    help="comma-separated theorem subset "
                         f"(of {', '.join(_CHECKS)})")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the seeded-mutant self-test")
    ap.add_argument("--device", default=None,
                    help="device of the checker's tables (default cuda)")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    report = run_tier(
        scope_for(args.tier), only=only, selftest=not args.no_selftest,
        device=args.device,
    )
    for t in report.theorems:
        status = "ok" if t.ok else f"{len(t.violations)} VIOLATION(S)"
        print(f"{t.name:22s} {t.instances:8d} instances  {status}")
        for key in ("valid_accepted", "mutants", "corpus_size",
                    "write_skew_instances"):
            if key in t.info:
                print(f"{'':22s} {key} = {t.info[key]}")
        if "corpus_max_loss" in t.info and t.info["corpus_size"]:
            print(f"{'':22s} corpus_max_loss = "
                  f"{t.info['corpus_max_loss'] * 100:.1f}%")
        if "micro_box" in t.info:
            print(f"{'':22s} micro_box = {t.info['micro_box']}")
        for v in t.violations[:10]:
            print(f"  {v}")
        if len(t.violations) > 10:
            print(f"  ... and {len(t.violations) - 10} more")
    for name, rejected in report.mutants_rejected.items():
        print(f"mutant {name:28s} {'rejected' if rejected else 'MISSED'}")
    print(f"model-checked instances: {model_checked_count()}",
          file=sys.stderr)
    print("ok" if report.ok else "FAILED", file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
