"""Static verification layer of the port (its own copy of the reference's
``analysis`` package): invariants checked for *all* inputs, not sampled
ones.

* :mod:`repro_torch.analysis.schedule_check` — :func:`verify_schedule`, a
  pure O(V + E) validator over any transfer DAG (acyclicity, dep bounds,
  phase monotonicity along dep edges — the admission theorem's
  precondition — epoch contiguity, clock-chain linearity, payload sanity,
  node bounds), and :class:`StreamScheduleVerifier`, its per-epoch form.
  Wired behind ``EngineConfig(verify_schedules=True)`` /
  ``WANSimulator(verify=True)`` / ``StreamingTimeline(verify=True)``.
* :mod:`repro_torch.analysis.config_check` — :func:`check_config`, one
  declarative rule table for every config-flag constraint.
* :mod:`repro_torch.analysis.lint` — repo-specific AST determinism lint
  (wall-clock outside measured branches, module-global RNG in numpy and
  torch, unordered set and dict iteration in digest and join paths, float
  sums over unordered sources, mutable defaults, bare float ``==`` on
  simulated times, tracked bytecode).  CLI:
  ``python -m repro_torch.analysis.lint src/repro_torch``.
* :mod:`repro_torch.analysis.modelcheck` — bounded explicit-state model
  checker: exhaustive DAG-space sweeps machine-checking the admission
  theorem and verifier completeness, plus protocol checks (CRDT merge
  confluence, OCC epoch atomicity, abort-set monotonicity, streaming
  eviction safety) on the port's device tables, and a seeded-mutant
  selftest.  CLI: ``python -m repro_torch.analysis.modelcheck --tier quick``.
* :mod:`repro_torch.analysis.mutate` — schedule mutators (one per verifier
  rule) used by the mutation-corpus checks and the model checker's
  invalid-side sampling.

The lint, the verifier and the config table are stdlib-only at import
time, so the lint CLI runs without the simulation stack.  The model-checker
and mutator exports below are lazy (PEP 562): importing
:mod:`repro_torch.analysis` does not pull in numpy or torch; touching
``run_tier`` etc. does.
"""

from .config_check import ConfigRule, check_config, validate_config
from .lint import lint_file, lint_paths
from .schedule_check import (
    ScheduleVerificationError,
    StreamScheduleVerifier,
    reset_verified_schedule_count,
    verified_schedule_count,
    verify_schedule,
)
from .violations import Violation, format_violations

__all__ = [
    "Violation",
    "format_violations",
    "verify_schedule",
    "ScheduleVerificationError",
    "StreamScheduleVerifier",
    "verified_schedule_count",
    "reset_verified_schedule_count",
    "ConfigRule",
    "check_config",
    "validate_config",
    "lint_file",
    "lint_paths",
    # lazy (numpy/torch-backed) — resolved on first attribute access
    "ModelCheckReport",
    "TheoremReport",
    "THEOREMS",
    "check_admission",
    "check_confluence",
    "check_occ_atomicity",
    "check_abort_monotonicity",
    "check_eviction",
    "model_checked_count",
    "reset_model_checked_count",
    "rebuild_counterexample",
    "run_selftest",
    "run_tier",
    "scope_for",
    "MUTATORS",
    "mutate_schedule",
]

_LAZY = {
    "MUTATORS": "mutate",
    "mutate_schedule": "mutate",
    "ModelCheckReport": "modelcheck",
    "TheoremReport": "modelcheck",
    "THEOREMS": "modelcheck",
    "check_admission": "modelcheck",
    "check_confluence": "modelcheck",
    "check_occ_atomicity": "modelcheck",
    "check_abort_monotonicity": "modelcheck",
    "check_eviction": "modelcheck",
    "model_checked_count": "modelcheck",
    "reset_model_checked_count": "modelcheck",
    "rebuild_counterexample": "modelcheck",
    "run_selftest": "modelcheck",
    "run_tier": "modelcheck",
    "scope_for": "modelcheck",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
