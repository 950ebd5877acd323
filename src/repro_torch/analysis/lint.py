"""Determinism/soundness lint: repo-specific AST rules; the port's own copy
of ``repro.analysis.lint``, its allowlists naming the port's files and its
critical functions the port's table paths beside the reference's names.

The repo's central promises — byte-identical digests across engines,
deterministic benchmark gates, simulated time never contaminated by host
wall-clock — are invariants *of the source*, not of any one run.  This
linter enforces them statically:

=====================  =====================================================
rule                   what it refuses
=====================  =====================================================
``wallclock``          ``time.time()`` / ``time.perf_counter()`` (and
                       friends) outside the explicit allowlist.  Wall-clock
                       belongs in exactly two kinds of places: genuinely
                       measured quantities (trainer step timing, planner
                       search cost, dry-run compile time, the benchmark
                       harness's own timers) and the explicitly *measured*-
                       CPU branch of the replication engine
                       (``modeled_cpu=False``).  Anywhere else it leaks
                       host load into simulated results.
``module-rng``         ``np.random.<draw>()`` module-level calls (global
                       RNG state).  Thread a ``np.random.Generator``
                       (``default_rng(seed)``) instead; constructors
                       (``default_rng``, ``SeedSequence``, bit generators)
                       are allowed.  Likewise torch's global generator:
                       ``torch.<draw>()`` (``rand``, ``randn``, ``randint``,
                       ``randperm``, ``normal``, ``bernoulli``,
                       ``multinomial``) without ``generator=``, and
                       ``torch.manual_seed()``.
``unordered-set-iter`` iterating a ``set``/``frozenset`` expression inside
                       a determinism-critical function (digest, epoch
                       validation / winner map, CRDT merge and table join
                       paths).  String
                       hashing is salted per process, so set order is not
                       reproducible across runs — wrap in ``sorted(...)``.
``unordered-dict-iter`` iterating a dict view (``.keys()``/``.values()``/
                       ``.items()``) or dict display inside a determinism-
                       critical function.  Dict order is insertion order,
                       and in merge/winner paths insertion order is arrival
                       order — content-deterministic digests must sort.
``float-sum-unordered`` ``sum()`` over an unordered iterable (set/dict
                       view) of simulated-time / byte quantities (``*_ms``,
                       ``*_s``, ``*_bytes``, ``nbytes``).  Float addition
                       is non-associative, so the accumulation order
                       changes the total — sort the iterable first.
``mutable-default``    mutable default arguments (``def f(x=[])``).
``float-time-eq``      bare ``==`` / ``!=`` between simulated-time scalars
                       (identifiers ending in ``_ms``).  Exact equality is
                       only meaningful against a literal ``0``; otherwise
                       compare with a tolerance or gate on ``<=``.
``tracked-bytecode``   ``*.pyc`` files tracked by git anywhere in the repo.
=====================  =====================================================

Suppression: a line containing ``lint: allow[<rule>]`` in a comment
suppresses that rule on that line; permanent exemptions live in the
per-rule allowlists below (path suffix, optionally ``::``-scoped to a
function/class qualname) with the reason recorded next to each entry.

Run it as a CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch

or in-process (``tests/test_torch_analysis.py`` asserts the port's tree is
clean and that each fixture under ``tests/fixtures/lint/`` and
``tests/fixtures/lint_torch/`` trips its rule exactly once)::

    from repro_torch.analysis.lint import lint_paths
    violations = lint_paths(["src/repro_torch"])
"""

from __future__ import annotations

import argparse
import ast
import re
import subprocess
import sys
from pathlib import Path

from .violations import Violation

__all__ = ["lint_file", "lint_paths", "main"]

# -- rule configuration ------------------------------------------------------

WALLCLOCK_CALLS = {
    "time", "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
    "process_time", "process_time_ns",
}

# np.random.* attribute calls that construct seeded generator objects rather
# than drawing from the module-global RNG state
RNG_CONSTRUCTORS = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64", "RandomState",
}

# torch.* calls that draw from torch's global generator unless given a
# generator= (torch.manual_seed reseeds it: always refused)
TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial",
}

# functions whose iteration order feeds digests / the OCC winner map / CRDT
# merge outcomes; set iteration inside any of these (or any function whose
# name mentions digest/winner) must be sorted.  The reference's names, and
# the port's table paths that play the same roles (the join, its reduction
# of a batch, the batch digests, the reference's count of changes)
CRITICAL_FUNCS = {
    "digest", "value_state", "full_state", "merge_updates", "apply_many",
    "merge_store", "validate_epoch", "validate_epoch_detailed",
    "_validate_python", "_validate_numpy",
    "committed_updates", "_advance_views", "advance_views", "append_epoch",
    "join_rows", "top_rows", "merge_rows", "digests", "_digests", "_changes",
}

# Allowlists: entries are a path suffix (posix), optionally "::"-scoped to a
# dotted qualname prefix.  Every entry records why wall-clock (etc.) is
# legitimate there — these are measured quantities, not simulated time.
ALLOWLIST: dict[str, tuple[str, ...]] = {
    "wallclock": (
        # device-plane step timing: real wall-clock IS the measurement
        "repro_torch/train/trainer.py",
        # plan-search wall cost, reported as plan_cost_s (never enters the
        # simulated timeline)
        "repro_torch/core/planner.py",
        # the dry-run's own time
        "repro_torch/launch/dryrun.py",
        # replication engine: plan_time_s accounting ...
        "repro_torch/core/replication.py::GeoCluster._plan_fn",
        # ... and the explicitly *measured*-CPU branch (modeled_cpu=False
        # charges real filter/zlib wall time; modeled_cpu=True is the
        # deterministic alternative)
        "repro_torch/core/replication.py::GeoCluster._prepare_epoch",
        # the benchmark harness times its own modules' wall cost
        "benchmarks/common.py",
        "benchmarks/run.py",
        # plan-cost figures: planner wall time is the reported metric
        "benchmarks/bench_scaling_cost_benefit.py",
        "benchmarks/bench_grouping_strategies.py",
        # long-horizon scaling gate: the O(E) claim is about real wall
        # time, so the 2x-epochs ratio is a measured quantity
        "benchmarks/bench_long_horizon.py",
    ),
    "module-rng": (),
    "unordered-set-iter": (),
    "unordered-dict-iter": (),
    "float-sum-unordered": (),
    "mutable-default": (),
    "float-time-eq": (),
}

_PRAGMA = re.compile(r"lint:\s*allow\[([a-z-]+(?:\s*,\s*[a-z-]+)*)\]")


def _allowed(rule: str, rel_path: str, qualname: str) -> bool:
    for entry in ALLOWLIST.get(rule, ()):
        if "::" in entry:
            suffix, scope = entry.split("::", 1)
            if rel_path.endswith(suffix) and (
                qualname == scope or qualname.startswith(scope + ".")
            ):
                return True
        elif rel_path.endswith(entry):
            return True
    return False


def _pragma_rules(line: str) -> set[str]:
    m = _PRAGMA.search(line)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",")}


def _is_setish(node: ast.AST) -> bool:
    """Syntactically a set-typed expression: literal, comprehension,
    ``set()``/``frozenset()`` call, or a set-algebra BinOp over one."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
    ):
        return _is_setish(node.left) or _is_setish(node.right)
    return False


def _is_dictish(node: ast.AST) -> bool:
    """Syntactically a dict-typed expression: display, comprehension, or a
    ``dict()`` call."""
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return True
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
        and node.func.id == "dict"


def _is_dict_view(node: ast.AST) -> bool:
    """A ``.keys()`` / ``.values()`` / ``.items()`` view call — the
    syntactic marker of dict iteration (a bare name can't be typed
    statically, exactly like the set rule)."""
    return isinstance(node, ast.Call) and not node.args \
        and not node.keywords and isinstance(node.func, ast.Attribute) \
        and node.func.attr in ("keys", "values", "items")


def _float_total_named(node: ast.AST) -> bool:
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return name is not None and (
        name == "nbytes" or name.endswith(("_ms", "_s", "_bytes"))
    )


def _mentions_float_total(node: ast.AST) -> bool:
    return any(_float_total_named(sub) for sub in ast.walk(node))


def _time_like(node: ast.AST) -> bool:
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return name is not None and name.endswith("_ms")


def _is_zero_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in (0, 0.0)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel_path: str, lines: list[str]):
        self.rel_path = rel_path
        self.lines = lines
        self.scope: list[str] = []
        self.time_imports: set[str] = set()  # from time import perf_counter
        self.out: list[Violation] = []

    # -- helpers ------------------------------------------------------------

    def _report(self, rule: str, message: str, node: ast.AST) -> None:
        if _allowed(rule, self.rel_path, ".".join(self.scope)):
            return
        line = getattr(node, "lineno", None)
        if line is not None and 1 <= line <= len(self.lines) \
                and rule in _pragma_rules(self.lines[line - 1]):
            return
        self.out.append(Violation(
            rule, message, file=self.rel_path, line=line,
        ))

    def _in_critical_func(self) -> bool:
        for name in self.scope:
            if name in CRITICAL_FUNCS or "digest" in name or "winner" in name:
                return True
        return False

    # -- scope tracking ------------------------------------------------------

    def _visit_scoped(self, node) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._visit_scoped(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_defaults(node)
        self._visit_scoped(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._check_defaults(node)
        self._visit_scoped(node)

    # -- rule: mutable-default ----------------------------------------------

    def _check_defaults(self, node) -> None:
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set", "bytearray")
            )
            if mutable:
                self._report(
                    "mutable-default",
                    f"function {node.name!r} has a mutable default "
                    "argument: it is shared across calls — default to "
                    "None and construct inside", d,
                )

    # -- rule: wallclock + module-rng ----------------------------------------

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "time":
            for alias in node.names:
                if alias.name in WALLCLOCK_CALLS:
                    self.time_imports.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # time.<clock>()
            if fn.attr in WALLCLOCK_CALLS and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "time":
                self._report(
                    "wallclock",
                    f"time.{fn.attr}() reads the host wall-clock: simulated "
                    "results must not depend on host load (allowlist the "
                    "site if this is a genuinely measured quantity)", node,
                )
            # np.random.<draw>()
            if isinstance(fn.value, ast.Attribute) \
                    and fn.value.attr == "random" \
                    and isinstance(fn.value.value, ast.Name) \
                    and fn.value.value.id in ("np", "numpy") \
                    and fn.attr not in RNG_CONSTRUCTORS:
                self._report(
                    "module-rng",
                    f"np.random.{fn.attr}() draws from module-global RNG "
                    "state: thread a np.random.Generator "
                    "(default_rng(seed)) instead", node,
                )
            # torch.<draw>() on the global generator, torch.manual_seed()
            if isinstance(fn.value, ast.Name) and fn.value.id == "torch":
                if fn.attr == "manual_seed":
                    self._report(
                        "module-rng",
                        "torch.manual_seed() reseeds torch's global "
                        "generator: thread a torch.Generator instead", node,
                    )
                elif fn.attr in TORCH_DRAWS and not any(
                    k.arg == "generator" for k in node.keywords
                ):
                    self._report(
                        "module-rng",
                        f"torch.{fn.attr}() without generator= draws from "
                        "torch's global generator: pass a seeded "
                        "torch.Generator", node,
                    )
        elif isinstance(fn, ast.Name) and fn.id in self.time_imports:
            self._report(
                "wallclock",
                f"{fn.id}() (imported from time) reads the host "
                "wall-clock: simulated results must not depend on host "
                "load", node,
            )
        self._check_float_sum(node)
        self.generic_visit(node)

    # -- rule: float-sum-unordered -------------------------------------------

    def _check_float_sum(self, node: ast.Call) -> None:
        fn = node.func
        if not (isinstance(fn, ast.Name) and fn.id == "sum" and node.args):
            return
        arg = node.args[0]
        if isinstance(arg, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            src = arg.generators[0].iter
            probe: ast.AST = arg.elt
        else:
            src = arg
            probe = arg
        if (_is_setish(src) or _is_dictish(src) or _is_dict_view(src)) \
                and _mentions_float_total(probe):
            self._report(
                "float-sum-unordered",
                "sum() over an unordered iterable of *_ms/*_s/*_bytes "
                "quantities: float addition is non-associative, so the "
                "accumulation order changes the total — sort the iterable "
                "first", node,
            )

    # -- rule: unordered-set-iter --------------------------------------------

    def _check_iter(self, iter_node: ast.AST) -> None:
        if not self._in_critical_func():
            return
        if _is_setish(iter_node):
            self._report(
                "unordered-set-iter",
                "iterating a set inside a determinism-critical function: "
                "string hashing is salted per process, so the order feeds "
                "nondeterminism into digest/winner-map paths — wrap in "
                "sorted(...)", iter_node,
            )
        elif _is_dictish(iter_node) or _is_dict_view(iter_node):
            self._report(
                "unordered-dict-iter",
                "iterating a dict view inside a determinism-critical "
                "function: dict order is insertion order, which in "
                "merge/winner paths is arrival order — wrap in "
                "sorted(...) so digests depend on content only", iter_node,
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # -- rule: float-time-eq -------------------------------------------------

    def visit_Compare(self, node: ast.Compare) -> None:
        operands = [node.left] + list(node.comparators)
        for op, lhs, rhs in zip(node.ops, operands, operands[1:]):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            if _is_zero_literal(lhs) or _is_zero_literal(rhs):
                continue  # exact-zero checks are well-defined on floats
            if _time_like(lhs) or _time_like(rhs):
                self._report(
                    "float-time-eq",
                    "bare float ==/!= on a simulated-time value (*_ms): "
                    "compare with a tolerance, or gate on <= (exact "
                    "equality is only meaningful against literal 0)", node,
                )
                break
        self.generic_visit(node)


# -- drivers -----------------------------------------------------------------


def lint_file(path: str | Path, root: Path | None = None) -> list[Violation]:
    """Lint one Python source file; returns its violations."""
    p = Path(path)
    rel = p.resolve().relative_to(root.resolve()).as_posix() if root \
        else p.as_posix()
    src = p.read_text()
    try:
        tree = ast.parse(src, filename=str(p))
    except SyntaxError as e:
        return [Violation("syntax-error", str(e), file=rel, line=e.lineno)]
    linter = _Linter(rel, src.splitlines())
    linter.visit(tree)
    return linter.out


def _tracked_bytecode(paths: list[Path]) -> list[Violation]:
    """Flag git-tracked ``*.pyc`` anywhere in the repo(s) containing the
    linted paths.  Committed bytecode is both noise and a staleness hazard
    (it shadows nothing but diffs on every rebuild).  Skipped silently when
    git (or a repo) is absent."""
    roots: set[Path] = set()
    for p in paths:
        cur = p.resolve()
        if cur.is_file():
            cur = cur.parent
        while cur != cur.parent:
            if (cur / ".git").exists():
                roots.add(cur)
                break
            cur = cur.parent
    out: list[Violation] = []
    for root in sorted(roots):
        try:
            res = subprocess.run(
                ["git", "-C", str(root), "ls-files", "-z", "--", "*.pyc"],
                capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if res.returncode != 0:
            continue
        for f in res.stdout.split("\0"):
            if f:
                out.append(Violation(
                    "tracked-bytecode",
                    "git-tracked bytecode: remove it and keep __pycache__/ "
                    "in .gitignore", file=f,
                ))
    return out


def lint_paths(paths: list[str | Path]) -> list[Violation]:
    """Lint every ``*.py`` under the given files/directories (recursively,
    skipping ``__pycache__``), plus the tracked-bytecode repo check."""
    roots = [Path(p) for p in paths]
    files: list[Path] = []
    for p in roots:
        if p.is_file():
            files.append(p)
        else:
            files.extend(
                f for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
    out: list[Violation] = []
    for f in files:
        out.extend(lint_file(f))
    out.extend(_tracked_bytecode(roots))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Determinism/soundness lint (repo-specific AST rules).",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    args = ap.parse_args(argv)
    violations = lint_paths(args.paths)
    for v in violations:
        print(v)
    n = len(violations)
    print(f"{n} violation(s)" if n else "clean", file=sys.stderr)
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
