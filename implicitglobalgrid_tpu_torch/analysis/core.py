"""Pass-registry framework of the port's ``analysis`` (the JAX package's
``analysis/core.py``).

The correctness story of the reference is implicit — ``update_halo!`` is only
safe because every rank issues the same collectives in the same order — and
the JAX package's one real distributed hang (its ``_gather_chunked``, PR 1)
was exactly a cross-rank collective-ordering divergence found by hand.  This
framework turns that bug class into machine-checked invariants over what the
port has to read: the package's Python AST, the host-side collective plans
its orchestration exposes (`analysis.collectives`), its ``IGG_*`` knob table
(`analysis.knobs`) and the autotuner's committed seed layer
(`analysis.tunecache`).  Analyzers report `Finding` records through one
runner with a baseline/suppression file and JSON + human reporters; the
fingerprints, exit codes and the SARIF export are the JAX package's.

The JAX package's jaxpr and HLO passes have torch twins that drive the
port's own code or read the CUDA compiler's report instead (the package
docstring lists them); `Context` builds only the package's ASTs, and this
module imports no torch.
"""

from __future__ import annotations

import fnmatch
import hashlib
import importlib
import json
import os
from dataclasses import dataclass, field

#: Finding severities, most severe first.  CRITICAL = a distributed-deadlock
#: class (cross-rank divergence); ERROR = must be fixed or explicitly
#: baselined with a justification; WARNING = reported, does not fail the
#: suite (unless ``strict``); INFO = notes/metrics carriers.
SEVERITIES = ("CRITICAL", "ERROR", "WARNING", "INFO")

#: Severities that make `Report.exit_code` nonzero (WARNING joins under
#: ``strict``).
FAILING = ("CRITICAL", "ERROR")

#: The repo root: the package's parent, where the committed records live.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass(frozen=True)
class Finding:
    """One analyzer result.

    ``path``/``line`` locate the finding in the repo when it is source-
    anchored; ``symbol`` is the stable anchor (function qualname, traced
    entry name) that survives line drift; ``anchor`` disambiguates several
    findings of one rule in one symbol (a knob name, an alias pair).  The
    `fingerprint` — the baseline-file key — deliberately hashes only the
    stable parts (analyzer, code, path, symbol, anchor), never the message
    or line number, so suppressions survive refactors that move lines or
    reword diagnostics.
    """

    analyzer: str
    code: str
    severity: str
    message: str
    path: str = ""
    line: int = 0
    symbol: str = ""
    anchor: str = ""
    fix_hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"Finding severity must be one of {SEVERITIES}, "
                f"got {self.severity!r}."
            )

    @property
    def fingerprint(self) -> str:
        key = "|".join(
            (self.analyzer, self.code, self.path, self.symbol, self.anchor)
        )
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    @property
    def location(self) -> str:
        if self.path and self.line:
            return f"{self.path}:{self.line}"
        return self.path or self.symbol or "<package>"

    def to_dict(self) -> dict:
        return {
            "analyzer": self.analyzer,
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "location": self.location,
            "symbol": self.symbol,
            "anchor": self.anchor,
            "fix_hint": self.fix_hint,
            "fingerprint": self.fingerprint,
        }


class Skipped(Exception):
    """Raised by an analyzer that cannot run here (its input does not exist
    on this machine, e.g. no ``nvcc`` build log): the runner lists it under
    ``skipped`` with the reason, never as clean."""


# -- Analyzer registry --------------------------------------------------------


@dataclass(frozen=True)
class AnalyzerSpec:
    """Registry row: where the pass lives and when it is relevant.

    ``paths`` are repo-relative glob patterns used by ``--changed-only`` —
    the analyzer runs iff some changed file matches one of them (changes to
    the analysis framework or its scripts always select every analyzer).
    ``cost``: ``"ast"`` passes read source and data only, ``"trace"``
    passes drive the port's own code on the CPU (simulated ranks, a
    recording process group, a stream shim), ``"compile"`` passes read the
    CUDA compiler's report (the JAX package's are over jaxprs and HLO).
    """

    name: str
    module: str
    func: str
    title: str
    paths: tuple = ("implicitglobalgrid_tpu_torch/**",)
    cost: str = "ast"

    def load(self):
        mod = importlib.import_module(self.module)
        return getattr(mod, self.func)


#: The shipped analyzer suite.  Order = run + report order.
REGISTRY: dict[str, AnalyzerSpec] = {
    s.name: s
    for s in (
        AnalyzerSpec(
            name="collective-consistency",
            module="implicitglobalgrid_tpu_torch.analysis.collectives",
            func="run",
            title="cross-rank collective-consistency / SPMD-divergence "
            "detector (AST rank guards + the host-plan censuses)",
            paths=(
                "implicitglobalgrid_tpu_torch/ops/**",
                "implicitglobalgrid_tpu_torch/models/**",
                "implicitglobalgrid_tpu_torch/parallel/**",
                "implicitglobalgrid_tpu_torch/serving/**",
                "implicitglobalgrid_tpu_torch/supervisor/**",
                "implicitglobalgrid_tpu_torch/fleet/**",
                "implicitglobalgrid_tpu_torch/integrity/**",
                "implicitglobalgrid_tpu_torch/tuning/**",
                "implicitglobalgrid_tpu_torch/utils/**",
            ),
            cost="ast",
        ),
        AnalyzerSpec(
            name="knob-decl",
            module="implicitglobalgrid_tpu_torch.analysis.knobs",
            func="run_knob_decl",
            title="every IGG_* knob declared and documented in the port's "
            "utils/config.py",
            paths=("implicitglobalgrid_tpu_torch/**",),
            cost="ast",
        ),
        AnalyzerSpec(
            name="tune-cache-valid",
            module="implicitglobalgrid_tpu_torch.analysis.tunecache",
            func="run",
            title="committed autotuner seed entries parse against the "
            "schema and hold currently-admissible configs (tuning/entries)",
            paths=(
                "implicitglobalgrid_tpu_torch/tuning/**",
                # the tile checks ARE the admissibility ladder — a kernel
                # constraint change must re-validate the committed winners
                "implicitglobalgrid_tpu_torch/ops/**",
            ),
            cost="ast",
        ),
        AnalyzerSpec(
            name="stream-aliasing",
            module="implicitglobalgrid_tpu_torch.analysis.aliasing",
            func="run",
            title="every tensor a launch on another CUDA stream touches is waited for "
            "and record_stream'd; carry_in wrappers launch on the current stream",
            paths=("implicitglobalgrid_tpu_torch/models/**",
                   "implicitglobalgrid_tpu_torch/ops/**"),
            cost="ast",
        ),
        AnalyzerSpec(
            name="overlap-independence",
            module="implicitglobalgrid_tpu_torch.analysis.overlap",
            func="run",
            title="the pipelined group's mid pass waits for the group's input only, "
            "never for its exchange (stream shim)",
            paths=("implicitglobalgrid_tpu_torch/models/**",
                   "implicitglobalgrid_tpu_torch/ops/**"),
            cost="trace",
        ),
        AnalyzerSpec(
            name="collective-budget",
            module="implicitglobalgrid_tpu_torch.analysis.budget",
            func="run",
            title="each model's exchange holds its P2POps per dimension to the "
            "committed budget (recording process group)",
            paths=("implicitglobalgrid_tpu_torch/ops/**",
                   "implicitglobalgrid_tpu_torch/models/**",
                   "implicitglobalgrid_tpu_torch/parallel/**"),
            cost="trace",
        ),
        AnalyzerSpec(
            name="perm-validity",
            module="implicitglobalgrid_tpu_torch.analysis.perms",
            func="run",
            title="the exchange's (source, target) pairs form a partial permutation "
            "with matched receives on every simulated rank",
            paths=("implicitglobalgrid_tpu_torch/ops/**",
                   "implicitglobalgrid_tpu_torch/parallel/**"),
            cost="trace",
        ),
        AnalyzerSpec(
            name="grad-soundness",
            module="implicitglobalgrid_tpu_torch.analysis.gradflow",
            func="run",
            title="no detached input on a differentiable entry's grad_fn graph, and "
            "the backward sends cotangents back across blocks",
            paths=("implicitglobalgrid_tpu_torch/ops/**",
                   "implicitglobalgrid_tpu_torch/models/**"),
            cost="trace",
        ),
        AnalyzerSpec(
            name="cost-model",
            module="implicitglobalgrid_tpu_torch.analysis.costmodel",
            func="run",
            title="each program of the cost matrix holds its hops, payload bytes per hop, "
            "kernel launches and modeled HBM bytes to the committed cost baseline "
            "(simulated ranks)",
            paths=("implicitglobalgrid_tpu_torch/ops/**",
                   "implicitglobalgrid_tpu_torch/models/**",
                   "implicitglobalgrid_tpu_torch/parallel/**",
                   "implicitglobalgrid_tpu_torch/tuning/space.py"),
            cost="trace",
        ),
        AnalyzerSpec(
            name="ptxas-budget",
            module="implicitglobalgrid_tpu_torch.analysis.ptxas",
            func="run",
            title="registers, spills and shared memory per kernel entry against the "
            "committed ptxas baseline (needs nvcc)",
            paths=("implicitglobalgrid_tpu_torch/csrc/**",
                   "implicitglobalgrid_tpu_torch/ops/_kernels.py"),
            cost="compile",
        ),
        AnalyzerSpec(
            name="bench-regression",
            module="implicitglobalgrid_tpu_torch.analysis.perf",
            func="run",
            title="committed H100 bench trajectory within per-metric tolerance bands "
            "(scripts/check_perf.py; waivers in analysis/perf_waivers.json)",
            paths=("BENCH_H100_*.json", "implicitglobalgrid_tpu_torch/benchmarks/**"),
            cost="ast",
        ),
    )
}

#: Changes to the analysis subsystem itself select the whole suite.
_SELF_PATHS = ("implicitglobalgrid_tpu_torch/analysis/**",)


def available_analyzers() -> tuple[str, ...]:
    return tuple(REGISTRY)


def select_for_paths(changed: list[str]) -> list[str]:
    """Analyzer names relevant to the given repo-relative changed paths
    (the ``--changed-only`` fast mode).  Framework changes select all."""
    changed = [p.replace(os.sep, "/") for p in changed]
    if any(
        fnmatch.fnmatch(p, pat) for p in changed for pat in _SELF_PATHS
    ):
        return list(REGISTRY)
    return [
        name
        for name, spec in REGISTRY.items()
        if any(
            fnmatch.fnmatch(p, pat) for p in changed for pat in spec.paths
        )
    ]


# -- Context: lazily-built shared IRs -----------------------------------------


class Context:
    """Shared state of one analysis run.

    The package AST parse (`module_asts`) is built once and shared.
    ``package_root``/``repo_root`` are overridable so tests can point the
    passes at fixture packages.
    """

    def __init__(self, repo_root: str | None = None,
                 package_root: str | None = None):
        self.repo_root = repo_root or REPO_ROOT
        self.package_root = package_root or os.path.join(
            REPO_ROOT, "implicitglobalgrid_tpu_torch")
        self._asts = None

    def module_asts(self) -> dict:
        """``{repo-relative path: (source, ast.Module)}`` for every ``.py``
        under the package (parsed once per context)."""
        if self._asts is None:
            import ast

            out = {}
            for dirpath, dirnames, filenames in os.walk(self.package_root):
                dirnames[:] = [
                    d for d in dirnames if d not in ("__pycache__",)
                ]
                for name in sorted(filenames):
                    if not name.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, name)
                    rel = os.path.relpath(path, self.repo_root).replace(
                        os.sep, "/"
                    )
                    with open(path, encoding="utf-8") as f:
                        src = f.read()
                    out[rel] = (src, ast.parse(src, filename=rel))
            self._asts = out
        return self._asts


# -- Baseline (suppression file) ----------------------------------------------

#: Default baseline location: versioned next to the analyzers.
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json"
)


@dataclass
class Baseline:
    """Fingerprint -> justification suppressions.

    Every entry MUST carry a non-empty justification — the file is the audit
    trail for "we looked at this finding and decided it is intentional",
    never a mute button.
    """

    suppressions: dict[str, dict] = field(default_factory=dict)
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        sup = {}
        for entry in data.get("suppressions", []):
            fp = entry.get("fingerprint", "")
            just = (entry.get("justification") or "").strip()
            if not fp:
                raise ValueError(
                    f"baseline {path}: suppression without a fingerprint: "
                    f"{entry!r}"
                )
            if not just:
                raise ValueError(
                    f"baseline {path}: suppression {fp} has no "
                    f"justification — every baselined finding must say WHY "
                    f"it is acceptable."
                )
            sup[fp] = entry
        return cls(suppressions=sup, path=path)

    def match(self, finding: Finding) -> dict | None:
        return self.suppressions.get(finding.fingerprint)


# -- Report + runner ----------------------------------------------------------


@dataclass
class Report:
    """One run's outcome: active findings (severity-ordered), suppressed
    findings (baseline hits), stale suppressions (baseline entries that
    matched nothing — the tree moved on), per-analyzer stats, and the
    analyzers that ran/skipped."""

    findings: list = field(default_factory=list)
    suppressed: list = field(default_factory=list)
    stale_suppressions: list = field(default_factory=list)
    ran: list = field(default_factory=list)
    skipped: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)

    def counts(self) -> dict:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def exit_code(self, strict: bool = False) -> int:
        if self.errors:
            return 2
        failing = FAILING + (("WARNING",) if strict else ())
        return 1 if any(f.severity in failing for f in self.findings) else 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "findings": [f.to_dict() for f in self.findings],
                "suppressed": [
                    {**f.to_dict(), "justification": j}
                    for f, j in self.suppressed
                ],
                "stale_suppressions": self.stale_suppressions,
                "ran": self.ran,
                "skipped": self.skipped,
                "counts": self.counts(),
                "stats": self.stats,
                "errors": self.errors,
            },
            indent=2,
            sort_keys=True,
        )

    def human(self) -> str:
        lines = []
        order = {s: i for i, s in enumerate(SEVERITIES)}
        for f in sorted(
            self.findings, key=lambda f: (order[f.severity], f.location)
        ):
            lines.append(f"{f.severity:8s} [{f.analyzer}/{f.code}] "
                         f"{f.location}: {f.message}")
            if f.fix_hint:
                lines.append(f"         fix: {f.fix_hint}")
            lines.append(f"         fingerprint: {f.fingerprint}")
        if self.suppressed:
            lines.append(f"-- {len(self.suppressed)} baselined finding(s):")
            for f, j in self.suppressed:
                lines.append(
                    f"   {f.analyzer}/{f.code} @ {f.location} "
                    f"[{f.fingerprint}] — {j}"
                )
        for fp in self.stale_suppressions:
            lines.append(
                f"WARNING  baseline suppression {fp} matched no finding — "
                f"remove it (the tree moved on)."
            )
        for name, err in self.errors.items():
            lines.append(f"ERROR    analyzer {name} crashed: {err}")
        for name in self.skipped:
            why = self.stats.get(name, {}).get("skipped")
            if why:
                lines.append(f"SKIPPED  analyzer {name}: {why}")
        c = self.counts()
        summary = ", ".join(f"{c[s]} {s}" for s in SEVERITIES if c[s])
        lines.append(
            f"analysis: {len(self.ran)} analyzer(s) ran"
            + (f", {len(self.skipped)} skipped" if self.skipped else "")
            + (f" — {summary}" if summary else " — clean")
        )
        return "\n".join(lines)


def run(
    names=None,
    *,
    baseline: str | None = DEFAULT_BASELINE,
    changed_paths: list[str] | None = None,
    ctx: Context | None = None,
    keep_going: bool = False,
) -> Report:
    """Run analyzers and fold their findings through the baseline.

    ``names``: analyzer subset (None = all).  ``changed_paths``: restrict to
    analyzers whose declared paths intersect (the ``--changed-only`` mode) —
    applied on top of ``names``.  ``baseline``: suppression-file path (None
    = no suppression).  ``keep_going``: trap analyzer crashes into
    ``report.errors`` instead of raising (the CLI's behavior; the tier-1
    test raises so a broken analyzer fails loudly).
    """
    ctx = ctx or Context()
    wanted = list(names) if names else list(REGISTRY)
    unknown = [n for n in wanted if n not in REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown analyzer(s) {unknown}; available: {list(REGISTRY)}"
        )
    if changed_paths is not None:
        relevant = set(select_for_paths(changed_paths))
        selected = [n for n in wanted if n in relevant]
    else:
        selected = wanted

    report = Report(skipped=[n for n in wanted if n not in selected])
    base = Baseline.load(baseline) if baseline else Baseline()
    used = set()
    for name in selected:
        spec = REGISTRY[name]
        try:
            found = list(spec.load()(ctx))
        except Skipped as e:
            report.skipped.append(name)
            report.stats[name] = {"skipped": str(e)}
            continue
        except Exception as e:  # noqa: BLE001 — CLI surfaces, test raises
            if not keep_going:
                raise
            report.errors[name] = f"{type(e).__name__}: {e}"
            continue
        report.ran.append(name)
        for f in found:
            hit = base.match(f)
            if hit is not None:
                used.add(f.fingerprint)
                report.suppressed.append((f, hit["justification"]))
            else:
                report.findings.append(f)
    # Staleness is only decidable when EVERY registered analyzer ran and
    # none crashed — on a subset / --changed-only / keep_going-crash run,
    # an unmatched suppression usually belongs to an analyzer that never
    # produced its findings, and advising "remove it" would delete valid
    # entries.
    if not report.errors and set(report.ran) == set(REGISTRY):
        report.stale_suppressions = [
            fp for fp in base.suppressions if fp not in used
        ]
    return report


def changed_files(repo_root: str | None = None,
                  ref: str | None = None) -> list[str]:
    """Repo-relative changed paths — the ``--changed-only`` census.

    ``ref=None`` (the default): `git status --porcelain` — staged, worktree
    and untracked changes vs HEAD; empty when git is unavailable (no fast
    mode, back-compat).  ``ref="main"`` (or any committish): the union of
    the merge-base diff against ``ref`` AND the status paths — what a PR
    branch changed even on a CLEAN CI checkout, where `git status` selects
    nothing.  In ref mode a git failure RAISES instead of returning empty:
    silently selecting zero analyzers on a bad ref would green-light a PR
    that was never linted.
    """
    import subprocess

    root = repo_root or Context().repo_root

    def _git(*args) -> str:
        return subprocess.run(
            ["git", *args], cwd=root, capture_output=True, text=True,
            timeout=30, check=True,
        ).stdout

    paths = []
    try:
        status = _git("status", "--porcelain")
    except Exception as e:  # noqa: BLE001 — no git
        if ref is not None:
            raise RuntimeError(
                f"--changed-only={ref}: git status failed in {root}: {e}"
            ) from e
        return []
    for line in status.splitlines():
        if len(line) < 4:
            continue
        p = line[3:].strip()
        if " -> " in p:  # renames list "old -> new"
            p = p.split(" -> ", 1)[1]
        paths.append(p.strip('"'))
    if ref is None:
        return paths
    try:
        base = _git("merge-base", "HEAD", ref).strip()
        diff = _git("diff", "--name-only", base, "HEAD")
    except Exception as e:  # noqa: BLE001 — bad ref must not select zero
        raise RuntimeError(
            f"--changed-only={ref}: merge-base diff failed in {root} "
            f"(is {ref!r} a valid ref?): {e}"
        ) from e
    seen = set(paths)
    for p in diff.splitlines():
        p = p.strip()
        if p and p not in seen:
            seen.add(p)
            paths.append(p)
    return paths
