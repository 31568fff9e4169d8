"""Cross-rank collective-consistency / SPMD-divergence detector.

Counterpart of the JAX package's ``analysis/collectives.py``.
``update_halo!`` in the reference (and every collective here) is only safe
because all ranks issue the same collectives in the same order; one rank
diverging — the JAX package's PR-1 ``_gather_chunked`` hang, where
non-root processes ran a different in-flight collective schedule than the
root — deadlocks the job.  The port runs eagerly, one Python process per
rank, so every collective it issues is a Python call: the divergence
channels are Python control flow and the host-side plans, and this
analyzer reads both:

1. **AST rank-guard pass** — any collective call lexically nested under
   ``if``/``while``/ternary control flow whose predicate mentions a
   rank-identity (``rank``, ``coords``, ``process_index``, ``is_root``,
   ``get_rank()``...) — or following an early exit under such a predicate
   — is exactly the hang class and is flagged CRITICAL.  The vocabulary is
   the port's: `torch.distributed`'s collectives and point-to-point calls,
   plus the port's own transport entry points (`COLLECTIVE_CALL_NAMES`).
2. **Host-plan census** — host-side orchestration exposes pure
   ``*_plan(is_root, ...)`` functions (the chunked gather, the autotuner's
   resolve, the supervisor's recovery, the fleet's directives, the
   integrity plane's guarded step), each evaluated per simulated rank (root and every
   non-root): the sequences must be identical.  Additional censuses
   register via `register_census_provider`.

The JAX package's third source, the traced-jaxpr perm and ``cond`` checks,
is the ``perm-validity`` analyzer here (`analysis.perms`): the port traces
nothing, so it runs the exchange's real send/receive code per simulated
rank, and Python control flow is what the rank-guard pass reads.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Context, Finding

ANALYZER = "collective-consistency"

#: Call names that issue (or wrap) a cross-rank collective:
#: `torch.distributed`'s collectives and point-to-point calls, and the
#: port's own transport entry points, so a guard ABOVE the torch call is
#: still caught at the call site that matters.
COLLECTIVE_CALL_NAMES = frozenset(
    {
        "broadcast",
        "all_reduce",
        "all_gather",
        "barrier",
        "send",
        "recv",
        "isend",
        "irecv",
        "batch_isend_irecv",
        "broadcast_object_list",
        "broadcast_control",
        "sync_all_processes",
        "update_halo",
        "gather",
    }
)

#: Identifier fragments that name a rank identity.  A predicate mentioning
#: one of these differs across ranks by construction.
RANKISH_NAMES = frozenset(
    {
        "rank",
        "myrank",
        "my_rank",
        "coords",
        "is_root",
        "process_index",
        "proc_id",
        "procid",
        "me",
    }
)

#: Calls whose result is a rank identity.
RANKISH_CALLS = ("process_index", "get_rank")


@dataclass
class RankCensus:
    """Per-rank ordered collective sequences of one entry point.

    ``sequences`` maps a rank key (process index, coords tuple, or any
    hashable label) to the ordered tuple of signature records that rank
    issues.  The divergence detector's invariant: ALL values are equal —
    one rank running a different sequence is the hang class.
    """

    name: str
    sequences: dict = field(default_factory=dict)


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _rankish_terms(test: ast.AST) -> list[str]:
    """Rank-identity terms mentioned in a predicate expression."""
    hits = []
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id.lower() in RANKISH_NAMES:
            hits.append(n.id)
        elif isinstance(n, ast.Attribute) and n.attr.lower() in RANKISH_NAMES:
            hits.append(n.attr)
        elif isinstance(n, ast.Call) and _call_name(n) in RANKISH_CALLS:
            hits.append(_call_name(n))
    return hits


def _always_exits(body: list) -> bool:
    """The statement list unconditionally leaves the enclosing block —
    ends in return/raise/continue/break (the early-exit guard idiom)."""
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


class _RankGuardVisitor(ast.NodeVisitor):
    """Find collective calls under rank-dependent Python control flow.

    Both guard shapes are covered: a collective lexically INSIDE a
    rank-conditioned branch, and the early-exit form — ``if rank != 0:
    return x`` followed by the collective — where every statement after
    the exiting branch runs only for the ranks that did not take it (the
    commonest shape of the PR-1 divergence).
    """

    def __init__(self, rel_path: str):
        self.rel = rel_path
        self.guards: list[tuple[ast.AST, list[str]]] = []
        self.func_stack: list[str] = []
        self.findings: list[Finding] = []

    def _with_guard(self, test, bodies):
        terms = _rankish_terms(test)
        if terms:
            self.guards.append((test, terms))
        for b in bodies:
            if isinstance(b, list):
                self._visit_block(b)
            else:
                self.visit(b)
        if terms:
            self.guards.pop()

    def _visit_block(self, stmts: list):
        """Visit a statement list; a rank-conditioned ``if`` whose taken
        branch always exits guards the REST of the block too."""
        pushed = 0
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                self.visit(stmt.test)
                self._with_guard(stmt.test, [stmt.body, stmt.orelse])
                terms = _rankish_terms(stmt.test)
                if terms and (
                    _always_exits(stmt.body) or _always_exits(stmt.orelse)
                ):
                    self.guards.append((stmt.test, terms))
                    pushed += 1
            else:
                self.visit(stmt)
        for _ in range(pushed):
            self.guards.pop()

    def visit_If(self, node: ast.If):
        # fallback for If nodes reached outside a _visit_block context
        self.visit(node.test)
        self._with_guard(node.test, [node.body, node.orelse])

    def visit_While(self, node: ast.While):
        self.visit(node.test)
        self._with_guard(node.test, [node.body, node.orelse])

    def visit_For(self, node: ast.For):
        self.visit(node.target)
        self.visit(node.iter)
        self._visit_block(node.body)
        self._visit_block(node.orelse)

    def visit_With(self, node: ast.With):
        for item in node.items:
            self.visit(item)
        self._visit_block(node.body)

    def visit_IfExp(self, node: ast.IfExp):
        self.visit(node.test)
        self._with_guard(node.test, [node.body, node.orelse])

    def _visit_func(self, node):
        self.func_stack.append(node.name)
        for dec in node.decorator_list:
            self.visit(dec)
        self._visit_block(node.body)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call):
        name = _call_name(node)
        if name in COLLECTIVE_CALL_NAMES and self.guards:
            terms = sorted({t for _, ts in self.guards for t in ts})
            qual = ".".join(self.func_stack) or "<module>"
            self.findings.append(
                Finding(
                    analyzer=ANALYZER,
                    code="rank-guarded-collective",
                    severity="CRITICAL",
                    message=(
                        f"collective `{name}` is issued under Python "
                        f"control flow conditioned on rank identity "
                        f"({', '.join(terms)}) — ranks taking different "
                        f"branches issue different collective sequences "
                        f"and deadlock (the _gather_chunked hang class)."
                    ),
                    path=self.rel,
                    line=node.lineno,
                    symbol=qual,
                    anchor=name,
                    fix_hint=(
                        "issue the collective unconditionally on every "
                        "rank and mask its RESULT per rank (torch.where / "
                        "contribute zeros), or lift the branch above the "
                        "collective so all ranks agree on it."
                    ),
                )
            )
        self.generic_visit(node)


def ast_findings(ctx: Context) -> list[Finding]:
    out = []
    for rel, (_src, tree) in ctx.module_asts().items():
        v = _RankGuardVisitor(rel)
        v.visit(tree)
        out.extend(v.findings)
    return out


# -- the divergence check ----------------------------------------------------


def check_rank_consistency(census: RankCensus) -> list[Finding]:
    """The core invariant: every rank's ordered collective sequence is
    identical.  Shared by the host-plan censuses and the seeded test
    fixtures."""
    items = sorted(census.sequences.items(), key=lambda kv: str(kv[0]))
    if not items:
        return []
    ref_rank, ref = items[0]
    out = []
    for rank, seq in items[1:]:
        if seq == ref:
            continue
        # first divergence position, for a actionable message
        i = next(
            (
                j
                for j in range(min(len(ref), len(seq)))
                if ref[j] != seq[j]
            ),
            min(len(ref), len(seq)),
        )
        at = (
            f"op {i}: rank {ref_rank} issues {ref[i]!r}, rank {rank} "
            f"issues {seq[i]!r}"
            if i < min(len(ref), len(seq))
            else f"rank {ref_rank} issues {len(ref)} collective(s), rank "
            f"{rank} issues {len(seq)}"
        )
        out.append(
            Finding(
                analyzer=ANALYZER,
                code="rank-divergent-sequence",
                severity="CRITICAL",
                message=(
                    f"entry `{census.name}`: collective sequences diverge "
                    f"across ranks — {at}.  A rank waiting in a collective "
                    f"its peers never issue hangs the fabric."
                ),
                symbol=census.name,
                anchor=str(rank),
                fix_hint=(
                    "make every rank issue the identical dispatch "
                    "sequence; rank-dependent work must happen host-side "
                    "on the fetched results, never in the collective "
                    "schedule."
                ),
            )
        )
        break  # one finding per entry; the first divergent rank names it
    return out


# -- host-plan census ---------------------------------------------------------

#: Census providers: callables ``ctx -> iterable[RankCensus]``.  Extensible
#: so host-side orchestration added later (and test fixtures) plug into the
#: same detector.
CENSUS_PROVIDERS: list = []


def register_census_provider(fn):
    """Register a ``ctx -> iterable[RankCensus]`` provider.  Returns ``fn``
    (decorator-friendly); remove with ``CENSUS_PROVIDERS.remove(fn)``."""
    CENSUS_PROVIDERS.append(fn)
    return fn


#: (dims, batch, root) grids the gather plan is simulated over (the JAX
#: package's): small, with a ragged tail and a non-default root.
_GATHER_PLAN_CONFIGS = (
    ((2, 2, 2), 3, 0),
    ((2, 2, 2), 8, 7),
    ((4, 2, 1), 3, 5),
    ((1,), 1, 0),
)


def gather_plan_censuses(ctx: Context):
    """The chunked gather's schedule per simulated rank.

    `ops.gather.collective_plan` is the single source of `_gather_chunked`'s
    chunk order; its ``is_root`` parameter exists precisely so this census
    can prove the schedule ignores it (the JAX package's PR-1 hang was
    non-roots running a different in-flight schedule than the root).
    """
    from ..ops.gather import collective_plan

    for dims, batch, root in _GATHER_PLAN_CONFIGS:
        nprocs = 1
        for d in dims:
            nprocs *= d
        yield RankCensus(
            name=f"host/gather_chunked[dims={dims},batch={batch},root={root}]",
            sequences={
                rank: tuple(("block_fetch",) + tuple(rec[1:])
                            for rec in collective_plan(dims, batch, is_root=(rank == root)))
                for rank in range(nprocs)
            },
        )


register_census_provider(gather_plan_censuses)


def tuning_plan_censuses(ctx: Context):
    """The autotuner resolve's host-transport schedule per simulated rank.

    `tuning.search.control_plan` is the single source of the resolve's
    dispatch order (cache-decision broadcast, then — on a miss — the
    measured candidates and the winner broadcast); its ``is_root``
    parameter exists precisely so this census can prove the schedule
    ignores rank identity AND rank-local cache state: a rank-keyed cache
    lookup (one rank's local hit skipping the measurement collectives its
    peers enter) is the `_gather_chunked` hang class wearing a tuner hat —
    the seeded positive fixture in ``tests/test_torch_analysis.py`` shows
    this detector catching exactly that divergence.
    """
    from ..tuning.search import control_plan

    for hit, n in ((True, 0), (False, 3), (False, 1), (False, 0)):
        yield RankCensus(
            name=f"host/tune_resolve[hit={hit},measured={n}]",
            sequences={
                rank: control_plan(is_root=(rank == 0), hit=hit,
                                   n_measured=n)
                for rank in range(4)
            },
        )


register_census_provider(tuning_plan_censuses)


def supervisor_plan_censuses(ctx: Context):
    """The supervised ranks' in-band recovery schedule per simulated rank.

    `supervisor.policy.recovery_plan` is the single source of the
    collective schedule applying one recovery directive implies (control
    broadcast + the checkpoint barriers for the resize family, nothing
    for out-of-band restarts); its ``is_root`` parameter exists precisely
    so this census can prove the schedule ignores rank identity, and its
    ``stale`` (fence) flag is rank-uniform by construction — a recovery
    decision keyed on rank identity or rank-LOCAL fence state (one stale
    rank skipping the checkpoint barriers its peers enter) is the
    `_gather_chunked` hang class wearing a supervisor hat.
    """
    from ..supervisor.policy import ACTIONS, recovery_plan

    for action in ACTIONS:
        for stale in (False, True):
            yield RankCensus(
                name=f"host/supervisor_recovery[action={action},"
                f"stale={stale}]",
                sequences={
                    rank: recovery_plan(
                        is_root=(rank == 0), action=action, stale=stale
                    )
                    for rank in range(4)
                },
            )


register_census_provider(supervisor_plan_censuses)


def fleet_plan_censuses(ctx: Context):
    """A pool's ranks' in-band fleet-directive schedule per simulated rank.

    `fleet.policy.fleet_plan` is the single source of the collective
    schedule a fleet action implies INSIDE the affected pool (the adopt/
    replay control broadcast for respawn and spill, the config-directive
    broadcast for the canary verdicts, the drain broadcast for retire —
    and NOTHING for quarantine, which is out-of-band by design); its
    ``is_root`` parameter exists precisely so this census can prove the
    schedule ignores rank identity, and its ``stale`` (fence) flag must
    gate all ranks or none — a zombie incarnation where one stale rank
    skips the broadcast its peers enter is the `_gather_chunked` hang
    class wearing a fleet hat.
    """
    from ..fleet.policy import FLEET_ACTIONS, fleet_plan

    for action in FLEET_ACTIONS:
        for stale in (False, True):
            yield RankCensus(
                name=f"host/fleet_plan[action={action},stale={stale}]",
                sequences={
                    rank: fleet_plan(
                        is_root=(rank == 0), action=action, stale=stale
                    )
                    for rank in range(4)
                },
            )


register_census_provider(fleet_plan_censuses)


def integrity_plan_censuses(ctx: Context):
    """The integrity plane's per-step schedule per simulated rank.

    `integrity.plan.integrity_plan` is the single source of what one
    guarded step's integrity observation implies on the wire: the
    transport checksum must add NO collective (the checksum word rides
    the existing halo payload; verification is a local recompute
    and a mismatch raises LOCALLY, escalated out-of-band through the
    ``sdc`` flight bundle), and the shadow audit's one replicated
    bit-compare reduction must key ONLY on the rank-uniform cadence
    (``IGG_INTEGRITY_EVERY`` via the env tier), never on a rank-local
    verdict — a rank-local integrity verdict driving a collective is the
    `_gather_chunked` hang class wearing an integrity hat.  ``is_root``
    exists precisely so this census can prove rank identity does not
    shape the schedule.
    """
    from ..integrity.plan import integrity_plan

    for checksums in (False, True):
        for audit_every, step in ((0, 5), (4, 4), (4, 5)):
            for dims in (1, 3):
                yield RankCensus(
                    name=f"host/integrity_plan[checksums={checksums},"
                    f"every={audit_every},step={step},dims={dims}]",
                    sequences={
                        rank: integrity_plan(
                            is_root=(rank == 0), checksums=checksums,
                            audit_every=audit_every, step=step,
                            exchange_dims=dims,
                        )
                        for rank in range(4)
                    },
                )


register_census_provider(integrity_plan_censuses)


def host_plan_findings(ctx: Context) -> list[Finding]:
    out = []
    for provider in list(CENSUS_PROVIDERS):
        for census in provider(ctx):
            out.extend(check_rank_consistency(census))
    return out


def run(ctx: Context) -> list[Finding]:
    return ast_findings(ctx) + host_plan_findings(ctx)
