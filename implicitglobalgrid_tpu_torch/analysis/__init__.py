"""``igg.analysis`` — the port's static-analysis suite (the JAX package's
``analysis``, over what the port has to read).

Eleven analyzers, each a host pass (`core.REGISTRY`):

* ``collective-consistency`` — cross-rank collective-ordering divergence
  (the distributed-deadlock class): the AST rank-guard pass over the
  package, with the port's collective vocabulary, plus the per-simulated-
  rank censuses of the host plans (`ops.gather.collective_plan`,
  `tuning.search.control_plan`, `supervisor.policy.recovery_plan`,
  `fleet.policy.fleet_plan`, `integrity.plan.integrity_plan`);
* ``knob-decl`` — every ``IGG_*`` the package references is declared and
  documented in ``utils/config.py``;
* ``tune-cache-valid`` — the autotuner's committed seed layer parses and
  holds admissible configs;
* ``stream-aliasing`` (JAX: pallas-aliasing) — every tensor a launch on a
  second CUDA stream touches is waited for and ``record_stream``'d, and
  the ``carry_in`` wrappers launch on the current stream (`aliasing`);
* ``overlap-independence`` — the pipelined group's mid pass waits for the
  group's input only, never for its exchange, and the received planes land
  after the join (the real schedule under a stream shim, `overlap`);
* ``collective-budget`` — each model's exchange holds its ``P2POp``s per
  dimension to the committed budget, per field and batched as controls
  (a recording process group, `budget`);
* ``perm-validity`` (JAX: the traced permutation checks) — the exchange's
  (source, target) pairs form a partial permutation with matched receives
  on every simulated rank (`perms`);
* ``grad-soundness`` — no detached input on a differentiable entry's
  ``grad_fn`` graph, and the backward sends cotangents back (`gradflow`);
* ``cost-model`` (JAX: hlo-cost, its host half) — each program of JAX's
  compiled matrix, run on every rank of a simulated grid, holds its hops,
  payload bytes per hop, kernel launches and modeled HBM bytes to the
  committed ``analysis/cost_baseline.json`` (`costmodel`; `reconcile` joins
  its modeled bytes to what T_eff counts);
* ``ptxas-budget`` (JAX: hlo-cost, its compiler half) — registers, spills,
  stack and shared memory per kernel entry against
  ``analysis/ptxas_baseline.json``; it needs a build of the kernels and
  reports itself skipped without one (`ptxas`);
* ``bench-regression`` — the committed ``BENCH_H100_r<NN>.json`` records
  (`benchmarks.bench` on the card): the newest round of the same card,
  power limit and headline metric as its predecessor, and within 15% of
  it on every gated throughput metric, modulo the justified waivers in
  ``analysis/perf_waivers.json`` (`perf`; the CLI is
  ``python -m implicitglobalgrid_tpu_torch.scripts.check_perf``).

Entry points: `run` (in-process), ``python -m
implicitglobalgrid_tpu_torch.analysis`` (CLI; SARIF with ``--sarif``;
``refresh`` rewrites the ptxas baseline, ``refresh cost`` the cost
baseline, each with a justification per change),
``tests/test_torch_analysis.py``, ``tests/test_torch_reconcile.py``.
Findings, fingerprints, the baseline file (``analysis/baseline.json``) and
exit codes are the JAX package's.

Design note: the JAX passes and modules with no torch twin here.

**knob-binding.** In JAX it flags ``os.environ``/``IGG_*`` reads reachable
from jit/shard_map/Pallas-traced code, whose values are baked into a cached
executable at trace time.  The port runs eagerly and traces nothing: every
env read runs when its call runs, and the values a built step keeps are
read when it is built, as documented.  The hazard returns with a captured
CUDA graph, which binds every value at capture; a twin would read the call
graph from the captured callable to its env reads, and comes with that
graph (ROADMAP Queue A leftover 8).

**ir.py.** JAX's traced and compiled IR of the config matrix (jaxprs,
optimized HLO).  The port has neither: its passes run the port's own code
on simulated ranks (`_sim`: `simulated_grid`, `recording_group`), which is
the twin of that role; the matrix's names and configs are copied into
`costmodel`.

**batch_hlo_ab, aot_weak_proxy** (JAX ``benchmarks/run.py:570``, ``:730``).
The first reads the collective-permutes of XLA's optimized HLO of the
batched exchange; its structural claim (B members, the unbatched hop count,
B times the payload) is the ``cost-model`` program
``exchange/porous[coalesce=True,batch=4]``.  The second compiles XLA's
program ahead of time for a 256-chip TPU topology; the port compiles
kernels, not programs, and its multi-GPU points wait for cards (leftover
3).  `benchmarks.run` refuses the ``batch_hlo`` mode by name, and
`benchmarks.bench` records both extras as skipped, with these reasons.

**utils/aot.py, utils/compat.py, utils/hlo_analysis.py.** JAX's
ahead-of-time compilation, version shims and HLO parser.  The port
compiles its kernels with ``nvcc`` on first use, keyed by a hash of source
and flags (`ops._kernels`), calls torch's public API directly, and has no
HLO (its byte counts come from shapes): no twin needed.
"""

from .core import (
    DEFAULT_BASELINE,
    FAILING,
    SEVERITIES,
    AnalyzerSpec,
    Baseline,
    Context,
    Finding,
    Report,
    available_analyzers,
    changed_files,
    run,
    select_for_paths,
)

__all__ = [
    "AnalyzerSpec",
    "Baseline",
    "Context",
    "DEFAULT_BASELINE",
    "FAILING",
    "Finding",
    "Report",
    "SEVERITIES",
    "available_analyzers",
    "changed_files",
    "run",
    "select_for_paths",
]
