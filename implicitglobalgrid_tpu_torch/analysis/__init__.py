"""``igg.analysis`` — the port's static-analysis suite (the JAX package's
``analysis``, over what the port has to read).

Three analyzers, each a host pass over source or data (`core.REGISTRY`):

* ``collective-consistency`` — cross-rank collective-ordering divergence
  (the distributed-deadlock class): the AST rank-guard pass over the
  package, with the port's collective vocabulary, plus the per-simulated-
  rank censuses of the host plans (`tuning.search.control_plan`,
  `supervisor.policy.recovery_plan`, `fleet.policy.fleet_plan`,
  `integrity.plan.integrity_plan`);
* ``knob-decl`` — every ``IGG_*`` the package references is declared and
  documented in ``utils/config.py``;
* ``tune-cache-valid`` — the autotuner's committed seed layer parses and
  holds admissible configs.

Entry points: `run` (in-process), ``python -m
implicitglobalgrid_tpu_torch.analysis`` (CLI; SARIF with ``--sarif``),
``tests/test_torch_analysis.py``.  Findings, fingerprints, the baseline
file (``analysis/baseline.json``) and exit codes are the JAX package's.

Design note: the JAX passes and modules with no torch twin here.

**knob-binding.** In JAX it flags ``os.environ``/``IGG_*`` reads reachable
from jit/shard_map/Pallas-traced code, whose values are baked into a cached
executable at trace time.  The port runs eagerly and traces nothing: every
env read runs when its call runs, and the values a built step keeps
(``make_multi_step``'s closures, the autotuner's resolve) are read when it
is built, as documented.  The hazard returns with a captured CUDA graph,
which binds every value at capture; a twin would read the call graph from
the captured callable to its env reads, and comes with that graph (ROADMAP
Queue A leftover 8).

**pallas-aliasing.** In JAX it holds ``input_output_aliases`` and donation
declarations against the kernels' actual in-place writes.  The port's
kernels write fresh outputs, except a pipelined mid pass, which writes into
its ring pass's outputs (``carry_in``) on a second CUDA stream: there the
hazard is stream order and ``record_stream``, which no declaration states.
A twin would read the wrappers' and `models._fused`'s ASTs and require a
stream wait and a ``record_stream`` for every tensor a launch on another
stream writes or reads (leftover 12).

**overlap-independence.** In JAX it proves, on the traced program, that
the pipelined schedule's interior kernel does not depend on the group's
permutes.  The port's schedule is streams: the mid pass waits only for
the group's input, the exchange starts from the ring pass; a stray wait
would serialize it silently.  A twin would read the stream events of one
traced group (`utils.profiling`, ``chip_smoke.py`` phase 13b) and require
the mid pass to start before the exchange ends (leftover 12).

**collective-budget.** In JAX it bounds the ``ppermute`` count per
(dimension, width group) of the traced exchanges, and their bytes in HLO.
The port has the hazard (a coalescing regression sends one message per
field); its CPU tests count ``P2POp``s per dimension today
(``_workers._count_p2p``).  A twin would run each model's exchange on a
recording process group and hold the counts to a committed budget
(leftover 12).

**hlo-cost.** In JAX it holds a static HLO cost model (bytes, flops,
launches, peak buffers) of the production matrix against a versioned
baseline.  The port has no HLO; what its kernels cost is fixed by their
CUDA sources and read on the card.  The nearest twin would hold ``nvcc
-Xptxas -v``'s registers, spills and shared memory per kernel against a
committed baseline; it needs ``nvcc``, so it runs in ``chip_smoke.py``
phase 1, not in the CPU tests (leftover 12).

**grad-soundness.** In JAX it flags cotangent-dropping primitives on a
differentiable entry's tangent path and censuses the backward's
collectives.  The port's hazard is a cut autograd graph: its kernels are
forward-only (a kernel call under grad raises) and its exchange has an
explicit adjoint (`ops.halo._Exchange`); finite-difference tests pin both.
A twin would walk each differentiable entry's ``grad_fn`` graph for
detached inputs and count the backward's ``P2POp``s (leftover 12).

**bench-regression.** In JAX it holds the committed ``BENCH_r*.json``
trajectory within per-metric tolerance bands; its sibling
``tuning.seed_from_bench`` seeds winners from those records.  Both read
TPU numbers, which are not the port's; the port has no H100 bench records
and no ``BENCHMARK.json`` yet.  Both wait for those records (leftover 13).

**The traced collective checks.** In JAX they require each traced
``ppermute`` to be a valid partial permutation and no collective to sit
inside a ``cond``.  The port traces nothing: its point-to-point partners
come from `parallel.topology`'s neighbour table at run time, and Python
control flow is what the rank-guard pass reads.  A twin would evaluate the
exchange's (source, target) pairs on every simulated rank of small grids
and require a permutation per dimension and side (leftover 12).

**utils/aot.py.** JAX's ahead-of-time compilation for TPU topologies
without devices.  The port compiles its kernels with ``nvcc`` on first
use, keyed by a hash of source and flags (`ops._kernels`): nothing to
port, no twin needed.

**utils/compat.py.** JAX's shims over ``shard_map`` and Pallas APIs across
JAX versions.  The port calls torch's public API directly: no twin needed.

**utils/hlo_analysis.py.** JAX's parser of optimized HLO for byte and
collective censuses.  The port has no HLO; its byte counts are computed
from shapes (``chip_smoke.py``'s bounds, `tuning.space.modeled_cost`): no
twin needed.
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
