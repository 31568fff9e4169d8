"""Cost-model analyzer (``cost-model``): the host half of the JAX package's
``hlo-cost`` (its other half, what the CUDA compiler states per kernel, is
``ptxas-budget``).

In JAX the pass reads the optimized HLO of the production config matrix
and pins per program its collective-permutes, their payload bytes per hop,
its fusions and the toolchain's ``bytes_accessed``.  The port has no HLO, so
this pass runs the port's real code on the CPU instead, once for every rank
of a simulated grid (`analysis._sim`: each rank's topology record, a
recording process group, receives zero-filled), and counts per program:

* **collective_permutes / collective_payload_bytes / collective_hop_bytes**
  — a hop is one shift of the whole grid, JAX's collective-permute: the
  sends that every rank issues from the same ``batch_isend_irecv`` call
  with the same tag.  Its payload is one rank's message (every rank's must
  be equal); ``collective_hop_bytes`` is the sorted multiset of the hops'
  payloads and ``collective_payload_bytes`` their sum;
* **bytes_accessed** — the modeled HBM traffic of the whole grid (every
  rank summed): each kernel launch at the kernels' one traffic model
  (`tuning.space.modeled_cost`, staggered fields at their ``n+1`` faces; a
  pipelined ring + mid pair counts as one launch), plus the plain-torch
  glue counted per operation (`traffic_counter`: every aten op that is not a view
  reads the tensors it takes and does not write, and writes its outputs or
  the tensors it mutates), plus the transport (a send reads its buffer, a
  receive writes its own);
* **kernel_launches** — the kernel wrappers' calls of rank 0's program, a
  ring and a mid launch each counting one (JAX counts custom-calls);
* **pipelined_split** — 1 where a ``pipelined=True`` cadence ran the
  split schedule, 0 where it fell back to the serialized one.

The programs are JAX's ``analysis/ir.py`` ``COMPILED_MATRIX``
(`PROGRAMS`), at its configs.  Baseline: ``analysis/cost_baseline.json``,
the port's own, with JAX's contract (`TOLERANCES`: structural counts exact,
the modeled bytes in a 2% band), rewritten only by ``python -m
implicitglobalgrid_tpu_torch.analysis refresh cost`` with a justification
per changed metric.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import warnings

from .core import Context, Finding

ANALYZER = "cost-model"

#: The committed baseline, versioned next to the analyzers.
COST_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cost_baseline.json")

#: Relative tolerance per metric (``"*"`` the default), JAX's contract:
#: structural counts are exact, the modeled bytes carry a band.
TOLERANCES = {"bytes_accessed": 0.02, "*": 0.0}

#: The program matrix (copy of JAX ``analysis/ir.py:373-393``).
EXCHANGE_PROGRAM = "exchange/porous[coalesce=True]"
BATCH_B = 4
BATCHED_EXCHANGE_PROGRAM = f"exchange/porous[coalesce=True,batch={BATCH_B}]"
BATCHED_CADENCE_PROGRAM = f"cadence/diffusion[batch={BATCH_B}]"
PROGRAMS = (
    EXCHANGE_PROGRAM,
    "cadence/diffusion[pipelined=True]",
    "cadence/acoustic[pipelined=True]",
    "cadence/porous[pipelined=True]",
    BATCHED_EXCHANGE_PROGRAM,
    BATCHED_CADENCE_PROGRAM,
)

#: The cadence configs (copy of JAX ``analysis/ir.py:615-622`` ``_CADENCES``):
#: local block, steps, kernel depth, ``fused_tile``, periods, PT iterations;
#: set up on a 2-rank x-split grid with overlap ``2k``, float32.
CADENCES = {
    "diffusion": dict(nloc=(40, 32, 128), nt=4, k=2, tile=(8, 16), periods={}),
    "acoustic": dict(nloc=(24, 32, 128), nt=4, k=2, tile=(8, 16), periods={"periodz": 1}),
    "porous": dict(nloc=(24, 32, 128), nt=2, k=2, tile=(8, 16), periods={"periodz": 1},
                   npt=5),
}
CADENCE_DIMS = (2, 1, 1)
MODEL_MODULES = {"diffusion": "diffusion3d", "acoustic": "acoustic3d",
                 "porous": "porous_convection3d"}
#: Each model's kernel wrapper, by its name in the model module.
KERNELS = {"diffusion": "fused_diffusion_steps", "acoustic": "fused_leapfrog_steps",
           "porous": "fused_pt_iterations"}
#: The exchange programs' grid (JAX ``analysis/ir.py:440-452``).
EXCHANGE_N, EXCHANGE_DIMS, EXCHANGE_PERIODS = 8, (2, 2, 2), (0, 0, 1)

STRUCTURAL = ("collective_permutes", "collective_payload_bytes", "collective_hop_bytes",
              "kernel_launches", "pipelined_split")


def model_module(model: str):
    return importlib.import_module(
        f"implicitglobalgrid_tpu_torch.models.{MODEL_MODULES[model]}")


def cadence_periods(model: str) -> tuple[int, int, int]:
    cfg = CADENCES[model]["periods"]
    return tuple(int(cfg.get(f"period{a}", 0)) for a in "xyz")


def cadence_setup_kwargs(model: str) -> dict:
    """``setup(..., init_grid=False)`` kwargs of one cadence config."""
    import torch

    kw = dict(init_grid=False, dtype=torch.float32)
    if "npt" in CADENCES[model]:
        kw["npt"] = CADENCES[model]["npt"]
    return kw


@contextlib.contextmanager
def cadence_grid(model: str):
    """Rank 0 of the cadence config's simulated 2-rank x-split grid."""
    from ._sim import simulated_grid

    k = CADENCES[model]["k"]
    with simulated_grid(CADENCES[model]["nloc"], CADENCE_DIMS, cadence_periods(model),
                        overlaps=(2 * k,) * 3) as gg:
        yield gg


# -- per-op traffic -------------------------------------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def traffic_counter():
    """A dispatch mode summing the bytes every aten op moves (``.bytes``),
    except while ``.paused``: an op that is not a view reads the tensors it
    takes and does not write, and writes its outputs, or the tensors it
    mutates; ``empty*`` allocations move nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.paused = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.__name__
            if self.paused or func.is_view or name.startswith(("empty", "new_empty")):
                return out
            schema = func._schema.arguments
            written = {a.name for a in schema if a.alias_info is not None
                       and a.alias_info.is_write}
            named = dict(zip((a.name for a in schema), args), **kwargs)
            moved = 0
            for value in named.values():
                for t in _tensors(value):
                    moved += _nbytes(t)  # read, or written in place
            if not written:
                moved += sum(_nbytes(t) for t in _tensors(out))
            self.bytes += moved
            return out

    return _Traffic()


# -- one program on every simulated rank ---------------------------------------


def _kernel_bytes(model: str, shape, ki: int, tile) -> int:
    """Modeled HBM bytes of one launch of ``ki`` steps at ``tile`` on a
    block (or a batch ``(B, *block)``) of ``shape``.  The cadence configs
    pin their tiles, so the count is the same for every card: the census is
    a host analysis with no device to choose."""
    import torch

    from ..tuning import space

    if tile is None:
        raise ValueError(f"{model}: a census launch needs the config's pinned tile")
    block, members = tuple(shape[-3:]), (shape[0] if len(shape) == 4 else 1)
    cost = space.modeled_cost(MODEL_MODULES[model], block, torch.float32,
                              {"fused_k": ki, "fused_tile": tuple(tile[:2])}, faces=True)
    return int(round(cost["bytes_per_step"] * ki)) * members


#: Where each kernel wrapper takes its ``k`` (its positional argument).
K_ARG = {"diffusion": 2, "acoustic": 4, "porous": 5}


@contextlib.contextmanager
def _counted_kernel(model: str, traffic, launches: dict):
    """Swap the model module's kernel wrapper for one that counts its
    launches (``launches["all"]``, ``launches["ring"]``) and adds each
    launch's modeled bytes to ``traffic``; the launch runs its plain
    version, uncounted."""
    mod = model_module(model)
    name = KERNELS[model]
    real = getattr(mod, name)

    def counted(*args, tile=None, tile_sel="all", carry_in=None):
        launches["all"] += 1
        traffic.paused = True
        try:
            out = real(*args, tile=tile, tile_sel=tile_sel, carry_in=carry_in)
        finally:
            traffic.paused = False
        launches["ring"] += tile_sel.startswith("ring")
        if not tile_sel.startswith("mid"):
            traffic.bytes += _kernel_bytes(model, args[0].shape, args[K_ARG[model]], tile)
        return out

    setattr(mod, name, counted)
    try:
        yield
    finally:
        setattr(mod, name, real)


def _per_rank(dims, run) -> list[dict]:
    """``run(traffic, launches)`` as every rank of ``dims`` on the current
    simulated grid, on a recording group; each rank's ``log``, bytes and
    launches."""
    import numpy as np

    from ._sim import recording_group, set_rank

    out = []
    for rank in range(int(np.prod(dims))):
        set_rank(rank, dims)
        traffic, launches = traffic_counter(), {"all": 0, "ring": 0}
        with recording_group() as (log, _), traffic:
            run(traffic, launches)
        sends = sum(nb for kind, _, _, nb, _ in log if kind == "send")
        out.append({"log": list(log), "bytes": traffic.bytes + sends,
                    "launches": launches["all"], "split": launches["ring"] > 0})
    return out


def hop_payloads(rank_sends) -> tuple[list[int], list[str]]:
    """The sorted payloads of one program's hops and what does not line up.
    ``rank_sends``: per rank, the ``(call, tag, nbytes)`` of its sends; a hop
    is one ``(call, tag)`` that some rank sends (JAX's collective-permute),
    its payload one rank's message, equal on every rank that sends it."""
    problems, hops = [], {}
    for sends in rank_sends:
        for call, tag, nbytes in sends:
            hops.setdefault((call, tag), set()).add(nbytes)
    for key, sizes in sorted(hops.items()):
        if len(sizes) > 1:
            problems.append(f"hop {key} carries {sorted(sizes)} bytes on different ranks")
    return sorted(max(s) for s in hops.values()), problems


def _hops(ranks: list[dict]) -> tuple[list[int], list[str]]:
    calls = {max((c for *_, c in r["log"]), default=-1) for r in ranks}
    problems = [] if len(calls) < 2 else [
        f"ranks issued different numbers of batch_isend_irecv calls ({sorted(calls)})"]
    hops, more = hop_payloads([(call, tag, nb) for kind, _, tag, nb, call in r["log"]
                               if kind == "send"] for r in ranks)
    return hops, problems + more


def _metrics(ranks: list[dict], split: bool = False) -> tuple[dict, list[str]]:
    hop_bytes, problems = _hops(ranks)
    out = {
        "collective_permutes": len(hop_bytes),
        "collective_payload_bytes": sum(hop_bytes),
        "collective_hop_bytes": hop_bytes,
        "bytes_accessed": sum(r["bytes"] for r in ranks),
        "kernel_launches": ranks[0]["launches"],
    }
    if split:
        out["pipelined_split"] = int(all(r["split"] for r in ranks))
    return out, problems


def exchange_program(batch: int | None = None, coalesce: bool = True):
    """The porous five-field exchange program (JAX ``analysis/ir.py:440``),
    ``batch`` members deep; ``coalesce=False`` is its per-field control."""
    import torch

    from ..models import _batched
    from ..ops.halo import update_halo
    from ._sim import simulated_grid
    from .budget import model_fields

    def run(traffic, launches):
        fields = model_fields("porous", EXCHANGE_N, batch, dtype=torch.float32)
        (update_halo if batch is None else _batched.update_halo)(
            *fields, width=1, coalesce=coalesce)

    n = EXCHANGE_N
    with simulated_grid((n, n, n), EXCHANGE_DIMS, EXCHANGE_PERIODS):
        return _metrics(_per_rank(EXCHANGE_DIMS, run))


def _cadence_program(model: str):
    cfg = CADENCES[model]
    mod = model_module(model)

    def run(traffic, launches):
        traffic.paused = True  # the set-up is not the program
        state, params = mod.setup(*cfg["nloc"], **cadence_setup_kwargs(model))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # an inadmissible split: pipelined_split 0
            step = mod.make_multi_step(params, cfg["nt"], fused_k=cfg["k"],
                                       fused_tile=cfg["tile"], pipelined=True)
            traffic.paused = False
            with _counted_kernel(model, traffic, launches):
                step(*state)

    with cadence_grid(model):
        return _metrics(_per_rank(CADENCE_DIMS, run), split=True)


def _batched_cadence_program(n: int = 8, nt: int = 2):
    """JAX ``analysis/ir.py:549`` ``_compile_batched_cadence_program``:
    ``make_multi_step(exchange_every=2, batch=True)`` on an overlap-4
    2-rank grid, B = `BATCH_B`."""
    import torch

    from ..models import _batched, diffusion3d
    from ._sim import simulated_grid

    def run(traffic, launches):
        traffic.paused = True
        bstate, params = _batched.batched_setup(diffusion3d, n, n, n, batch=BATCH_B,
                                                init_grid=False, dtype=torch.float32)
        step = diffusion3d.make_multi_step(params, nt, exchange_every=2, batch=True)
        traffic.paused = False
        step(*bstate)

    with simulated_grid((n, n, n), CADENCE_DIMS, overlaps=(4, 4, 4)):
        return _metrics(_per_rank(CADENCE_DIMS, run))


def program_census(name: str) -> tuple[dict, list[str]]:
    """``(metrics, problems)`` of one program of `PROGRAMS`."""
    if name == EXCHANGE_PROGRAM:
        return exchange_program()
    if name == BATCHED_EXCHANGE_PROGRAM:
        return exchange_program(BATCH_B)
    if name == BATCHED_CADENCE_PROGRAM:
        return _batched_cadence_program()
    for model in CADENCES:
        if name == f"cadence/{model}[pipelined=True]":
            return _cadence_program(model)
    raise ValueError(f"unknown program {name!r}; matrix: {PROGRAMS}")


def cost_census(programs=PROGRAMS) -> tuple[dict, list[Finding]]:
    """``({program: metrics}, findings)`` over ``programs``."""
    census, out = {}, []
    for name in programs:
        census[name], problems = program_census(name)
        for msg in problems:
            out.append(Finding(
                analyzer=ANALYZER, code="census-misaligned", severity="ERROR",
                message=f"{name}: {msg}: the hop census cannot pair the ranks' messages.",
                symbol=name, anchor="hops"))
    return census, out


# -- baseline ---------------------------------------------------------------------


def load_baseline(path: str = COST_BASELINE) -> dict:
    """The committed cost baseline (JAX's schema)::

        {"version": 1, "tolerances": {...},
         "programs": {name: {"metrics": {metric: value},
                             "justifications": {metric: note}}}}

    Every metric carries a justification (the file is an audit trail)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != 1:
        raise ValueError(f"cost baseline {path}: unsupported version "
                         f"{data.get('version')!r} (expected 1).")
    for name, prog in data.get("programs", {}).items():
        just = prog.get("justifications", {})
        missing = [m for m in prog.get("metrics", {}) if not (just.get(m) or "").strip()]
        if missing:
            raise ValueError(
                f"cost baseline {path}: program {name} has unjustified metric(s) {missing} "
                f"— refresh through `python -m implicitglobalgrid_tpu_torch.analysis refresh "
                f"cost --justify`.")
    return data


def _tolerance(metric: str, baseline: dict) -> float:
    tols = baseline.get("tolerances", TOLERANCES)
    return float(tols.get(metric, tols.get("*", 0.0)))


def within_band(old, new, tol: float) -> bool:
    if isinstance(old, list) or isinstance(new, list):
        return old == new
    return abs(float(new) - float(old)) <= tol * max(abs(float(old)), 1.0)


def compare_census(census: dict, baseline: dict) -> list[Finding]:
    """Findings of one census against a baseline (empty = clean).  A change
    in either direction fails: an improvement is news for the baseline."""
    out = []
    programs = baseline.get("programs", {})
    for name, prog in programs.items():
        got = census.get(name)
        if got is None:
            out.append(Finding(
                analyzer=ANALYZER, code="program-missing", severity="ERROR",
                message=f"baselined program {name} is missing from the census.",
                symbol=name, anchor="missing"))
            continue
        for metric, old in prog.get("metrics", {}).items():
            if metric not in got:
                out.append(Finding(
                    analyzer=ANALYZER, code="metric-lost", severity="ERROR",
                    message=f"{name}: baselined metric {metric} is absent from the census.",
                    symbol=name, anchor=metric))
                continue
            new, tol = got[metric], _tolerance(metric, baseline)
            if within_band(old, new, tol):
                continue
            if metric in STRUCTURAL:
                hint = "a hop more, a wider payload or a lost split changes the exchange"
                direction = "changed"
            else:
                hint = "an extra copy or pass"
                direction = "regressed" if new > old else "improved"
            out.append(Finding(
                analyzer=ANALYZER, code="cost-regression", severity="ERROR",
                message=(f"{name}: {metric} {direction} {old} -> {new} (tolerance {tol:.0%} "
                         f"of baseline; {hint}).  If intended, refresh via `python -m "
                         f"implicitglobalgrid_tpu_torch.analysis refresh cost --justify`."),
                symbol=name, anchor=metric))
        for metric in sorted(set(got) - set(prog.get("metrics", {}))):
            out.append(Finding(
                analyzer=ANALYZER, code="metric-unbaselined", severity="WARNING",
                message=f"{name}: census metric {metric}={got[metric]} has no baseline entry.",
                symbol=name, anchor=metric))
    for name in sorted(set(census) - set(programs)):
        out.append(Finding(
            analyzer=ANALYZER, code="program-unbaselined", severity="WARNING",
            message=f"program {name} has no baseline entry; refresh to gate it.",
            symbol=name, anchor="unbaselined"))
    return out


def run(ctx: Context) -> list[Finding]:
    census, out = cost_census()
    if not os.path.exists(COST_BASELINE):
        return out + [Finding(
            analyzer=ANALYZER, code="baseline-missing", severity="ERROR",
            message=f"cost baseline {COST_BASELINE} does not exist: run `python -m "
                    f"implicitglobalgrid_tpu_torch.analysis refresh cost`.",
            symbol="cost_baseline.json", anchor="missing")]
    return out + compare_census(census, load_baseline())


def refresh_main(argv=None) -> int:
    """``python -m implicitglobalgrid_tpu_torch.analysis refresh cost``:
    rewrite the cost baseline from a fresh census.  Exit 0 = written (or a
    clean dry run), 1 = a changed metric lacks a justification, 2 = the
    census found misaligned hops."""
    p = argparse.ArgumentParser(
        prog="python -m implicitglobalgrid_tpu_torch.analysis refresh cost",
        description=refresh_main.__doc__)
    p.add_argument("--justify", action="append", default=[], metavar="PROGRAM::METRIC=NOTE",
                   help="justification for one changed metric (repeatable)")
    p.add_argument("--justify-all", default=None, metavar="NOTE",
                   help="justification for every otherwise unjustified changed metric")
    p.add_argument("--dry-run", action="store_true", help="report changes, write nothing")
    p.add_argument("--out", default=None, help="output path (default: the committed baseline)")
    args = p.parse_args(argv)
    notes = {}
    for spec in args.justify:
        program, sep0, rest = spec.partition("::")  # program names hold "=", never "::"
        metric, sep, note = rest.partition("=")
        if not (sep0 and sep and note.strip()):
            p.error(f"--justify must be PROGRAM::METRIC=NOTE, got {spec!r}")
        notes[f"{program}::{metric.strip()}"] = note.strip()
    census, problems = cost_census()
    if problems:
        for f in problems:
            print(f"refresh: {f.message}", file=sys.stderr)
        return 2
    path = args.out or COST_BASELINE
    old = load_baseline(path) if os.path.exists(path) else {"programs": {}}
    old_p = old.get("programs", {})
    changed, missing, programs = [], [], {}
    for name, metrics in census.items():
        was = old_p.get(name, {})
        just = {}
        for metric, now in metrics.items():
            before = was.get("metrics", {}).get(metric)
            if before is not None and within_band(before, now, TOLERANCES.get(
                    metric, TOLERANCES["*"])):
                just[metric] = was.get("justifications", {}).get(metric, "")
                metrics[metric] = before
                continue
            key = f"{name}::{metric}"
            changed.append(f"{key}: {before} -> {now}")
            note = notes.get(key, args.justify_all)
            if note:
                just[metric] = note
            else:
                missing.append(key)
        programs[name] = {"metrics": metrics, "justifications": just}
    for name in sorted(set(old_p) - set(census)):
        changed.append(f"{name}: dropped")
    for line in changed:
        print(f"changed  {line}")
    if not changed:
        print("refresh: the census matches the committed baseline; nothing to refresh")
    if args.dry_run:
        return 0
    if missing:
        print("refresh: changed metrics need a justification (--justify PROGRAM::METRIC=NOTE "
              "or --justify-all NOTE):\n  " + "\n  ".join(missing), file=sys.stderr)
        return 1
    if not changed:
        return 0
    doc = {"version": 1,
           "_comment": ["Per program of the cost-model matrix, what the census counts on the "
                        "simulated grid: held by the cost-model analyzer (structural counts "
                        "exact, bytes_accessed within 2%).  Rewritten only by `python -m "
                        "implicitglobalgrid_tpu_torch.analysis refresh cost`, with a "
                        "justification per changed metric."],
           "tolerances": TOLERANCES, "programs": programs}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"refresh: wrote {path} ({len(programs)} programs)")
    return 0
