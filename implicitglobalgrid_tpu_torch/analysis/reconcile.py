"""Cost-model reconciliation report: achieved vs modeled traffic (the JAX
package's ``analysis/reconcile.py``).

The cost model (``cost-model``, `analysis.costmodel`) pins what each
production cadence MOVES — its modeled ``bytes_accessed`` — and the bench
records (`benchmarks.run`) pin what the card ACHIEVED — the ``T_eff``
convention, which counts only the must-stream bytes of the evolving state.
The join is one number per model::

    achieved_fraction = must_stream_bytes * iterations / bytes_accessed

the share of the program's modeled traffic that the T_eff convention counts
as mandatory.  A measured ``T_eff`` of X GB/s then implies the card
sustained ``X / achieved_fraction`` GB/s of modeled traffic (`join_measured`
attaches both to a bench record as its ``efficiency`` extra).  A fraction
above 1 is temporal blocking, not an error: a kernel advances ``k`` steps
per pass over HBM, so a step moves less than the convention counts.

Conventions are JAX's: diffusion streams T in+out per step; acoustic P, Vx,
Vy, Vz per step; porous Pf, qDx, qDy, qDz in+out per PT iteration
(``iterations = nt * npt``), each at its real shape (staggered ``n+1``
faces included; the bench's own T_eff counts cells only, like JAX's).  The
cadence configs are JAX's (`costmodel.CADENCES`): rank 0 of a simulated
2-rank x-split grid, float32.  A port field is one rank's block, so the
global must-stream bytes are the block's times the ranks, as JAX counts
its global arrays; the modeled bytes are summed over the ranks too.

``source="modeled"`` (JAX: ``"compiled"``; the port has no HLO) runs the
census afresh: the kernels at `tuning.space.modeled_cost` plus the
plain-torch glue per operation (the porous T update, the plain lead PT
iteration, the exchange's slab copies).  ``source="baseline"`` reads the
committed ``analysis/cost_baseline.json``.  Either way the census is a
host analysis on simulated CPU ranks at configs that pin their kernel
tiles, so it has no device to choose: the report is one set of numbers
per tree.

Caveat recorded in every report: the fraction is taken at the cadence
configs (small blocks, 2 ranks), where the kernels' window redundancy and
the halo share weigh differently from the bench sizes (256³ and 512³).
"""

from __future__ import annotations

import argparse
import json

from . import costmodel

#: The models covered (keys of `costmodel.CADENCES`).
MODELS = ("diffusion", "acoustic", "porous")

#: Per-model must-stream state slice in the state tuple's order (JAX
#: ``analysis/reconcile.py:51-55``; the porous state is (T, Pf, qDx, qDy,
#: qDz)).
_STREAM_SLICES = {
    "diffusion": slice(0, 1),   # T
    "acoustic": slice(0, 4),    # P, Vx, Vy, Vz
    "porous": slice(1, 5),      # Pf, qDx, qDy, qDz (per PT iteration)
}

NOTE = (
    "achieved_fraction = must-stream bytes / modeled bytes_accessed of the "
    "cadence config (small 2-rank blocks: the kernels' window redundancy and "
    "the halo share differ from the bench sizes); above 1 = temporal blocking "
    "(k steps per HBM pass), not an error; measured_teff / achieved_fraction "
    "= implied modeled GB/s the card sustained"
)


def cadence_program(model: str) -> str:
    return f"cadence/{model}[pipelined=True]"


def model_iterations(model: str) -> int:
    """Streaming iterations of one cadence program: ``nt`` steps, times
    ``npt`` PT iterations for porous (the unit its bench times)."""
    cfg = costmodel.CADENCES[model]
    return int(cfg["nt"]) * int(cfg.get("npt", 1))


def model_stream_bytes(model: str) -> dict:
    """Must-stream bytes per iteration of one cadence config:
    ``{stream_bytes, global_shape, dtype, fields}``.  The model is set up
    as rank 0 of the config's simulated grid; its stream slice's
    `utils.telemetry.teff_bytes` times the ranks is the global count."""
    from ..utils.telemetry import teff_bytes

    mod = costmodel.model_module(model)
    with costmodel.cadence_grid(model) as gg:
        state, _ = mod.setup(*costmodel.CADENCES[model]["nloc"],
                             **costmodel.cadence_setup_kwargs(model))
        fields = state[_STREAM_SLICES[model]]
        return {
            "stream_bytes": int(teff_bytes(fields)) * int(gg.nprocs),
            "global_shape": [int(s) for s in gg.nxyz_g],
            "dtype": str(fields[0].dtype).removeprefix("torch."),
            "fields": len(fields),
        }


def _program_costs(source: str) -> dict:
    """``{model: {"bytes_accessed", "flops"}}`` of the cadence programs
    (no flop model: ``flops`` is None)."""
    if source == "baseline":
        programs = costmodel.load_baseline().get("programs", {})
        return {model: {"bytes_accessed": programs.get(cadence_program(model), {}).get(
                    "metrics", {}).get("bytes_accessed"), "flops": None}
                for model in MODELS}
    if source == "modeled":
        census, _ = costmodel.cost_census([cadence_program(m) for m in MODELS])
        return {model: {"bytes_accessed": census[cadence_program(model)]["bytes_accessed"],
                        "flops": None} for model in MODELS}
    raise ValueError(f"source must be 'baseline' or 'modeled', got {source!r}")


def reconcile_report(*, source: str = "baseline") -> dict:
    """The achieved-vs-modeled report for the three models (JAX's keys).
    A model without modeled bytes reports ``achieved_fraction: None`` and
    says why."""
    costs = _program_costs(source)
    models = {}
    for model in MODELS:
        iters = model_iterations(model)
        stream = model_stream_bytes(model)
        rec = {"program": cadence_program(model), "iterations": iters, **stream,
               **costs[model]}
        ba = costs[model].get("bytes_accessed")
        if ba:
            rec["modeled_bytes_per_iteration"] = float(ba) / iters
            rec["achieved_fraction"] = round(stream["stream_bytes"] * iters / float(ba), 6)
        else:
            rec["achieved_fraction"] = None
            rec["note"] = (f"no bytes_accessed available from source={source!r} for "
                           f"{cadence_program(model)}")
        models[model] = rec
    return {"source": source, "note": NOTE, "models": models}


def join_measured(report: dict, measured_teff_gbs: dict,
                  measured_overlap: dict | None = None) -> dict:
    """Attach measured ``T_eff`` values (``{model: GB/s}``) to a report:
    ``measured_teff_gbs`` and ``modeled_actual_gbs`` (= measured /
    achieved_fraction) per model, and ``measured_overlap_fraction`` where
    ``measured_overlap`` has one; models without a measurement or a
    fraction pass through unchanged (JAX's `join_measured`)."""
    out = {"source": report.get("source"), "note": report.get("note"), "models": {}}
    for model, rec in report.get("models", {}).items():
        rec = dict(rec)
        teff = measured_teff_gbs.get(model)
        frac = rec.get("achieved_fraction")
        if teff is not None:
            rec["measured_teff_gbs"] = float(teff)
            if frac:
                rec["modeled_actual_gbs"] = round(float(teff) / frac, 3)
        if measured_overlap and measured_overlap.get(model) is not None:
            rec["measured_overlap_fraction"] = float(measured_overlap[model])
        out["models"][model] = rec
    return out


def main(argv=None) -> int:
    """CLI: print the report as one JSON line."""
    ap = argparse.ArgumentParser(
        prog="python -m implicitglobalgrid_tpu_torch.analysis.reconcile",
        description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=("baseline", "modeled"), default="modeled",
                    help="baseline: the committed cost_baseline.json numbers; modeled: a "
                         "fresh census of the cadence programs (default)")
    args = ap.parse_args(argv)
    print(json.dumps(reconcile_report(source=args.source)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
