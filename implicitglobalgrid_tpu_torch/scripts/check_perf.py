#!/usr/bin/env python
"""check_perf — the perf-regression gate over the port's H100 bench
records, the port's copy of the JAX package's ``scripts/check_perf.py``.

Compares a candidate bench record against a reference within per-metric
tolerance bands.  Gated metrics are the headline plus every nested
`analysis.perf.GATED_KEYS` entry under ``extras``.  Defaults compare the
two newest parseable committed ``BENCH_H100_r<NN>.json`` rounds — the
self-consistency check the ``bench-regression`` pass also runs; pass
``--candidate`` to gate a FRESH record before committing it.

Examples::

    python -m implicitglobalgrid_tpu_torch.scripts.check_perf              # newest vs previous
    python -m implicitglobalgrid_tpu_torch.scripts.check_perf -c rec.json  # fresh vs newest
    python -m implicitglobalgrid_tpu_torch.benchmarks.bench --out rec.json && \\
        python -m implicitglobalgrid_tpu_torch.scripts.check_perf -c rec.json
    python -m implicitglobalgrid_tpu_torch.scripts.check_perf --tol 0.10 --json

Exit code: 0 = within tolerance (waived regressions listed), 1 = at least
one unwaived metric dropped beyond tolerance, 2 = the comparison is
impossible (missing or unparseable records, or two records of different
cards, power limits or headline metrics).  Waivers live in
``implicitglobalgrid_tpu_torch/analysis/perf_waivers.json`` — every entry
requires a justification; ``--strict-waivers`` also fails on STALE
waivers (entries that matched nothing).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..analysis.core import REPO_ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m implicitglobalgrid_tpu_torch.scripts.check_perf",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--candidate", default=None,
                   help="candidate record (BENCH wrapper or raw record JSON; default: the "
                        "newest committed round)")
    p.add_argument("--against", default=None,
                   help="reference record file (default: the newest committed round below "
                        "the candidate)")
    p.add_argument("--tol", type=float, default=None,
                   help="allowed fractional drop per metric (default 0.15)")
    p.add_argument("--waivers", default=None,
                   help="waiver file (default: the package waiver file)")
    p.add_argument("--json", action="store_true", help="JSON verdict")
    p.add_argument("--strict-waivers", action="store_true",
                   help="stale waivers (matching nothing) also fail")
    args = p.parse_args(argv)

    from ..analysis import perf

    tol = perf.DEFAULT_TOL if args.tol is None else args.tol
    # exit 2 = "comparison impossible" covers setup failures too: a typo'd
    # path or malformed waiver file must not read as a perf regression (1)
    try:
        waivers = perf.load_waivers(args.waivers or perf.PERF_WAIVERS)
    except (OSError, ValueError) as e:
        print(f"check_perf: cannot load waivers: {e}", file=sys.stderr)
        return 2

    records, skipped = perf.load_bench_records(REPO_ROOT)
    cand_round = None
    if args.candidate:
        try:
            cand = perf.parse_bench_file(args.candidate)
        except OSError as e:
            print(f"check_perf: cannot read {args.candidate}: {e}", file=sys.stderr)
            return 2
        if cand is None:
            print(f"check_perf: {args.candidate} holds no parseable bench record",
                  file=sys.stderr)
            return 2
    elif records:
        cand_round, cand = records[-1]
        records = records[:-1]
    else:
        print("check_perf: no parseable committed BENCH_H100 records", file=sys.stderr)
        return 2

    if args.against:
        try:
            ref = perf.parse_bench_file(args.against)
        except OSError as e:
            print(f"check_perf: cannot read {args.against}: {e}", file=sys.stderr)
            return 2
        ref_label = args.against
        if ref is None:
            print(f"check_perf: {args.against} holds no parseable bench record",
                  file=sys.stderr)
            return 2
    elif records:
        ref_round, ref = records[-1]
        ref_label = perf.record_name(ref_round)
    else:
        print("check_perf: no committed reference record to compare against",
              file=sys.stderr)
        return 2

    why = perf.comparability_error(cand, ref)
    if why is not None:
        print(f"check_perf: {why[0]}: {why[1]} ({ref_label}) — records of different cards, "
              f"power limits or headline metrics are not compared", file=sys.stderr)
        return 2

    cmp = perf.compare_metrics(
        perf.gate_metrics(cand), perf.gate_metrics(ref),
        tol=tol, waivers=waivers, candidate_round=cand_round,
    )
    used = {w["waiver_index"] for w in cmp["waived"]}
    stale = [w for i, w in enumerate(waivers) if i not in used]
    verdict = {
        "ok": not cmp["regressions"] and not (args.strict_waivers and stale),
        "reference": ref_label,
        "tol": tol,
        **cmp,
        "stale_waivers": [w["metric"] for w in stale],
        "skipped_records": skipped,
    }
    if args.json:
        print(json.dumps(verdict, indent=2, sort_keys=True))
    else:
        for reg in cmp["regressions"]:
            print(f"REGRESSION {reg['metric']}: {reg['reference']:.2f} -> "
                  f"{reg['candidate']:.2f} GB/s ({reg['drop']:.1%} drop, tolerance {tol:.0%})")
        for w in cmp["waived"]:
            print(f"waived     {w['metric']}: {w['drop']:.1%} drop — {w['justification']}")
        for m in cmp["missing"]:
            print(f"note       {m}: present in reference, absent from candidate "
                  f"(config retired?)")
        for w in stale:
            print(f"stale      waiver for {w['metric']} matched nothing — remove it")
        for s in skipped:
            print(f"note       {s}: unparseable record, skipped")
        state = "FAIL" if not verdict["ok"] else "OK"
        print(f"check_perf: {state} ({cmp['checked']} metric(s) vs {ref_label}, "
              f"tol {tol:.0%})")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
