"""Bench-regression analyzer (``bench-regression``; the JAX package's
``analysis/perf.py`` over the port's H100 records).

The port's perf evidence is the ``BENCH_H100_r<NN>.json`` trajectory at the
repo root: one raw record per round, written by
``python -m implicitglobalgrid_tpu_torch.benchmarks.bench`` on the card.
This module turns it into a machine-checked invariant, with JAX's
semantics:

* `load_bench_records` parses every committed ``BENCH_H100_r<NN>.json``
  (the run wrapper ``{"n", "parsed", "tail", ...}`` or a raw record),
  skipping rounds whose record is truncated beyond recovery — those are
  reported, never silently used.  ``BENCH_r<N>.json`` (the JAX package's
  TPU rounds) never matches: a TPU number is not the card's;
* `gate_metrics` flattens a record to its gated metrics: the headline
  ``value`` plus every `GATED_KEYS` entry in ``extras`` (throughput,
  higher-is-better — wall-time columns drift with the shared host and are
  deliberately NOT gated);
* `compare_metrics` fails a candidate metric that DROPS more than ``tol``
  (default 15%) below the reference, unless a waiver in
  ``analysis/perf_waivers.json`` covers it.  Every waiver REQUIRES a
  justification, and stale waivers are reported.

One adaptation: a record names the card it ran on (its ``device`` block:
``name`` and ``power_limit_w`` as ``nvidia-smi`` gives them).  Two records
of different cards or power limits, or of different headline ``metric``,
are not compared (`comparability_error`): `gate_summary` then returns
``ok`` with ``checked: 0`` and a ``note``, the registry pass reports
``device-mismatch`` or ``metric-mismatch``, and ``check_perf`` exits 2.

Consumers: ``python -m implicitglobalgrid_tpu_torch.scripts.check_perf``
(CLI gate — nonzero on regression), the ``bench-regression`` registry
pass (the committed trajectory itself must be self-consistent), and
`benchmarks.bench` (attaches an ``extras.perf_gate`` verdict to every
fresh record).  Host-only: imports no torch.
"""

from __future__ import annotations

import glob
import json
import os
import re

from .core import Context, Finding

ANALYZER = "bench-regression"

#: Allowed fractional DROP per metric vs the reference record.  One-sided:
#: improvements never fail (the next round's reference simply rises).
DEFAULT_TOL = 0.15

#: Machine-readable waiver file, next to the analyzers like baseline.json.
PERF_WAIVERS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "perf_waivers.json"
)

_ROUND_RE = re.compile(r"BENCH_H100_r(\d+)\.json$")


def record_name(round_n: int) -> str:
    """The committed file name of round ``round_n``."""
    return f"BENCH_H100_r{round_n:02d}.json"


def _rounds(repo_root: str) -> list:
    """``[(round, path)...]`` of every ``BENCH_H100_r<NN>.json`` under
    ``repo_root``, parseable or not, ascending."""
    found = []
    for path in glob.glob(os.path.join(repo_root, "BENCH_*.json")):
        m = _ROUND_RE.search(os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def next_round(repo_root: str) -> int:
    """The round a new record under ``repo_root`` takes: one past the
    highest committed (1 when there is none)."""
    rounds = _rounds(repo_root)
    return rounds[-1][0] + 1 if rounds else 1


# -- record discovery ---------------------------------------------------------


def parse_bench_file(path: str) -> dict | None:
    """The bench record inside one ``BENCH_H100_*.json`` (None =
    unrecoverable).

    Accepts the run wrapper (``parsed`` preferred, then a full-JSON
    ``tail``) and the raw record itself.
    """
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except ValueError:  # truncated mid-write: a skip-and-report, not a crash
        return None
    if not isinstance(data, dict):
        return None
    if "metric" in data and "extras" in data:
        return data
    rec = data.get("parsed")
    if isinstance(rec, dict) and "extras" in rec:
        return rec
    tail = data.get("tail", "")
    start = tail.find("{")  # the record is the line's first JSON object
    if start >= 0:
        try:
            # raw_decode: the record may be followed by trailing log text
            # (a normal capture shape) — only a TRUNCATED object fails
            rec, _ = json.JSONDecoder().raw_decode(tail[start:])
            if isinstance(rec, dict) and "extras" in rec:
                return rec
        except ValueError:
            pass
    return None


def load_bench_records(repo_root: str) -> tuple[list, list]:
    """``([(round, record)...] ascending, [unparseable paths])``."""
    records, skipped = [], []
    for round_n, path in _rounds(repo_root):
        rec = parse_bench_file(path)
        if rec is None:
            skipped.append(os.path.basename(path))
        else:
            records.append((round_n, rec))
    return records, skipped


#: extras keys gated as higher-is-better throughput metrics (JAX's):
#: ``teff``/``teff_grad`` GB/s; ``members_per_s`` the ensemble record;
#: ``rounds_per_s`` and the INVERSE submit-to-result latencies of the
#: front-door record (inverting makes "p99 got slower" a one-sided drop);
#: ``tuned_speedup`` the autotuner's closed loop (t_default / t_tuned).
GATED_KEYS = ("teff", "teff_grad", "members_per_s", "rounds_per_s",
              "result_p50_per_s", "result_p99_per_s", "tuned_speedup")


def _flatten(record: dict, keys) -> dict:
    """``{dotted extras path: value}`` of every numeric entry named in
    ``keys``, at any depth under ``extras``."""
    out = {}

    def walk(prefix: str, node) -> None:
        if not isinstance(node, dict):
            return
        for key, val in node.items():
            if key in keys and isinstance(val, (int, float)):
                out[f"{prefix}{key}"] = float(val)
            elif isinstance(val, dict):
                walk(f"{prefix}{key}.", val)

    walk("", record.get("extras", {}))
    return out


def gate_metrics(record: dict) -> dict:
    """Flatten one bench record to ``{metric path: value}`` for the gated
    throughput metrics (headline ``value`` + every nested `GATED_KEYS`
    entry under ``extras``; error-bearing extras contribute nothing)."""
    out = {}
    if isinstance(record.get("value"), (int, float)):
        out["headline"] = float(record["value"])
    out.update(_flatten(record, GATED_KEYS))
    return out


#: extras keys REPORTED beside the verdict but not gated (JAX's): the
#: reconcile join's ``achieved_fraction``, the raw front-door latencies,
#: the captured ``overlap_fraction`` and a traced request's critical-path
#: ``*_share`` split.
REPORTED_KEYS = ("achieved_fraction", "submit_to_result_p50_s",
                 "submit_to_result_p99_s", "overlap_fraction",
                 "queue_wait_share", "admission_share", "rounds_share",
                 "exchange_share", "checkpoint_share", "reroute_share",
                 "other_share")


def reported_metrics(record: dict) -> dict:
    """Flatten one bench record to ``{metric path: value}`` for the
    report-only keys (`REPORTED_KEYS`) — same walk as `gate_metrics`,
    no comparison semantics."""
    return _flatten(record, REPORTED_KEYS)


def comparability_error(candidate: dict, reference: dict) -> tuple[str, str] | None:
    """``(code, why)`` when the two records must not be compared, else None:
    ``device-mismatch`` (another card name or power limit; a missing
    ``device`` block reads as empty) or ``metric-mismatch`` (both carry a
    headline ``metric`` and they differ)."""
    cdev = candidate.get("device") or {}
    rdev = reference.get("device") or {}
    for field in ("name", "power_limit_w"):
        if cdev.get(field) != rdev.get(field):
            return ("device-mismatch",
                    f"device {field} {cdev.get(field)!r} is not the reference's "
                    f"{rdev.get(field)!r}")
    cm, rm = candidate.get("metric"), reference.get("metric")
    if cm is not None and rm is not None and cm != rm:
        return "metric-mismatch", f"metric {cm!r} is not the reference's {rm!r}"
    return None


# -- waivers ------------------------------------------------------------------


def load_waivers(path: str = PERF_WAIVERS) -> list[dict]:
    """Waiver entries (``[]`` when the file is absent).  Schema::

        {"waivers": [{"metric": "...", "justification": "...",
                      "max_drop": 0.5, "rounds": [5]}]}

    ``metric`` names a `gate_metrics` path; ``max_drop`` bounds the waived
    drop (a measured concession, not a blank check — default 1.0 = any
    drop); ``rounds`` restricts the waiver to specific candidate rounds
    (omit = any).  A waiver without a justification is an error.
    """
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    waivers = data.get("waivers", [])
    for w in waivers:
        if not (w.get("metric") or "").strip():
            raise ValueError(f"perf waiver without a metric: {w!r}")
        if not (w.get("justification") or "").strip():
            raise ValueError(
                f"perf waiver for {w['metric']!r} has no justification — "
                f"every waived regression must say WHY it is acceptable."
            )
    return waivers


def _waiver_for(metric: str, drop: float, round_n, waivers) -> dict | None:
    for w in waivers:
        if w["metric"] != metric:
            continue
        rounds = w.get("rounds")
        if rounds is not None and round_n not in rounds:
            # a round-scoped waiver covers ONLY those committed rounds; a
            # fresh --candidate record has no round (None)
            continue
        if drop <= float(w.get("max_drop", 1.0)):
            return w
    return None


# -- comparison ---------------------------------------------------------------


def compare_metrics(candidate: dict, reference: dict, *,
                    tol: float = DEFAULT_TOL, waivers=None,
                    candidate_round=None) -> dict:
    """Compare flattened metric maps.  Returns::

        {"regressions": [{metric, reference, candidate, drop}...],
         "waived":      [{..., "justification", "waiver_index"}...],
         "missing":     [metrics in reference absent from candidate],
         "checked":     n}

    Only metrics present in BOTH records are compared; reference metrics
    the candidate lost entirely are listed in ``missing``.
    """
    waivers = load_waivers() if waivers is None else waivers
    regressions, waived, missing = [], [], []
    checked = 0
    for metric, ref in sorted(reference.items()):
        if ref <= 0:
            continue
        if metric not in candidate:
            missing.append(metric)
            continue
        checked += 1
        cand = candidate[metric]
        drop = (ref - cand) / ref
        if drop <= tol:
            continue
        rec = {
            "metric": metric,
            "reference": ref,
            "candidate": cand,
            "drop": round(drop, 4),
        }
        w = _waiver_for(metric, drop, candidate_round, waivers)
        if w is not None:
            rec["justification"] = w["justification"]
            # which ENTRY matched: staleness is tracked per entry
            rec["waiver_index"] = waivers.index(w)
            waived.append(rec)
        else:
            regressions.append(rec)
    return {
        "regressions": regressions,
        "waived": waived,
        "missing": missing,
        "checked": checked,
    }


def gate_summary(candidate_record: dict, repo_root: str, *,
                 tol: float = DEFAULT_TOL) -> dict:
    """The bench hook: compare a FRESH record against the newest committed
    round.  Returns a JSON-ready verdict (never raises on an empty
    trajectory; a record of another card or headline metric is not
    compared: ``checked: 0`` and a ``note`` say why)."""
    records, skipped = load_bench_records(repo_root)
    if not records:
        return {"ok": True, "note": "no committed BENCH records to compare",
                "skipped_records": skipped}
    ref_round, ref_rec = records[-1]
    why = comparability_error(candidate_record, ref_rec)
    if why is not None:
        return {"ok": True, "checked": 0, "reference_round": ref_round,
                "note": f"{why[0]}: {why[1]} ({record_name(ref_round)}); nothing compared",
                "skipped_records": skipped}
    cmp = compare_metrics(
        gate_metrics(candidate_record), gate_metrics(ref_rec), tol=tol
    )
    return {
        "ok": not cmp["regressions"],
        "reference_round": ref_round,
        "tol": tol,
        **cmp,
        "reported": reported_metrics(candidate_record),
        "skipped_records": skipped,
    }


def run(ctx: Context) -> list[Finding]:
    """Registry pass: the COMMITTED trajectory must be self-consistent —
    the newest parseable round comparable with, and within tolerance of,
    its predecessor (modulo waivers).  The live gate for fresh records is
    ``python -m implicitglobalgrid_tpu_torch.scripts.check_perf``."""
    records, skipped = load_bench_records(ctx.repo_root)
    out = []
    for name in skipped:
        out.append(
            Finding(
                analyzer=ANALYZER,
                code="unparseable-record",
                severity="ERROR",
                message=(
                    f"{name} holds no parseable bench record — the gate "
                    f"cannot audit it, so the round merges sight-unseen.  "
                    f"Re-emit the record, or baseline the truncation with "
                    f"a justification."
                ),
                symbol=name,
                anchor="unparseable",
            )
        )
    if len(records) < 2:
        return out  # one (or zero) records: nothing to regress from
    (prev_round, prev), (cand_round, cand) = records[-2], records[-1]
    why = comparability_error(cand, prev)
    if why is not None:
        # the newest round cannot be gated against its predecessor: the
        # trajectory has a blind spot, which someone must look at
        out.append(
            Finding(
                analyzer=ANALYZER,
                code=why[0],
                severity="ERROR",
                message=(
                    f"{record_name(cand_round)}: {why[1]} in "
                    f"r{prev_round:02d} — the round cannot be gated.  "
                    f"Re-measure on the reference's card, or baseline the "
                    f"change with a justification."
                ),
                symbol=f"r{cand_round:02d}",
                anchor=why[0],
            )
        )
        return out
    cmp = compare_metrics(
        gate_metrics(cand), gate_metrics(prev),
        candidate_round=cand_round,
    )
    for reg in cmp["regressions"]:
        out.append(
            Finding(
                analyzer=ANALYZER,
                code="perf-regression",
                severity="ERROR",
                message=(
                    f"BENCH_H100_r{cand_round:02d}: {reg['metric']} dropped "
                    f"{reg['drop']:.1%} vs r{prev_round:02d} "
                    f"({reg['reference']:.2f} -> {reg['candidate']:.2f} "
                    f"GB/s, tolerance {DEFAULT_TOL:.0%}) — waive it in "
                    f"analysis/perf_waivers.json with a justification, or "
                    f"fix the regression."
                ),
                symbol=f"r{cand_round:02d}",
                anchor=reg["metric"],
            )
        )
    for metric in cmp["missing"]:
        # a gated metric that vanished from the newest round: a regression
        # can hide by deleting its benchmark
        out.append(
            Finding(
                analyzer=ANALYZER,
                code="metric-vanished",
                severity="ERROR",
                message=(
                    f"BENCH_H100_r{cand_round:02d}: gated metric {metric} "
                    f"(present in r{prev_round:02d}) is absent — a "
                    f"regression can hide by dropping its benchmark.  "
                    f"Re-measure the config, or baseline the retirement "
                    f"with a justification."
                ),
                symbol=f"r{cand_round:02d}",
                anchor=metric,
            )
        )
    return out
