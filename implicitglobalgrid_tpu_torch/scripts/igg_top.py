#!/usr/bin/env python
"""Cluster view over per-rank live-plane endpoints — the port's copy of the
JAX package's ``scripts/igg_top.py`` (stdlib only).

Each rank's ``IGG_METRICS_PORT`` server (`implicitglobalgrid_tpu_torch.utils.liveplane`)
exposes ``/metrics`` (Prometheus text) and ``/healthz`` (JSON).  This tool
scrapes any set of them into ONE cluster view: a merged exposition with
``rank`` labels, and a terminal summary table (per-rank step p50/p99,
T_eff, skew, last-step age, alerts) — the live answer to "which rank is
slow" without waiting for a trace merge::

    python -m implicitglobalgrid_tpu_torch.scripts.igg_top host0:9100 host1:9100
    python -m implicitglobalgrid_tpu_torch.scripts.igg_top --dir $IGG_TELEMETRY_DIR
    python -m implicitglobalgrid_tpu_torch.scripts.igg_top --endpoints-file endpoints.txt
    python -m implicitglobalgrid_tpu_torch.scripts.igg_top --dir RUN --watch 2
    python -m implicitglobalgrid_tpu_torch.scripts.igg_top --dir RUN --prom merged.prom

``--dir`` reads the ``liveplane.p<rank>.json`` endpoint files each rank
writes into ``IGG_TELEMETRY_DIR`` when it binds an ephemeral port — the
discovery channel for port-0 runs (the soak ``live_plane`` scenario uses
exactly this).  A scrape retries with exponential backoff (``--retries``,
default ``IGG_FLEET_SCRAPE_RETRIES`` or 2) before the rank is declared
``UNREACHABLE``; unreachable ranks get an explicit table row.  Output and
exit codes are the JAX tool's: 0 all endpoints scraped, 1 any endpoint
unreachable, 2 bad usage.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
import urllib.request

SCRAPE_TIMEOUT_S = 3.0
DEFAULT_RETRIES = 2
RETRY_BACKOFF_S = 0.25
UNREACHABLE = "UNREACHABLE"

_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


# ---------------------------------------------------------------------------
# endpoint discovery
# ---------------------------------------------------------------------------


def discover_endpoints(args) -> list[str]:
    """``host:port`` list from positional args / --endpoints-file / --dir."""
    endpoints = list(args.endpoints)
    if args.endpoints_file:
        with open(args.endpoints_file) as f:
            endpoints += [
                line.strip()
                for line in f
                if line.strip() and not line.startswith("#")
            ]
    if args.dir:
        files = sorted(glob.glob(os.path.join(args.dir, "liveplane.p*.json")))
        if not files:
            raise FileNotFoundError(
                f"{args.dir}: no liveplane.p*.json endpoint files (is the "
                f"run up with IGG_METRICS_PORT and IGG_TELEMETRY_DIR set?)"
            )
        for path in files:
            with open(path) as f:
                doc = json.load(f)
            endpoints.append(f"{doc['host']}:{doc['port']}")
    if not endpoints:
        raise ValueError(
            "no endpoints: pass host:port arguments, --endpoints-file or "
            "--dir"
        )
    return endpoints


def scrape(endpoint: str, *, retries: int | None = None,
           backoff_s: float = RETRY_BACKOFF_S) -> dict:
    """One rank's ``{health, metrics}``.

    Retries ``retries`` times with exponential backoff (``backoff_s``,
    ``2*backoff_s``, ...) before re-raising — a rank mid-GC or with a
    momentarily full accept queue is busy, not dead.  ``retries=None``
    reads ``IGG_FLEET_SCRAPE_RETRIES`` (shared with the fleet router's
    health scraper) and falls back to ``DEFAULT_RETRIES``.
    """
    if retries is None:
        raw = os.environ.get("IGG_FLEET_SCRAPE_RETRIES", "")
        retries = int(raw) if raw.strip() else DEFAULT_RETRIES
    last: Exception | None = None
    for attempt in range(max(0, retries) + 1):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            with urllib.request.urlopen(
                f"http://{endpoint}/healthz", timeout=SCRAPE_TIMEOUT_S
            ) as r:
                health = json.load(r)
            with urllib.request.urlopen(
                f"http://{endpoint}/metrics", timeout=SCRAPE_TIMEOUT_S
            ) as r:
                metrics = r.read().decode()
            return {"endpoint": endpoint, "health": health,
                    "metrics": metrics}
        except Exception as e:  # noqa: BLE001 — any failure is retryable
            last = e
    raise last


# ---------------------------------------------------------------------------
# merged exposition
# ---------------------------------------------------------------------------


def merge_expositions(per_rank: dict[int, str]) -> str:
    """Join per-rank Prometheus text into one exposition with rank labels.

    Sample lines gain (or extend) a label set with ``rank="N"``; each
    metric's ``# TYPE`` header is emitted once.  The output stays valid
    text format 0.0.4, so one igg_top scrape can stand in for N direct
    scrapes in any collector.
    """
    types: dict[str, str] = {}
    samples: list[tuple[str, str]] = []
    for rank in sorted(per_rank):
        for line in per_rank[rank].splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("# TYPE "):
                parts = line.split()
                if len(parts) == 4:
                    types.setdefault(parts[2], parts[3])
                continue
            if line.startswith("#"):
                continue
            m = _SAMPLE.match(line)
            if not m:
                continue
            name, labels, value = m.groups()
            inner = labels[1:-1] if labels else ""
            inner = f'rank="{rank}"' + (f",{inner}" if inner else "")
            samples.append((name, f"{name}{{{inner}}} {value}"))
    out: list[str] = []
    emitted: set[str] = set()
    for name, line in samples:
        if name not in emitted:
            emitted.add(name)
            t = types.get(name)
            if t:
                out.append(f"# TYPE {name} {t}")
        out.append(line)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# summary table
# ---------------------------------------------------------------------------


def _fmt(v, scale=1.0, suffix="", nd=1) -> str:
    if v is None:
        return "-"
    return f"{v * scale:.{nd}f}{suffix}"


def _reject_rate(frontdoor: dict) -> str | None:
    """``"NN%(tenant)"`` — overall reject share, tagged with the worst
    tenant by reject count (the per-tenant quota/backpressure attribution
    the front door's capped counters carry)."""
    admitted = frontdoor.get("admitted_total") or 0
    rejected = frontdoor.get("rejected_total") or 0
    total = admitted + rejected
    if not total:
        return None
    pct = f"{100.0 * rejected / total:.0f}%"
    tenants = frontdoor.get("tenants") or {}
    worst = max(
        tenants, key=lambda t: tenants[t].get("rejected", 0), default=None
    )
    if worst is not None and tenants[worst].get("rejected", 0) > 0:
        return f"{pct}({worst})"
    return pct


def summary_rows(healths: dict[int, dict]) -> list[dict]:
    """One summary row per rank from its ``/healthz`` document (incl. the
    ``serving``/``frontdoor`` SLO columns — queue depth, pool occupancy,
    round p50/p99, per-tenant reject rate — so one screen answers
    "is serving healthy" across ranks, ISSUE 12)."""
    rows = []
    for rank in sorted(healths):
        h = healths[rank]
        slo = h.get("slo", {})
        step = next(
            (s for n, s in slo.items() if n.endswith("step_seconds")), {}
        )
        teff = next(
            (s for n, s in slo.items() if n.endswith("t_eff_gbs")), {}
        )
        rnd = next(
            (s for n, s in slo.items() if n.endswith("round_seconds")), {}
        )
        serving = h.get("serving") or {}
        frontdoor = h.get("frontdoor") or {}
        active = h.get("alerts", {}).get("active", [])
        occupancy = None
        if serving.get("active_members") is not None:
            cap = serving.get("capacity")
            occupancy = (
                f"{serving['active_members']:.0f}/{cap:.0f}"
                if cap is not None else f"{serving['active_members']:.0f}"
            )
        rows.append(
            {
                "rank": rank,
                "ok": h.get("ok"),
                "coords": h.get("coords"),
                "step": h.get("last_step", {}).get("step"),
                "age_s": h.get("last_step", {}).get("age_s"),
                "p50_ms": (step.get("p50") or 0) * 1e3 if step else None,
                "p99_ms": (step.get("p99") or 0) * 1e3 if step else None,
                "teff_gbs": teff.get("p50") if teff else None,
                "skew": h.get("skew", {}).get("step_seconds_max_over_min"),
                "queue": serving.get("queue_depth"),
                "members": occupancy,
                "oldest_s": serving.get("oldest_request_age_s"),
                "rnd_p50_ms": (rnd.get("p50") or 0) * 1e3 if rnd else None,
                "rnd_p99_ms": (rnd.get("p99") or 0) * 1e3 if rnd else None,
                "reject": _reject_rate(frontdoor),
                "alerts": ",".join(
                    f"{a['rule']}({a['severity']})" for a in active
                ) or "-",
            }
        )
    return rows


def render_table(rows: list[dict]) -> str:
    head = (
        f"{'rank':>4} {'ok':>4} {'step':>8} {'age':>8} {'p50':>9} "
        f"{'p99':>9} {'T_eff':>9} {'skew':>6} {'queue':>6} {'mem':>7} "
        f"{'oldest':>8} {'rnd50':>8} {'rnd99':>8} {'rej':>10}  alerts"
    )
    lines = [head, "-" * len(head)]
    for r in rows:
        if r["ok"] == UNREACHABLE:
            # explicit row state: the hole in the fleet stays on the
            # screen the operator is watching, aligned with its rank
            lines.append(
                f"{r['rank']:>4} {'DOWN':>4} "
                + " ".join(["-".rjust(w) for w in (8, 8, 9, 9, 9, 6, 6,
                                                   7, 8, 8, 8, 10)])
                + f"  {UNREACHABLE} {r['alerts']}"
            )
            continue
        lines.append(
            f"{r['rank']:>4} {('ok' if r['ok'] else 'ALRT'):>4} "
            f"{r['step'] if r['step'] is not None else '-':>8} "
            f"{_fmt(r['age_s'], suffix='s'):>8} "
            f"{_fmt(r['p50_ms'], suffix='ms'):>9} "
            f"{_fmt(r['p99_ms'], suffix='ms'):>9} "
            f"{_fmt(r['teff_gbs'], suffix='GB', nd=2):>9} "
            f"{_fmt(r['skew'], nd=2):>6} "
            f"{_fmt(r.get('queue'), nd=0):>6} "
            f"{r.get('members') or '-':>7} "
            f"{_fmt(r.get('oldest_s'), suffix='s'):>8} "
            f"{_fmt(r.get('rnd_p50_ms'), suffix='ms'):>8} "
            f"{_fmt(r.get('rnd_p99_ms'), suffix='ms'):>8} "
            f"{r.get('reject') or '-':>10}  {r['alerts']}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def scrape_cluster(endpoints: list[str], *,
                   retries: int | None = None) -> tuple[dict, list[str]]:
    """``({rank: scrape result}, [unreachable endpoint messages])``."""
    by_rank: dict[int, dict] = {}
    errors: list[str] = []
    for i, ep in enumerate(endpoints):
        try:
            res = scrape(ep, retries=retries)
        except Exception as e:
            errors.append(f"{ep}: {type(e).__name__}: {e}")
            continue
        rank = res["health"].get("rank", i)
        by_rank[rank] = res
    return by_rank, errors


def one_view(args, endpoints: list[str]) -> int:
    by_rank, errors = scrape_cluster(
        endpoints, retries=getattr(args, "retries", None)
    )
    healths = {r: res["health"] for r, res in by_rank.items()}
    rows = summary_rows(healths)
    for msg in errors:
        rows.append({
            "rank": "?", "ok": UNREACHABLE, "coords": None, "step": None,
            "age_s": None, "p50_ms": None, "p99_ms": None, "teff_gbs": None,
            "skew": None, "queue": None, "members": None, "oldest_s": None,
            "rnd_p50_ms": None, "rnd_p99_ms": None, "reject": None,
            "alerts": msg,
        })
    print(
        f"igg_top — {len(by_rank)}/{len(endpoints)} rank(s) at "
        f"{time.strftime('%H:%M:%S')}"
    )
    print(render_table(rows))
    for msg in errors:
        print(f"igg_top: UNREACHABLE {msg}", file=sys.stderr)
    if args.prom:
        merged = merge_expositions(
            {r: res["metrics"] for r, res in by_rank.items()}
        )
        with open(args.prom, "w", encoding="utf-8") as f:
            f.write(merged)
        print(f"igg_top: wrote merged exposition {args.prom}", file=sys.stderr)
    if args.json:
        print(json.dumps({"ranks": healths, "errors": errors}, default=str))
    return 1 if errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m implicitglobalgrid_tpu_torch.scripts.igg_top",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("endpoints", nargs="*", help="host:port endpoints")
    ap.add_argument("--endpoints-file", help="file of host:port lines")
    ap.add_argument("--dir", help="telemetry dir holding liveplane.p*.json")
    ap.add_argument("--watch", type=float, metavar="SECONDS",
                    help="refresh the view every SECONDS until interrupted")
    ap.add_argument("--retries", type=int, default=None, metavar="N",
                    help="scrape retries with exponential backoff before an "
                         "endpoint is declared UNREACHABLE (default: "
                         "IGG_FLEET_SCRAPE_RETRIES or 2)")
    ap.add_argument("--prom", help="write the merged rank-labeled exposition")
    ap.add_argument("--json", action="store_true",
                    help="also print the cluster health view as one JSON line")
    args = ap.parse_args(argv)
    try:
        endpoints = discover_endpoints(args)
    except (OSError, ValueError) as e:
        print(f"igg_top: {e}", file=sys.stderr)
        return 2
    if not args.watch:
        return one_view(args, endpoints)
    try:
        while True:
            print("\x1b[2J\x1b[H", end="")  # clear screen, home cursor
            one_view(args, endpoints)
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
