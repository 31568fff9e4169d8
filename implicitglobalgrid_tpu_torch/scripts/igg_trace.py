#!/usr/bin/env python
"""Merge / validate per-rank igg trace files — the port's copy of the JAX
package's ``scripts/igg_trace.py``, over `implicitglobalgrid_tpu_torch.utils.tracing`.

``igg.dump_trace(dir)`` leaves one ``trace.p<rank>.json`` per process;
this tool joins any set of them into ONE Chrome-trace/Perfetto JSON on the
shared barrier-aligned clock (one track per rank, alignment offsets and
their honesty bound in ``otherData.clock_alignment``)::

    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace merge RUN_DIR -o merged.json
    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace merge RUN_DIR --device -o merged.json
    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace merge RUN_DIR --per-epoch -o m.json
    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace validate merged.json
    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace summarize RUN_DIR
    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace request TRACE_ID RUN_DIR [-o req.json]
    python -m implicitglobalgrid_tpu_torch.scripts.igg_trace export RUN_DIR --otlp -o spans.otlp.json

``--device`` additionally joins each rank's profiler capture
(``profile.p<rank>.json`` capture metas written by the ``IGG_PROFILE``
windowed capture over `torch.profiler`, `implicitglobalgrid_tpu_torch.utils.profiling`)
as device-op tracks on the same per-rank pids — host spans and device ops
side by side in ONE valid Chrome trace, aligned through the shared scope
names, with the anchor uncertainty recorded in
``otherData.device_alignment``.

``summarize`` prints a per-span-name aggregate table (count, total,
p50/p99, max) over one or more per-rank dumps.  Load ``merged.json`` at
https://ui.perfetto.dev (or chrome://tracing).

``request TRACE_ID`` reconstructs ONE request's causal tree from any set
of dumps — across pools, generations and re-routes (supervised restarts
leave ``trace.g<gen>.p<rank>.json`` dumps; directories pick those up
too) — printing the tree and its critical-path latency attribution,
writing the request-highlighted Chrome view with ``-o`` and the OTLP/JSON
slice with ``--otlp``.  A loud ``INCOMPLETE`` banner fires when any
contributing ring dropped spans.  ``export --otlp`` ships every closed
span as byte-stable OTLP/JSON (the Jaeger/Tempo ingest shape).
``merge --per-epoch`` merges a multi-generation dump dir as one trace
(one pid band per (generation, epoch) group) instead of refusing it.
Exit codes, output documents and tables are the JAX tool's: 0 ok,
1 invalid trace, 2 bad input/usage.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _expand(inputs: list[str]) -> list[str]:
    """Trace files from a mix of files and directories (a directory means
    every ``trace.p*.json`` in it, plus the generation-suffixed
    ``trace.g<gen>.p*.json`` dumps a supervised restart leaves)."""
    paths: list[str] = []
    for item in inputs:
        if os.path.isdir(item):
            found = sorted(
                glob.glob(os.path.join(item, "trace.p*.json"))
                + glob.glob(os.path.join(item, "trace.g*.p*.json"))
            )
            if not found:
                raise FileNotFoundError(
                    f"{item}: no trace.p*.json files (run with "
                    f"IGG_TELEMETRY_DIR set and call igg.dump_trace)."
                )
            paths.extend(found)
        else:
            paths.append(item)
    return paths


def cmd_merge(args) -> int:
    from ..utils import tracing

    try:
        paths = _expand(args.inputs)
        doc = tracing.merge_trace_files(paths, per_epoch=args.per_epoch)
        if args.device:
            from ..utils import profiling

            # capture metas live next to the trace files: search directory
            # inputs AND the parent dirs of explicit trace.pN.json inputs
            # (the stale-refusal remedy says "merge the current run's
            # files explicitly" — --device must work in that form too)
            dirs: list[str] = []
            for item in args.inputs:
                d = item if os.path.isdir(item) else os.path.dirname(
                    os.path.abspath(item)
                )
                if d not in dirs:
                    dirs.append(d)
            metas: list[str] = []
            for d in dirs:
                metas.extend(profiling.find_capture_metas(d))
            if not metas:
                raise ValueError(
                    "--device: no profile.p*.json capture metas next to "
                    "the trace files (run with IGG_PROFILE=steps:A-B so "
                    "each rank captures a device window)."
                )
            profiling.attach_device_tracks(doc, metas)
    except (OSError, ValueError) as e:
        print(f"igg_trace: {e}", file=sys.stderr)
        return 2
    problems = tracing.validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"igg_trace: INVALID merged trace: {p}", file=sys.stderr)
        return 1
    out = json.dumps(doc)
    if args.output == "-":
        print(out)
    else:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out)
        nspans = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
        ranks = sorted({e["pid"] for e in doc["traceEvents"]})
        print(
            f"igg_trace: wrote {args.output}: {nspans} span(s) across "
            f"rank(s) {ranks} — load it at https://ui.perfetto.dev",
            file=sys.stderr,
        )
    return 0


def render_span_table(stats: dict) -> str:
    """Fixed-width aggregate table (the JAX tool's layout, held equal by
    tests/test_torch_operator_tools.py)."""
    head = (
        f"{'span':<32} {'count':>7} {'total_ms':>10} {'mean_ms':>9} "
        f"{'p50_ms':>9} {'p99_ms':>9} {'max_ms':>9}"
    )
    lines = [head, "-" * len(head)]
    for name, s in stats.items():
        lines.append(
            f"{name:<32} {s['count']:>7} {s['total_s'] * 1e3:>10.3f} "
            f"{s['mean_s'] * 1e3:>9.3f} {s['p50_s'] * 1e3:>9.3f} "
            f"{s['p99_s'] * 1e3:>9.3f} {s['max_s'] * 1e3:>9.3f}"
        )
    return "\n".join(lines)


def cmd_summarize(args) -> int:
    from ..utils import tracing

    try:
        paths = _expand(args.inputs)
        docs = [tracing._load_rank_trace(os.fspath(p)) for p in paths]
    except (OSError, ValueError) as e:
        print(f"igg_trace: {e}", file=sys.stderr)
        return 2
    stats = tracing.span_stats([d["spans"] for d in docs])
    if args.json:
        print(json.dumps(stats))
        return 0
    ranks = sorted(d["rank"] for d in docs)
    nspans = sum(len(d["spans"]) for d in docs)
    print(f"# {nspans} span(s) across rank(s) {ranks}")
    print(render_span_table(stats))
    return 0


def render_request_tree(tree: dict) -> str:
    """Indented causal-tree text: one line per span with rank/gen
    provenance and duration — the terminal view of `tracing.request_tree`
    (the JAX tool's layout)."""
    lines = [
        f"trace {tree['trace_id']}: {tree['spans']} span(s), "
        f"rank(s) {tree['ranks']}, gen(s) {tree['gens'] or '-'}"
    ]

    def _walk(nodes, depth):
        for n in nodes:
            where = f"rank {n['rank']}"
            if n.get("gen") is not None:
                where += f" gen {n['gen']}"
            lines.append(
                f"{'  ' * depth}- {n['name']}  [{where}]  "
                f"{n['dur_s'] * 1e3:.3f}ms"
            )
            _walk(n["children"], depth + 1)

    _walk(tree.get("roots", ()), 1)
    return "\n".join(lines)


def render_critical_path(cp: dict) -> str:
    """Latency-attribution table over `tracing.critical_path` output."""
    lines = [f"critical path: total {cp['total_s'] * 1e3:.3f}ms"]
    for seg, v in cp["segments"].items():
        lines.append(
            f"  {seg:<12} {v['s'] * 1e3:>10.3f}ms {v['share'] * 100:>6.1f}%"
        )
    return "\n".join(lines)


def cmd_request(args) -> int:
    from ..utils import tracing

    try:
        paths = _expand(args.inputs)
        docs = [tracing._load_rank_trace(os.fspath(p)) for p in paths]
    except (OSError, ValueError) as e:
        print(f"igg_trace: {e}", file=sys.stderr)
        return 2
    tree = tracing.request_tree(docs, args.trace_id)
    if not tree["spans"]:
        print(
            f"igg_trace: no spans for trace {args.trace_id} in "
            f"{len(docs)} dump(s).",
            file=sys.stderr,
        )
        return 2
    if tree["incomplete"]:
        # the ring evicted spans somewhere: the tree below is silently
        # partial and the reader must know before trusting it
        print(
            f"igg_trace: INCOMPLETE — contributing dump(s) dropped "
            f"{tree['dropped']} span(s) to ring overflow; raise "
            f"IGG_TRACE_RING and re-run for a full tree.",
            file=sys.stderr,
        )
    print(render_request_tree(tree))
    print(render_critical_path(tracing.critical_path(tree)))
    if args.output:
        view = tracing.request_chrome_trace(tree)
        problems = tracing.validate_chrome_trace(view)
        if problems:
            for p in problems:
                print(f"igg_trace: INVALID request view: {p}",
                      file=sys.stderr)
            return 1
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(json.dumps(view))
        print(
            f"igg_trace: wrote {args.output} (request-highlighted Chrome "
            f"view) — load it at https://ui.perfetto.dev",
            file=sys.stderr,
        )
    if args.otlp:
        out = tracing.otlp_trace(docs, trace_id=args.trace_id)
        problems = tracing.validate_otlp(out)
        if problems:
            for p in problems:
                print(f"igg_trace: INVALID OTLP export: {p}",
                      file=sys.stderr)
            return 1
        with open(args.otlp, "w", encoding="utf-8") as f:
            f.write(json.dumps(out, sort_keys=True, separators=(",", ":")))
        print(f"igg_trace: wrote {args.otlp} (OTLP/JSON)", file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    from ..utils import tracing

    try:
        paths = _expand(args.inputs)
        docs = [tracing._load_rank_trace(os.fspath(p)) for p in paths]
    except (OSError, ValueError) as e:
        print(f"igg_trace: {e}", file=sys.stderr)
        return 2
    out = tracing.otlp_trace(docs, trace_id=args.trace_id)
    problems = tracing.validate_otlp(out)
    if problems:
        for p in problems:
            print(f"igg_trace: INVALID OTLP export: {p}", file=sys.stderr)
        return 1
    # byte-stable serialization: same dumps, same bytes (the golden-pin
    # contract — a collector diff means the data changed, not the tool)
    body = json.dumps(out, sort_keys=True, separators=(",", ":"))
    if args.output == "-":
        print(body)
    else:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(body)
        nspans = sum(
            len(ss["spans"])
            for rs in out["resourceSpans"]
            for ss in rs["scopeSpans"]
        )
        print(
            f"igg_trace: wrote {args.output}: {nspans} OTLP span(s) from "
            f"{len(docs)} dump(s)",
            file=sys.stderr,
        )
    return 0


def cmd_validate(args) -> int:
    from ..utils import tracing

    try:
        with open(args.trace, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"igg_trace: {args.trace}: {e}", file=sys.stderr)
        return 2
    problems = tracing.validate_chrome_trace(doc)
    for p in problems:
        print(f"igg_trace: {args.trace}: {p}", file=sys.stderr)
    if not problems:
        print(f"igg_trace: {args.trace}: valid", file=sys.stderr)
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m implicitglobalgrid_tpu_torch.scripts.igg_trace",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="join per-rank trace files")
    mp.add_argument("inputs", nargs="+",
                    help="trace.pN.json files and/or directories")
    mp.add_argument("-o", "--output", default="-",
                    help="merged trace path ('-' = stdout)")
    mp.add_argument("--device", action="store_true",
                    help="join each rank's IGG_PROFILE capture "
                         "(profile.p*.json metas in the input dirs) as "
                         "device-op tracks on the rank pids")
    mp.add_argument("--per-epoch", action="store_true",
                    help="merge a multi-generation dump dir (supervised "
                         "restarts) as one trace: one pid band per "
                         "(generation, epoch) group instead of refusing "
                         "the set")
    vp = sub.add_parser("validate", help="check a merged Chrome trace")
    vp.add_argument("trace")
    sp = sub.add_parser(
        "summarize", help="per-span-name aggregate table over rank dumps"
    )
    sp.add_argument("inputs", nargs="+",
                    help="trace.pN.json files and/or directories")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable stats instead of the table")
    rp = sub.add_parser(
        "request",
        help="reconstruct one request's causal tree across dumps",
    )
    rp.add_argument("trace_id", help="the request's 32-hex trace id")
    rp.add_argument("inputs", nargs="+",
                    help="trace.pN.json files and/or directories (any mix "
                         "of pools/generations)")
    rp.add_argument("-o", "--output", default=None,
                    help="write the request-highlighted Chrome view here")
    rp.add_argument("--otlp", default=None, metavar="PATH",
                    help="write the request's OTLP/JSON slice here")
    ep = sub.add_parser(
        "export", help="OTLP/JSON export of every closed span"
    )
    ep.add_argument("inputs", nargs="+",
                    help="trace.pN.json files and/or directories")
    ep.add_argument("-o", "--output", default="-",
                    help="OTLP/JSON path ('-' = stdout)")
    ep.add_argument("--otlp", action="store_true",
                    help="accepted for symmetry; OTLP/JSON is the only "
                         "export format")
    ep.add_argument("--trace-id", default=None,
                    help="restrict the export to one request's spans")
    args = ap.parse_args(argv)
    if args.cmd == "merge":
        return cmd_merge(args)
    if args.cmd == "summarize":
        return cmd_summarize(args)
    if args.cmd == "request":
        return cmd_request(args)
    if args.cmd == "export":
        return cmd_export(args)
    return cmd_validate(args)


if __name__ == "__main__":
    raise SystemExit(main())
