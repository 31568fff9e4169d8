"""ptxas-budget analyzer (``ptxas-budget``), the twin of the JAX package's
``analysis/costmodel.py`` and ``cost_baseline.json``.

In JAX the pass holds a static HLO cost model of the production programs
against a versioned baseline.  The port has no HLO: what its kernels cost
is fixed by their CUDA sources, and the compiler states the part a source
edit can silently break.  ``nvcc -Xptxas -v`` reports, per kernel entry
(each template instance), its registers, its spill stores and loads, its
stack frame and its static shared memory.  The kernels run with registers
at the cap (one or two resident blocks per SM), so one more register can
halve the resident blocks, and a spill puts local-memory traffic into the
stepping loop; neither changes a result.  The dynamic shared memory of a
launch (the plane window) is the wrappers' ``window_bytes``, printed by
``chip_smoke.py`` phases 3, 5 and 6, not a compiler output.

`ops._kernels` keeps each build's report (`ops._kernels.build_log`).  This
pass parses it for every ``csrc/*.cu`` and holds every entry to the
committed ``analysis/ptxas_baseline.json``, exactly: registers, spills,
stack and shared memory.  It needs ``nvcc``, so where no source was built
(no CUDA toolkit, as on a CPU-only machine) it reports itself skipped, not
clean.  ``python -m implicitglobalgrid_tpu_torch.analysis refresh`` builds
the kernels and rewrites the baseline; every changed entry needs a
justification (the contract of the JAX package's
``scripts/refresh_cost_baseline.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from .core import Context, Finding, Skipped

ANALYZER = "ptxas-budget"

#: The committed baseline, versioned next to the analyzers.
PTXAS_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "ptxas_baseline.json")

METRICS = ("registers", "spill_stores", "spill_loads", "stack_bytes", "smem_bytes")

_ENTRY = re.compile(r"Compiling entry function '([^']+)' for '(sm_\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
#: The anonymous namespace's mangled name carries a hash of the source
#: path: dropped, so that the key is the same in every checkout.
_ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def entry_key(mangled: str) -> str:
    return _ANON.sub("_ZN", mangled)


def parse_report(text: str) -> dict:
    """``{entry: {metric: int}}`` of one ``-Xptxas -v`` report."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(entry_key(m.group(1)), dict.fromkeys(METRICS, 0))
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def sources() -> list[str]:
    from ..ops import _kernels

    return sorted(p.stem for p in _kernels.CSRC.glob("*.cu"))


def census(build: bool = False) -> dict:
    """``{source: {entry: {metric: int}}}`` from each source's build report;
    ``build=True`` builds what is missing (needs ``nvcc``).  Raises
    `Skipped` when a report is missing."""
    from ..ops import _kernels

    out = {}
    for src in sources():
        if build:
            _kernels.build(src)
        text = _kernels.build_log(src)
        if text is None:
            raise Skipped(
                f"no nvcc build report of csrc/{src}.cu here (the kernels are compiled on "
                f"first use on a machine with the CUDA toolkit): nothing to hold against "
                f"the baseline")
        out[src] = parse_report(text)
    return out


def load_baseline(path: str = PTXAS_BASELINE) -> dict:
    if not os.path.exists(path):
        return {"version": 1, "kernels": {}, "justifications": {}}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != 1:
        raise ValueError(f"ptxas baseline {path}: unsupported version "
                         f"{data.get('version')!r} (expected 1).")
    return data


def compare(got: dict, baseline: dict) -> list[Finding]:
    """Findings of a census against a baseline (exact, every metric)."""
    out = []
    base = baseline.get("kernels", {})
    for src in sorted(set(got) | set(base)):
        have, want = got.get(src, {}), base.get(src, {})
        for entry in sorted(set(have) | set(want)):
            sym = f"{src}::{entry}"
            if entry not in want:
                out.append(Finding(
                    analyzer=ANALYZER, code="entry-unbaselined", severity="ERROR",
                    message=f"{sym}: a kernel entry the baseline does not hold "
                            f"({have[entry]}).",
                    path=f"implicitglobalgrid_tpu_torch/csrc/{src}.cu", symbol=sym,
                    anchor="new", fix_hint="refresh the baseline with a justification."))
                continue
            if entry not in have:
                out.append(Finding(
                    analyzer=ANALYZER, code="entry-lost", severity="ERROR",
                    message=f"{sym}: the baseline holds an entry the build no longer has.",
                    path=f"implicitglobalgrid_tpu_torch/csrc/{src}.cu", symbol=sym,
                    anchor="lost", fix_hint="refresh the baseline with a justification."))
                continue
            for metric in METRICS:
                was, now = want[entry].get(metric, 0), have[entry][metric]
                if was != now:
                    code = "spill-change" if metric.startswith("spill") else f"{metric}-change"
                    out.append(Finding(
                        analyzer=ANALYZER, code=code, severity="ERROR",
                        message=(f"{sym}: {metric} {was} -> {now} (exact budget).  More "
                                 f"registers can cut the resident blocks per SM; a spill puts "
                                 f"local-memory traffic into the stepping loop."),
                        path=f"implicitglobalgrid_tpu_torch/csrc/{src}.cu", symbol=sym,
                        anchor=metric,
                        fix_hint="restore the budget, or refresh the baseline with a "
                                 "justification (python -m implicitglobalgrid_tpu_torch."
                                 "analysis refresh --justify ...)."))
    return out


def run(ctx: Context) -> list[Finding]:
    return compare(census(), load_baseline())


def refresh_main(argv=None) -> int:
    """``python -m implicitglobalgrid_tpu_torch.analysis refresh``: build
    the kernels and rewrite the ptxas baseline.  Exit 0 = written (or a
    clean dry run), 1 = changed entries lack a justification, 2 = the
    census failed (no ``nvcc``)."""
    p = argparse.ArgumentParser(
        prog="python -m implicitglobalgrid_tpu_torch.analysis refresh",
        description=refresh_main.__doc__)
    p.add_argument("--justify", action="append", default=[], metavar="SOURCE::ENTRY=NOTE",
                   help="justification for one changed entry (repeatable)")
    p.add_argument("--justify-all", default=None, metavar="NOTE",
                   help="justification for every otherwise unjustified changed entry")
    p.add_argument("--dry-run", action="store_true", help="report changes, write nothing")
    p.add_argument("--out", default=None, help="output path (default: the committed baseline)")
    args = p.parse_args(argv)
    notes = {}
    for spec in args.justify:
        key, sep, note = spec.partition("=")
        if not sep or not note.strip() or "::" not in key:
            p.error(f"--justify must be SOURCE::ENTRY=NOTE, got {spec!r}")
        notes[key.strip()] = note.strip()
    try:
        got = census(build=True)
    except (Skipped, RuntimeError) as e:
        print(f"refresh: census failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    path = args.out or PTXAS_BASELINE
    old = load_baseline(path)
    old_k, old_j = old.get("kernels", {}), old.get("justifications", {})
    changed, missing, justifications = [], [], {}
    for src in sorted(set(got) | set(old_k)):
        for entry in sorted(set(got.get(src, {})) | set(old_k.get(src, {}))):
            key = f"{src}::{entry}"
            was, now = old_k.get(src, {}).get(entry), got.get(src, {}).get(entry)
            if was == now:
                justifications[key] = old_j.get(key, "")
                continue
            changed.append(f"{key}: {was} -> {now}")
            note = notes.get(key, args.justify_all)
            if not note:
                missing.append(key)
            elif now is not None:
                justifications[key] = note
    for line in changed:
        print(f"changed  {line}")
    if not changed:
        print("refresh: the build matches the committed baseline; nothing to refresh")
    if args.dry_run:
        return 0
    if missing:
        print("refresh: changed entries need a justification (--justify SOURCE::ENTRY=NOTE "
              "or --justify-all NOTE):\n  " + "\n  ".join(missing), file=sys.stderr)
        return 1
    doc = {"version": 1,
           "_comment": ["Per kernel entry, what `nvcc -Xptxas -v` reports for sm_90a: held "
                        "exactly by the ptxas-budget analyzer.  Rewritten only by `python -m "
                        "implicitglobalgrid_tpu_torch.analysis refresh`, with a justification "
                        "per changed entry."],
           "kernels": got, "justifications": justifications}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"refresh: wrote {path} ({sum(len(v) for v in got.values())} entries)")
    return 0
