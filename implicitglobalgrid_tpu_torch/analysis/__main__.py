"""The port's analysis CLI (the JAX package's ``scripts/igg_lint.py``).

Examples::

    python -m implicitglobalgrid_tpu_torch.analysis               # every analyzer
    python -m implicitglobalgrid_tpu_torch.analysis --list        # what passes exist
    python -m implicitglobalgrid_tpu_torch.analysis knob-decl     # a subset
    python -m implicitglobalgrid_tpu_torch.analysis --changed-only       # `git status`
    python -m implicitglobalgrid_tpu_torch.analysis --changed-only=main  # merge-base diff
    python -m implicitglobalgrid_tpu_torch.analysis --json
    python -m implicitglobalgrid_tpu_torch.analysis --sarif out.sarif
    python -m implicitglobalgrid_tpu_torch.analysis refresh --justify-all "why"
        # rebuild the kernels and rewrite analysis/ptxas_baseline.json
    python -m implicitglobalgrid_tpu_torch.analysis refresh cost --justify \
        "exchange/porous[coalesce=True]::bytes_accessed=why"
        # rewrite analysis/cost_baseline.json from a fresh census

With no analyzer named (or ``--all``) every analyzer runs: the port's suite
is host passes, seconds in all (``ptxas-budget`` reports itself skipped
where no kernel was built).  Exit code: 0 = clean (or
WARNING-only), 1 = CRITICAL/ERROR findings (WARNINGs too under
``--strict``), 2 = an analyzer crashed.  Findings are suppressed through
the baseline file (justified suppressions only); ``--no-baseline`` shows
the raw findings.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import DEFAULT_BASELINE, changed_files, run
from .core import REGISTRY


def main(argv=None) -> int:
    raw = sys.argv[1:] if argv is None else list(argv)
    if raw[:2] == ["refresh", "cost"]:
        from .costmodel import refresh_main

        return refresh_main(raw[2:])
    if raw[:1] == ["refresh"]:
        from .ptxas import refresh_main

        return refresh_main(raw[1:])
    p = argparse.ArgumentParser(prog="python -m implicitglobalgrid_tpu_torch.analysis",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("analyzers", nargs="*", help="analyzer names (see --list)")
    p.add_argument("--all", action="store_true", help="run every analyzer (the default)")
    p.add_argument("--list", action="store_true", dest="list_passes",
                   help="list available analyzers and exit")
    p.add_argument("--json", action="store_true", help="JSON report")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: the package baseline)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (show raw findings)")
    p.add_argument("--changed-only", nargs="?", const=True, default=None,
                   metavar="REF",
                   help="run only analyzers relevant to changed paths: "
                        "bare = `git status`; =REF adds the merge-base diff "
                        "against REF (a clean checkout has no status paths)")
    p.add_argument("--sarif", default=None, metavar="PATH",
                   help="also write the report as SARIF 2.1.0 to PATH "
                        "('-' = stdout)")
    p.add_argument("--strict", action="store_true",
                   help="WARNINGs also fail the run")
    args = p.parse_args(argv)

    if args.list_passes:
        for name, spec in REGISTRY.items():
            print(f"{name:24s} [{spec.cost}]  {spec.title}")
        return 0
    unknown = [n for n in args.analyzers if n not in REGISTRY]
    if unknown:
        p.error(f"unknown analyzer(s): {unknown}")
    names = None if args.all or not args.analyzers else args.analyzers

    baseline = None if args.no_baseline else (args.baseline or DEFAULT_BASELINE)
    changed = None
    if args.changed_only is not None:
        ref = None if args.changed_only is True else args.changed_only
        if ref is not None and ref in REGISTRY and not any(
                a.startswith("--changed-only=") for a in raw):
            # argparse would silently eat an analyzer name as the git ref
            p.error(
                f"'--changed-only {ref}' parsed {ref!r} as a git ref, but it "
                f"names an analyzer — write `--changed-only={ref}` for a ref "
                f"of that name, or put analyzer names BEFORE the bare flag"
            )
        try:
            changed = changed_files(ref=ref)
        except RuntimeError as e:
            print(f"analysis: {e}", file=sys.stderr)
            return 2
    report = run(names, baseline=baseline, changed_paths=changed, keep_going=True)
    text = report.to_json() if args.json else report.human()
    if args.sarif:
        from .sarif import report_to_sarif

        sarif_text = json.dumps(report_to_sarif(report), indent=2, sort_keys=True) + "\n"
        if args.sarif == "-":
            sys.stdout.write(sarif_text)
            # stdout IS the artifact now: the report must not corrupt it
            print(text, file=sys.stderr)
            return report.exit_code(strict=args.strict)
        with open(args.sarif, "w", encoding="utf-8") as f:
            f.write(sarif_text)
    print(text)
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
