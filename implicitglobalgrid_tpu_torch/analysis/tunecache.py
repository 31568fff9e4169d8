"""Tune-cache validity analyzer (``tune-cache-valid``; the JAX package's
``analysis/tunecache.py`` over the port's seed layer).

The committed seed layer of the autotuner (`tuning.cache.SEED_DIR`) is
configuration-as-data: a stale or hand-mangled entry would silently steer
every chip run that trusts it.  This pass makes the layer a tier-1
invariant with the same contract as the other gates (a finding fails the
suite unless baselined with a justification):

* every committed entry PARSES against the schema
  (`tuning.cache.validate_entry`) — a corrupt file or an unknown config
  field is an ERROR, not a runtime surprise;
* a ``schema_version`` other than the current `tuning.cache.SCHEMA_VERSION`
  is a ``stale-schema`` finding — the entry must be re-seeded, because
  readers (correctly) refuse it and the layer silently stops serving;
* the keyed config must be CURRENTLY ADMISSIBLE
  (`tuning.cache.admissibility_error`): ``fused_k`` clears the kernel's
  envelope for the keyed size/dtype, the tile its shared-memory and slot
  checks, and a porous width the PT schedule — an entry the models would
  refuse at build time is dead weight wearing authority;
* the filename must match the key digest (`tuning.cache.entry_filename`)
  — a hand-edited key that drifts from its digest would shadow (or never
  serve) its lookups.

Pure file + math checks (no device): registered at ``ast`` cost.
"""

from __future__ import annotations

import json
import os

from .core import Context, Finding

ANALYZER = "tune-cache-valid"


def cache_findings(directory: str) -> list[Finding]:
    """Findings over one committed entry directory (empty dir = clean)."""
    from ..tuning import cache as _cache

    out = []
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except ValueError as e:
            out.append(Finding(
                analyzer=ANALYZER, code="entry-corrupt", severity="ERROR",
                message=(f"{name}: not parseable JSON ({e}) — lookups "
                         f"refuse it, the entry serves nothing."),
                symbol=name, anchor="corrupt",
                fix_hint="re-measure the point (tuning sweep) or delete it.",
            ))
            continue
        ver = doc.get("schema_version") if isinstance(doc, dict) else None
        if ver != _cache.SCHEMA_VERSION:
            out.append(Finding(
                analyzer=ANALYZER, code="stale-schema", severity="ERROR",
                message=(f"{name}: schema_version {ver!r} is not the "
                         f"current {_cache.SCHEMA_VERSION} — readers refuse "
                         f"the entry, so the committed layer silently "
                         f"stopped serving this key."),
                symbol=name, anchor="schema",
                fix_hint="re-measure at the current schema (tuning sweep).",
            ))
            continue
        try:
            key, config = _cache.validate_entry(doc)
        except ValueError as e:
            out.append(Finding(
                analyzer=ANALYZER, code="entry-invalid", severity="ERROR",
                message=f"{name}: {e}",
                symbol=name, anchor="schema",
                fix_hint="re-measure the point (tuning sweep).",
            ))
            continue
        want = _cache.entry_filename(key)
        if name != want:
            out.append(Finding(
                analyzer=ANALYZER, code="key-drift", severity="ERROR",
                message=(f"{name}: the embedded key digests to {want} — a "
                         f"hand-edited key shadows (or never serves) its "
                         f"lookups."),
                symbol=name, anchor="digest",
            ))
            continue
        err = _cache.admissibility_error(key, config)
        if err is not None:
            out.append(Finding(
                analyzer=ANALYZER, code="inadmissible-config",
                severity="ERROR",
                message=(f"{name}: config {config} is not admissible for "
                         f"key {key['model']}/{key['size']}/{key['dtype']}: "
                         f"{err} — the model builders would refuse it at "
                         f"apply time."),
                symbol=name, anchor="admissible",
                fix_hint=("re-measure the point (tuning sweep) or "
                          "delete the entry."),
            ))
    return out


def run(ctx: Context) -> list[Finding]:
    directory = os.path.join(ctx.package_root, "tuning", "entries")
    return cache_findings(directory)
