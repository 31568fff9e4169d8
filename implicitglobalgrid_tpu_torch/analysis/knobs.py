"""Knob declaration/documentation lint (``knob-decl``).

Counterpart of the JAX package's ``analysis/knobs.py`` knob-decl pass (its
``scripts/check_knobs.py``): every ``IGG_*`` referenced in the package must
be declared in ``utils/config.py`` and documented.  The port's
documentation of its knobs is the env-var table of ``utils/config.py``'s
module docstring, so the port's run passes that file as both the
declaration (its whole text) and the documentation (its docstring).

The JAX package's other knob pass, knob-binding (env reads reachable from
traced code), has no twin here: see the package docstring's design note.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Context, Finding

_KNOB = re.compile(r"IGG_[A-Z0-9_]+")


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def _documentation(path: str) -> str:
    """The documentation text of ``path``: a Python module's docstring,
    any other file's whole text."""
    text = _read(path)
    if path.endswith(".py"):
        return ast.get_docstring(ast.parse(text)) or ""
    return text


def referenced_knobs(repo: str, package: str, config: str) -> dict:
    """``knob -> [repo-relative files referencing it]`` over the package,
    excluding the declaration site (utils/config.py)."""
    refs: dict[str, list[str]] = {}
    for dirpath, dirnames, filenames in os.walk(package):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            if os.path.samefile(path, config):
                continue
            rel = os.path.relpath(path, repo)
            for knob in set(_KNOB.findall(_read(path))):
                refs.setdefault(knob, []).append(rel)
    return {k: sorted(v) for k, v in sorted(refs.items())}


def knob_decl_findings(repo: str, package: str, config: str,
                       usage: str) -> list[Finding]:
    """Findings for the knobs the ``package`` references but the
    ``config`` file does not declare or the ``usage`` file (a Python
    module: its docstring) does not document."""
    declared = set(_KNOB.findall(_read(config)))
    documented = set(_KNOB.findall(_documentation(usage)))
    config_rel = os.path.relpath(config, repo)
    usage_rel = os.path.relpath(usage, repo)
    out = []
    for knob, files in referenced_knobs(repo, package, config).items():
        where = ", ".join(files)
        if knob not in declared:
            out.append(
                Finding(
                    analyzer="knob-decl",
                    code="undeclared-knob",
                    severity="ERROR",
                    message=(
                        f"{knob} (referenced in {where}) is not declared "
                        f"in {config_rel}"
                    ),
                    path=files[0],
                    symbol=knob,
                    anchor="declare",
                    fix_hint=(
                        "add it to the knob table in utils/config.py (and "
                        "an accessor if it is read per call)"
                    ),
                )
            )
        if knob not in documented:
            out.append(
                Finding(
                    analyzer="knob-decl",
                    code="undocumented-knob",
                    severity="ERROR",
                    message=(
                        f"{knob} (referenced in {where}) is not documented "
                        f"in {usage_rel}"
                    ),
                    path=files[0],
                    symbol=knob,
                    anchor="document",
                    fix_hint=f"add a row to the env-var table of {usage_rel}",
                )
            )
    return out


def run_knob_decl(ctx: Context) -> list[Finding]:
    config = os.path.join(ctx.package_root, "utils", "config.py")
    return knob_decl_findings(repo=ctx.repo_root, package=ctx.package_root,
                              config=config, usage=config)
