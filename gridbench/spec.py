"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.  Adding a cell, a configuration, a traffic mix or a
metric adds files and entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def metric(name: str):
    """The reader module of one metric (``metrics/<name>.py``; a metric's
    name may hold dots, so it is loaded from its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gridbench_metric__{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(model: str):
    """The plain reference of a model (``reference/<model>.py``)."""
    return importlib.import_module(f"gridbench.reference.{model}")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric_entry: dict, cell: str) -> bool:
    return "workloads" not in metric_entry or cell in metric_entry["workloads"]


def grid_of(cfg: dict, traf: dict) -> dict:
    """The grid a cell runs: the configuration's, with the traffic's
    overrides (``traffic["grid"]``)."""
    grid = {k: list(cfg["grid"][k]) for k in ("block", "overlaps", "periods")}
    grid.update({k: list(v) for k, v in traf.get("grid", {}).items()})
    return grid


def _resolved(cfg: dict, key: str, value):
    """A traffic value, or the configuration's own where it says
    ``"config"``."""
    return cfg[key] if value == "config" else value


def steps_per_call(cfg: dict, traf: dict) -> int:
    return int(_resolved(cfg, "steps_per_call", traf["steps_per_call"]))


def queued_calls(cfg: dict, traf: dict) -> int:
    """How many calls the host keeps enqueued ahead of the card: the
    traffic's ``queued_calls``, or one."""
    return int(traf.get("queued_calls", 1))


def options(cfg: dict, traf: dict) -> dict:
    """The keyword options of the model's ``make_multi_step`` that the
    traffic names (``traffic["options"]``)."""
    return {k: _resolved(cfg, k, v) for k, v in traf.get("options", {}).items()}


def nominal_ms_per_step(cfg: dict, traf: dict) -> float:
    """The time per step that sizes a cell's window: the traffic's entry for
    this configuration, or the configuration's entry for this traffic."""
    own = traf.get("nominal_ms_per_step", {})
    return float(own[cfg["name"]] if cfg["name"] in own else cfg["nominal_ms_per_step"][traf["name"]])


#: the most calls a traced window times: the reduction reads the profiler's
#: Chrome trace of the window in one piece, and a window of many short calls
#: would make it many times larger.  The profiler's host work grows with the
#: trace, so where the host paces the card (the per-step cell) the idle share
#: and the step's share of the peak depend on this length: 2048 calls keep
#: them near the traced window they were first read at (2151 calls).
TRACED_CALLS = 2048


def window_calls(cfg: dict, traf: dict, seconds: float, trace: bool = False) -> int:
    """A fixed number of calls, from the run's length and the nominal time
    per step: every seed gets the same work.  A traced window times at most
    ``TRACED_CALLS`` of them."""
    ms = nominal_ms_per_step(cfg, traf) * steps_per_call(cfg, traf)
    calls = max(2, int(round(seconds * 1000.0 / ms)))
    return min(calls, TRACED_CALLS) if trace else calls
