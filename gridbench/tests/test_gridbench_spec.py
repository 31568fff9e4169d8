"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix and metric that it names found by name in its own file; a new
one is files and entries only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from gridbench import spec
from gridbench.tests import small

ROOT = spec.HERE.parent
BENCH = spec.load_benchmark(ROOT)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gridbench"]
    assert BENCH["command"] == ["python3", "-m", "gridbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e["name"]
    for w in BENCH["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("group,name", list(_names()))
def test_every_name_uses_only_the_allowed_characters(group, name):
    assert spec.NAME.fullmatch(name), (group, name)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_unit_and_direction_is_allowed(m):
    assert spec.UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_are_unique_and_setup_is_there():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_is_found_by_name(c):
    assert c["file"] == f"gridbench/configs/{c['name']}.json"
    cfg = spec.config(c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    spec.reference(cfg["program"]["module"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_names_its_cpu_block(c):
    block = spec.config(c["name"])["cpu_block"]
    assert len(block) == 3 and all(type(n) is int and n > 0 for n in block), block


def _cell_is_complete(bench, w):
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg, traf = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert traf["name"] == w["traffic"]
    assert spec.nominal_ms_per_step(cfg, traf) > 0
    assert spec.queued_calls(cfg, traf) >= 1
    e2e = [m["name"] for m in bench["end_to_end"] if spec.applies(m, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(spec.applies(m, w["name"]) for m in bench["per_layer"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_what_the_contract_asks(w):
    _cell_is_complete(BENCH, w)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_is_a_reader_of_its_own(m):
    mod = spec.metric(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.BETTER, mod.MOVES, mod.SOURCE) == (
        m["unit"], m["layer"], m["better"], m["moves"], m["source"])
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert spec.applies(moved, cell), (m["name"], cell)


def test_every_file_under_the_benchmark_folders_is_named():
    named = {p for p in (spec.HERE / "metrics").glob("*.py")}
    assert {spec.HERE / "metrics" / f"{m['name']}.py" for m in BENCH["per_layer"]} == named
    used = {w["traffic"] for w in BENCH["workloads"]}
    files = {p.stem for p in (spec.HERE / "traffic").glob("*.json")}
    assert used <= files


def _copy(tmp_path):
    """The benchmark in a tree of its own: BENCHMARK.json and ``gridbench/``
    without its tests, which run from where they are on ``spec.HERE``."""
    here = tmp_path / "gridbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return here


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}


def test_a_new_cell_configuration_traffic_and_metric_are_files_and_entries(tmp_path,
                                                                           monkeypatch):
    here = _copy(tmp_path)
    cfg = spec.config("diffusion3d-512")
    cfg["name"] = "diffusion3d-320"
    cfg["grid"]["block"] = [320, 320, 320]
    cfg["nominal_ms_per_step"] = {"fused": 0.2}
    (here / "configs" / "diffusion3d-320.json").write_text(json.dumps(cfg))
    # a traffic mix with options of make_multi_step of its own, and its
    # nominal time on a configuration that is already there
    traf = {"name": "pipelined8", "steps_per_call": 8,
            "options": {"fused_k": "config", "pipelined": False},
            "nominal_ms_per_step": {"diffusion3d-512": 0.45}}
    (here / "traffic" / "pipelined8.json").write_text(json.dumps(traf))
    (here / "metrics" / "calls.py").write_text(
        'UNIT, LAYER, BETTER, MOVES, SOURCE = "1", "model cadence", "higher", '
        '"step_ms", "host_clock"\n\n\ndef read(ctx):\n'
        '    return float(ctx["window"]["calls"])\n')
    monkeypatch.setattr(spec, "HERE", here)
    c, t = spec.config("diffusion3d-320"), spec.traffic("pipelined8")
    assert spec.steps_per_call(c, t) == 8
    assert spec.options(c, t) == {"fused_k": 4, "pipelined": False}
    assert spec.metric("calls").read({"window": {"calls": 5}}) == 5.0
    assert spec.window_calls(c, spec.traffic("fused"), 20) == round(20e3 / (0.2 * 16))
    assert spec.window_calls(spec.config("diffusion3d-512"), t, 20) == round(20e3 / (0.45 * 8))


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_a_new_configuration_runs_and_fails_as_a_cell_from_its_files_alone(tmp_path,
                                                                          monkeypatch, fault):
    """A configuration added as its file and entries, with no other file of
    the benchmark or of its tests edited: its cell passes the checks every
    cell passes, a sound CPU run of it is correct, and the exchange left out
    (its grid is periodic in y) makes it not correct."""
    here = _copy(tmp_path)
    before = _files(tmp_path)
    cfg = spec.config("porous3d-256")
    cfg.update(name="porous3d-240", cpu_block=[30, 32, 28])
    cfg["grid"]["block"] = [240, 240, 240]
    (here / "configs" / "porous3d-240.json").write_text(json.dumps(cfg))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "porous3d-256")
    bench["configs"].append({**entry, "name": "porous3d-240",
                             "file": "gridbench/configs/porous3d-240.json"})
    cell = {"name": "porous3d-240.fused", "config": "porous3d-240", "traffic": "fused",
            "chips": 1, "why": "240^3, the porous cell's mix at another block"}
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("step_ms", "chunk_ms_p95", "exchange_mib_per_step"):
            m["workloads"].append(cell["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    after = _files(tmp_path)
    changed = {p for p in before.keys() | after.keys() if before.get(p) != after.get(p)}
    assert changed == {Path("BENCHMARK.json"), Path("gridbench/configs/porous3d-240.json")}

    monkeypatch.setattr(spec, "HERE", here)
    _cell_is_complete(bench, cell)
    assert small.cell(cell["name"])[2]["grid"]["block"] == [30, 32, 28]
    assert "exchange" in small.faults(cell["name"])
    line, _ = small.one_run(cell["name"], fault=fault)
    assert line["correct"] is (fault is None), line["checks"]


def test_the_program_takes_the_traffic_options(monkeypatch):
    """The options reach the model's ``make_multi_step`` as the traffic
    names them, ``"config"`` resolved; the harness adds only autotune."""
    from gridbench import program

    seen = {}

    class Model:
        @staticmethod
        def setup(*block, **kw):
            return None, "params"

        @staticmethod
        def make_multi_step(params, nsteps, **opts):
            seen.update(opts, nsteps=nsteps)
            return lambda *s: s

    monkeypatch.setattr(program.importlib, "import_module", lambda name: Model)
    cfg = spec.config("porous3d-256")
    traf = {"name": "t", "steps_per_call": 2, "options": {"fused_k": "config", "batch": False}}
    program.Program(cfg, spec.grid_of(cfg, traf), 2, spec.options(cfg, traf), "cpu")
    assert seen == {"autotune": False, "fused_k": 6, "batch": False, "nsteps": 2}
