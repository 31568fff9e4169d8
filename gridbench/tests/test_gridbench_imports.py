"""No run loads JAX or the JAX package (top-level names compared whole: the
port's own name begins with the JAX package's), a run that holds one once
its result is built prints no result, and the plain reference imports
nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from gridbench import run, spec
from gridbench.tests import small

ROOT = spec.HERE.parent
DRIVE = """
import json, sys
from gridbench import control, run, spec
from gridbench.tests import small
for name in {cells!r}:
    small.one_run(name)
for m in spec.load_benchmark(spec.HERE.parent)["per_layer"]:
    spec.metric(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_entry_paths_and_every_metric_reader_load_no_jax():
    cells = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]
    out = subprocess.run([sys.executable, "-c", DRIVE.format(cells=cells)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "implicitglobalgrid_tpu_torch" in loaded
    assert not loaded & set(run.BANNED), loaded & set(run.BANNED)


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "implicitglobalgrid_tpu_torchlike", sys)
    assert "implicitglobalgrid_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.banned_modules()


def test_a_metric_reader_that_loads_jax_leaves_no_result(monkeypatch, capsys):
    """The line of a traced run is built, every reader run, before the run
    looks for the banned modules and prints."""
    bench, c, cfg, traf = small.cell("diffusion3d-512.fused")
    summary = {"ops": {"k": [1, 1e-3]}, "scoped_s": {}, "busy_s": 1e-3,
               "window_s": 1e-3, "idle_gaps": {}}
    out = {"calls": 2, "steps": 32, "total_ms": 12.0, "times_ms": [6.0, 6.0], "trace": summary,
           "checks": {"start": 0.0, "sample": 0.0}}

    class Reader:
        @staticmethod
        def read(ctx):
            sys.modules["jax"] = sys
            return 1.0

    monkeypatch.setattr(spec, "metric", lambda name: Reader)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    line = run.result(bench, c, cfg, traf, small.args(trace=1), out, 1.0, {"platform": "gpu"})
    try:
        with pytest.raises(SystemExit) as e:
            run.report(line)
    finally:
        sys.modules.pop("jax", None)
    assert e.value.code != 0
    printed = capsys.readouterr()
    assert printed.out == "" and "jax" in printed.err
    run.report(line)
    assert json.loads(capsys.readouterr().out)["correct"] is True


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "gridbench.run", "--workload",
                          "diffusion3d-512.fused", "--seed", str(2**31 + 1), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    if "torch.cuda.is_available() is false" not in out.stderr:
        pytest.skip("a card is visible here")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    assert names <= {"__future__", "torch", "math", "."}, names
