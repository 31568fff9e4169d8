"""A whole run of each cell on the CPU at a small size, with the timed path
sound and then broken underneath: ``correct`` holds for the sound run and
fails for each fault the cell can have, and for the control (the reference
in bfloat16 in the program's place)."""

from __future__ import annotations

import pytest
import torch

from gridbench import control, spec
from gridbench.tests import small
from gridbench.window import Window

ONE_GPU = [w["name"] for w in spec.load_benchmark(spec.HERE.parent)["workloads"]
           if w["chips"] == 1]
FAULTS = [(c, f) for c in ONE_GPU for f in small.faults(c)]


@pytest.mark.parametrize("name", ONE_GPU)
def test_a_sound_run_is_correct(name):
    line, out = small.one_run(name)
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["checks"]) == {"start", "sample"}
    assert line["attempted"] == out["calls"] and line["failed"] == 0


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    line, _ = small.one_run(name, fault=fault)
    assert not line["correct"], (fault, line["checks"])
    assert line["failed"] >= 1


@pytest.mark.parametrize("name", ONE_GPU)
def test_the_control_fails_and_the_program_passes_on_several_seeds(name):
    _, _, cfg, traf = small.cell(name)
    for seed in (3, 2**31 + 1, 2**32 + 77):
        w = Window(cfg, traf, seed, torch.device("cpu"))
        w.run(spec.window_calls(cfg, traf, 0.04))
        prog = w.checks()
        ctrl = w.checks(advance=control.lower_precision(w.ref))
        for k, v in prog.items():
            assert v <= cfg["limits"][k] < ctrl[k], (seed, k, v, ctrl[k])

