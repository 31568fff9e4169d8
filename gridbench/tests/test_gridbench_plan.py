"""Every seed gets the same work: the same shapes, steps and calls; the seed
moves only the initial values and which call is sampled."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from gridbench import run, spec, window
from gridbench.layout import Layout
from gridbench.tests import small
from gridbench.window import sample_index

BENCH = spec.load_benchmark(spec.HERE.parent)
CELLS = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]


@pytest.mark.parametrize("cfg_name,traf_name", CELLS)
def test_two_seeds_get_identical_plans(cfg_name, traf_name):
    """The calls, steps and options of a window come from the files and the
    run's length alone; the seed picks only the sampled call."""
    cfg, traf = spec.config(cfg_name), spec.traffic(traf_name)
    calls = spec.window_calls(cfg, traf, BENCH["run_seconds"])
    assert calls >= 20
    assert spec.steps_per_call(cfg, traf) >= 1
    assert all(v != "config" for v in spec.options(cfg, traf).values())
    for seed in (0, 2**31 + 5, 2**33 + 1):
        assert 1 <= sample_index(seed, calls) < calls


@pytest.mark.parametrize("cfg_name", [c["name"] for c in BENCH["configs"]])
def test_seeds_change_values_and_not_shapes(cfg_name):
    cfg = spec.config(cfg_name)
    ref = spec.reference(cfg["program"]["module"])
    cfg["grid"]["block"] = list(cfg["cpu_block"])
    lay = Layout.of(cfg["grid"])
    a = ref.initial(cfg, lay, 1, "cpu")
    b = ref.initial(cfg, lay, 2**31 + 9, "cpu")
    c = ref.initial(cfg, lay, 1, "cpu")
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert any(not torch.equal(a[k], b[k]) for k in a)
    for k in a:
        differ = a[k] != c[k]
        assert not differ.any(), (
            f"{k}: {int(differ.sum())} values differ between two draws of one seed, the first "
            f"at {differ.nonzero()[0].tolist()}; NaN in the draws: "
            f"{bool(a[k].isnan().any())}, {bool(c[k].isnan().any())}")


#: the windows of the benchmark's cells at its run length, untraced and
#: traced, worked by hand: 20 s over 0.42 ms x 16 steps, 6.4 ms x 8 and
#: 0.66 ms x 1, a traced one at most 2048 calls
CALLS = {"diffusion3d-512.fused": (2976, 2048), "porous3d-256.fused": (391, 391),
         "diffusion3d-512.per_step": (30303, 2048)}


@pytest.mark.parametrize("cell,untraced,traced", [(k, *v) for k, v in CALLS.items()])
def test_a_traced_window_times_at_most_the_cap(cell, untraced, traced):
    w = spec.workload(BENCH, cell)
    cfg, traf = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert spec.window_calls(cfg, traf, BENCH["run_seconds"]) == untraced
    got = spec.window_calls(cfg, traf, BENCH["run_seconds"], trace=True)
    assert got == traced == min(untraced, spec.TRACED_CALLS)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_run_sizes_its_window_by_whether_it_traces(monkeypatch, trace):
    seen = []
    monkeypatch.setattr(window.Window, "run", lambda self, calls: seen.append(calls) or {})
    monkeypatch.setattr(window.Window, "checks", lambda self: {})
    cfg, traf = spec.config("diffusion3d-512"), spec.traffic("per_step")
    run.run_window(cfg, traf, SimpleNamespace(seed=1, seconds=20, trace=trace), "cpu")
    assert seen == [2048 if trace else 30303]


#: per cell, the calls the host keeps enqueued ahead of the card
QUEUED = {"diffusion3d-512.fused": 1, "porous3d-256.fused": 1, "diffusion3d-512.per_step": 64}


@pytest.mark.parametrize("cell,queued", QUEUED.items())
def test_the_host_keeps_the_traffics_calls_queued_ahead_of_the_card(monkeypatch, cell, queued):
    """Before it enqueues call ``c`` the host waits for the end of call
    ``c - queued - 1`` (mark ``c - queued``), and for nothing else."""
    waits = []
    monkeypatch.setattr(window._Timer, "wait", lambda self, i: waits.append(i))
    _, _, cfg, traf = small.cell(cell)
    assert spec.queued_calls(cfg, traf) == queued
    calls = queued + 5
    window.Window(cfg, traf, 1, "cpu").run(calls)
    assert waits == [c - queued for c in range(queued + 1, calls)]
