"""Every seed gets the same work: the same shapes, steps and calls; the seed
moves only the initial values and which call is sampled."""

from __future__ import annotations

import pytest
import torch

from gridbench import spec
from gridbench.layout import Layout
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


@pytest.mark.parametrize("model,cfg_name", [("diffusion3d", "diffusion3d-512"),
                                            ("porous_convection3d", "porous3d-256")])
def test_seeds_change_values_and_not_shapes(model, cfg_name):
    ref = spec.reference(model)
    cfg = spec.config(cfg_name)
    cfg["grid"]["block"] = [12, 20, 16]
    lay = Layout.of(cfg["grid"])
    a = ref.initial(cfg, lay, 1, "cpu")
    b = ref.initial(cfg, lay, 2**31 + 9, "cpu")
    c = ref.initial(cfg, lay, 1, "cpu")
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert not torch.equal(a["T"], b["T"])
    assert all(torch.equal(a[k], c[k]) for k in a)
