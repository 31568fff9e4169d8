"""The plain acoustic reference against one step worked by hand on a 4x4x4
grid, and against the program at a small size on the CPU in float64, where
the two must agree to rounding; and the leapfrog kernel's roofline reader
on hand-worked numbers."""

from __future__ import annotations

import pytest
import torch

from gridbench import spec
from gridbench.tests.test_gridbench_reference import _against_the_program

ACOU = spec.reference("acoustic3d")
P_ONE = {"K": 1.0, "rho": 1.0, "dx": 1.0, "dy": 1.0, "dz": 1.0, "dt": 0.5}


def _fields(n=4):
    z = torch.zeros
    return {"P": z(n, n, n, dtype=torch.float64), "Vx": z(n + 1, n, n, dtype=torch.float64),
            "Vy": z(n, n + 1, n, dtype=torch.float64), "Vz": z(n, n, n + 1, dtype=torch.float64)}


def test_one_leapfrog_step_by_hand():
    # a unit pressure at the interior cell (1,1,1): each velocity's two faces
    # around it move by dt/rho * (P[j] - P[j-1])/h = -+0.5, then every
    # cell's pressure drops by dt*K times its divergence
    s = _fields()
    s["P"][1, 1, 1] = 1.0
    s["Vx"][2, 0, 1] = 3.0  # a face along the y wall: frozen
    out = ACOU.steps(s, P_ONE, 1, (False, False, False))
    assert out["Vx"][1:3, 1, 1].tolist() == [-0.5, 0.5]
    assert out["Vy"][1, 1:3, 1].tolist() == [-0.5, 0.5]
    assert out["Vz"][1, 1, 1:3].tolist() == [-0.5, 0.5]
    assert float(out["Vx"][2, 0, 1]) == 3.0
    for name in ("Vx", "Vy", "Vz"):
        assert float(out[name].abs().sum()) == (4.0 if name == "Vx" else 1.0)
    # div at the centre 3 -> 1 - 0.5*3; at each of its six neighbours -0.5
    # -> +0.25; beside the frozen face, (1,0,1) and (3,0,1) see -+3
    assert float(out["P"][1, 1, 1]) == -0.5
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        want = 0.25 + (-1.5 if c == (1, 0, 1) else 0.0)
        assert float(out["P"][c]) == want, c
    assert float(out["P"][2, 0, 1]) == 1.5
    assert float(out["P"].sum()) == pytest.approx(1.0)


def test_a_periodic_dimension_wraps_through_face_zero():
    s = _fields()
    s["Vz"] = s["Vz"][..., :4].clone()  # periodic z: as many faces as cells
    s["P"][1, 1, 0] = 1.0
    out = ACOU.steps(s, P_ONE, 1, (False, False, True))
    # face 0 lies between cell 3 (wrapped) and cell 0
    assert out["Vz"][1, 1].tolist() == [-0.5, 0.5, 0.0, 0.0]
    assert float(out["P"][1, 1, 3]) == 0.25
    assert float(out["P"][1, 1, 0]) == -0.5


def test_acoustic_reference_agrees_with_the_program():
    # walls all round at a thin overlap, per step; the periodic and fused
    # cadences are tests/test_torch_acoustic_reference.py's cases
    _against_the_program("acoustic3d-512", "acoustic3d", [32, 30, 36],
                         {"periods": [0, 0, 0], "overlaps": [2, 2, 2]}, None, 3)


def _leapfrog_ctx(calls, ops):
    bench = spec.load_benchmark(spec.HERE.parent)
    c = spec.workload(bench, "acoustic3d-512.fused")
    cfg, traf = spec.config(c["config"]), spec.traffic(c["traffic"])
    trace = {"ops": ops, "scoped_s": {}, "busy_s": 1.0, "window_s": 1.0, "idle_gaps": {}}
    window = {"calls": calls, "steps": calls * spec.steps_per_call(cfg, traf), "trace": trace}
    return {"cell": c, "config": cfg, "traffic": traf, "window": window}


def test_fused_leapfrog_roofline_is_the_least_time_over_the_kernel_time():
    # a 512^3 launch of 6 steps reads and writes P (512^3) and three face
    # fields (513 x 512^2) once: bytes bound it (15.3 GFLOP take 0.23 ms)
    nbytes = 2 * (512**3 + 3 * 513 * 512**2) * 4
    assert nbytes == 4_301_258_752
    name = "void (anonymous namespace)::fused_leapfrog_kernel<float, false>(float const*)"
    ctx = _leapfrog_ctx(2, {name: [8, 8 * 10.36e-3], "Memcpy DtoD": [1, 1.0]})
    got = spec.metric("fused_leapfrog_roofline").read(ctx)
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 10.36e-3)
    assert 12.3 < got < 12.5


def test_fused_leapfrog_roofline_without_the_kernel_returns_nothing():
    assert spec.metric("fused_leapfrog_roofline").read(
        _leapfrog_ctx(2, {"fused_pt_kernel": [8, 1.0]})) is None
