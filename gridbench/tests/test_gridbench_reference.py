"""The plain reference against small grids worked by hand, and against the
program at small sizes on the CPU in float64, where the two must agree to
rounding."""

from __future__ import annotations

import pytest
import torch

from gridbench import spec
from gridbench.layout import Layout, take

DIFF = spec.reference("diffusion3d")
PORO = spec.reference("porous_convection3d")


def test_one_diffusion_step_by_hand():
    p = {"lam": 2.0, "dx": 1.0, "dy": 0.5, "dz": 1.0, "dt": 0.01}
    T = torch.zeros(3, 3, 3, dtype=torch.float64)
    T[1, 1, 1] = 1.0
    Cp = torch.full_like(T, 4.0)
    out = DIFF.steps({"T": T, "Cp": Cp}, p, 1, (False, False, False))["T"]
    # lap at the centre: x -2, y -2/0.25 = -8, z -2 -> -12; dT = 0.01*2*(-12)/4
    assert float(out[1, 1, 1]) == pytest.approx(1.0 - 0.06)
    expect = T.clone()
    expect[1, 1, 1] = 0.94
    assert torch.equal(out, expect)  # every other cell is a boundary cell


def test_a_periodic_dimension_wraps():
    p = {"lam": 1.0, "dx": 1.0, "dy": 1.0, "dz": 1.0, "dt": 0.1}
    T = torch.zeros(3, 3, 4, dtype=torch.float64)
    T[1, 1, 0] = 1.0
    out = DIFF.steps({"T": T, "Cp": torch.ones_like(T)}, p, 1, (False, False, True))["T"]
    assert float(out[1, 1, 3]) == pytest.approx(0.1)  # the wrapped neighbour
    assert float(out[1, 1, 1]) == pytest.approx(0.1)
    assert float(out[1, 1, 0]) == pytest.approx(1.0 - 0.6)


def test_porous_relaxation_by_hand():
    # one relaxation on a 3x3x3 block with one interior cell: only the
    # z flux faces around it move (buoyancy), then Pf follows their divergence
    p = {"dx": 1.0, "dy": 1.0, "dz": 1.0, "dt": 0.0, "lam": 0.0, "phi": 0.1, "theta": 0.5,
         "beta": 0.1, "buoy": 2.0, "npt": 1}
    T = torch.zeros(3, 3, 3, dtype=torch.float64)
    T[1, 1, 1] = 1.0
    z = dict(T=T, Pf=torch.zeros_like(T), qDx=torch.zeros(4, 3, 3, dtype=torch.float64),
             qDy=torch.zeros(3, 4, 3, dtype=torch.float64),
             qDz=torch.zeros(3, 3, 4, dtype=torch.float64))
    out = PORO.steps(z, p, 1, (False, False, False))
    # inner z faces of the centre column: avg T = 0.5 on faces 1 and 2
    assert out["qDz"][1, 1].tolist() == [0.0, 0.5, 0.5, 0.0]
    assert float(out["qDz"].abs().sum()) == pytest.approx(1.0)
    assert float(out["qDx"].abs().sum()) == 0.0
    # div at (1,1,0) = +0.5, at (1,1,2) = -0.5, centre 0
    assert out["Pf"][1, 1].tolist() == pytest.approx([-0.05, 0.0, 0.05])
    assert torch.equal(out["T"], T)  # dt = 0


def _against_the_program(cfg_name, model, block, grid_kw, fused_k, nsteps):
    import implicitglobalgrid_tpu_torch as igg
    from importlib import import_module

    m = import_module(f"implicitglobalgrid_tpu_torch.models.{model}")
    ref = spec.reference(model)
    cfg = spec.config(cfg_name)
    cfg["grid"].update(block=block, **grid_kw)
    lay = Layout.of(cfg["grid"])
    fields = ref.initial(cfg, lay, 2**31 + 3, "cpu", torch.float64)
    block_fields = {k: take(v, lay.block_index(ref.STAGGER[k]))
                    for k, v in fields.items()}
    kw = {k: cfg["physics"][k] for k in cfg["program"]["setup_keys"]}
    for d, ax in enumerate("xyz"):
        kw[f"period{ax}"] = lay.periods[d]
        kw[f"overlap{ax}"] = lay.overlaps[d]
    try:
        _, params = m.setup(*block, dtype=torch.float64, device="cpu", quiet=True, **kw)
        opts = {"fused_k": fused_k} if fused_k else {}
        step = m.make_multi_step(params, nsteps, autotune=False, **opts)
        out = step(*(block_fields[k] for k in cfg["program"]["state"]))
    finally:
        igg.finalize_global_grid()
    want = ref.steps(fields, ref.params(cfg, lay), nsteps, tuple(bool(p) for p in lay.periods))
    for k, got in zip(cfg["program"]["state"], out):
        if k in ref.EVOLVING:
            w = take(want[k], lay.block_index(ref.STAGGER[k]))
            assert float((got - w).abs().max()) <= 1e-12 * float(w.abs().max()), k


@pytest.mark.parametrize("grid_kw,fused_k,nsteps", [
    ({"periods": [0, 0, 0], "overlaps": [8, 8, 8]}, 4, 8),
    ({"periods": [1, 1, 1], "overlaps": [2, 2, 2]}, None, 3),
    ({"periods": [1, 0, 1], "overlaps": [8, 8, 8]}, 4, 8),
])
def test_diffusion_reference_agrees_with_the_program(grid_kw, fused_k, nsteps):
    _against_the_program("diffusion3d-512", "diffusion3d", [24, 22, 20], grid_kw, fused_k,
                         nsteps)


@pytest.mark.parametrize("grid_kw,fused_k", [
    ({"periods": [0, 1, 0], "overlaps": [14, 14, 14]}, 6),
    ({"periods": [0, 0, 1], "overlaps": [14, 14, 14]}, 6),
    ({"periods": [0, 0, 0], "overlaps": [2, 2, 2]}, None),
])
def test_porous_reference_agrees_with_the_program(grid_kw, fused_k):
    _against_the_program("porous3d-256", "porous_convection3d", [32, 30, 28], grid_kw, fused_k, 2)
