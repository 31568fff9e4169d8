"""The models' shared cadence front end (`models._fused.make_cadence`).

Every misuse of the cadence keywords raises when the cadence is built, with
its text; every cadence (fused ``k=2``, ``exchange_every=2``, per-step), on
a block and on a batch of two, equals bit for bit the same steps composed
by hand from the model's pieces: the kernel group or the plain group, each
followed by its width-``w`` `update_halo`; `make_step`; and for porous the
time step around them (`_pt_schedule`'s lead and chunks, then the T update
and its exchange).  CPU, float64, periodic in x with overlap 4.
"""

import dataclasses

import pytest
import torch

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu_torch.models import _batched, acoustic3d, diffusion3d
from implicitglobalgrid_tpu_torch.models import porous_convection3d as porous
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog, fused_pt, fused_stencil

MODELS = {"diffusion": diffusion3d, "acoustic": acoustic3d, "porous": porous}
#: What each model's messages count steps in.
UNIT = {"diffusion": "step", "acoustic": "step", "porous": "iteration"}
BLOCK = (10, 8, 8)
GRID = dict(periodx=1, overlapx=4)


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _setup(name, batch=False):
    kw = dict(dtype=torch.float64, device="cpu", quiet=True, **GRID)
    if name == "porous":
        kw["npt"] = 5  # the fused cadence: one lead iteration, chunks [2, 2]
    if batch:
        return _batched.batched_setup(MODELS[name], *BLOCK, batch=2, **kw)
    return MODELS[name].setup(*BLOCK, **kw)


MISUSES = [
    ("fused_k with hide_comm", 4, dict(fused_k=2), True,
     "fused_k and hide_comm are mutually exclusive: the fused kernel's slab exchange is already "
     "amortized over k {unit}s; overlap scheduling applies to the per-{unit} XLA path."),
    ("exchange_every with hide_comm", 4, dict(exchange_every=2), True,
     "exchange_every and hide_comm are mutually exclusive: overlap scheduling hides the "
     "per-{unit} exchange; a slab cadence replaces it."),
    ("exchange_every < 1", 4, dict(exchange_every=0), False,
     "exchange_every must be >= 1 (got 0)"),
    ("nsteps not a multiple of fused_k", 3, dict(fused_k=2), False,
     "nsteps=3 must be a multiple of fused_k=2"),
    ("nsteps not a multiple of exchange_every", 3, dict(exchange_every=2), False,
     "nsteps=3 must be a multiple of exchange_every=2"),
    ("half fused_tile", 4, dict(fused_k=2, fused_tile=(4, None)), False,
     "fused_tile=(4, None): pass both bx and by, or neither"),
    ("pipelined on the per-step path", 4, dict(pipelined=True), False,
     "pipelined applies to the group cadences (fused_k or exchange_every > 1); the "
     "per-{unit} path has no group schedule."),
]
#: Porous's nsteps counts time steps and its groups PT iterations, so no
#: group width has to divide it.
NOT_FOR = {"porous": {"nsteps not a multiple of fused_k",
                      "nsteps not a multiple of exchange_every"}}


@pytest.mark.parametrize("name,case,nsteps,kw,hide,text", [
    pytest.param(name, *m, id=f"{name}-{m[0]}")
    for name in MODELS for m in MISUSES if m[0] not in NOT_FOR.get(name, ())
])
def test_misuse_raises_when_the_cadence_is_built(name, case, nsteps, kw, hide, text):
    _, params = _setup(name)
    params = dataclasses.replace(params, hide_comm=hide)
    with pytest.raises(ValueError) as e:
        MODELS[name].make_multi_step(params, nsteps, autotune=False, **kw)
    assert str(e.value) == text.format(unit=UNIT[name])


def _pieces(name, params):
    """``(plain, kernel)``: one plain step ``(c, aux) -> c`` and one kernel
    group ``(k, c, aux) -> c`` of the model (``c``: the fields a step
    advances, ``aux``: the read-only ones)."""
    h = (params.dx, params.dy, params.dz)
    if name == "diffusion":
        update = diffusion3d._diffusion_update(params)
        c3 = tuple(params.dt * params.lam / (d * d) for d in h)
        return (lambda c, aux: (update(c[0], aux[0]),),
                lambda k, c, aux: (fused_stencil.fused_diffusion_steps(c[0], aux[0], k, *c3),))
    if name == "acoustic":
        v_update = acoustic3d._velocity_update(params)
        p_update = acoustic3d._pressure_update(params)
        co = (*(params.dt / params.rho / d for d in h), params.dt * params.K,
              *(1.0 / d for d in h))

        def leapfrog(c, aux):
            V = v_update(*c)
            return (p_update(c[0], *V), *V)

        return leapfrog, lambda k, c, aux: fused_leapfrog.fused_leapfrog_steps(*c, k, *co)
    flux_update = porous._flux_update(params)
    p_update = porous._pressure_update(params)
    co = (params.theta_q, *(1.0 / d for d in h), params.Ra * params.lam_T, params.beta_p)

    def pt_iteration(c, aux):
        q = flux_update(aux[0], *c)
        return (p_update(c[0], *q), *q)

    return pt_iteration, lambda k, c, aux: fused_pt.fused_pt_iterations(aux[0], *c, k, *co)


def _by_hand(name, params, cadence, nsteps, batch, state):
    model = MODELS[name]
    if cadence == "per_step":
        step = model.make_step(params, batch=batch)
        for _ in range(nsteps):
            state = step(*state)
        return state
    halo = _batched.update_halo if batch else tigg.update_halo

    def exchange(c, width=1):
        out = halo(*c, width=width)
        return out if len(c) > 1 else (out,)

    plain, kernel = _pieces(name, params)
    fused = cadence == "fused_k=2"

    def groups(c, aux, lead, chunks):
        for _ in range(lead):
            c = exchange(plain(c, aux))
        for ki in chunks:
            if fused:
                c = kernel(ki, c, aux)
            else:
                for _ in range(ki):
                    c = plain(c, aux)
            c = exchange(c, width=2)
        return c

    if name != "porous":
        n = 1 if name == "diffusion" else len(state)
        return (*groups(state[:n], state[n:], 0, [2] * (nsteps // 2)), *state[n:])
    t_update = porous._temperature_update(params)
    lead, chunks = porous._pt_schedule(params.npt, 2, even=fused)
    for _ in range(nsteps):
        T, *s = state
        s = groups(tuple(s), (T,), lead, chunks)
        state = (halo(t_update(T, *s[1:])), *s)
    return state


CADENCES = {"fused_k=2": dict(fused_k=2), "exchange_every=2": dict(exchange_every=2),
            "per_step": {}}


@pytest.mark.parametrize("batch", [False, True], ids=["block", "batch"])
@pytest.mark.parametrize("cadence", list(CADENCES))
@pytest.mark.parametrize("name", list(MODELS))
def test_cadence_equals_its_steps_by_hand(name, cadence, batch):
    state, params = _setup(name, batch)
    nsteps = 2 if name == "porous" else 4
    step = MODELS[name].make_multi_step(params, nsteps, batch=batch, autotune=False,
                                        **CADENCES[cadence])
    got = step(*(a.clone() for a in state))
    want = _by_hand(name, params, cadence, nsteps, batch, tuple(a.clone() for a in state))
    assert len(got) == len(want) == len(state)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert not torch.equal(got[0], state[0])
