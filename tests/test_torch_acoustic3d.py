"""The PyTorch port's acoustic model against the JAX package's.

Both packages start from bit-identical inputs: the JAX state goes through
`state_from_numpy` into the port.  Tolerances: float64 1e-12 relative to the
pressure's scale, float32 four ULPs of that scale (torch and XLA round the
same expressions differently in the last bit), and the fused cadence rtol =
atol = 2e-5 (the JAX package's kernel-vs-XLA tolerance,
`tests/test_pallas_leapfrog.py`).  Initial conditions: float64 within 4 ULPs
of the field's scale, float32 within 2 ULPs.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import acoustic3d as ja
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl

DT = {np.float32: (jnp.float32, torch.float32), np.float64: (jnp.float64, torch.float64)}
NAMES = ("P", "Vx", "Vy", "Vz")


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _setup_both(nxyz, dtype, ndev=1, **kw):
    """The JAX state as numpy arrays, its params, and the port's grid."""
    state, jparams = ja.setup(*nxyz, dtype=DT[dtype][0], quiet=True,
                              devices=jax.devices()[:ndev], **kw)
    return tuple(np.asarray(a) for a in state), jparams


def _assert_close(got, want, dtype, scale):
    if dtype == np.float64:
        tol = dict(rtol=1e-12, atol=1e-12 * scale)
    else:
        tol = dict(rtol=0, atol=4 * np.finfo(np.float32).eps * scale)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == DT[dtype][1], name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("periodic", [0, 1])
def test_setup_ics_match_jax(dtype, periodic):
    kw = dict(periodx=periodic, periody=periodic, periodz=periodic)
    sj, jparams = _setup_both((12, 10, 14), dtype, **kw)
    state, params = ta.setup(12, 10, 14, dtype=DT[dtype][1], quiet=True, device="cpu", **kw)
    assert params == ta.params_from(jparams)
    eps = np.finfo(dtype).eps * (4 if dtype == np.float64 else 2)
    for name, a, w in zip(NAMES, state, sj):
        assert a.dtype == DT[dtype][1] and tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=eps * np.abs(sj[0]).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cadence", ["make_step", "exchange_every=1", "exchange_every=2"])
def test_steps_match_jax_on_periodic_block(dtype, cadence):
    kw = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)
    nxyz, nt = (12, 10, 14), 4
    sj, jparams = _setup_both(nxyz, dtype, **kw)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    params = ta.params_from(jparams)
    state = ta.state_from_numpy(*sj)
    if cadence == "make_step":
        jstep, tstep = ja.make_step(jparams, donate=False), ta.make_step(params)
        want = tuple(map(jnp.asarray, sj))
        for _ in range(nt):
            want = jstep(*want)
            state = tstep(*state)
    else:
        w = int(cadence[-1])
        want = ja.make_multi_step(jparams, nt, donate=False, exchange_every=w)(
            *map(jnp.asarray, sj))
        state = ta.make_multi_step(params, nt, exchange_every=w)(*state)
    _assert_close(state, want, dtype, np.abs(sj[0]).max())


@pytest.mark.parametrize("periodx", [1, 0])
def test_fused_cadence_matches_jax_kernel_cadence(periodx):
    """fused_k=2 on a (16, 32, 128) block, periodic in x with overlap 4 (z
    has no halo activity, so the JAX package takes its kernel + slab
    exchange cadence, `fused_block_step`) or not periodic at all (the kernel
    alone); the JAX kernel runs through the Pallas interpreter."""
    kw = dict(periodx=periodx, overlapx=4)
    nxyz, nt = (16, 32, 128), 4
    sj, jparams = _setup_both(nxyz, np.float32, **kw)
    from implicitglobalgrid_tpu.ops.pallas_leapfrog import fused_support_error

    assert fused_support_error(nxyz, 2, 4) is None  # not the JAX fallback
    with pallas_force_interpret():
        step = ja.make_multi_step(jparams, nt, donate=False, fused_k=2, pipelined=False)
        want = jax.block_until_ready(step(*map(jnp.asarray, sj)))
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    before = fl.launches
    got = ta.make_multi_step(ta.params_from(jparams), nt, fused_k=2, pipelined=False)(
        *ta.state_from_numpy(*sj))
    assert fl.launches == before  # CPU tensors: the plain version, no launch
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("step_kw", [dict(), dict(fused_k=2)])
def test_two_process_solver_matches_jax_two_devices(step_kw, tmp_path):
    """Two port ranks over gloo (dimx=2) against the JAX 2-device grid, per
    block, float64.  The JAX package runs fused_k in float64 as its plain
    cadence (its kernel takes no float64); the port runs its kernel's plain
    version: same math, other constant folding."""
    kw = dict(dimx=2, periodx=1, overlapx=4)
    nxyz, nt = (10, 8, 8), 4
    sj, jparams = _setup_both(nxyz, np.float64, ndev=2, **kw)
    assert jigg.get_global_grid().dims == (2, 1, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the JAX f64 fused fallback
        want = ja.make_multi_step(jparams, nt, donate=False, **step_kw)(*map(jnp.asarray, sj))
    want = [np.asarray(a) for a in want]
    pj = {f: getattr(jparams, f) for f in ("K", "rho", "lx", "ly", "lz", "dx", "dy", "dz",
                                            "dt", "hide_comm")}
    pj["dtype"] = "float64"
    outs = spawn(
        dict(kind="acoustic", nxyz=list(nxyz), grid=kw, params=pj, nsteps=nt, step=step_kw,
             inputs=dict(zip(NAMES, sj))),
        2, tmp_path, timeout=120,
    )
    scale = np.abs(sj[0]).max()
    for rank, out in enumerate(outs):
        for name, w in zip(NAMES, want):
            n = w.shape[0] // 2  # the block layout: rank r holds rows [r*n, (r+1)*n)
            np.testing.assert_allclose(out[name], w[rank * n:(rank + 1) * n], rtol=1e-12,
                                       atol=1e-12 * scale, err_msg=f"{name} rank {rank}")


def test_later_slices_raise_not_implemented(tmp_path, monkeypatch):
    state, params = ta.setup(8, 8, 8, dtype=torch.float64, quiet=True, device="cpu")
    # Ported since: autotune=True (Queue A item 15, tests/test_torch_tuning.py)
    # searches, stores and applies a winner, a pure schedule substitution;
    monkeypatch.setenv("IGG_TUNE_CACHE", str(tmp_path))
    tuned = ta.make_multi_step(params, 2, autotune=True)(*state)
    for a, b in zip(tuned, ta.make_multi_step(params, 2)(*state)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert len(list(tmp_path.glob("acoustic3d_8x8x8_float64_*.json"))) == 1
    # Ported since: coalesce=True (Queue A leftover 2, tests/test_torch_coalesced.py)
    # runs, bit for bit with coalesce=False;
    assert all(torch.equal(a, b) for a, b in zip(
        ta.make_multi_step(params, 2, coalesce=True)(*state),
        ta.make_multi_step(params, 2, coalesce=False)(*state)))
    # batch=True (Queue A item 10, tests/test_torch_batched.py);
    # (Queue A item 9): pipelined belongs to the group cadences,
    # as in JAX, and hide_comm runs (tests/test_torch_overlap.py).
    with pytest.raises(ValueError, match="per-step path has no group schedule"):
        ta.make_multi_step(params, 2, pipelined=True)
    hidden = ta.Params(**{**params.__dict__, "hide_comm": True})
    assert all(torch.isfinite(a).all() for a in ta.make_step(hidden)(*state))
    tigg.finalize_global_grid()
    state, params = ta.setup(8, 8, 8, hide_comm=True, dtype=torch.float64, quiet=True,
                             device="cpu")
    assert params.hide_comm
    tigg.finalize_global_grid()
    # run(guard_every=...) (Queue A item 12, tests/test_torch_resilience.py).
    P = ta.run(1, 8, 8, 8, quiet=True, device="cpu", guard_every=1)
    assert torch.isfinite(P).all()
    assert not tigg.grid_is_initialized()


def test_cadence_errors_match_jax():
    kw = dict(periodx=1, overlapx=4)
    _, jparams = _setup_both((10, 8, 8), np.float64, **kw)
    _, params = ta.setup(10, 8, 8, dtype=torch.float64, quiet=True, device="cpu", **kw)
    hidden = (ta.Params(**{**params.__dict__, "hide_comm": True}),
              ja.Params(**{**jparams.__dict__, "hide_comm": True}))

    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for args, skw, hide in [
        ((3,), dict(fused_k=2), False),
        ((4,), dict(fused_k=2, exchange_every=4), False),
        ((8,), dict(fused_k=4), False),
        ((4,), dict(exchange_every=0), False),
        ((3,), dict(exchange_every=2), False),
        ((6,), dict(exchange_every=3), False),
        ((4,), dict(fused_k=2), True),
        ((4,), dict(exchange_every=2), True),
    ]:
        tp, jp = hidden if hide else (params, jparams)
        assert msg(lambda: ta.make_multi_step(tp, *args, **skw)) == msg(
            lambda: ja.make_multi_step(jp, *args, **skw)
        ), (skw, hide)


def _assert_fused_rejects_outside_the_kernel_envelope(device):
    state, params = ta.setup(12, 8, 8, dtype=torch.float32, quiet=True, device=device,
                             periodx=1, overlapx=6)
    before = fl.launches
    with pytest.raises(ValueError, match="even"):
        ta.make_multi_step(params, 6, fused_k=3)(*state)
    with pytest.raises(ValueError, match="float32 or float64"):
        ta.make_multi_step(params, 4, fused_k=2)(*(a.bfloat16() for a in state))
    assert fl.launches == before


def test_kernel_envelope_raises_instead_of_falling_back():
    """A config the kernel does not take raises; it never runs the plain
    cadence in the kernel's place."""
    _assert_fused_rejects_outside_the_kernel_envelope("cpu")


@pytest.mark.cuda
def test_kernel_envelope_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    _assert_fused_rejects_outside_the_kernel_envelope(None)


def test_run_and_pressure():
    P = ta.run(3, 8, 8, 8, dtype=torch.float64, quiet=True, device="cpu", periodz=1)
    assert not tigg.grid_is_initialized() and P.shape == (8, 8, 8)
    assert torch.isfinite(P).all()
    state, _ = ta.setup(8, 6, 5, dtype=torch.float32, quiet=True, device="cpu")
    assert ta.pressure(state) is state[0]
