"""The PyTorch port's diffusion model against the JAX package's.

Both packages start from bit-identical inputs: the JAX state goes through
`state_from_numpy` into the port.  Tolerances: float64 1e-12 relative (the
JAX package's own cross-cadence tolerance), float32 four ULPs of the field's
scale (torch and XLA round the same expression differently in the last bit),
and the fused cadence rtol = atol = 1e-5 (the JAX package's fused-vs-XLA
tolerance).  Initial conditions: float64 within 4 ULPs of the field's scale,
float32 within 2 ULPs.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import diffusion3d as jd
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

DT = {np.float32: (jnp.float32, torch.float32), np.float64: (jnp.float64, torch.float64)}


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _setup_both(nxyz, dtype, ndev=1, **kw):
    jdt, tdt = DT[dtype]
    (TJ, CpJ), jparams = jd.setup(*nxyz, dtype=jdt, quiet=True, devices=jax.devices()[:ndev], **kw)
    return (np.asarray(TJ), np.asarray(CpJ)), jparams


def _tol(dtype, scale):
    if dtype == np.float64:
        return dict(rtol=1e-12, atol=1e-12 * scale)
    return dict(rtol=0, atol=4 * np.finfo(np.float32).eps * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("periodic", [0, 1])
def test_setup_ics_match_jax(dtype, periodic):
    kw = dict(periodx=periodic, periody=periodic, periodz=periodic)
    (TJ, CpJ), jparams = _setup_both((12, 10, 14), dtype, **kw)
    (T, Cp), params = td.setup(12, 10, 14, dtype=DT[dtype][1], quiet=True, device="cpu", **kw)
    assert (params.dx, params.dy, params.dz, params.dt) == (
        jparams.dx, jparams.dy, jparams.dz, jparams.dt
    )
    assert params == td.params_from(jparams)
    ulps = 4 if dtype == np.float64 else 2
    eps = np.finfo(dtype).eps
    assert T.dtype == Cp.dtype == DT[dtype][1]
    np.testing.assert_allclose(T.numpy(), TJ, rtol=0, atol=ulps * eps * np.abs(TJ).max())
    np.testing.assert_allclose(Cp.numpy(), CpJ, rtol=0, atol=ulps * eps * np.abs(CpJ).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cadence", ["make_step", "exchange_every=1", "exchange_every=2"])
def test_steps_match_jax_on_periodic_block(dtype, cadence):
    kw = dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)
    nxyz, nt = (12, 10, 14), 4
    (TJ, CpJ), jparams = _setup_both(nxyz, dtype, **kw)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    params = td.params_from(jparams)
    T, Cp = td.state_from_numpy(TJ, CpJ)
    if cadence == "make_step":
        jstep, tstep = jd.make_step(jparams, donate=False), td.make_step(params)
        tj, cj = jnp.asarray(TJ), jnp.asarray(CpJ)
        for _ in range(nt):
            tj, cj = jstep(tj, cj)
            T, Cp = tstep(T, Cp)
    else:
        w = int(cadence[-1])
        tj, _ = jd.make_multi_step(jparams, nt, donate=False, exchange_every=w)(
            jnp.asarray(TJ), jnp.asarray(CpJ)
        )
        T, Cp = td.make_multi_step(params, nt, exchange_every=w)(T, Cp)
    assert T.dtype == DT[dtype][1]
    np.testing.assert_allclose(T.numpy(), np.asarray(tj), **_tol(dtype, np.abs(TJ).max()))
    assert np.array_equal(Cp.numpy(), CpJ)


def test_fused_cadence_matches_jax_kernel_cadence():
    """fused_k=2 on a periodx=1, overlapx=4 block of (16, 32, 128): z has no
    halo activity, so the JAX package takes its kernel + slab-exchange
    cadence (`fused_block_step`) through the Pallas interpreter."""
    kw = dict(periodx=1, overlapx=4)
    nxyz, nt = (16, 32, 128), 4
    (TJ, CpJ), jparams = _setup_both(nxyz, np.float32, **kw)
    from implicitglobalgrid_tpu.ops.pallas_stencil import fused_support_error

    assert fused_support_error(nxyz, 2, 4) is None  # not the JAX fallback
    with pallas_force_interpret():
        step = jd.make_multi_step(jparams, nt, donate=False, fused_k=2, pipelined=False)
        tj, _ = step(jnp.asarray(TJ), jnp.asarray(CpJ))
        tj = np.asarray(jax.block_until_ready(tj))
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    T, Cp = td.state_from_numpy(TJ, CpJ)
    before = fs.launches
    T, _ = td.make_multi_step(td.params_from(jparams), nt, fused_k=2, pipelined=False)(T, Cp)
    assert fs.launches == before  # CPU tensors: the plain version, no launch
    np.testing.assert_allclose(T.numpy(), tj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("step_kw", [dict(), dict(exchange_every=2), dict(fused_k=2)])
def test_two_process_solver_matches_jax_two_devices(step_kw, tmp_path):
    """Two port ranks over gloo (dimx=2) against the JAX 2-device grid, per
    block, float64.  The JAX package runs fused_k in float64 as its
    exchange_every=k cadence (its kernel takes no float64); the port runs
    its kernel's plain version: same math, other constant folding."""
    kw = dict(dimx=2, periodx=1, overlapx=4)
    nxyz, nt = (10, 8, 8), 4
    (TJ, CpJ), jparams = _setup_both(nxyz, np.float64, ndev=2, **kw)
    assert jigg.get_global_grid().dims == (2, 1, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the JAX f64 fused fallback
        tj, _ = jd.make_multi_step(jparams, nt, donate=False, **step_kw)(
            jnp.asarray(TJ), jnp.asarray(CpJ)
        )
    tj = np.asarray(tj)
    pj = {k: getattr(jparams, k) for k in
          ("lam", "cp_min", "lx", "ly", "lz", "dx", "dy", "dz", "dt", "hide_comm")}
    pj["dtype"] = "float64"
    outs = spawn(
        dict(kind="multi_step", nxyz=list(nxyz), grid=kw, params=pj, nsteps=nt,
             step=step_kw, inputs=dict(T=TJ, Cp=CpJ)),
        2, tmp_path, timeout=120,
    )
    for rank, out in enumerate(outs):
        want = tj[rank * nxyz[0]:(rank + 1) * nxyz[0]]
        np.testing.assert_allclose(out["T"], want, rtol=1e-12, atol=1e-12 * np.abs(TJ).max())


def test_later_slices_raise_not_implemented():
    (T, Cp), params = td.setup(8, 8, 8, dtype=torch.float64, quiet=True, device="cpu")
    for kw in (dict(autotune=True),):
        with pytest.raises(NotImplementedError, match="later slice"):
            td.make_multi_step(params, 2, **kw)
    # Ported since: batch=True (Queue A item 10, tests/test_torch_batched.py);
    # (Queue A item 9): pipelined belongs to the group cadences,
    # as in JAX, and hide_comm runs (tests/test_torch_overlap.py).
    with pytest.raises(ValueError, match="per-step path has no group schedule"):
        td.make_multi_step(params, 2, pipelined=True)
    tigg.finalize_global_grid()
    (T, Cp), params = td.setup(8, 8, 8, hide_comm=True, dtype=torch.float64, quiet=True,
                               device="cpu")
    assert params.hide_comm and torch.isfinite(td.make_step(params)(T, Cp)[0]).all()


def test_cadence_errors_match_jax():
    kw = dict(periodx=1, overlapx=4)
    _, jparams = _setup_both((10, 8, 8), np.float64, **kw)
    _, params = td.setup(10, 8, 8, dtype=torch.float64, quiet=True, device="cpu", **kw)

    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for args, skw in [
        ((3,), dict(fused_k=2)),
        ((4,), dict(fused_k=2, exchange_every=4)),
        ((8,), dict(fused_k=4)),
        ((4,), dict(exchange_every=0)),
        ((3,), dict(exchange_every=2)),
        ((6,), dict(exchange_every=3)),
    ]:
        assert msg(lambda: td.make_multi_step(params, *args, **skw)) == msg(
            lambda: jd.make_multi_step(jparams, *args, **skw)
        ), skw


def _assert_fused_rejects_outside_the_kernel_envelope(device):
    (T, Cp), params = td.setup(12, 8, 8, dtype=torch.float32, quiet=True, device=device,
                               periodx=1, overlapx=6)
    before = fs.launches
    with pytest.raises(ValueError, match="even"):
        td.make_multi_step(params, 6, fused_k=3)(T, Cp)
    with pytest.raises(ValueError, match="float32 or float64"):
        td.make_multi_step(params, 4, fused_k=2)(T.bfloat16(), Cp.bfloat16())
    assert fs.launches == before


def test_kernel_envelope_raises_instead_of_falling_back():
    """A config the kernel does not take raises; it never runs the plain
    cadence in the kernel's place."""
    _assert_fused_rejects_outside_the_kernel_envelope("cpu")


@pytest.mark.cuda
def test_kernel_envelope_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    _assert_fused_rejects_outside_the_kernel_envelope(None)


def test_run_and_gather():
    T = td.run(3, 8, 8, 8, dtype=torch.float64, quiet=True, device="cpu", periodz=1)
    assert not tigg.grid_is_initialized() and T.shape == (8, 8, 8)
    assert torch.isfinite(T).all()
    (T, Cp), params = td.setup(8, 6, 5, dtype=torch.float32, quiet=True, device="cpu")
    G = tigg.gather(T)
    assert G.shape == (8, 6, 5) and np.array_equal(G, T.numpy())
    buf = np.zeros(8 * 6 * 5, np.float32)
    assert tigg.gather(T, buf) is None and np.array_equal(buf.reshape(8, 6, 5), G)
    with pytest.raises(ValueError, match="length nprocs"):
        tigg.gather(T, np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        tigg.gather(T, np.zeros(8 * 6 * 5, np.float64))
    with pytest.raises(ValueError, match="root must be"):
        tigg.gather(T, root=1)
    assert td.temperature((T, Cp)) is T


def test_readme_solver_ports_line_for_line():
    """The README's solver with `jnp` -> `torch` and the port's package: the
    `stencil` decorator passes through, so the step runs as written."""
    igg = tigg
    nx, nt = 8, 3
    lam, cp_min, lx, ly, lz = 1.0, 1.0, 10.0, 10.0, 10.0
    igg.init_global_grid(nx, nx, nx, quiet=True, device="cpu")
    dx = lx / (igg.nx_g() - 1); dy = ly / (igg.ny_g() - 1); dz = lz / (igg.nz_g() - 1)  # noqa: E702
    dt = min(dx * dx, dy * dy, dz * dz) * cp_min / lam / 8.1
    T = igg.zeros((nx, nx, nx), torch.float64)
    X, Y, Z = igg.coord_fields(T, (dx, dy, dz))

    @igg.stencil
    def init_ic(X, Y, Z):
        Cp = cp_min + 5 * torch.exp(-(X - lx / 1.5) ** 2 - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
        T = 100 * torch.exp(-((X - lx / 2) / 2) ** 2 - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 3) / 2) ** 2)
        return Cp, T

    Cp, T = init_ic(X, Y, Z)

    def inn(A):
        return A[1:-1, 1:-1, 1:-1]

    @igg.stencil(donate_argnums=(0,))
    def step(T, Cp):
        lap = ((T[2:, 1:-1, 1:-1] - 2 * inn(T) + T[:-2, 1:-1, 1:-1]) / (dx * dx)
               + (T[1:-1, 2:, 1:-1] - 2 * inn(T) + T[1:-1, :-2, 1:-1]) / (dy * dy)
               + (T[1:-1, 1:-1, 2:] - 2 * inn(T) + T[1:-1, 1:-1, :-2]) / (dz * dz))
        T = T + torch.nn.functional.pad(dt * lam / inn(Cp) * lap, (1, 1, 1, 1, 1, 1))
        return igg.update_halo(T), Cp

    igg.tic()
    for _ in range(nt):
        T, Cp = step(T, Cp)
    assert igg.toc() >= 0 and torch.isfinite(T).all()
