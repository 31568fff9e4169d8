"""The port's pipelined group schedule and early slab exchange.

* `begin_slab_exchange` followed by `finish_slab_exchange` equals
  `update_halo(width=w)` bit for bit: on one rank (self partners, staggered
  fields, corners) and across two gloo ranks split in x and in y.
* The kernels' plain versions: the ring launch and the mid launch (written
  into the ring's outputs) equal one ``"all"`` launch bit for bit, ragged
  last tiles included; on the card the same for the CUDA kernels (``cuda``
  marker, skipped here).
* The pipelined cadence of each model equals its serialized cadence bit for
  bit (periodic x/y/z, a forced ``fused_tile``, ``pipelined=True``), on one
  rank and across two gloo ranks, the ragged porous schedule (npt=10, chunks [4, 4, 2])
  included, and the JAX package's ``pipelined=False`` cadence within the
  model tests' float64 tolerance (1e-12 relative; JAX runs float64 fused
  cadences as its plain cadence, the port its kernels' plain versions).
* ``pipelined=True`` where the split is not admissible warns once and runs
  the serialized schedule; ``pipelined`` on the per-step path raises JAX's
  error.
* Auto (``pipelined=None``) splits only where some x/y exchange has a
  partner other than the block itself: on one rank every partner is the
  block itself and auto runs the serialized schedule, the main configs of
  `chip_smoke.py` included.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import acoustic3d as ja
from implicitglobalgrid_tpu.models import diffusion3d as jd
from implicitglobalgrid_tpu.models import porous_convection3d as jpc
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import _fused
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
from implicitglobalgrid_tpu_torch.ops import fused_pt as fp
from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs
from implicitglobalgrid_tpu_torch.ops.halo import begin_slab_exchange, finish_slab_exchange


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def unique(shape, offset=0):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float64) + 1 + offset).reshape(shape)


def _staggered(nxyz):
    n0, n1, n2 = nxyz
    return [nxyz, (n0 + 1, n1, n2), (n0, n1 + 1, n2), (n0, n1, n2 + 1)]


# -- the early slab exchange --------------------------------------------------


@pytest.mark.parametrize("periods,width", [((1, 1, 1), 1), ((1, 1, 1), 2), ((0, 1, 1), 2),
                                           ((1, 0, 0), 1), ((0, 0, 0), 1)])
def test_begin_finish_equals_update_halo_one_rank(periods, width):
    nxyz = (10, 9, 8)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", periodx=periods[0],
                          periody=periods[1], periodz=periods[2], overlapx=4, overlapy=4,
                          overlapz=4)
    fields = [torch.from_numpy(unique(s, 1000 * i)) for i, s in enumerate(_staggered(nxyz))]
    want = [f.clone() for f in fields]
    tigg.update_halo(*want, width=width)
    got = [f.clone() for f in fields]
    pend = begin_slab_exchange(got, range(3), width=width)
    # finish on later tensors that hold the same owned values
    later = [g.clone() for g in got]
    finish_slab_exchange(later, pend)
    for g, w in zip(later, want):
        assert torch.equal(g, w)
    assert all(torch.equal(g, f) for g, f in zip(got, fields))  # begin writes nothing


@pytest.mark.parametrize("dims", [(2, 1, 1), (1, 2, 1)], ids=["x", "y"])
def test_begin_finish_equals_update_halo_two_ranks(dims, tmp_path):
    nxyz = (8, 9, 8)
    names = ["C", "Fx", "Fy", "Fz"]
    shapes = _staggered(nxyz)
    fields = [unique(tuple(d * s for d, s in zip(dims, shp)), 1000 * i)
              for i, shp in enumerate(shapes)]
    grid = dict(dimx=dims[0], dimy=dims[1], periodx=1, periody=1, periodz=1, overlapx=4,
                overlapy=4, overlapz=4)
    outs = spawn(dict(kind="halo", nxyz=list(nxyz), grid=grid, fields=names,
                      shapes=[list(s) for s in shapes], width=2, split=True,
                      inputs=dict(zip(names, fields))), 2, tmp_path, timeout=120)
    for out in outs:
        for name in names:
            assert np.array_equal(out[f"{name}_split"], out[name]), name


# -- subset launches of the kernels' plain versions ---------------------------


def _kernel_calls():
    lf = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)
    pt = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)
    return {
        "diffusion": (2, lambda ins, k, **kw: (fs.fused_diffusion_steps(
            *ins, k, 0.12, 0.06, 0.03, **kw),)),
        "leapfrog": (1, lambda ins, k, **kw: fl.fused_leapfrog_steps(*ins, k, *lf, **kw)),
        "pt": (2, lambda ins, k, **kw: fp.fused_pt_iterations(*ins, k, *pt, **kw)),
    }


def _inputs(name, shape, ncells, device="cpu", dtype=torch.float64):
    gen = torch.Generator(device=device).manual_seed(5)
    cells = [torch.rand(shape, generator=gen, device=device, dtype=dtype) + 1
             for _ in range(ncells)]
    if name == "diffusion":
        return cells
    return [*cells, *(0.1 * torch.randn(s, generator=gen, device=device, dtype=dtype)
                      for s in fl.face_shapes(shape))]


def _ring_mid(call, ins, k, tile, sel):
    ring = call(ins, k, tile=tile, tile_sel="ring" + sel)
    out = call(ins, k, tile=tile, tile_sel="mid" + sel, carry_in=ring)
    assert all(o is r for o, r in zip(out, ring))  # written into the ring's outputs
    return out


@pytest.mark.parametrize("name", ["diffusion", "leapfrog", "pt"])
@pytest.mark.parametrize("shape,tile", [((30, 29, 10), (8, 8, 4)), ((24, 32, 6), (6, 8, 6))])
def test_plain_ring_and_mid_equal_all(name, shape, tile):
    ncells, call = _kernel_calls()[name]
    ins = _inputs(name, shape, ncells)
    want = call(ins, 2, tile=tile)
    for sel in ("0", "1", "01"):
        got = _ring_mid(call, ins, 2, tile, sel)
        for g, w in zip(got, want):
            assert torch.equal(g, w), sel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["diffusion", "leapfrog", "pt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_ring_and_mid_equal_all(cuda_device, name, dtype):
    ncells, call = _kernel_calls()[name]
    shape, tile = (37, 45, 70), (10, 16, 32)
    ins = _inputs(name, shape, ncells, cuda_device, dtype)
    want = call(ins, 4, tile=tile)
    for sel in ("0", "1", "01"):
        got = _ring_mid(call, ins, 4, tile, sel)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), sel


# -- the pipelined cadences ---------------------------------------------------

#: (JAX model, port model, setup kwargs, nxyz, nsteps, fused_k, fused_tile)
CONFIGS = {
    "diffusion": (jd, td, dict(), (32, 30, 8), 4, 2, (8, 8)),
    "acoustic": (ja, ta, dict(), (32, 30, 8), 4, 2, (8, 8)),
    "porous": (jpc, tpc, dict(npt=5), (32, 30, 8), 1, 2, (8, 8)),
    "porous npt=10": (jpc, tpc, dict(npt=10), (48, 45, 16), 1, 4, (12, 12)),
}


def _grid_kw(k):
    o = 2 * k
    return dict(periodx=1, periody=1, periodz=1, overlapx=o, overlapy=o, overlapz=o)


def _jax_serialized(jm, kw, nxyz, nsteps, k, ndev=1, dimx=1):
    state, jparams = jm.setup(*nxyz, dtype=jnp.float64, quiet=True, devices=jax.devices()[:ndev],
                              dimx=dimx, **kw, **_grid_kw(k))
    state = [np.asarray(a) for a in state]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # JAX's float64 fused fallback
        want = jm.make_multi_step(jparams, nsteps, donate=False, fused_k=k, pipelined=False)(
            *map(jnp.asarray, state))
    return state, jparams, [np.asarray(a) for a in want]


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_pipelined_cadence_bitwise_one_rank(config, monkeypatch):
    jm, tm, kw, nxyz, nsteps, k, tile = CONFIGS[config]
    state, jparams, want = _jax_serialized(jm, kw, nxyz, nsteps, k)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **_grid_kw(k))
    assert tm.pipelined_support_error(nxyz, k, torch.float64, *tile) is None
    params = tm.params_from(jparams)
    tstate = tm.state_from_numpy(*state)
    groups = []
    real = _fused.run_pipelined_group_schedule
    monkeypatch.setattr(_fused, "run_pipelined_group_schedule",
                        lambda chunks, *a, **kw: groups.extend(chunks) or real(chunks, *a, **kw))
    piped = tm.make_multi_step(params, nsteps, fused_k=k, fused_tile=tile, pipelined=True)(
        *tstate)
    assert groups  # the pipelined schedule ran
    groups.clear()
    auto = tm.make_multi_step(params, nsteps, fused_k=k, fused_tile=tile)(*tstate)
    assert not groups  # one rank: every x/y partner is the block itself
    serial = tm.make_multi_step(params, nsteps, fused_k=k, fused_tile=tile, pipelined=False)(
        *tstate)
    for p, a, s, w in zip(piped, auto, serial, want):
        assert torch.equal(p, s) and torch.equal(a, s)
        _close(p.numpy(), w)


@pytest.mark.parametrize("config", ["diffusion", "acoustic", "porous npt=10"])
def test_pipelined_cadence_two_ranks(config, tmp_path):
    """Two gloo ranks split in x: the pipelined cadence's early exchange
    crosses processes (x) and stays local (self partners in y and z)."""
    jm, tm, kw, nxyz, nsteps, k, tile = CONFIGS[config]
    state, jparams, want = _jax_serialized(jm, kw, nxyz, nsteps, k, ndev=2, dimx=2)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **_grid_kw(k))
    assert tm.pipelined_support_error(nxyz, k, torch.float64, *tile) is None
    tigg.finalize_global_grid()
    params = tm.params_from(jparams)
    pj = {key: v for key, v in params.__dict__.items() if key != "dtype"}
    pj["dtype"] = "float64"
    kind = {jd: "multi_step", ja: "acoustic", jpc: "porous"}[jm]
    names = {"multi_step": ("T", "Cp"), "acoustic": ("P", "Vx", "Vy", "Vz"),
             "porous": ("T", "Pf", "qDx", "qDy", "qDz")}[kind]
    steps = [dict(fused_k=k, fused_tile=list(tile), pipelined=p) for p in (True, False)]
    outs = spawn(dict(kind=kind, nxyz=list(nxyz), grid=dict(dimx=2, **_grid_kw(k)),
                      params=pj, nsteps=nsteps, steps=steps,
                      inputs=dict(zip(names, state))), 2, tmp_path, timeout=180)
    for rank, out in enumerate(outs):
        for name, w in zip(names, want):
            assert np.array_equal(out[f"{name}0"], out[f"{name}1"]), (rank, name)
            n = w.shape[0] // 2  # the block layout: rank r holds rows [r*n, (r+1)*n)
            _close(out[f"{name}0"], w[rank * n:(rank + 1) * n])


def test_inadmissible_pipelined_warns_once_and_matches_serialized():
    nxyz = (24, 24, 8)  # (3, 3) tiles at (8, 8): one mid01 tile, not admissible
    (T, Cp), params = td.setup(*nxyz, dtype=torch.float64, quiet=True, device="cpu",
                               **_grid_kw(2))
    assert "mid01 has < 2 tiles" in td.pipelined_support_error(nxyz, 2, torch.float64, 8, 8)
    step = td.make_multi_step(params, 4, fused_k=2, fused_tile=(8, 8), pipelined=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [step(T, Cp)[0] for _ in range(2)]
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "running the serialized group schedule" in msgs[0]
    want, _ = td.make_multi_step(params, 4, fused_k=2, fused_tile=(8, 8), pipelined=False)(T, Cp)
    assert all(torch.equal(g, want) for g in got)


@pytest.mark.parametrize("jm,tm,kw", [(jd, td, {}), (ja, ta, {}), (jpc, tpc, dict(npt=2))],
                         ids=["diffusion", "acoustic", "porous"])
def test_pipelined_on_the_per_step_path_raises_like_jax(jm, tm, kw):
    _, jparams = jm.setup(8, 8, 8, dtype=jnp.float64, quiet=True, devices=jax.devices()[:1], **kw)
    with pytest.raises(ValueError) as je:
        jm.make_multi_step(jparams, 2, donate=False, pipelined=True)
    _, params = tm.setup(8, 8, 8, dtype=torch.float64, quiet=True, device="cpu", **kw)
    with pytest.raises(ValueError) as te:
        tm.make_multi_step(params, 2, pipelined=True)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="pass both bx and by"):
        tm.make_multi_step(params, 2, fused_k=2, fused_tile=(8, None))


#: The main configs of `chip_smoke.py` phases 3, 5 and 6: (port model, kernel
#: module, stagger, fused_k, overlap, periods).
MAIN_CONFIGS = {
    "diffusion": (td, fs, 0, 4, 8, (1, 1, 1)),
    "acoustic": (ta, fl, 1, 6, 12, (0, 0, 1)),
    "porous": (tpc, fp, 1, 6, 14, (0, 0, 1)),
}


def _plan(tm, kmod, stagger, k, gg, pipelined):
    model = {td: "diffusion", ta: "acoustic", tpc: "porous"}[tm]
    return _fused.group_plan(kmod, model, (256,) * 3, torch.float32, "cpu", k=k, width=k,
                             pipelined=pipelined, fused_tile=None, stagger=stagger, gg=gg)


@pytest.mark.parametrize("config", list(MAIN_CONFIGS))
def test_chip_configs_admit_the_split(config):
    """The x/y/z-periodic 256^3 twins that `chip_smoke.py` phase 7 pipelines
    (``pipelined=True``) admit the split at the default split tile (4 x
    segments).  The main configs stay serialized by default on one rank:
    diffusion's is periodic in x and y, but every partner is the block
    itself; acoustic's and porous's are periodic in z only (no x/y
    activity, as in JAX)."""
    tm, kmod, stagger, k, o, periods = MAIN_CONFIGS[config]
    tigg.init_global_grid(256, 256, 256, quiet=True, device="cpu", periodx=1, periody=1,
                          periodz=1, overlapx=o, overlapy=o, overlapz=o)
    assert tm.pipelined_support_error((256,) * 3, k, torch.float32) is None
    gg = tigg.global_grid()
    assert _plan(tm, kmod, stagger, k, gg, True) == (True, "01", (64, 16, 32))
    assert _plan(tm, kmod, stagger, k, gg, None) == (False, "01", None)
    tigg.finalize_global_grid()
    tigg.init_global_grid(256, 256, 256, quiet=True, device="cpu", periodx=periods[0],
                          periody=periods[1], periodz=periods[2], overlapx=o, overlapy=o,
                          overlapz=o)
    gg = tigg.global_grid()
    assert _plan(tm, kmod, stagger, k, gg, None)[0] is False  # the main path's default
    if periods[:2] == (0, 0):
        assert "no x/y halo activity" in tm.pipelined_support_error((256,) * 3, k,
                                                                   torch.float32)
    tigg.finalize_global_grid()


@pytest.mark.parametrize("config", list(MAIN_CONFIGS))
def test_support_error_plans_tiles_for_the_grids_device(config, monkeypatch):
    """Without ``device=``, `pipelined_support_error` plans its tiles for
    the grid's device: a grid on ``cuda:0`` reaches the kernel's
    `default_tile` with ``cuda:0``, not the CPU ladder's device.  The spy
    answers with the CPU ladder, so no card is needed."""
    import dataclasses

    tm, kmod, stagger, k, o, _ = MAIN_CONFIGS[config]
    tigg.init_global_grid(256, 256, 256, quiet=True, device="cpu", periodx=1, periody=1,
                          periodz=1, overlapx=o, overlapy=o, overlapz=o)
    seen = []

    def spy(shape, k, itemsize, device):
        seen.append(torch.device(device))
        return kmod.tile_for(shape, k, itemsize)

    monkeypatch.setattr(kmod, "default_tile", spy)
    assert tm.pipelined_support_error((256,) * 3, k, torch.float32) is None
    assert seen == [torch.device("cpu")]
    tigg.set_global_grid(dataclasses.replace(tigg.global_grid(), device=torch.device("cuda", 0)))
    assert tm.pipelined_support_error((256,) * 3, k, torch.float32) is None
    assert seen[1:] == [torch.device("cuda", 0)]
    assert tm.pipelined_support_error((256,) * 3, k, torch.float32, device="cpu") is None
    assert seen[2:] == [torch.device("cpu")]
    tigg.set_global_grid(dataclasses.replace(tigg.global_grid(), device=torch.device("cpu")))


@pytest.mark.parametrize("dims,sel", [((2, 1, 1), "01"), ((1, 2, 1), "01"), ((1, 1, 2), None)],
                         ids=["x", "y", "z"])
def test_auto_splits_where_an_xy_partner_is_another_block(dims, sel):
    """Auto takes the split where an x or y exchange crosses to another
    block (the grid seen by one rank of a ``dims`` split, periodic x/y/z);
    a z-only split leaves every x/y partner the block itself."""
    tm, kmod, stagger, k, o, _ = MAIN_CONFIGS["diffusion"]
    tigg.init_global_grid(256, 256, 256, quiet=True, device="cpu", periodx=1, periody=1,
                          periodz=1, overlapx=o, overlapy=o, overlapz=o)
    gg = tigg.global_grid().replace(dims=dims)
    split, got_sel, tile = _plan(tm, kmod, stagger, k, gg, None)
    assert split is (sel is not None)
    if split:
        assert (got_sel, tile) == (sel, (64, 16, 32))
    assert _plan(tm, kmod, stagger, k, gg, False) == (False, None, None)
