"""The PyTorch port's overlap layer (`ops/overlap.py`) against the JAX package's.

* The tile-subset tables equal the JAX functions on JAX's own test grids,
  and ring/mid partition every tile.
* `tile_split_error` equals JAX's verdict wherever the two geometries agree
  (``bx | n0`` and ``by | n1``), and holds the port's ragged last tile to the
  same rules.
* `hide_communication` equals the port's plain ``update_halo(update(...))``
  bit for bit, and JAX's ``igg.stencil(igg.hide_communication(...))`` within
  1e-12 in float64 (the JAX package's own overlap tolerance), on one rank
  and across two gloo ranks (through the models' ``hide_comm``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.ops import overlap as jov
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import acoustic3d as ta
from implicitglobalgrid_tpu_torch.models import diffusion3d as td
from implicitglobalgrid_tpu_torch.models import porous_convection3d as tpc
from implicitglobalgrid_tpu_torch.ops import overlap as tov


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


# -- the tile-subset tables --------------------------------------------------


@pytest.mark.parametrize("ncx,ncy", [(3, 1), (3, 3), (4, 3), (5, 4), (8, 1)])
def test_subset_tables_match_jax_and_partition(ncx, ncy):
    assert tov.TILE_SELS == jov.TILE_SELS
    allt = set(range(ncx * ncy))
    for dims in ("0", "1", "01"):
        if ("0" in dims and ncx < 3) or ("1" in dims and ncy < 3):
            continue
        tiles = {}
        for kind in ("ring", "mid"):
            sel = kind + dims
            count = tov.tile_subset_count(sel, ncx, ncy)
            assert count == jov.tile_subset_count(sel, ncx, ncy)
            t_of, j_of = tov.tile_subset_map(sel, ncx, ncy), jov.tile_subset_map(sel, ncx, ncy)
            tiles[kind] = [t_of(i) for i in range(count)]
            assert tiles[kind] == [j_of(i) for i in range(count)]
            assert len(set(tiles[kind])) == count
        ring, mid = set(tiles["ring"]), set(tiles["mid"])
        assert ring | mid == allt and not ring & mid
        for t in mid:  # interior tiles never touch a split dim's edge
            ix, iy = divmod(t, ncy)
            assert "0" not in dims or 0 < ix < ncx - 1
            assert "1" not in dims or 0 < iy < ncy - 1
    assert tov.tile_subset_map("all", ncx, ncy)(ncx * ncy - 1) == ncx * ncy - 1
    with pytest.raises(ValueError, match="unknown tile subset"):
        tov.tile_subset_count("ring2", ncx, ncy)


def test_tile_split_error_matches_jax_where_the_geometries_agree():
    shapes = [(n0, n1, 128) for n0 in (16, 24, 48) for n1 in (16, 24, 48)]
    n = 0
    for shape in shapes:
        for bx in (4, 8, 16):
            for by in (4, 8, 16):
                if shape[0] % bx or shape[1] % by:
                    continue
                for k, o, active in ((2, 4, (0,)), (2, 4, (1,)), (4, 8, (0, 1)), (2, 5, (0, 1)),
                                     (4, 9, (1,)), (2, 4, ())):
                    args = (shape, k, k, bx, by, k, active)
                    kw = dict(ox=o, oy=o)
                    got, want = tov.tile_split_error(*args, **kw), jov.tile_split_error(*args, **kw)
                    assert (got is None) == (want is None), (args, got, want)
                    n += got is None
    assert n > 10  # the table admits some splits


@pytest.mark.parametrize("case", [
    # (shape, k, width, bx, by, active, ox, oy) -> admissible?
    (((30, 32, 8), 2, 2, 8, 8, (0,), 4, 4), True),     # last x segment 6 >= ox, >= k+w
    (((27, 32, 8), 2, 2, 8, 8, (0,), 4, 4), False),    # last x segment 3 < ox = 4
    (((28, 32, 8), 2, 2, 8, 8, (0,), 4, 4), True),     # last segment 4: ox 4, k+w 4
    (((28, 32, 8), 2, 2, 8, 8, (0,), 5, 5), False),    # staggered ox 5 > last segment 4
    (((32, 30, 8), 2, 2, 8, 8, (1,), 5, 5), True),     # ragged y: last tile 6
    (((32, 29, 8), 2, 2, 8, 8, (1,), 4, 4), True),     # ragged y: last tile 5 >= ox, k+w
    (((32, 20, 8), 4, 4, 8, 8, (1,), 4, 4), False),    # last y tile 4 < H+w = 8
    (((17, 32, 8), 2, 2, 8, 8, (0,), 4, 4), False),    # 3 segments, the last of 1 plane
    (((16, 32, 8), 2, 2, 8, 8, (0,), 4, 4), False),    # 2 segments: no interior
])
def test_tile_split_error_ragged_last_tile(case):
    (shape, k, w, bx, by, active, ox, oy), admissible = case
    err = tov.tile_split_error(shape, k, w, bx, by, k, active, ox=ox, oy=oy)
    assert (err is None) == admissible, err


def test_check_tile_subset_rejects_bad_requests():
    T = torch.zeros(32, 32, 8)
    tile = (8, 8, 8)
    assert tov.check_tile_subset("all", None, (32, 32), tile, (T,)) is None
    assert tov.check_tile_subset("ring01", None, (32, 32), tile, (T,)) is None
    assert tov.check_tile_subset("mid01", T, (32, 32), tile, (T,)) == (T,)
    for sel, carry, match in (
        ("all", T, "only for 'mid"),
        ("ring0", T, "only for 'mid"),
        ("mid1", None, "needs carry_in"),
        ("mid1", (T, T), "1 output"),
        ("mid1", torch.zeros(32, 32, 9), "does not match"),
        ("ring9", None, "must be one of"),
    ):
        with pytest.raises(ValueError, match=match):
            tov.check_tile_subset(sel, carry, (32, 32), tile, (T,))
    with pytest.raises(ValueError, match="needs >= 2"):
        tov.check_tile_subset("mid01", T, (24, 24), tile, (T,))  # (3, 3): one mid tile


# -- hide_communication ------------------------------------------------------


def _laplacian_step(T):
    # the JAX test's radius-1 update, written for both frameworks
    dT = (T[:-2, 1:-1, 1:-1] + T[2:, 1:-1, 1:-1] + T[1:-1, :-2, 1:-1] + T[1:-1, 2:, 1:-1]
          + T[1:-1, 1:-1, :-2] + T[1:-1, 1:-1, 2:] - 6.0 * T[1:-1, 1:-1, 1:-1])
    if isinstance(T, torch.Tensor):
        out = T.clone()
        out[1:-1, 1:-1, 1:-1] += 0.1 * dT
        return out
    return T.at[1:-1, 1:-1, 1:-1].add(0.1 * dT)


def _staggered_step(P, Vx):
    if isinstance(P, torch.Tensor):
        Vx = Vx.clone()
        Vx[1:-1] += P[1:] - P[:-1]
        return P - 0.1 * (Vx[1:] - Vx[:-1]), Vx
    Vx = Vx.at[1:-1, :, :].add(P[1:, :, :] - P[:-1, :, :])
    return P.at[:, :, :].add(-0.1 * (Vx[1:, :, :] - Vx[:-1, :, :])), Vx


def _both(step, fields, **grid):
    """The port's hide_communication and plain step, and JAX's overlapped
    step, from the same numpy fields on one block."""
    jigg.init_global_grid(8, 8, 8, quiet=True, devices=jax.devices()[:1], **grid)
    jout = jigg.stencil(jigg.hide_communication(step, radius=1))(*map(jnp.asarray, fields))
    jout = [np.asarray(a) for a in ((jout,) if not isinstance(jout, tuple) else jout)]
    jigg.finalize_global_grid()
    tigg.init_global_grid(8, 8, 8, quiet=True, device="cpu", **grid)
    tin = [torch.from_numpy(f.copy()) for f in fields]
    hidden = tov.hide_communication(step, radius=1)(*tin)
    plain = step(*tin)
    plain = tigg.update_halo(*((plain,) if isinstance(plain, torch.Tensor) else plain))
    as_tuple = lambda x: (x,) if isinstance(x, torch.Tensor) else tuple(x)  # noqa: E731
    return as_tuple(hidden), as_tuple(plain), jout


@pytest.mark.parametrize("periods", [(0, 0, 0), (1, 1, 1), (0, 0, 1)])
def test_hide_communication_equals_plain_and_jax(periods):
    f = np.random.default_rng(0).normal(size=(8, 8, 8))
    grid = dict(periodx=periods[0], periody=periods[1], periodz=periods[2])
    hidden, plain, jout = _both(_laplacian_step, [f], **grid)
    assert torch.equal(hidden[0], plain[0])
    np.testing.assert_allclose(hidden[0].numpy(), jout[0], rtol=1e-12, atol=1e-12)


def test_hide_communication_multifield_staggered():
    rng = np.random.default_rng(1)
    fields = [rng.normal(size=(8, 8, 8)), rng.normal(size=(9, 8, 8))]
    hidden, plain, jout = _both(_staggered_step, fields, periodz=1)
    for h, p, j in zip(hidden, plain, jout):
        assert torch.equal(h, p)
        np.testing.assert_allclose(h.numpy(), j, rtol=1e-12, atol=1e-12)


def test_hide_communication_errors_match_jax():
    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for shape, radius in (((3, 8, 8), 1), ((8, 8, 8), 3)):
        f = np.ones(shape)
        jigg.init_global_grid(*shape, quiet=True, periodx=1, devices=jax.devices()[:1])
        want = msg(lambda: jigg.stencil(jigg.hide_communication(_laplacian_step, radius=radius))(
            jnp.asarray(f)))
        jigg.finalize_global_grid()
        tigg.init_global_grid(*shape, quiet=True, periodx=1, device="cpu")
        got = msg(lambda: tov.hide_communication(_laplacian_step, radius=radius)(
            torch.from_numpy(f)))
        tigg.finalize_global_grid()
        assert got == want


def _model_state(model, shape, **kw):
    state, params = model.setup(*shape, dtype=torch.float64, quiet=True, device="cpu",
                                periodx=1, periody=1, periodz=1, hide_comm=True, **kw)
    gen = torch.Generator().manual_seed(2)
    state = tuple(a + 0.01 * torch.rand(a.shape, generator=gen, dtype=a.dtype) for a in state)
    return state, params


@pytest.mark.parametrize("model,kw", [(td, {}), (ta, {}), (tpc, dict(npt=3))],
                         ids=["diffusion", "acoustic", "porous"])
def test_models_hide_comm_equals_plain(model, kw):
    state, params = _model_state(model, (10, 9, 8), **kw)
    plain = model.Params(**{**params.__dict__, "hide_comm": False})
    nt = 2
    got = model.make_multi_step(params, nt)(*state)
    want = model.make_multi_step(plain, nt)(*state)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    step_h, step_p = model.make_step(params), model.make_step(plain)
    for g, w in zip(step_h(*state), step_p(*state)):
        assert torch.equal(g, w)


def test_hide_comm_two_ranks(tmp_path):
    """Acoustic ``hide_comm`` over two gloo ranks split in x: bit-identical
    to the plain per-step cadence on every rank."""
    rng = np.random.default_rng(3)
    nxyz = (8, 8, 8)
    shapes = ((16, 8, 8), (18, 8, 8), (16, 9, 8), (16, 8, 9))
    inputs = dict(zip(("P", "Vx", "Vy", "Vz"), (rng.normal(size=s) for s in shapes)))
    pj = dict(dx=0.7, dy=0.6, dz=0.5, dt=0.2, dtype="float64")
    outs = spawn(dict(kind="acoustic", nxyz=list(nxyz), grid=dict(dimx=2, periodx=1, periody=1),
                      params=pj, nsteps=3, steps=[dict(hide_comm=True), dict(hide_comm=False)],
                      inputs=inputs), 2, tmp_path, timeout=120)
    for out in outs:
        for name in ("P", "Vx", "Vy", "Vz"):
            assert np.array_equal(out[f"{name}0"], out[f"{name}1"]), name
