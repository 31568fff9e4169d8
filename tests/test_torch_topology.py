"""The PyTorch port's topology, grid and index math against the JAX package.

The same arguments go through `implicitglobalgrid_tpu` (the reference) and
`implicitglobalgrid_tpu_torch`; integer results and coordinates must be
bit-exact.  Multi-block topologies are simulated on one process by replacing
the grid record's ``dims`` (the reference's simulated-topology trick).
"""

import ast
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.parallel import topology as jtopo
from implicitglobalgrid_tpu_torch.parallel import topology as ttopo

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("nprocs", [1, 2, 4, 6, 8, 12, 16, 30])
def test_dims_create_matches_jax(nprocs):
    for dims in [(0, 0, 0), (2, 0, 0), (0, 0, 1), (1, 2, 0), (0, 3, 0), (2, 2, 2), (-1, 0, 0)]:
        assert _outcome(ttopo.dims_create, nprocs, dims) == _outcome(
            jtopo.dims_create, nprocs, dims
        ), (nprocs, dims)


@pytest.mark.parametrize(
    "dims,periods,disp",
    [
        ((2, 3, 4), (0, 0, 0), 1),
        ((2, 3, 4), (1, 0, 1), 1),
        ((4, 1, 2), (1, 1, 1), 2),
        ((3, 3, 3), (0, 1, 0), 2),
        ((1, 1, 1), (1, 0, 1), 1),
    ],
)
def test_neighbors_and_global_shape_match_jax(dims, periods, disp):
    for rank in range(int(np.prod(dims))):
        c = ttopo.coords_of_rank(rank, dims)
        assert c == jtopo.coords_of_rank(rank, dims)
        assert ttopo.rank_of_coords(c, dims) == rank
        np.testing.assert_array_equal(
            ttopo.neighbors_table(c, dims, periods, disp),
            jtopo.neighbors_table(c, dims, periods, disp),
        )
    for nxyz, overlaps in [((8, 8, 8), (2, 2, 2)), ((9, 6, 5), (3, 2, 4))]:
        assert ttopo.implied_global_shape(nxyz, dims, overlaps, periods) == (
            jtopo.implied_global_shape(nxyz, dims, overlaps, periods)
        )


def _both_grids(nxyz, dims, **kw):
    """A JAX one-device grid and a torch CPU grid with the same arguments,
    both re-labelled to the simulated topology ``dims``."""
    jigg.init_global_grid(*nxyz, dimx=1, dimy=1, dimz=1, quiet=True,
                          devices=jax.devices()[:1], **kw)
    tigg.init_global_grid(*nxyz, dimx=1, dimy=1, dimz=1, quiet=True, device="cpu", **kw)
    for mod in (jigg, tigg):
        gg = mod.get_global_grid()
        nxyz_g = jtopo.implied_global_shape(gg.nxyz, dims, gg.overlaps, gg.periods)
        mod.set_global_grid(gg.replace(dims=tuple(dims), nxyz_g=nxyz_g,
                                       nprocs=int(np.prod(dims))))


@pytest.mark.parametrize(
    "nxyz,dims,kw",
    [
        ((5, 5, 5), (3, 3, 3), dict(periodz=1)),
        ((8, 8, 8), (2, 2, 1), dict(overlapx=3, periodx=1, periody=1)),
        ((6, 5, 7), (2, 1, 4), dict(periodx=1, periody=1, periodz=1)),
        ((7, 6, 6), (1, 2, 2), dict(overlapy=4, overlapz=3)),
    ],
)
def test_global_sizes_and_coordinates_bit_exact(nxyz, dims, kw):
    _both_grids(nxyz, dims, **kw)
    shapes = [nxyz, (nxyz[0] + 1, nxyz[1], nxyz[2]), (nxyz[0], nxyz[1] - 2, nxyz[2] + 2)]
    for shp in shapes:
        # The port's field is the local block; the JAX package's is the
        # global-block array of dims*local.
        A = np.zeros(shp)
        AJ = np.zeros(tuple(d * s for d, s in zip(dims, shp)))
        for f in ("nx_g", "ny_g", "nz_g"):
            assert getattr(tigg, f)(A) == getattr(jigg, f)(AJ)
            assert getattr(tigg, f)() == getattr(jigg, f)()
        for name, d in (("x_g", 0.37), ("y_g", 10 / 123), ("z_g", 1.25)):
            dim = "xyz".index(name[0])
            for cidx in range(dims[dim]):
                c = [0, 0, 0]
                c[dim] = cidx
                for i in range(shp[dim]):
                    got = getattr(tigg, name)(i, d, A, coords=tuple(c))
                    want = getattr(jigg, name)(i, d, AJ, coords=tuple(c))
                    assert got == want, (name, shp, c, i)
                # vectorized: a float64 index tensor gives the same values
                vec = getattr(tigg, name)(torch.arange(shp[dim], dtype=torch.float64), d, A,
                                          coords=tuple(c))
                want = [getattr(jigg, name)(i, d, AJ, coords=tuple(c)) for i in range(shp[dim])]
                assert vec.tolist() == want


@pytest.mark.parametrize("periodic", [0, 1])
def test_coord_fields_match_jax(periodic):
    kw = dict(periodx=periodic, periody=periodic, periodz=periodic, quiet=True)
    jigg.init_global_grid(6, 5, 7, devices=jax.devices()[:1], **kw)
    tigg.init_global_grid(6, 5, 7, device="cpu", **kw)
    sp = (0.3, 10 / 123, 1.7)
    for shp in [(6, 5, 7), (7, 5, 7), (6, 5, 8)]:
        J = jigg.coord_fields(jigg.zeros(shp, jax.numpy.float64), sp)
        Tt = tigg.coord_fields(tigg.zeros(shp, torch.float64), sp)
        for dim, (a, b) in enumerate(zip(J, Tt)):
            # Within a few ULPs of the domain length of the JAX fields (XLA
            # re-associates the coordinate arithmetic inside its compiled
            # block function: -5.6e-17 there where the formula gives 0.0) ...
            length = tigg.get_global_grid().nxyz_g[dim] * sp[dim]
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=8 * np.finfo(np.float64).eps * length)
            # ... and bit-exact against the JAX package's host x_g/y_g/z_g.
            host = [(jigg.x_g, jigg.y_g, jigg.z_g)[dim](i, sp[dim], np.zeros(shp))
                    for i in range(shp[dim])]
            assert np.moveaxis(b.numpy(), dim, 0)[:, 0, 0].tolist() == host


def test_init_returns_and_grid_record():
    me, dims, nprocs, coords, device = tigg.init_global_grid(
        8, 6, 4, periody=1, overlapz=3, quiet=True, device="cpu"
    )
    assert (me, dims, nprocs, coords, device) == (0, (1, 1, 1), 1, (0, 0, 0), torch.device("cpu"))
    gg = tigg.get_global_grid()
    assert gg.nxyz_g == (8, 4, 4) and gg.overlaps == (2, 2, 3)
    assert tigg.select_device() == torch.device("cpu")


def test_field_constructors_and_shape_helpers():
    tigg.init_global_grid(6, 5, 5, periodz=1, overlapz=3, quiet=True, device="cpu")
    assert tigg.zeros((6, 5, 5)).dtype == torch.get_default_dtype()
    assert torch.equal(tigg.ones(6, torch.float64), torch.ones(6, dtype=torch.float64))
    assert torch.equal(tigg.full((2, 3), 7, torch.int32), torch.full((2, 3), 7, dtype=torch.int32))
    A = tigg.from_block_fn(lambda c: np.full((6, 5, 5), 1 + c[0]), (6, 5, 5), torch.float32)
    assert A.dtype == torch.float32 and float(A.sum()) == 150.0
    with pytest.raises(ValueError, match="expected"):
        tigg.from_block_fn(lambda c: np.zeros((2, 2)), (6, 5, 5))
    V = torch.zeros(6, 5, 6)
    assert tigg.local_shape(V) == (6, 5, 6) and tigg.halosize(2, V) == (6, 5)
    assert [tigg.ol(d, V) for d in range(3)] == [2, 2, 4]
    g = np.arange(2 * 6 * 5 * 5).reshape(12, 5, 5)
    with pytest.raises(ValueError, match="neither one block"):
        tigg.block_from_numpy(g)
    assert torch.equal(tigg.block_from_numpy(g[6:]), torch.from_numpy(g[6:]))
    # a global-block array on a (simulated) 2x1x1 grid: the block at coords
    gg = tigg.get_global_grid()
    tigg.set_global_grid(gg.replace(dims=(2, 1, 1), nprocs=2, coords=(1, 0, 0), me=1))
    assert torch.equal(tigg.block_from_numpy(g), torch.from_numpy(g[6:]))
    assert torch.equal(tigg.block_from_numpy(g, coords=(0, 0, 0)), torch.from_numpy(g[:6]))


def test_error_contracts_match_jax():
    def msg(fn):
        with pytest.raises((ValueError, RuntimeError)) as e:
            fn()
        return type(e.value), str(e.value)

    for args, kw in [
        ((1, 4, 4), {}),
        ((4, 1, 4), {}),
        ((4, 4, 1), dict(dimz=2)),
        ((3, 4, 4), dict(periodx=1, overlapx=3)),
    ]:
        j = msg(lambda: jigg.init_global_grid(*args, quiet=True, devices=jax.devices()[:1], **kw))
        t = msg(lambda: tigg.init_global_grid(*args, quiet=True, device="cpu", **kw))
        assert j == t
    # not initialized, for every grid-bound entry point
    for fn in ("nx_g", "finalize_global_grid", "tic", "toc", "get_global_grid", "select_device"):
        assert msg(getattr(tigg, fn)) == msg(getattr(jigg, fn))
    assert msg(lambda: tigg.update_halo(torch.zeros(4, 4, 4))) == msg(
        lambda: jigg.update_halo(np.zeros((4, 4, 4)))
    )
    # double init
    jigg.init_global_grid(4, 4, 4, quiet=True, devices=jax.devices()[:1])
    tigg.init_global_grid(4, 4, 4, quiet=True, device="cpu")
    assert msg(lambda: tigg.init_global_grid(4, 4, 4, device="cpu")) == msg(
        lambda: jigg.init_global_grid(4, 4, 4, devices=jax.devices()[:1])
    )
    # toc before tic
    assert msg(tigg.toc) == msg(jigg.toc)
    tigg.tic()
    assert tigg.toc() >= 0.0
    tigg.finalize_global_grid()
    tigg.init_global_grid(4, 4, 4, quiet=True, device="cpu")  # re-init after finalize


def test_env_tier(monkeypatch):
    monkeypatch.setenv("IGG_OVERLAP", "4")
    monkeypatch.setenv("IGG_QUIET", "1")
    tigg.init_global_grid(9, 9, 9, overlapy=2, device="cpu")
    gg = tigg.get_global_grid()
    assert gg.overlaps == (4, 2, 4) and gg.quiet
    tigg.finalize_global_grid()
    monkeypatch.setenv("IGG_OVERLAP", "two")
    with pytest.raises(ValueError, match="IGG_OVERLAP must be an integer"):
        tigg.init_global_grid(9, 9, 9, device="cpu")


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tigg.init_global_grid(8, 8, 8, quiet=True)
    assert not tigg.grid_is_initialized()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with jax blocked
    and without touching the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import implicitglobalgrid_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'implicitglobalgrid_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in [REPO / "chip_smoke.py", *sorted((REPO / "implicitglobalgrid_tpu_torch").rglob("*.py"))]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "implicitglobalgrid_tpu"), (path, name)
