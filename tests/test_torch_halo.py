"""The PyTorch port's `update_halo` against the JAX package's, bit-exact.

Coordinate-encoding oracle: every element of the global-block field holds a
unique value, so any misplaced plane shows.  One process: the port's grid
against a one-device JAX grid.  Several processes: two or four port ranks
over gloo (worker processes that never import JAX,
`implicitglobalgrid_tpu_torch._workers`) against a JAX grid of as many
devices, block by block.
"""

import jax
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu_torch._workers import spawn


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def unique(shape, dtype, offset=0):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float64) + 1 + offset).reshape(shape).astype(dtype)


def _jax_update(fields, width):
    from jax.sharding import NamedSharding, PartitionSpec as P

    gg = jigg.get_global_grid()
    arrs = [
        jax.device_put(f, NamedSharding(gg.mesh, P(*jigg.AXIS_NAMES[: f.ndim])))
        for f in fields
    ]
    out = jigg.update_halo(*arrs, width=width)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


SINGLE_CASES = [
    # (local shape, field shapes, dtypes, width, grid kwargs)
    ((6, 6, 6), [(6, 6, 6)], [np.float64], 1, dict(periodx=1, periody=1, periodz=1)),
    ((6, 5, 7), [(6, 5, 7)], [np.float64], 1, dict(periodz=1)),
    ((5, 5, 5), [(6, 5, 5), (5, 5, 5), (5, 5, 6)], [np.float64, np.float32, np.float64], 1,
     dict(periodx=1, periodz=1)),
    ((8, 8, 8), [(8, 8, 8)], [np.float32], 1, dict(overlapx=3, periodx=1)),
    ((9, 9, 9), [(9, 9, 9), (10, 9, 9)], [np.float64, np.float32], 2,
     dict(periodx=1, periody=1, periodz=1, overlapx=4, overlapy=4, overlapz=4)),
    ((12, 10, 9), [(12, 10, 9)], [np.float32], 2,
     dict(periodx=1, periodz=1, overlapx=4, overlapz=4)),
    ((8, 8, 8), [(8, 8, 8)], [np.float64], 1, dict()),  # nothing to exchange
    ((6, 6, 6), [(6, 6, 6)], [np.float64], 1, dict(periodx=1, periody=1, disp=2)),
]


@pytest.mark.parametrize("nxyz,shapes,dtypes,width,kw", SINGLE_CASES)
def test_update_halo_single_process_matches_jax(nxyz, shapes, dtypes, width, kw):
    jigg.init_global_grid(*nxyz, quiet=True, devices=jax.devices()[:1], **kw)
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    fields = [unique(s, dt, offset=1000 * i) for i, (s, dt) in enumerate(zip(shapes, dtypes))]
    want = _jax_update(fields, width)
    tensors = [torch.from_numpy(f.copy()) for f in fields]
    got = tigg.update_halo(*tensors, width=width)
    got = got if isinstance(got, tuple) else (got,)
    for g, t, w, f in zip(got, tensors, want, fields):
        assert g is t  # updated in place and returned
        assert g.dtype == torch.from_numpy(f).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_update_halo_errors_match_jax():
    kw = dict(quiet=True, periodx=1)
    jigg.init_global_grid(6, 6, 6, devices=jax.devices()[:1], **kw)
    tigg.init_global_grid(6, 6, 6, device="cpu", **kw)

    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    A = np.zeros((6, 6, 6))
    t = torch.zeros(6, 6, 6, dtype=torch.float64)
    assert msg(lambda: tigg.update_halo()) == msg(lambda: jigg.update_halo())
    assert msg(lambda: tigg.update_halo(t, t)) == msg(
        lambda: jigg.update_halo(*(lambda a: (a, a))(jax.numpy.asarray(A)))
    )
    assert msg(lambda: tigg.update_halo(t, width=0)) == msg(lambda: jigg.update_halo(A, width=0))
    assert msg(lambda: tigg.update_halo(t, width=2)) == msg(lambda: jigg.update_halo(A, width=2))
    # a field with no halo anywhere (ol < 2 in every dimension)
    small = (5, 5, 5)
    assert msg(lambda: tigg.update_halo(torch.zeros(small))) == msg(
        lambda: jigg.update_halo(np.zeros(small))
    )
    with pytest.raises(ValueError, match="grid's device"):
        tigg.update_halo(t.to("meta"))


TWO_PROC_CASES = [
    # (grid kwargs, field shapes, width)
    (dict(dimx=2), [(6, 6, 6)], 1),
    (dict(dimx=2, periodx=1), [(6, 6, 6), (7, 6, 6)], 1),
    (dict(dimx=2, periodx=1, periodz=1, overlapx=4, overlapz=4), [(9, 6, 9)], 2),
    (dict(dimx=2, periody=1), [(6, 6, 6), (6, 7, 6)], 1),
]


@pytest.mark.parametrize("kw,shapes,width", TWO_PROC_CASES)
def test_update_halo_two_processes_match_jax(kw, shapes, width, tmp_path):
    _check_multi_process(kw, shapes, width, 2, tmp_path)


def test_update_halo_four_processes_corners_match_jax(tmp_path):
    """dims (2, 2, 1), periodic in x and y: the y exchange must carry the
    x-exchanged corner planes between processes."""
    _check_multi_process(dict(dimx=2, dimy=2, periodx=1, periody=1),
                         [(6, 5, 4), (6, 6, 4)], 1, 4, tmp_path)


def _check_multi_process(kw, shapes, width, nprocs, tmp_path):
    nxyz = shapes[0]
    jigg.init_global_grid(*nxyz, quiet=True, devices=jax.devices()[:nprocs], **kw)
    gg = jigg.get_global_grid()
    assert int(np.prod(gg.dims)) == nprocs
    fields = [
        unique(tuple(gg.dims[d] * s[d] for d in range(3)), np.float64, offset=10**5 * i)
        for i, s in enumerate(shapes)
    ]
    want = _jax_update(fields, width)
    names = [f"F{i}" for i in range(len(fields))]
    outs = spawn(
        dict(kind="halo", nxyz=list(nxyz), grid=kw, fields=names,
             shapes=[list(s) for s in shapes], width=width,
             inputs=dict(zip(names, fields))),
        nprocs, tmp_path, timeout=120,
    )
    for rank, out in enumerate(outs):
        c = tigg.parallel.topology.coords_of_rank(rank, gg.dims)
        for name, s, w in zip(names, shapes, want):
            block = w[tuple(slice(c[d] * s[d], (c[d] + 1) * s[d]) for d in range(3))]
            np.testing.assert_array_equal(out[name], block)
