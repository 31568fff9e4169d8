"""The PyTorch port's `update_halo` against the JAX package's, bit-exact.

Coordinate-encoding oracle: every element of the global-block field holds a
unique value, so any misplaced plane shows.  One process: the port's grid
against a one-device JAX grid.  Several processes: two or four port ranks
over gloo (worker processes that never import JAX,
`implicitglobalgrid_tpu_torch._workers`) against a JAX grid of as many
devices, block by block.  The ``halo.payload_bytes`` counter of one
exchange call against the halo planes counted from the shapes, on every
exchange path, and unmoved by a backward pass.
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


# -- the payload counter --------------------------------------------------------

PAYLOAD_CASES = {
    # name: (local shape, field shapes, width, grid kwargs, how the exchange is called)
    "periodic_x": ((6, 6, 6), [(6, 6, 6)], 1, dict(periodx=1), "update_halo"),
    "periodic_xyz": ((6, 5, 7), [(6, 5, 7)], 1, dict(periodx=1, periody=1, periodz=1),
                     "update_halo"),
    "non_periodic": ((6, 6, 6), [(6, 6, 6)], 1, dict(), "update_halo"),
    "staggered": ((6, 6, 6), [(6, 6, 6), (7, 6, 6), (6, 6, 7)], 1, dict(periodx=1, periodz=1),
                  "update_halo"),
    "width_3": ((12, 12, 11), [(12, 12, 11), (12, 13, 11)], 3,
                dict(periody=1, periodz=1, overlapy=6, overlapz=6), "update_halo"),
    "coalesce_off": ((8, 8, 8), [(8, 8, 8), (8, 9, 8)], 1, dict(periody=1), "coalesce_off"),
    "split": ((9, 9, 9), [(9, 9, 9), (10, 9, 9)], 2,
              dict(periodx=1, periody=1, overlapx=4, overlapy=4), "split"),
    "batched": ((6, 6, 6), [(6, 6, 6), (6, 7, 6)], 1, dict(periodx=1, periody=1), "batched"),
    "dims": ((6, 6, 6), [(6, 6, 6)], 1, dict(periodx=1, periodz=1), "dims"),
}
BATCH = 3


def _payload():
    from implicitglobalgrid_tpu_torch.utils import telemetry

    return telemetry.snapshot()["counters"].get("halo.payload_bytes", 0)


def _halo_plane_bytes(nxyz, shapes, width, kw, itemsize=8, members=1):
    """The halo planes one exchange writes on a one-process grid: in every
    periodic dimension where a field has a halo (shape-aware overlap >= 2),
    ``width`` planes on each side, both written from the block itself."""
    total = 0
    for s in shapes:
        for d, ax in enumerate("xyz"):
            ol = kw.get(f"overlap{ax}", 2) + s[d] - nxyz[d]
            if kw.get(f"period{ax}") and ol >= 2:
                total += 2 * width * int(np.prod(s)) // s[d] * itemsize * members
    return total


@pytest.mark.parametrize("case", list(PAYLOAD_CASES))
def test_payload_bytes_of_one_exchange_call_are_the_halo_planes(case):
    from implicitglobalgrid_tpu_torch.models import _batched
    from implicitglobalgrid_tpu_torch.ops import halo
    from implicitglobalgrid_tpu_torch.utils import telemetry

    nxyz, shapes, width, kw, how = PAYLOAD_CASES[case]
    tigg.init_global_grid(*nxyz, quiet=True, device="cpu", **kw)
    members = BATCH if how == "batched" else 1
    fields = [torch.rand((members, *s) if how == "batched" else s, dtype=torch.float64)
              for s in shapes]
    telemetry.reset()
    if how == "update_halo":
        tigg.update_halo(*fields, width=width)
    elif how == "coalesce_off":
        tigg.update_halo(*fields, width=width, coalesce=False)
    elif how == "split":
        halo.finish_slab_exchange(fields, halo.begin_slab_exchange(fields, (0, 1, 2), width=width))
    elif how == "batched":
        _batched.update_halo(*fields, width=width)
    else:
        halo.exchange_dims(fields[0], (0, 2), width=width)
    want = _halo_plane_bytes(nxyz, shapes, width, kw, members=members)
    assert _payload() == want
    assert (want == 0) == (case == "non_periodic")


@pytest.mark.parametrize("path", ["update_halo", "fused_cadence"])
def test_a_backward_pass_adds_no_payload_bytes(path):
    """The adjoint exchange, and the plain forward a fused cadence's
    backward recomputes, leave the counter where the forward left it."""
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.utils import telemetry

    if path == "update_halo":
        tigg.init_global_grid(6, 6, 6, quiet=True, device="cpu", periodx=1, periody=1)
        A = torch.rand((6, 6, 6), dtype=torch.float64, requires_grad=True)
        telemetry.reset()
        out = tigg.update_halo(A.clone())
        loss = (out ** 2).sum()
        want = _halo_plane_bytes((6, 6, 6), [(6, 6, 6)], 1, dict(periodx=1, periody=1))
    else:
        state, params = diffusion3d.setup(16, 32, 128, quiet=True, device="cpu",
                                          dtype=torch.float32, periodz=1, overlapz=4)
        T = state[0].clone().requires_grad_(True)
        telemetry.reset()
        out = diffusion3d.make_multi_step(params, 2, fused_k=2, autotune=False)(T, state[1])
        loss = (out[0] ** 2).sum()
        want = _halo_plane_bytes((16, 32, 128), [(16, 32, 128)], 2, dict(periodz=1, overlapz=4),
                                 itemsize=4)
    assert _payload() == want > 0
    loss.backward()
    assert _payload() == want
