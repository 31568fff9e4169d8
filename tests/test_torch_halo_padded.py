"""The port's `update_halo_padded_faces` against the JAX package's.

A cell field and three face fields in the `pad_faces` layout, exchanged in
place.  One device, periodic in x, y and z, float64: the real ``n+1`` faces
equal JAX's (run inside its `stencil`, as its own tests run it) bit for bit,
with every dimension, with ``dims=(0, 1)``, and at ``width=2`` on a deep-halo
grid; and they equal the port's own unpad -> `update_halo` -> pad.  Two gloo
ranks: one case against JAX's `update_halo` block by block.  The junk tail
past the real faces is never compared (the layout forbids reading it).
"""


import jax
import numpy as np
import pytest
import torch

from _time_limit import time_limit
import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as tfl
from implicitglobalgrid_tpu_torch.ops.halo import update_halo_padded_faces

#: Hard limit of each test, seconds: a hang fails the test.
LIMIT_S = 120


@pytest.fixture(autouse=True)
def _limit_and_finalize_grids():
    with time_limit(LIMIT_S):
        yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    if jigg.grid_is_initialized():
        jigg.finalize_global_grid()


def unique(shape, offset=0):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float64) + 1 + offset).reshape(shape)


def fields_of(nxyz):
    """A cell field and its x, y, z face fields, every element unique."""
    return [unique(s, 10**6 * i) for i, s in enumerate((nxyz, *tfl.face_shapes(nxyz)))]


def jax_padded(fields, width, dims):
    from implicitglobalgrid_tpu.ops.halo import update_halo_padded_faces as jpadded
    from implicitglobalgrid_tpu.ops.pallas_leapfrog import pad_faces, unpad_faces

    step = jigg.stencil(lambda C, Ax, Ay, Az: (lambda out: (out[0], *unpad_faces(*out[1:])))(
        jpadded(C, *pad_faces(Ax, Ay, Az), width=width, dims=dims)))
    return [np.asarray(a) for a in step(*(jax.numpy.asarray(f) for f in fields))]


CASES = [
    # (block, width, dims, grid kwargs)
    ((8, 8, 8), 1, None, {}),
    ((8, 8, 8), 1, (0, 1), {}),
    ((9, 8, 10), 2, None, dict(overlapx=4, overlapy=4, overlapz=4)),
    ((9, 8, 10), 2, (0, 1), dict(overlapx=4, overlapy=4, overlapz=4)),
]


@pytest.mark.parametrize("nxyz,width,dims,kw", CASES)
def test_padded_faces_equal_jax_and_unpad_update_pad(nxyz, width, dims, kw):
    kw = dict(periodx=1, periody=1, periodz=1, quiet=True, **kw)
    fields = fields_of(nxyz)
    jigg.init_global_grid(*nxyz, devices=jax.devices()[:1], **kw)
    want = jax_padded(fields, width, dims)
    jigg.finalize_global_grid()

    tigg.init_global_grid(*nxyz, device="cpu", **kw)
    C, *faces = (torch.from_numpy(f.copy()) for f in fields)
    padded = tfl.pad_faces(*faces)
    got = update_halo_padded_faces(C, *padded, width=width, dims=dims)
    assert got[0] is C and all(g is p for g, p in zip(got[1:], padded))  # in place
    got = [C, *tfl.unpad_faces(*got[1:])]
    for name, g, w in zip(("C", "Vx", "Vy", "Vz"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    # the port's own unpad -> update_halo -> pad, on every dimension
    if dims is None:
        ref = [torch.from_numpy(f.copy()) for f in fields]
        tigg.update_halo(*ref, width=width)
        for name, g, r in zip(("C", "Vx", "Vy", "Vz"), got, ref):
            assert torch.equal(g, r), name
    # an exchange touches planes of the real faces only: the junk tail stays
    for axis, (p, q) in enumerate(zip(padded, tfl.pad_faces(
            *(torch.from_numpy(f) for f in fields[1:])))):
        tail = p.narrow(axis, nxyz[axis] + 1, p.shape[axis] - nxyz[axis] - 1)
        assert torch.equal(tail, q.narrow(axis, nxyz[axis] + 1, tail.shape[axis]))


def test_padded_faces_refuse_what_update_halo_refuses():
    tigg.init_global_grid(8, 8, 8, periodx=1, device="cpu", quiet=True)
    C, *faces = (torch.zeros(s, dtype=torch.float64)
                 for s in ((8, 8, 8), *tfl.face_shapes((8, 8, 8))))
    with pytest.raises(ValueError, match="width must be >= 1"):
        update_halo_padded_faces(C, *tfl.pad_faces(*faces), width=0)
    with pytest.raises(ValueError, match="overlap >= 4"):
        update_halo_padded_faces(C, *tfl.pad_faces(*faces), width=2)


def test_padded_faces_two_ranks_equal_jax(tmp_path):
    nxyz, kw = (8, 6, 7), dict(dimx=2, periodx=1, periodz=1)
    jigg.init_global_grid(*nxyz, quiet=True, devices=jax.devices()[:2], **kw)
    gg = jigg.get_global_grid()
    shapes = [nxyz, *tfl.face_shapes(nxyz)]
    glob = [unique(tuple(gg.dims[d] * s[d] for d in range(3)), 10**6 * i)
            for i, s in enumerate(shapes)]
    from jax.sharding import NamedSharding, PartitionSpec as P

    arrs = [jax.device_put(f, NamedSharding(gg.mesh, P(*jigg.AXIS_NAMES))) for f in glob]
    want = [np.asarray(a) for a in jigg.update_halo(*arrs)]
    names = ["C", "Vx", "Vy", "Vz"]
    outs = spawn(dict(kind="halo", nxyz=list(nxyz), grid=kw, fields=names,
                      shapes=[list(s) for s in shapes], width=1, padded=True,
                      inputs=dict(zip(names, glob))), 2, tmp_path, timeout=90)
    for rank, out in enumerate(outs):
        c = tigg.parallel.topology.coords_of_rank(rank, gg.dims)
        for name, s, w in zip(names, shapes, want):
            block = w[tuple(slice(c[d] * s[d], (c[d] + 1) * s[d]) for d in range(3))]
            np.testing.assert_array_equal(out[f"{name}_padded"], block, err_msg=name)
            np.testing.assert_array_equal(out[name], block, err_msg=name)
