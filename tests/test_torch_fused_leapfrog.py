"""`ops.fused_leapfrog`: the plain version against the JAX package's kernel,
the wrapper's contract on the CPU, and the CUDA kernel on the card.

The JAX kernel runs through the Pallas interpreter
(`utils.compat.pallas_force_interpret`) at the shapes and tiles of the JAX
package's own `tests/test_pallas_leapfrog.py`, with its tolerance: rtol =
atol = 2e-5 in float32; the frozen velocity faces bit-exact, and P evolving
on the array boundary.  float64, which the TPU kernel does not take, is held
against ``k`` applications of the JAX model's `_velocity_update` and
`_pressure_update` (max |diff| <= 1e-12 relative to each field's scale: the
two fold the constants differently).  On the card the kernel equals the
plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu.models.acoustic3d import Params as JParams
from implicitglobalgrid_tpu.models.acoustic3d import _pressure_update, _velocity_update
from implicitglobalgrid_tpu.ops import pallas_leapfrog as jl
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl

SPACING, K, RHO = (0.1, 0.15, 0.2), 1.3, 0.8


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal(shape).astype(dtype)
    return (P, *(0.1 * rng.standard_normal(s).astype(dtype) for s in fl.face_shapes(shape)))


def _coeffs(spacing=SPACING, K=K, rho=RHO):
    dt = min(spacing) / (K / rho) ** 0.5 / 2.0
    ca = tuple(dt / rho / d for d in spacing)
    return (*ca, dt * K, *(1.0 / d for d in spacing)), dt


def _faces_frozen(out, inp):
    """Every boundary plane of every velocity field kept bit for bit."""
    return all(
        np.array_equal(np.take(o, i, axis=d), np.take(a, i, axis=d))
        for o, a in zip(out[1:], inp[1:])
        for d in range(3)
        for i in (0, o.shape[d] - 1)
    )


@pytest.mark.parametrize("k", [2, 4])
def test_plain_version_matches_jax_kernel_f32(k):
    shape = (16, 32, 128)
    ins = _inputs(shape, np.float32)
    co, _ = _coeffs()
    with pallas_force_interpret():
        P, *Vp = jl.fused_leapfrog_steps(
            jnp.asarray(ins[0]), *jl.pad_faces(*map(jnp.asarray, ins[1:])), k, *co, bx=8, by=16
        )
    want = [np.asarray(a) for a in (P, *jl.unpad_faces(*Vp))]
    got = [a.numpy() for a in fl.fused_leapfrog_steps_reference(*map(torch.from_numpy, ins), k, *co)]
    for name, g, w in zip(("P", "Vx", "Vy", "Vz"), got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)
    assert _faces_frozen(got, ins) and _faces_frozen(want, ins)
    for d in range(3):  # P evolves on the array boundary (all-cells update)
        assert not np.array_equal(np.take(got[0], 0, axis=d), np.take(ins[0], 0, axis=d))


@pytest.mark.parametrize("k", [2, 4])
def test_plain_version_matches_jax_model_steps_f64(k):
    shape = (12, 10, 14)
    ins = _inputs(shape, np.float64, seed=1)
    co, dt = _coeffs()
    jp = JParams(K=K, rho=RHO, dx=SPACING[0], dy=SPACING[1], dz=SPACING[2], dt=dt,
                 dtype=jnp.float64)
    vu, pu = _velocity_update(jp), _pressure_update(jp)

    @jax.jit
    def step(P, Vx, Vy, Vz):
        Vx, Vy, Vz = vu(P, Vx, Vy, Vz)
        return pu(P, Vx, Vy, Vz), Vx, Vy, Vz

    ref = tuple(map(jnp.asarray, ins))
    for _ in range(k):
        ref = step(*ref)
    got = fl.fused_leapfrog_steps_reference(*map(torch.from_numpy, ins), k, *co)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())
    assert _faces_frozen([a.numpy() for a in got], ins)


def test_pad_faces_match_jax_and_round_trip():
    ins = _inputs((6, 5, 7), np.float32, seed=3)
    V = tuple(map(torch.from_numpy, ins[1:]))
    padded = fl.pad_faces(*V)
    want = jl.pad_faces(*map(jnp.asarray, ins[1:]))
    assert tuple(tuple(a.shape) for a in padded) == fl.padded_face_shapes((6, 5, 7)) \
        == jl.padded_face_shapes((6, 5, 7))
    for p, w in zip(padded, want):
        assert np.array_equal(p.numpy(), np.asarray(w))
    for a, b in zip(fl.unpad_faces(*padded), V):
        assert torch.equal(a, b)


def test_cpu_wrapper_is_the_plain_version_and_not_a_launch():
    ins = _inputs((9, 7, 11), np.float32, seed=2)
    tins = tuple(torch.from_numpy(a) for a in ins)
    co, _ = _coeffs()
    before = fl.launches
    got = fl.fused_leapfrog_steps(*tins, 4, *co)
    assert fl.launches == before
    for g, w in zip(got, fl.fused_leapfrog_steps_reference(*tins, 4, *co)):
        assert torch.equal(g, w)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(tins, ins))  # inputs not written


def _fields(shape=(8, 8, 8), dtype=torch.float32, device="cpu"):
    return [torch.zeros(s, dtype=dtype, device=device)
            for s in (shape, *fl.face_shapes(shape))]


def _bad(i, **kw):
    f = _fields()
    f[i] = torch.zeros(f[i].shape, **kw)
    return f


@pytest.mark.parametrize(
    "fields,k,match",
    [
        (_fields(), 3, "even"),
        (_fields(), 10, "even"),
        (_bad(2, dtype=torch.float64), 2, "dtype"),
        (_fields()[:1] + _fields((8, 8, 9))[1:], 2, "face fields must have shapes"),
        (_fields()[:2] + _fields()[1:3], 2, "face fields must have shapes"),
        (_fields((8, 2, 8)), 2, ">= 3"),
        ([torch.zeros(8, 8)] + _fields()[1:], 2, "3-D"),
        (_fields(dtype=torch.bfloat16), 2, "float32 or float64"),
        (_fields(device="meta"), 2, "CUDA or CPU"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(fields, k, match):
    with pytest.raises(ValueError, match=match):
        fl.fused_leapfrog_steps(*fields, k, *_coeffs()[0])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [2, 4, 6, 8])
def test_tiles_fit_shared_memory(k, itemsize):
    """The ring of k+4 x planes of the four fields, each plane the owned
    (by, bz) plus k a side and one more row and column for the y/z faces."""
    bx, by, bz = fl.tile_for((256, 256, 256), k, itemsize)
    assert bx == 256 and fl.ring_depth(k) == k + 4
    plane = (by + 2 * k + 1) * (bz + 2 * k + 1)
    assert 4 * (k + 4) * plane * itemsize == fl.window_bytes((256, 256, 256), k, (bx, by, bz),
                                                             itemsize) <= 232448
    assert (by, bz) == next(t for t in fl._TILES
                            if fl.window_bytes((256,) * 3, k, (256, *t), itemsize) <= 232448)
    assert fl.tile_for((12, 12, 12), k, 4) == (12, *fl._TILES[0])  # a small block clips


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,k", [
    ((37, 45, 70), torch.float32, 2), ((37, 45, 70), torch.float32, 6),  # ragged tiles
    ((37, 45, 70), torch.float32, 8), ((37, 45, 70), torch.float64, 4),
    ((12, 12, 12), torch.float32, 6),  # a block smaller than one window
    ((5, 64, 96), torch.float32, 4),  # n0 shorter than the plane ring
])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype, k):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ins = [torch.randn(s, generator=gen, device=cuda_device, dtype=dtype)
           for s in (shape, *fl.face_shapes(shape))]
    co, _ = _coeffs()
    before = fl.launches
    got = fl.fused_leapfrog_steps(*ins, k, *co)
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    for g, w in zip(got, fl.fused_leapfrog_steps_reference(*ins, k, *co)):
        assert torch.equal(g, w)  # --fmad=false: bit-exact
