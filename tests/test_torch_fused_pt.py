"""`ops.fused_pt`: the plain version against the JAX package's kernel, the
wrapper's contract on the CPU, and the CUDA kernel on the card.

The JAX kernel runs through the Pallas interpreter
(`utils.compat.pallas_force_interpret`) at the shapes and tiles of the JAX
package's own `tests/test_pallas_pt.py`, with its tolerance: max |diff| /
max(scale, 1) < 2e-5 per field in float32; the frozen flux faces bit-exact,
Pf evolving on the array boundary, buoyancy reaching z faces only, and T
unmodified.  float64, which the TPU kernel does not take, is held against
``k`` applications of the JAX model's `_flux_update` and `_pressure_update`
(max |diff| <= 1e-12 relative to each field's scale: the two fold the
constants differently).  On the card the kernel equals the plain version bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu.models.porous_convection3d import Params as JParams
from implicitglobalgrid_tpu.models.porous_convection3d import _flux_update, _pressure_update
from implicitglobalgrid_tpu.ops import pallas_pt as jp
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch.ops import fused_pt as fp

SPACING = (0.1, 0.15, 0.2)
JPARAMS = dict(Ra=100.0, lam_T=0.01, dx=SPACING[0], dy=SPACING[1], dz=SPACING[2],
               theta_q=0.5, beta_p=3e-4)
# th, idx, idy, idz, ralam, bp as the JAX model's fused cadence passes them
COEFFS = (0.5, *(1.0 / d for d in SPACING), 100.0 * 0.01, 3e-4)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    T, Pf = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
    return (T, Pf, *(0.1 * rng.standard_normal(s).astype(dtype) for s in fp.face_shapes(shape)))


def _jax_kernel(ins, k):
    with pallas_force_interpret():
        Pf, *qp = jp.fused_pt_iterations(
            *map(jnp.asarray, ins[:2]), *jp.pad_faces(*map(jnp.asarray, ins[2:])), k, *COEFFS,
            bx=8, by=16,
        )
    return [np.asarray(a) for a in (Pf, *jp.unpad_faces(*qp))]


def _assert_scale_close(got, want, tol):
    for name, g, w in zip(("Pf", "qDx", "qDy", "qDz"), got, want):
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(g - w).max()) / scale < tol, name


@pytest.mark.parametrize("k", [2, 4])
def test_plain_version_matches_jax_kernel_f32(k):
    ins = _inputs((16, 32, 128), np.float32)
    tins = tuple(map(torch.from_numpy, ins))
    want = _jax_kernel(ins, k)
    got = [a.numpy() for a in fp.fused_pt_iterations_reference(*tins, k, *COEFFS)]
    assert all(g.dtype == np.float32 for g in got)
    _assert_scale_close(got, want, 2e-5)
    for out in (got, want):  # frozen flux faces, bit-exact
        for o, a in zip(out[1:], ins[2:]):
            for d in range(3):
                for i in (0, o.shape[d] - 1):
                    assert np.array_equal(np.take(o, i, axis=d), np.take(a, i, axis=d))
    for d in range(3):  # Pf evolves on the array boundary (all-cells update)
        assert not np.array_equal(np.take(got[0], 0, axis=d), np.take(ins[1], 0, axis=d))
    assert np.array_equal(tins[0].numpy(), ins[0])  # T is read-only


def test_buoyancy_reaches_z_faces_only():
    """With grad(Pf) = 0 and q = 0, one iteration moves only the interior z
    faces (th * ralam * av_z(T)); two agree with the JAX kernel."""
    shape = (16, 32, 128)
    T = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    zeros = [np.zeros(s, np.float32) for s in (shape, *fp.face_shapes(shape))]
    tins = (torch.from_numpy(T), *map(torch.from_numpy, zeros))
    _, qx, qy, qz = fp.fused_pt_iterations_reference(*tins, 1, *COEFFS)
    assert not qx.any() and not qy.any()
    th, ralam, Tt = COEFFS[0], COEFFS[4], tins[0]
    buoyancy = th * (ralam * (0.5 * (Tt[1:-1, 1:-1, 1:] + Tt[1:-1, 1:-1, :-1])))
    assert torch.equal(qz[1:-1, 1:-1, 1:-1], buoyancy) and buoyancy.any()
    qz[1:-1, 1:-1, 1:-1] = 0
    assert not qz.any()
    got = [a.numpy() for a in fp.fused_pt_iterations(*tins, 2, *COEFFS)]
    _assert_scale_close(got, _jax_kernel((T, *zeros), 2), 2e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_plain_version_matches_jax_model_iterations_f64(k):
    ins = _inputs((12, 10, 14), np.float64, seed=1)
    jparams = JParams(dtype=jnp.float64, **JPARAMS)
    fu, pu = _flux_update(jparams), _pressure_update(jparams)
    T = jnp.asarray(ins[0])

    @jax.jit
    def it(Pf, qDx, qDy, qDz):
        qDx, qDy, qDz = fu(T, Pf, qDx, qDy, qDz)
        return pu(Pf, qDx, qDy, qDz), qDx, qDy, qDz

    ref = tuple(map(jnp.asarray, ins[1:]))
    for _ in range(k):
        ref = it(*ref)
    got = fp.fused_pt_iterations_reference(*map(torch.from_numpy, ins), k, *COEFFS)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())


def test_cpu_wrapper_is_the_plain_version_and_not_a_launch():
    ins = _inputs((9, 7, 11), np.float32, seed=2)
    tins = tuple(map(torch.from_numpy, ins))
    before = fp.launches
    got = fp.fused_pt_iterations(*tins, 4, *COEFFS)
    assert fp.launches == before
    for g, w in zip(got, fp.fused_pt_iterations_reference(*tins, 4, *COEFFS)):
        assert torch.equal(g, w)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(tins, ins))  # inputs not written


def _fields(shape=(8, 8, 8), dtype=torch.float32, device="cpu"):
    return [torch.zeros(s, dtype=dtype, device=device)
            for s in (shape, shape, *fp.face_shapes(shape))]


@pytest.mark.parametrize(
    "fields,k,match",
    [
        (_fields(), 3, "even"),
        (_fields(), 10, "even"),
        ([torch.zeros(8, 8, 9)] + _fields()[1:], 2, "cell fields must share a shape"),
        (_fields()[:1] + [torch.zeros(8, 8, 8, dtype=torch.float64)] + _fields()[2:], 2, "dtype"),
        (_fields()[:2] + _fields((8, 9, 8))[2:], 2, "face fields must have shapes"),
        (_fields(dtype=torch.bfloat16), 2, "float32 or float64"),
        (_fields(device="meta"), 2, "CUDA or CPU"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(fields, k, match):
    with pytest.raises(ValueError, match=match):
        fp.fused_pt_iterations(*fields, k, *COEFFS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,k", [
    ((37, 45, 70), torch.float32, 2), ((37, 45, 70), torch.float32, 6),  # ragged tiles
    ((37, 45, 70), torch.float32, 8), ((37, 45, 70), torch.float64, 4),
    ((12, 12, 12), torch.float32, 6),  # a block smaller than one window
    ((5, 64, 96), torch.float32, 4),  # n0 shorter than the plane ring
])
def test_cuda_kernel_matches_plain_version(shape, dtype, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = [torch.randn(s, generator=gen, device=dev, dtype=dtype)
           for s in (shape, shape, *fp.face_shapes(shape))]
    T0 = ins[0].clone()
    before = fp.launches
    got = fp.fused_pt_iterations(*ins, k, *COEFFS)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    for g, w in zip(got, fp.fused_pt_iterations_reference(*ins, k, *COEFFS)):
        assert torch.equal(g, w)  # --fmad=false: bit-exact
    assert torch.equal(ins[0], T0)
