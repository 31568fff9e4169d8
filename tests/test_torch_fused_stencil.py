"""`ops.fused_stencil`: the plain version against the JAX package's kernel,
the wrapper's contract on the CPU, and the CUDA kernel on the card.

The JAX kernel runs through the Pallas interpreter
(`utils.compat.pallas_force_interpret`), as the JAX package's own
`tests/test_pallas_stencil.py` runs it, at the same shapes and tolerance:
max |diff| < 5e-6 in float32 (the interpreter's XLA fusion rounds a few ULPs
differently), the frozen outer ring bit-exact.  float64, which the TPU kernel
does not take, is held against ``k`` applications of the JAX model's
`_diffusion_update` (max |diff| <= 1e-12 relative to the field's scale: the
two fold the constants differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu.models.diffusion3d import Params as JParams
from implicitglobalgrid_tpu.models.diffusion3d import _diffusion_update as j_update
from implicitglobalgrid_tpu.ops.pallas_stencil import fused_diffusion_steps as j_fused
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch.ops import _kernels
from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal(shape).astype(dtype)
    Cp = (1.0 + rng.random(shape)).astype(dtype)
    return T, Cp


def _ring_equal(out, inp):
    return all(
        np.array_equal(np.take(out, i, axis=d), np.take(inp, i, axis=d))
        for d in range(3)
        for i in (0, out.shape[d] - 1)
    )


@pytest.mark.parametrize(
    "k,shape",
    [(2, (16, 32, 128)), (4, (16, 32, 128)), (8, (32, 64, 128))],
)
def test_plain_version_matches_jax_kernel_f32(k, shape):
    T, Cp = _inputs(shape, np.float32)
    dx = 0.1
    c = float((dx * dx / 8.1) / (dx * dx))
    with pallas_force_interpret():
        want = np.asarray(j_fused(jnp.asarray(T), jnp.asarray(Cp), k, c, c, c, bx=8, by=16))
    got = fs.fused_diffusion_steps_reference(torch.from_numpy(T), torch.from_numpy(Cp), k, c, c, c)
    got = got.numpy()
    assert got.dtype == np.float32
    assert float(np.max(np.abs(got - want))) < 5e-6
    assert _ring_equal(got, T) and _ring_equal(want, T)


@pytest.mark.parametrize("k", [2, 4])
def test_plain_version_matches_jax_model_steps_f64(k):
    shape = (12, 10, 14)
    T, Cp = _inputs(shape, np.float64, seed=1)
    dx, dy, dz = 0.1, 0.2, 0.4
    dt = dx * dx / 8.1
    upd = jax.jit(j_update(JParams(dx=dx, dy=dy, dz=dz, dt=dt, dtype=jnp.float64)))
    ref = jnp.asarray(T)
    for _ in range(k):
        ref = upd(ref, jnp.asarray(Cp))
    got = fs.fused_diffusion_steps_reference(
        torch.from_numpy(T), torch.from_numpy(Cp), k,
        dt / (dx * dx), dt / (dy * dy), dt / (dz * dz),
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-12 * np.abs(T).max())
    assert _ring_equal(got, T)


def test_cpu_wrapper_is_the_plain_version_and_not_a_launch():
    T, Cp = _inputs((9, 7, 11), np.float32, seed=2)
    Tt, Cpt = torch.from_numpy(T), torch.from_numpy(Cp)
    before = fs.launches
    got = fs.fused_diffusion_steps(Tt, Cpt, 4, 0.1, 0.05, 0.02)
    assert fs.launches == before
    assert torch.equal(got, fs.fused_diffusion_steps_reference(Tt, Cpt, 4, 0.1, 0.05, 0.02))
    assert np.array_equal(Tt.numpy(), T)  # the input is not written


@pytest.mark.parametrize(
    "T,Cp,k,match",
    [
        (torch.zeros(8, 8, 8), torch.zeros(8, 8, 8), 3, "even"),
        (torch.zeros(8, 8, 8), torch.zeros(8, 8, 8), 10, "even"),
        (torch.zeros(8, 8, 8), torch.zeros(8, 8, 8, dtype=torch.float64), 2, "dtype"),
        (torch.zeros(8, 8, 8), torch.zeros(8, 8, 9), 2, "shape"),
        (torch.zeros(8, 2, 8), torch.zeros(8, 2, 8), 2, ">= 3"),
        (torch.zeros(8, 8), torch.zeros(8, 8), 2, "3-D"),
        (torch.zeros(8, 8, 8, dtype=torch.bfloat16), torch.zeros(8, 8, 8, dtype=torch.bfloat16),
         2, "float32 or float64"),
        (torch.zeros(8, 8, 8, device="meta"), torch.zeros(8, 8, 8, device="meta"), 2, "CUDA or CPU"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(T, Cp, k, match):
    with pytest.raises(ValueError, match=match):
        fs.fused_diffusion_steps(T, Cp, k, 0.1, 0.1, 0.1)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [2, 4, 6, 8])
def test_tiles_fit_shared_memory(k, itemsize):
    tile = fs.tile_for((512, 512, 512), k, itemsize)
    assert tile[0] == 512  # the block marches all of x
    assert fs.window_bytes((512, 512, 512), k, tile, itemsize) <= 232448
    assert fs.plane_slots((512, 512, 512), k, tile, itemsize) <= fs.slots(itemsize, k) * fs.THREADS
    # a small block clips the window: the preferred tile fits
    assert fs.tile_for((12, 12, 12), k, itemsize) == (12, *fs._TILES[0])


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.nvcc_path()
    # the library name follows the source: a changed source is a new library
    p = _kernels.library_path("fused_diffusion")
    assert p.parent == _kernels.BUILD_DIR and p.name.startswith("libfused_diffusion_")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py on one")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,k", [
    ((37, 45, 70), torch.float32, 2), ((37, 45, 70), torch.float32, 4),
    ((37, 45, 70), torch.float32, 8), ((37, 45, 70), torch.float64, 4),
    ((12, 12, 12), torch.float32, 4), ((5, 64, 96), torch.float32, 4),
])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, dtype, k):
    """Ragged against every tile, a block smaller than one window, and an x
    extent shorter than the plane rings."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    T = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    Cp = 1 + torch.rand(shape, generator=gen, device=cuda_device, dtype=dtype)
    before = fs.launches
    got = fs.fused_diffusion_steps(T, Cp, k, 0.12, 0.06, 0.03)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    want = fs.fused_diffusion_steps_reference(T, Cp, k, 0.12, 0.06, 0.03)
    assert torch.equal(got, want)  # --fmad=false: bit-exact
    assert _ring_equal(got.cpu().numpy(), T.cpu().numpy())
