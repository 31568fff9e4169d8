"""The port's example twins (``examples/torch_*.py``) against the JAX
package's examples.

Each twin runs at 8^3-16^3 with ``device="cpu"`` (the tests pass it; a twin
runs on the card by default) and finalizes its grid; importing one
initializes no grid.  Where a JAX twin exists its final field is compared
with the JAX example's on the same global grid:

* the fused twins and the onlyvis recipe against the JAX example on one
  device, in one process (float32 to four ULPs of the field's scale, the
  model tests' tolerance; the JAX diffusion example takes its XLA path at
  a block outside its TPU kernel's envelope, as its own test does);
* the multidevice twins against the JAX examples, which take all eight
  CPU devices (dims (2, 2, 2) of 8^3 blocks, a 14^3 global grid): the port
  on one process at 14^3, the JAX blocks de-duplicated (float64 to 1e-12
  relative; float32 to four ULPs);
* two gloo ranks (one spawn, the launch ``torchrun`` would make): the novis
  twin equals the one-process run block for block, bit for bit, and the
  vis and onlyvis twins gather frames to rank 0 (the chunked gather).
"""

import importlib.util
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.utils.compat import pallas_force_interpret
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.ops.gather import assemble_dedup

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
TWINS = ["torch_diffusion3d_multidevice_novis", "torch_diffusion3d_multidevice",
         "torch_diffusion3d_gpu", "torch_diffusion3d_gpu_novis", "torch_diffusion3d_gpu_onlyvis",
         "torch_diffusion3d_gpu_fused", "torch_acoustic3d_gpu_fused",
         "torch_porous_convection3d_gpu_fused"]


@pytest.fixture(autouse=True)
def _finalize_grids():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    if jigg.grid_is_initialized():
        jigg.finalize_global_grid()


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, dtype):
    scale = float(np.abs(want).max())
    tol = 1e-12 * scale if dtype == np.float64 else 4 * np.finfo(np.float32).eps * scale
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _dedup(G, nloc=8, dims=(2, 2, 2)):
    """The de-duplicated global array of a JAX global-block array of
    ``nloc^3`` blocks on ``dims`` (non-periodic, overlap 2)."""
    blocks = {c: G[tuple(slice(i * nloc, (i + 1) * nloc) for i in c)] for c in np.ndindex(*dims)}
    return assemble_dedup(blocks, (nloc,) * 3, dims, (2, 2, 2), (0, 0, 0), G.dtype)


@pytest.mark.parametrize("name", TWINS)
def test_importing_a_twin_initializes_no_grid(name):
    mod = _load(name)
    assert not tigg.grid_is_initialized()
    src = open(os.path.join(EXAMPLES, name + ".py")).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|implicitglobalgrid_tpu)\b", src, re.M)
    assert callable(getattr(mod, "diffusion3d", None) or getattr(mod, "diffusion3d_vis", None)
                    or getattr(mod, "diffusion3d_fused", None)
                    or getattr(mod, "acoustic3d_fused", None)
                    or getattr(mod, "porous_convection3d_fused"))


@pytest.mark.parametrize("twin,dtype", [("torch_diffusion3d_multidevice_novis", np.float64),
                                        ("torch_diffusion3d_gpu_novis", np.float32)])
def test_novis_twins_match_jax(twin, dtype):
    J = np.asarray(_load("diffusion3d_multidevice_novis").diffusion3d(
        nx=8, nt=3, dtype=jnp.dtype(dtype)))
    assert not jigg.grid_is_initialized()
    T = _load(twin).diffusion3d(nx=14, nt=3, device="cpu", quiet=True,
                                dtype=getattr(torch, np.dtype(dtype).name))
    assert not tigg.grid_is_initialized()
    _close(T.numpy(), _dedup(J), dtype)


@pytest.mark.parametrize("twin", ["torch_diffusion3d_multidevice", "torch_diffusion3d_gpu"])
def test_vis_twins_match_jax_frames(tmp_path, twin):
    (tmp_path / "jax").mkdir()
    want = _load("diffusion3d_multidevice").diffusion3d_vis(nx=8, nt=4, nvis=2,
                                                           outdir=str(tmp_path / "jax"))
    out = tmp_path / "torch"
    out.mkdir()
    got = _load(twin).diffusion3d_vis(nx=14, nt=4, nvis=2, device="cpu", outdir=str(out),
                                      dtype=torch.float64, quiet=True)
    assert not tigg.grid_is_initialized()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, np.asarray(w), np.float64)
    assert [p.name for p in out.iterdir()] in (["diffusion3d.gif"], ["diffusion3d_frames.npy"])


def test_onlyvis_twin_matches_jax():
    want = _load("diffusion3d_tpu_onlyvis").diffusion3d(nx=8, nt=4, nvis=2,
                                                        devices=jax.devices()[:1], quiet=True)
    got = _load("torch_diffusion3d_gpu_onlyvis").diffusion3d(nx=8, nt=4, nvis=2, device="cpu",
                                                            quiet=True)
    assert not tigg.grid_is_initialized() and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (6, 6) and g.tobytes() == np.asarray(w, g.dtype).tobytes()


_FUSED = {
    "diffusion": ("diffusion3d_tpu_fused", "diffusion3d_fused", "torch_diffusion3d_gpu_fused",
                  dict(nx=16, nt=4, k=2), {}),
    "acoustic": ("acoustic3d_tpu_fused", "acoustic3d_fused", "torch_acoustic3d_gpu_fused",
                 dict(nx=16, ny=32, nz=128, nt=4, k=2), dict(fused_tile=(8, 16))),
    "porous": ("porous_convection3d_tpu_fused", "porous_convection3d_fused",
               "torch_porous_convection3d_gpu_fused",
               dict(nx=16, ny=32, nz=128, nt=2, w=2, npt=4), dict(fused_tile=(8, 16))),
}


@pytest.mark.parametrize("model", list(_FUSED))
def test_fused_twins_match_jax_on_one_device(model):
    jname, func, tname, kw, jkw = _FUSED[model]
    with warnings.catch_warnings():
        # the JAX diffusion example's block is outside its kernel's envelope
        warnings.simplefilter("ignore", RuntimeWarning)
        with pallas_force_interpret():
            J = np.asarray(getattr(_load(jname), func)(quiet=True, devices=jax.devices()[:1],
                                                       **kw, **jkw))
    T = getattr(_load(tname), func)(device="cpu", quiet=True, **kw)
    assert not tigg.grid_is_initialized() and not jigg.grid_is_initialized()
    assert np.isfinite(T.numpy()).all() and T.dtype == torch.float32
    _close(T.numpy(), J, np.float32)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("examples")
    calls = {
        "novis": ["torch_diffusion3d_multidevice_novis", "diffusion3d",
                  dict(nx=8, ny=14, nz=14, nt=3, device="cpu", dtype="float64", quiet=True)],
        "vis": ["torch_diffusion3d_multidevice", "diffusion3d_vis",
                dict(nx=8, nt=4, nvis=2, device="cpu", outdir=str(work), dtype="float64",
                     quiet=True)],
        "onlyvis": ["torch_diffusion3d_gpu_onlyvis", "diffusion3d",
                    dict(nx=8, nt=3, nvis=1, device="cpu", quiet=True)],
    }
    return work, spawn({"kind": "examples", "inputs": {}, "calls": calls}, 2, work / "run")


def test_two_ranks_novis_equals_one_process_bit_for_bit(two_ranks):
    _, outs = two_ranks
    T = _load("torch_diffusion3d_multidevice_novis").diffusion3d(
        nx=14, nt=3, device="cpu", dtype=torch.float64, quiet=True).numpy()
    # rank r's x block starts at global cell 6r (overlap 2)
    for r, out in enumerate(outs):
        assert out["novis"].tobytes() == T[6 * r:6 * r + 8].tobytes()


def test_two_ranks_vis_and_onlyvis_frames_on_rank_0(two_ranks):
    work, outs = two_ranks
    assert int(outs[0]["vis_n"]) == 2 and int(outs[1]["vis_n"]) == 0
    for i in range(2):
        f = outs[0][f"vis{i}"]
        assert f.shape == (6, 12) and np.isfinite(f).all()  # (z, x) of the 12 x 6 x 6 interior
    assert f.max() > 0
    assert {p.name for p in work.iterdir()} & {"diffusion3d.gif", "diffusion3d_frames.npy"}
    assert int(outs[0]["onlyvis_n"]) == 3 and int(outs[1]["onlyvis_n"]) == 0
    assert outs[0]["onlyvis0"].shape == (6, 12)
