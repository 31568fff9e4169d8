"""The port's public names against the JAX package's.

`implicitglobalgrid_tpu_torch.__all__` equals `implicitglobalgrid_tpu.__all__`
up to an explicit list of names not ported yet, each tied to the ROADMAP
Queue A item (or leftover) that brings it, and JAX-mesh-only names.  The
reference usage ``igg.stencil(igg.hide_communication(step, radius=1))``
(the JAX package's `tests/test_stencil_overlap.py`) runs on the port.
"""

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg

#: Names of the JAX package's ``__all__`` that the port does not export yet,
#: with the ROADMAP Queue A item (or leftover) that brings each.
NOT_YET_PORTED = {
    "profile_trace": "14d",
    "profiling": "14d",
    "supervisor": "14e",
    "fleet": "14e",
    "analysis": "15",
}
#: JAX-only by design: the names of the device mesh's axes.
JAX_MESH_ONLY = {"AXIS_NAMES"}


@pytest.fixture(autouse=True)
def _finalize_torch_grid():
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()


def test_all_matches_jax_up_to_the_names_not_yet_ported():
    port, ref = set(tigg.__all__), set(jigg.__all__)
    assert port - ref == {"block_from_numpy"}  # the port's numpy entry for JAX-made fields
    assert ref - port == set(NOT_YET_PORTED) | JAX_MESH_ONLY
    assert not set(NOT_YET_PORTED) & JAX_MESH_ONLY
    assert len(tigg.__all__) == len(port)


@pytest.mark.parametrize("name", sorted(set(jigg.__all__) - set(NOT_YET_PORTED) - JAX_MESH_ONLY))
def test_every_shared_name_resolves(name):
    assert getattr(tigg, name) is not None


def test_ported_since_the_export_fault():
    """The three names the port defined but did not export (ROADMAP Queue C)."""
    from implicitglobalgrid_tpu_torch.ops.overlap import hide_communication
    from implicitglobalgrid_tpu_torch.parallel.grid import check_initialized

    assert tigg.hide_communication is hide_communication
    assert tigg.check_initialized is check_initialized
    assert tigg.NNEIGHBORS_PER_DIM == jigg.NNEIGHBORS_PER_DIM == 2
    with pytest.raises(RuntimeError, match="before init_global_grid"):
        tigg.check_initialized()


def test_stencil_of_hide_communication_runs_like_jax_usage():
    """``igg.stencil(igg.hide_communication(step, radius=1))`` equals
    ``update_halo(step(A))`` bit for bit on a periodic x/y/z block."""
    tigg.init_global_grid(10, 9, 8, periodx=1, periody=1, periodz=1, quiet=True, device="cpu")
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((10, 9, 8)))

    def step(A):
        out = A.clone()
        out[1:-1, 1:-1, 1:-1] = (A[2:, 1:-1, 1:-1] + A[:-2, 1:-1, 1:-1] + A[1:-1, 2:, 1:-1]
                                 + A[1:-1, :-2, 1:-1] + A[1:-1, 1:-1, 2:]
                                 + A[1:-1, 1:-1, :-2]) / 6
        return out

    fast = tigg.stencil(tigg.hide_communication(step, radius=1))
    got, want = fast(A), tigg.update_halo(step(A))
    assert torch.equal(got, want)
    assert not torch.equal(got, A)


def test_gather_takes_dedup_as_jax_does():
    """`gather`'s keyword-only parameters are the JAX package's (its
    test-only ``_force_chunked`` hook aside), ``dedup`` included."""
    import inspect

    def kwonly(fn):
        return {n: p.default for n, p in inspect.signature(fn).parameters.items()
                if p.kind is p.KEYWORD_ONLY and not n.startswith("_")}

    assert kwonly(tigg.gather) == kwonly(jigg.gather)
    assert kwonly(tigg.gather)["dedup"] is False


def test_block_slice_matches_jax():
    """`block_slice` of the same numpy field: one device (the block is the
    field), then two devices split in x, where JAX slices each block of the
    global-block array and the port each rank's block."""
    import jax

    rng = np.random.default_rng(0)
    A = rng.standard_normal((16, 6, 5))
    interior = (slice(1, -1),) * 3
    for ndev, cases in ((1, (interior, slice(2, 5), (slice(None), slice(0, 3)))), (2, (interior,))):
        jigg.init_global_grid(16 // ndev, 6, 5, dimx=ndev, quiet=True,
                              devices=jax.devices()[:ndev])
        tigg.init_global_grid(16 // ndev, 6, 5, quiet=True, device="cpu")
        for sl in cases:
            want = np.asarray(jigg.block_slice(jax.numpy.asarray(A), sl))
            for r in range(ndev):
                block = torch.from_numpy(A[r * 16 // ndev:(r + 1) * 16 // ndev].copy())
                got = tigg.block_slice(block, sl)
                h = want.shape[0] // ndev
                np.testing.assert_array_equal(got.numpy(), want[r * h:(r + 1) * h])
                got.zero_()  # a copy: the block is untouched
                assert not torch.equal(block, torch.zeros_like(block))
        with pytest.raises(ValueError, match="preserve the number of dimensions") as e:
            tigg.block_slice(torch.from_numpy(A), (0,))
        with pytest.raises(ValueError) as ej:
            jigg.block_slice(jax.numpy.asarray(A), (0,))
        assert str(e.value) == str(ej.value)
        jigg.finalize_global_grid()
        tigg.finalize_global_grid()
