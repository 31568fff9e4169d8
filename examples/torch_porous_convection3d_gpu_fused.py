"""3-D porous convection with the fused PT-iteration kernel (PyTorch).

The port's twin of ``porous_convection3d_tpu_fused.py``: ``overlap = 2w``
deep halos license ``w`` pseudo-transient iterations per memory pass of the
hand-written CUDA kernel (``csrc/fused_pt.cu``) and per all-field slab
exchange; ``porous_convection3d.make_multi_step(fused_k=w)`` wires both.
``w`` must divide the even part of ``npt`` into chunks the kernel takes.

Run (any number of GPUs; overlap 12 licenses w = 6)::

    python examples/torch_porous_convection3d_gpu_fused.py [--nx 256] [--nt 24] [--w 6] [--npt 12]
    torchrun --nproc-per-node 4 examples/torch_porous_convection3d_gpu_fused.py
"""

import argparse


def porous_convection3d_fused(nx=256, nt=24, w=6, npt=12, ny=None, nz=None, fused_tile=None,
                              device=None, quiet=False, **setup_kwargs):
    """Run about ``nt`` time steps (whole chunks) after one warm-up chunk and
    return this process's final temperature block.  ``setup_kwargs`` go to
    `porous_convection3d.setup`; ``device=None`` is ``cuda:<local rank>``."""
    import torch

    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import porous_convection3d as pc

    setup_kwargs = {"overlapx": 2 * w, "overlapy": 2 * w, "overlapz": 2 * w, **setup_kwargs}
    state, params = pc.setup(
        nx, ny if ny is not None else nx, nz if nz is not None else nx, npt=npt,
        dtype=torch.float32, device=device, quiet=quiet, **setup_kwargs)
    # Whole time steps chunk into one call (each carries npt PT iterations).
    chunk = max(min(nt, 8), 1)
    step = pc.make_multi_step(params, chunk, fused_k=w, fused_tile=fused_tile)
    state = step(*state)  # warm-up chunk
    igg.tic()
    for _ in range(max(nt // chunk, 1)):
        state = step(*state)
    T = pc.temperature(state)
    t = igg.toc()  # synchronizes the card
    me = igg.get_global_grid().me
    igg.finalize_global_grid()
    if me == 0 and not quiet:
        steps = max(nt // chunk, 1) * chunk
        print(f"{steps} steps x {npt} PT iterations in {t:.3f} s = "
              f"{t / (steps * npt) * 1e3:.3f} ms/PT-iteration")
    return T


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--nt", type=int, default=24)
    p.add_argument("--w", type=int, default=6)
    p.add_argument("--npt", type=int, default=12)
    a = p.parse_args()
    porous_convection3d_fused(nx=a.nx, nt=a.nt, w=a.w, npt=a.npt)
