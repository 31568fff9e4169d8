"""3-D staggered acoustic FDTD with the fused leapfrog kernel (PyTorch).

The port's twin of ``acoustic3d_tpu_fused.py``: ``overlap = 2k`` deep halos
license ``k`` temporally blocked leapfrog steps per memory pass of the
hand-written CUDA kernel (``csrc/fused_leapfrog.cu``) and per all-field slab
exchange; ``acoustic3d.make_multi_step(fused_k=k)`` wires both over the real
``n+1`` face arrays.

Run (any number of GPUs; overlap 12 licenses k = 6)::

    python examples/torch_acoustic3d_gpu_fused.py [--nx 256] [--nt 600] [--k 6]
    torchrun --nproc-per-node 4 examples/torch_acoustic3d_gpu_fused.py
"""

import argparse


def acoustic3d_fused(nx=256, nt=600, k=6, ny=None, nz=None, fused_tile=None, device=None,
                     quiet=False, **setup_kwargs):
    """Run about ``nt`` steps (whole chunks) after one warm-up chunk and
    return this process's final pressure block.  ``setup_kwargs`` go to
    `acoustic3d.setup`; ``device=None`` is ``cuda:<local rank>``."""
    import torch

    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import acoustic3d

    setup_kwargs = {"overlapx": 2 * k, "overlapy": 2 * k, "overlapz": 2 * k, **setup_kwargs}
    state, params = acoustic3d.setup(
        nx, ny if ny is not None else nx, nz if nz is not None else nx,
        dtype=torch.float32, device=device, quiet=quiet, **setup_kwargs)
    # One call advances `chunk` steps; `fused_k` must divide it.
    chunk = max(k * max(min(nt, 96) // k, 1), k)
    step = acoustic3d.make_multi_step(params, chunk, fused_k=k, fused_tile=fused_tile)
    state = step(*state)  # warm-up chunk
    igg.tic()
    for _ in range(max(nt // chunk, 1)):
        state = step(*state)
    P = acoustic3d.pressure(state)
    t = igg.toc()  # synchronizes the card
    me = igg.get_global_grid().me
    igg.finalize_global_grid()
    if me == 0 and not quiet:
        steps = max(nt // chunk, 1) * chunk
        print(f"{steps} steps in {t:.3f} s = {t / steps * 1e3:.3f} ms/step")
    return P


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--nt", type=int, default=600)
    p.add_argument("--k", type=int, default=6)
    a = p.parse_args()
    acoustic3d_fused(nx=a.nx, nt=a.nt, k=a.k)
