"""3-D heat diffusion with deep-halo temporal blocking on the GPU (PyTorch).

The port's twin of ``diffusion3d_tpu_fused.py``: ``overlap = 2k`` deep halos
license ``k`` temporally blocked steps per memory pass of the hand-written
CUDA kernel (``csrc/fused_diffusion.cu``) and per halo exchange
(``update_halo(width=k)``); ``diffusion3d.make_multi_step(fused_k=k)`` wires
both.

Run (any number of GPUs; overlap 2k licenses k)::

    python examples/torch_diffusion3d_gpu_fused.py [--nx 256] [--nt 1000] [--k 4]
    torchrun --nproc-per-node 4 examples/torch_diffusion3d_gpu_fused.py
"""

import argparse


def diffusion3d_fused(nx=256, nt=1000, k=4, device=None, quiet=False, **setup_kwargs):
    """Run about ``nt`` steps (whole chunks) after one warm-up chunk and
    return this process's final temperature block.  ``setup_kwargs`` go to
    `diffusion3d.setup` (periods, overlaps, dims); ``device=None`` is
    ``cuda:<local rank>``."""
    import torch

    import implicitglobalgrid_tpu_torch as igg
    from implicitglobalgrid_tpu_torch.models import diffusion3d

    setup_kwargs = {"overlapx": 2 * k, "overlapy": 2 * k, "overlapz": 2 * k, **setup_kwargs}
    state, params = diffusion3d.setup(nx, nx, nx, dtype=torch.float32, device=device,
                                      quiet=quiet, **setup_kwargs)
    # One call advances `chunk` steps; `fused_k` must divide it.
    chunk = max(k * max(min(nt, 100) // k, 1), k)
    step = diffusion3d.make_multi_step(params, chunk, fused_k=k)
    state = step(*state)  # warm-up chunk
    igg.tic()
    for _ in range(max(nt // chunk, 1)):
        state = step(*state)
    T = diffusion3d.temperature(state)
    t = igg.toc()  # synchronizes the card
    me = igg.get_global_grid().me
    igg.finalize_global_grid()
    if me == 0 and not quiet:
        steps = max(nt // chunk, 1) * chunk
        print(f"{steps} steps in {t:.3f} s = {t / steps * 1e3:.3f} ms/step")
    return T


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--nt", type=int, default=1000)
    p.add_argument("--k", type=int, default=4)
    a = p.parse_args()
    diffusion3d_fused(nx=a.nx, nt=a.nt, k=a.k)
