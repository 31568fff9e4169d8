"""3-D heat diffusion on the GPU, no visualization.

The port's twin of ``diffusion3d_tpu_novis.py``: the solver of
``torch_diffusion3d_multidevice_novis.py`` in float32, each process bound to
its GPU (``cuda:<local rank>``), its fields in that GPU's memory.

Run::

    python examples/torch_diffusion3d_gpu_novis.py [--nx 256] [--nt 1000]
    torchrun --nproc-per-node 4 examples/torch_diffusion3d_gpu_novis.py
"""

import argparse
import importlib.util
import os

import torch

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_diffusion3d_multidevice_novis",
    os.path.join(_here, "torch_diffusion3d_multidevice_novis.py"),
)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def diffusion3d(nx=256, nt=1000, device=None, dtype=torch.float32, **kwargs):
    """The novis solver in float32 on the process's GPU by default."""
    return _mod.diffusion3d(nx=nx, nt=nt, device=device, dtype=dtype, **kwargs)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--nt", type=int, default=1000)
    a = p.parse_args()
    diffusion3d(nx=a.nx, nt=a.nt)
