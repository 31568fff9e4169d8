"""3-D heat diffusion on the GPU with in-situ visualization on process 0.

The port's twin of ``diffusion3d_tpu.py``: the full solver of
``torch_diffusion3d_multidevice.py`` with the ``gather`` -> heatmap -> GIF
pipeline, its fields in the memory of the process's GPU.

Run::

    python examples/torch_diffusion3d_gpu.py [--nx 128] [--nt 2000] [--nvis 500]
    torchrun --nproc-per-node 4 examples/torch_diffusion3d_gpu.py
"""

import argparse
import importlib.util
import os

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_diffusion3d_multidevice", os.path.join(_here, "torch_diffusion3d_multidevice.py")
)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

#: The solver, run on the process's GPU unless ``device=`` says otherwise.
diffusion3d_vis = _mod.diffusion3d_vis

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--nt", type=int, default=2000)
    p.add_argument("--nvis", type=int, default=500)
    p.add_argument("--outdir", default=".")
    a = p.parse_args()
    diffusion3d_vis(a.nx, a.nt, a.nvis, None, a.outdir)
