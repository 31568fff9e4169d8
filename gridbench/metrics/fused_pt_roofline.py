"""Share of its roofline that the pseudo-transient kernel (``ops/fused_pt``
-> ``csrc/fused_pt.cu``) reaches: the least time of the window's kernel work
(per kernel chunk T read once, Pf and the three fluxes read and written
once; 29 float32 operations a cell a relaxation) over the kernel's device
time in the trace."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = "%", "kernels", "higher", "step_ms", "device_trace"


def read(ctx):
    ph = ctx["window"]
    sec = readers.op_seconds(ph["trace"], "fused_pt_kernel")
    if not sec:
        return None
    cfg = ctx["config"]
    nx, ny, nz = cfg["grid"]["block"]
    n = nx * ny * nz
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    size = readers.ITEMSIZE[cfg["dtype"]]
    _, chunks = readers.pt_schedule(int(cfg["physics"]["npt"]), int(cfg["fused_k"]))
    nbytes = ph["steps"] * len(chunks) * (n + 2 * n + 2 * faces) * size
    flops = ph["steps"] * sum(chunks) * n * 29
    return 100.0 * readers.bound_seconds(nbytes, flops) / sec
