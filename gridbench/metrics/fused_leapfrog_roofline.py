"""Share of its roofline that the leapfrog kernel (``ops/fused_leapfrog`` ->
``csrc/fused_leapfrog.cu``) reaches: the least time of the window's kernel
work (per group of ``fused_k`` steps P, Vx, Vy and Vz read once and written
once over the block, the faces at n+1; the reference's operations a cell a
step) over the kernel's device time in the trace."""

from gridbench import readers, spec

UNIT, LAYER, BETTER, MOVES, SOURCE = "%", "kernels", "higher", "step_ms", "device_trace"


def read(ctx):
    ph = ctx["window"]
    sec = readers.op_seconds(ph["trace"], "fused_leapfrog_kernel")
    if not sec:
        return None
    cfg = ctx["config"]
    nx, ny, nz = cfg["grid"]["block"]
    n = nx * ny * nz
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    groups = ph["steps"] // int(cfg["fused_k"])
    nbytes = groups * 2 * (n + faces) * readers.ITEMSIZE[cfg["dtype"]]
    flops = ph["steps"] * n * spec.reference(cfg["program"]["module"]).flops_per_cell_step(cfg)
    return 100.0 * readers.bound_seconds(nbytes, flops) / sec
