"""Share of its roofline that the diffusion kernel (``ops/fused_stencil`` ->
``csrc/fused_diffusion.cu``) reaches: the least time of the window's kernel
work (per group of ``fused_k`` steps T and Cp read once and T written once
over the block; 17 float32 operations a cell a step) over the kernel's
device time in the trace."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = "%", "kernels", "higher", "step_ms", "device_trace"


def read(ctx):
    ph = ctx["window"]
    sec = readers.op_seconds(ph["trace"], "fused_diffusion_kernel")
    if not sec:
        return None
    cfg = ctx["config"]
    n, size = readers.cells(cfg), readers.ITEMSIZE[cfg["dtype"]]
    groups = ph["steps"] // int(cfg["fused_k"])
    return 100.0 * readers.bound_seconds(groups * 3 * n * size, ph["steps"] * n * 17) / sec
