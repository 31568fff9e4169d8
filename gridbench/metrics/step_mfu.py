"""The whole step's share of the card's float32 peak: the floating-point
operations of the window's steps at every cell of the global grid, counted
from the reference's formulas (``flops_per_cell_step``), over the window's
device time (CUDA events, every call) at the data sheet's 67 TFLOP/s."""

import math

from gridbench import readers, spec
from gridbench.layout import Layout

UNIT, LAYER, BETTER, MOVES, SOURCE = "%", "model cadence", "higher", "step_ms", "device_trace"


def read(ctx):
    w, cfg = ctx["window"], ctx["config"]
    flops = spec.reference(cfg["program"]["module"]).flops_per_cell_step(cfg)
    cells = math.prod(Layout.of(spec.grid_of(cfg, ctx["traffic"])).global_shape())
    return 100.0 * w["steps"] * cells * flops / (1e-3 * w["total_ms"] * readers.FP32_FLOPS_PER_S)
