"""Share of its roofline that the porous temperature update (plain torch,
``models/porous_convection3d._temperature_update``) reaches: the least time
of the window's T updates (per step T read once, qDx, qDy and qDz read once
and T written once over the block; 50 float32 operations a cell, the
reference's count) over the device time inside the program's
``igg_temperature_update`` range."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = ("%", "plain torch around the kernels", "higher", "step_ms",
                                      "program_span")
SCOPE = "igg_temperature_update"


def read(ctx):
    ph = ctx["window"]
    sec = ph["trace"]["scoped_s"].get(SCOPE)
    if not sec:
        return None
    cfg = ctx["config"]
    nx, ny, nz = cfg["grid"]["block"]
    n = nx * ny * nz
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    nbytes = ph["steps"] * (2 * n + faces) * readers.ITEMSIZE[cfg["dtype"]]
    return 100.0 * readers.bound_seconds(nbytes, ph["steps"] * n * 50) / sec
