"""Share of its roofline that the plain diffusion update (plain torch,
``models/diffusion3d._diffusion_update``) reaches: the least time of the
window's updates (per step T and Cp read once and T written once over the
block; 17 float32 operations a cell, the count `fused_diffusion_roofline`
uses) over the device time inside the program's ``igg_diffusion_update``
range."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = ("%", "plain torch around the kernels", "higher", "step_ms",
                                      "program_span")
SCOPE = "igg_diffusion_update"


def read(ctx):
    ph = ctx["window"]
    sec = ph["trace"]["scoped_s"].get(SCOPE)
    if not sec:
        return None
    cfg = ctx["config"]
    n = readers.cells(cfg)
    nbytes = ph["steps"] * 3 * n * readers.ITEMSIZE[cfg["dtype"]]
    return 100.0 * readers.bound_seconds(nbytes, ph["steps"] * n * 17) / sec
