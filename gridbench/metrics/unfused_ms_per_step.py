"""Device time per step of the plain torch work around the kernels (the
stencil of ``ops/stencil`` and the models' updates, such as the porous
``_temperature_update``): every device operation outside the program's
``igg_*`` scopes that is not one of its fused kernels."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = "ms", "plain torch around the kernels", "lower", "step_ms", "device_trace"


def read(ctx):
    ph = ctx["window"]
    return 1e3 * readers.unfused_seconds(ph["trace"]) / ph["steps"]
