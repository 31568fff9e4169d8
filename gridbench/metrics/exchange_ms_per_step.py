"""Device time per step of the halo exchange (``ops/halo``): the device
operations inside the program's exchange scopes."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = "ms", "halo exchange", "lower", "step_ms", "device_trace"


def read(ctx):
    ph = ctx["window"]
    sec = readers.exchange_seconds(ph["trace"])
    return 1e3 * sec / ph["steps"] if sec else None
