"""Share of the traced window in which no kernel, copy or memset runs on
the card."""

from gridbench import readers

UNIT, LAYER, BETTER, MOVES, SOURCE = "%", "device", "lower", "step_ms", "device_trace"


def read(ctx):
    return readers.idle_percent(ctx["window"]["trace"])
