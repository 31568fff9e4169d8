"""Bytes per step that the halo exchange writes into halos, in MiB: the
port's ``halo.payload_bytes`` counter (``ops/halo``: every width-w slab
written into a halo, self copies included, counted from the shapes), read
from the port's telemetry in this process.  A run is one process, and every
call exchanges alike, so the count is over every step the program ran in
it: the warm-up's and the window's."""

from gridbench.window import WARMUP_CALLS

UNIT, LAYER, BETTER, MOVES, SOURCE = "MiB", "halo exchange", "lower", "step_ms", "program_counter"
COUNTER = "halo.payload_bytes"


def payload_bytes():
    """The counter's value, or None where the program keeps no such counter."""
    from implicitglobalgrid_tpu_torch.utils import telemetry

    return telemetry.snapshot()["counters"].get(COUNTER)


def read(ctx):
    ph = ctx["window"]
    nbytes = payload_bytes()
    if not nbytes:
        return None
    steps = (WARMUP_CALLS + ph["calls"]) * (ph["steps"] // ph["calls"])
    return nbytes / steps / 2**20
