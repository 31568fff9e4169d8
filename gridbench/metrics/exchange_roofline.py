"""Share of the card's HBM bandwidth that the halo exchange reaches: twice
its payload bytes per step (`exchange_mib_per_step`: each plane read at its
source once and written into the halo once) at 3.35 TB/s, over the
exchange's device time per step (the device operations inside the
program's exchange ranges)."""

from gridbench import readers, spec

UNIT, LAYER, BETTER, MOVES, SOURCE = "%", "halo exchange", "higher", "step_ms", "program_span"


def read(ctx):
    ph = ctx["window"]
    mib = spec.metric("exchange_mib_per_step").read(ctx)
    sec = readers.exchange_seconds(ph["trace"])
    if not mib or not sec:
        return None
    least = ph["steps"] * 2 * mib * 2**20 / readers.HBM_BYTES_PER_S
    return 100.0 * least / sec
