"""What the per-layer metric readers share: the card's published peaks, and
the least bytes and operations of a kernel's work, counted from the shapes
(each input read once, each output written once)."""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
#: tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: the program's exchange scopes (``utils/profiling.SCOPE_NAMES``)
EXCHANGE_SCOPES = ("igg_halo_exchange", "igg_slab_exchange_begin", "igg_slab_exchange_finish")
ITEMSIZE = {"float32": 4, "float64": 8}


def op_seconds(summary: dict, name: str) -> float:
    """Device seconds of the operations whose name holds ``name``."""
    return sum(sec for op, (_, sec) in summary["ops"].items() if name in op)


def exchange_seconds(summary: dict) -> float:
    return sum(summary["scoped_s"].get(s, 0.0) for s in EXCHANGE_SCOPES)


def idle_percent(summary: dict) -> float:
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def cells(cfg: dict) -> int:
    return math.prod(cfg["grid"]["block"])


def pt_schedule(npt: int, k: int) -> tuple[int, list[int]]:
    """The fused porous cadence's split of ``npt`` relaxations: ``lead``
    plain ones (odd ``npt``), then even kernel chunks of at most ``k``."""
    lead = npt % 2
    rem, chunks = npt - lead, []
    while rem > 0:
        ki = min(k, rem)
        ki -= ki % 2
        chunks.append(ki)
        rem -= ki
    return lead, chunks
