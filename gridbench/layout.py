"""Where a one-rank grid's block lies on the global grid: the benchmark's
own account of ImplicitGlobalGrid's layout, used to make the inputs and to
judge the outputs.  Imports neither the program nor anything it made.

A block of ``n`` cells with ``o`` overlapping cells spans ``n`` global
cells in a non-periodic dimension and ``n - o`` in a periodic one, where
block cell ``i`` is global cell ``i`` modulo the global size.  A field
staggered in a dimension (one more entry than cells) is indexed by faces:
face ``j`` lies between cells ``j-1`` and ``j``; a periodic dimension has as
many faces as cells.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Layout:
    block: tuple[int, int, int]
    overlaps: tuple[int, int, int]
    periods: tuple[int, int, int]

    @classmethod
    def of(cls, grid: dict) -> "Layout":
        return cls(*(tuple(int(v) for v in grid[k]) for k in ("block", "overlaps", "periods")))

    def global_shape(self) -> tuple[int, int, int]:
        return tuple(n - o if p else n for n, o, p in zip(self.block, self.overlaps, self.periods))

    def stagger(self, stagger: tuple[int, int, int]) -> tuple[int, int, int]:
        """A field's extra entries along each dimension on the global grid:
        none in a periodic dimension."""
        return tuple(0 if p else s for p, s in zip(self.periods, stagger))

    def block_index(self, stagger: tuple[int, int, int] = (0, 0, 0), device=None):
        """Per dimension, the indices into a global array (cells, or faces
        where ``stagger`` is 1) that give the block."""
        idx = []
        for n, s, g, p in zip(self.block, stagger, self.global_shape(), self.periods):
            i = torch.arange(n + s, device=device)
            idx.append(i % g if p else i)
        return idx


def take(A: torch.Tensor, idx) -> torch.Tensor:
    """``A`` at the index lists ``idx``, one per dimension (a copy)."""
    for d, i in enumerate(idx):
        A = A.index_select(d, i)
    return A


#: planes of the global grid drawn per call of the generator
SLAB = 16


def seeded_slabs(gen: torch.Generator, global_shape, device, draw=torch.randn):
    """Seeded values over the global grid, drawn in slabs of ``SLAB``
    x-planes in order: yields each slab's x-slice and its values, so no
    second array of the whole grid is made."""
    gx, gy, gz = global_shape
    for a in range(0, gx, SLAB):
        b = min(gx, a + SLAB)
        yield slice(a, b), draw((b - a, gy, gz), generator=gen, device=device,
                                dtype=torch.float32)
