"""The x-marching plan of the CUDA diffusion kernel, in pure Python.

``csrc/fused_diffusion.cu`` cannot run on the CPU, so this file checks what
can be checked without the card, at the tiles the wrapper chooses
(`ops.fused_stencil.tile_for`):

* the window geometry (`Axis`, a mirror of ``staggered.cuh``'s side ranges
  and caps): the owned (y, z) tiles and x segments partition the cells
  exactly once, each level's update range reads only what the level before
  left valid, the owned tile lies in what level k leaves valid, and the
  per-slot level caps select exactly the ranges;
* the schedule (`march`, a mirror of the kernel on whole (y, z) planes):
  rings of `RING` planes of T and Cp loaded `AHEAD` planes ahead, level s at
  plane t-s, the register queues (T^{s-1} of the last two planes, 1/Cp k
  planes deep) and the double-buffered level planes.  A load lands either
  when it is issued or only at the wait before its plane is stepped, the
  buffers start as NaN, and the result must equal
  `fused_diffusion_steps_reference` bit for bit (the same torch operations
  on the same values).  Updating one ring of planes in place, as the
  staggered kernels do, must fail it;
* the tile ladder: shared memory (rings, level planes, guards) and slots
  of one or two z-adjacent positions, and the C++ constants the wrapper
  mirrors.
"""

import re
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu_torch.ops import _kernels
from implicitglobalgrid_tpu_torch.ops import fused_stencil as fs

RAGGED = [(37, 45, 70), (12, 12, 12), (5, 64, 96)]
SHAPES = RAGGED + [(256, 256, 256), (512, 512, 512)]
C3 = (1 / 8.1, 0.5 / 8.1, 0.25 / 8.1)  # cx, cy, cz
ALL = 15  # igg::kAll: a cap no k reaches


@dataclass(frozen=True)
class Axis:
    """``igg::Axis``: one axis of a block's window (window-local ranges)."""

    n: int
    w0: int
    e: int
    o0: int
    o1: int

    @classmethod
    def make(cls, n, tile, b, k):
        o0 = tile * b
        o1 = min(o0 + b, n)
        w0 = max(o0 - k, 0)
        return cls(n, w0, min(o1 + k, n) - w0, o0, o1)

    @property
    def lo_face(self):
        return self.w0 == 0

    @property
    def hi_face(self):
        return self.w0 + self.e == self.n

    def side(self, s):
        """``side_lo(s)``, ``side_hi(s)``: the diffusion update range."""
        return (1 if self.lo_face else s, self.e - 1 if self.hi_face else self.e - s)

    def side_levels(self, i):
        lo = (ALL if i >= 1 else 0) if self.lo_face else i
        hi = (ALL if i < self.e - 1 else 0) if self.hi_face else self.e - 1 - i
        return max(0, min(lo, hi, ALL))


def axes(n, b, k):
    return [Axis.make(n, i, b, k) for i in range(-(-n // b))]


def tiles(shape, k, itemsize=4, bx=None):
    tile = fs.tile_for(shape, k, itemsize)
    return tile if bx is None else (bx, *tile[1:])


# -- geometry ---------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_owned_tiles_partition_the_cells(shape, k):
    for n, b in zip(shape, tiles(shape, k)):
        cells = np.zeros(n, int)
        for a in axes(n, b, k):
            cells[a.o0:a.o1] += 1
        assert (cells == 1).all()


@pytest.mark.parametrize("bx", [None, 8])
@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_each_level_reads_what_the_level_before_left_valid(shape, k, bx):
    """Per axis of every window: level s reads its range and one cell on
    each side, all valid after level s-1 (its range plus the array's frozen
    cells), never updates a frozen cell, and the owned tile is valid after
    level k."""
    for n, b in zip(shape, tiles(shape, k, bx=bx)):
        for a in axes(n, b, k):
            frozen = {i for i, on in ((0, a.lo_face), (a.e - 1, a.hi_face)) if on}
            valid = set(range(a.e))
            for s in range(1, k + 1):
                upd = set(range(*a.side(s)))
                assert not upd & frozen
                assert upd | {i - 1 for i in upd} | {i + 1 for i in upd} <= valid
                valid = upd | frozen
            assert set(range(a.o0 - a.w0, a.o1 - a.w0)) <= valid


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_level_caps_are_the_update_ranges(shape, k):
    for n, b in zip(shape[1:], tiles(shape, k)[1:]):
        for a in axes(n, b, k):
            for s in range(1, k + 1):
                assert [i for i in range(a.e) if s <= a.side_levels(i)] == list(range(*a.side(s)))


# -- the ladder ---------------------------------------------------------------


def _cxx_smem_bytes(n1, n2, k, by, bz, itemsize):
    """``smem_bytes`` of fused_diffusion.cu, transcribed."""
    e = 1 if itemsize == 8 and k >= 6 else 2  # kElems
    ey, rz = min(by + 2 * k, n1), -(-min(bz + 2 * k, n2) // e) * e
    ring = 2 + 2  # kRing = kAhead + 2
    return ((2 * ring + 2 * (k - 1)) * ey * rz + 2 * (rz + e)) * itemsize


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_ladder_fits_shared_memory_and_the_slots(shape, k, itemsize):
    tile = fs.tile_for(shape, k, itemsize)
    assert tile[0] == shape[0] and tile[1:] in fs._TILES
    ey, ez = fs.window_plane(shape, k, tile)
    e = fs.elems(itemsize, k)
    assert fs.plane_slots(shape, k, tile, itemsize) == ey * -(-ez // e)
    assert fs.plane_slots(shape, k, tile, itemsize) <= fs.slots(itemsize, k) * fs.THREADS
    nbytes = fs.window_bytes(shape, k, tile, itemsize)
    assert nbytes == _cxx_smem_bytes(*shape[1:], k, *tile[1:], itemsize)
    assert nbytes <= fs._SMEM_PER_BLOCK
    assert fs.grid(shape, tile) == (-(-shape[2] // tile[2]), -(-shape[1] // tile[1]), 1)


@pytest.mark.parametrize("shape,k,itemsize,resident,want", [
    ((256, 256, 256), 4, 4, 2, 2),  # 128 (y, z) tiles: a second block per SM
    ((256, 256, 256), 2, 4, 3, 3),
    ((256, 256, 256), 6, 4, 1, 1),  # one resident block: no cut
    ((512, 512, 512), 4, 4, 2, 1),  # 512 tiles already fill the card
    ((37, 45, 70), 4, 4, 2, 1),  # no segment shorter than 8k planes
    ((256, 32, 32), 8, 8, 2, 4),  # f64 k=8: 32 small tiles, 4 segments of 64 planes
])
def test_x_segments_fill_the_resident_blocks(shape, k, itemsize, resident, want):
    nseg = fs.segments(shape, k, itemsize, resident, 132)
    assert nseg == want
    bx = -(-shape[0] // nseg)
    assert bx >= fs._MIN_SEGMENT * k or nseg == 1
    gz, gy, gx = fs.grid(shape, (bx, *fs.tile_for(shape, k, itemsize)[1:]))
    assert gx == nseg and (nseg == 1 or gx * gy * gz <= resident * 132)


def test_wrapper_constants_mirror_the_cuda_source():
    src = (_kernels.CSRC / "fused_diffusion.cu").read_text()
    header = (_kernels.CSRC / "staggered.cuh").read_text()
    assert f"constexpr int kThreads = {fs.THREADS};" in header
    assert f"constexpr int kAhead = {fs.AHEAD};" in src
    assert "constexpr int kRing = kAhead + 2;" in src and fs.RING == fs.AHEAD + 2
    assert "constexpr int kElems = sizeof(T) == 8 && K >= 6 ? 1 : 2;" in src
    assert "constexpr int kSlots = sizeof(T) == 4 && K == 6 ? 2 : 1;" in src
    for k in (2, 4, 6, 8):
        assert fs.slots(4, k) == (2 if k == 6 else 1) and fs.slots(8, k) == 1
        assert fs.elems(4, k) == 2 and fs.elems(8, k) == (1 if k >= 6 else 2)


# -- the schedule -----------------------------------------------------------


@dataclass(frozen=True)
class _Window:
    x: Axis
    y: Axis
    z: Axis


def march(T, Cp, k, tile, land, variant="queue"):
    """The kernel over every block of the grid; returns the stored field
    (NaN where no block stored)."""
    n0, n1, n2 = T.shape
    out = torch.full_like(T, float("nan"))
    for bxi in range(-(-n0 // tile[0])):
        for byi in range(-(-n1 // tile[1])):
            for bzi in range(-(-n2 // tile[2])):
                w = _Window(Axis.make(n0, bxi, tile[0], k), Axis.make(n1, byi, tile[1], k),
                            Axis.make(n2, bzi, tile[2], k))
                block = _march_block if variant == "queue" else _march_block_in_place
                block(w, T, Cp, out, k, land)
    return out


class _Loads:
    """The cp.async plane loads of T and Cp into rings of ``depth`` planes:
    landing at issue, or only at the wait before plane p is stepped."""

    def __init__(self, w, T, Cp, depth, land):
        ey, ez = w.y.e, w.z.e
        self.w, self.T, self.Cp, self.depth, self.land = w, T, Cp, depth, land
        self.ring_t = torch.full((depth, ey, ez), float("nan"), dtype=T.dtype)
        self.ring_c = torch.full_like(self.ring_t, float("nan"))
        self.pending = {}

    def load(self, p):
        w = self.w
        if p >= w.x.e:
            return
        gx, ys, zs = w.x.w0 + p, slice(w.y.w0, w.y.w0 + w.y.e), slice(w.z.w0, w.z.w0 + w.z.e)
        copy = (p % self.depth, self.T[gx, ys, zs], self.Cp[gx, ys, zs])
        if self.land == "issue":
            self._put(*copy)
        else:
            self.pending[p] = copy

    def wait(self, p):
        if p in self.pending:
            self._put(*self.pending.pop(p))

    def _put(self, i, t, c):
        self.ring_t[i] = t
        self.ring_c[i] = c


def _sl(lo_hi, d=0):
    return slice(lo_hi[0] + d, lo_hi[1] + d)


def _on(w, s, p):
    """Level s updates plane p (and some (y, z) position of it)."""
    return all(lo < hi for lo, hi in (w.x.side(s), w.y.side(s), w.z.side(s))) \
        and w.x.side(s)[0] <= p < w.x.side(s)[1]


def _lap(xp, v, xm, src, ys, zs, cx, cy, cz):
    """The kernel's point update's Laplacian, in its order, on a (y, z) patch."""
    v2 = 2 * v
    return ((xp - v2) + xm) * cx + ((src[_sl(ys, 1), _sl(zs)] - v2) + src[_sl(ys, -1), _sl(zs)]) \
        * cy + ((src[_sl(ys), _sl(zs, 1)] - v2) + src[_sl(ys), _sl(zs, -1)]) * cz


def _store(w, out, k, t, plane):
    b = t - k
    if w.x.o0 - w.x.w0 <= b < w.x.o1 - w.x.w0:
        oy, oz = slice(w.y.o0 - w.y.w0, w.y.o1 - w.y.w0), slice(w.z.o0 - w.z.w0, w.z.o1 - w.z.w0)
        out[w.x.w0 + b, w.y.o0:w.y.o1, w.z.o0:w.z.o1] = plane[oy, oz]


def _march_block(w, T, Cp, out, k, land):
    """``fused_diffusion_kernel`` for one block, on whole (y, z) planes."""
    cx, cy, cz = C3
    ey, ez = w.y.e, w.z.e
    nan = torch.full((ey, ez), float("nan"), dtype=T.dtype)
    loads = _Loads(w, T, Cp, fs.RING, land)
    levels = torch.full((k - 1, 2, ey, ez), float("nan"), dtype=T.dtype)
    q1, q2, minv = [nan] * k, [nan] * k, [nan] * k
    for a in range(fs.AHEAD):
        loads.load(a)
    for t in range(w.x.e + k):
        loads.wait(t)
        loads.load(t + fs.AHEAD)
        cur = loads.ring_t[t % fs.RING].clone()
        rcp = 1 / loads.ring_c[t % fs.RING]
        for s in range(1, k + 1):
            p = t - s
            src = loads.ring_t[(t - 1) % fs.RING] if s == 1 else levels[s - 2, p % 2]
            v = q1[s - 1]
            nxt = v.clone()
            if _on(w, s, p):
                ys, zs = w.y.side(s), w.z.side(s)
                at = (_sl(ys), _sl(zs))
                lap = _lap(cur[at], v[at], q2[s - 1][at], src, ys, zs, cx, cy, cz)
                nxt[at] = v[at] + lap * minv[s - 1][at]
            if s < k:
                levels[s - 1, p % 2] = nxt
            q2[s - 1], q1[s - 1], cur = q1[s - 1], cur, nxt
        _store(w, out, k, t, cur)
        minv = [rcp] + minv[:-1]


def _march_block_in_place(w, T, Cp, out, k, land):
    """The staggered kernels' way applied to diffusion: one ring of T planes
    that every level updates in place (x neighbours read from the ring).
    Level s at plane p reads plane p-1 after level s overwrote it: wrong."""
    cx, cy, cz = C3
    depth = k + fs.AHEAD + 2  # planes t-k-1 .. t+AHEAD
    loads = _Loads(w, T, Cp, depth, land)
    for a in range(fs.AHEAD):
        loads.load(a)
    for t in range(w.x.e + k):
        loads.wait(t)
        loads.load(t + fs.AHEAD)
        ring = loads.ring_t
        for s in range(1, k + 1):
            p = t - s
            if _on(w, s, p):
                ys, zs = w.y.side(s), w.z.side(s)
                at = (_sl(ys), _sl(zs))
                src = ring[p % depth]
                v = src[at]
                lap = _lap(ring[(p + 1) % depth][at], v, ring[(p - 1) % depth][at], src, ys, zs,
                           cx, cy, cz)
                ring[p % depth][at] = v + lap * (1 / loads.ring_c[p % depth][at])
        _store(w, out, k, t, ring[(t - k) % depth])


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    T = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    Cp = torch.from_numpy(1.0 + rng.random(shape)).to(dtype)
    return T, Cp


CASES = [((37, 45, 70), torch.float32, 2, None), ((37, 45, 70), torch.float32, 4, None),
         ((37, 45, 70), torch.float32, 8, None), ((37, 45, 70), torch.float64, 4, None),
         ((12, 12, 12), torch.float32, 4, None), ((5, 64, 96), torch.float32, 4, None),
         ((37, 45, 70), torch.float32, 6, 8)]


@pytest.mark.parametrize("land", ["issue", "wait"])
@pytest.mark.parametrize("shape,dtype,k,bx", CASES)
def test_schedule_equals_plain_version(shape, dtype, k, bx, land):
    T, Cp = _inputs(shape, dtype, seed=k)
    got = march(T, Cp, k, tiles(shape, k, T.element_size(), bx), land)
    assert torch.equal(got, fs.fused_diffusion_steps_reference(T, Cp, k, *C3))


@pytest.mark.parametrize("k", [2, 4])
def test_in_place_single_ring_fails_the_schedule(k):
    """The oracle can tell: one in-place ring reads T^s(p-1) where level s
    needs T^{s-1}(p-1)."""
    shape = (37, 45, 70)
    T, Cp = _inputs(shape, torch.float32, seed=k)
    got = march(T, Cp, k, tiles(shape, k), "issue", variant="in_place")
    want = fs.fused_diffusion_steps_reference(T, Cp, k, *C3)
    assert torch.isfinite(got).all()
    assert not torch.equal(got, want)
