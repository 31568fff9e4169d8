"""The x-marching plan of the two staggered CUDA kernels, in pure Python.

``csrc/staggered.cuh`` cannot run on the CPU, so this file checks what can
be checked without the card, at the tiles the wrappers choose
(`ops.fused_leapfrog.tile_for`):

* the window geometry (`Axis`, a line-for-line mirror of the header's):
  the owned (y, z) tiles and x segments partition the cells and the n+1
  faces (top face included) exactly once, each level's update ranges read
  only what the level before left valid, and the owned tile lies in what
  level k leaves valid;
* the schedule (`march`, a mirror of the header's ``march`` on whole (y, z)
  planes): the ring of `ring_depth(k)` x planes, `PLANES` planes per
  iteration loaded one iteration ahead, level s's halves at planes t-s+1..
  and t-s.., in place, and the stores of planes t-k... A load lands either
  when it is issued or only at the wait before its planes are stepped (the
  two ends of its flight), the ring starts as NaN, and
  the result must equal the plain versions bit for bit (the same torch
  operations on the same values).
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu_torch.ops import fused_leapfrog as fl
from implicitglobalgrid_tpu_torch.ops import fused_pt as fp

SHAPES = [(37, 45, 70), (12, 12, 12), (5, 64, 96), (256, 256, 256)]
LF = (0.05, 0.04, 0.03, 0.07, 10.0, 6.6, 5.0)  # cax, cay, caz, b, idx, idy, idz
PT = (0.5, 10.0, 6.6, 5.0, 1.0, 3e-4)  # th, idx, idy, idz, ralam, bp


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

    def cell(self, s):
        return (0 if self.lo_face else s, self.e if self.hi_face else self.e - s)

    def face(self, s):
        return (1 if self.lo_face else s, self.e if self.hi_face else self.e - s + 1)

    def side(self, s):
        return (1 if self.lo_face else s, self.e - 1 if self.hi_face else self.e - s)

    # The ranges as level caps: i is in the range at level s iff s <= cap.
    def cell_levels(self, i):
        return _cap(ALL if self.lo_face else i,
                    (ALL if i < self.e else 0) if self.hi_face else self.e - 1 - i)

    def face_levels(self, i):
        return _cap((ALL if i >= 1 else 0) if self.lo_face else i,
                    (ALL if i < self.e else 0) if self.hi_face else self.e - i)

    def side_levels(self, i):
        return _cap((ALL if i >= 1 else 0) if self.lo_face else i,
                    (ALL if i < self.e - 1 else 0) if self.hi_face else self.e - 1 - i)


ALL = 15  # kAll: a cap no k reaches


def _cap(lo, hi):
    return max(0, min(lo, hi, ALL))


def axes(n, b, k):
    return [Axis.make(n, i, b, k) for i in range(-(-n // b))]


def tiles(shape, k, itemsize=4, bx=None):
    tile = fl.tile_for(shape, k, itemsize)
    return tile if bx is None else (bx, *tile[1:])


# -- geometry ---------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_owned_tiles_partition_cells_and_faces(shape, k):
    """Every cell and every face (0..n) is owned by exactly one block along
    each axis; the top face n by the block whose tile reaches it."""
    for n, b in zip(shape, tiles(shape, k)):
        cells, faces = np.zeros(n, int), np.zeros(n + 1, int)
        for a in axes(n, b, k):
            cells[a.o0:a.o1] += 1
            faces[a.o0:a.o1 + (a.o1 == n)] += 1
        assert (cells == 1).all() and (faces == 1).all()


def _rng(lo_hi):
    return set(range(*lo_hi))


@pytest.mark.parametrize("bx", [None, 8])
@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_each_level_reads_what_the_level_before_left_valid(shape, k, bx):
    """Per axis of every window: what is valid after level s (cells: the
    update range; faces along their axis: the range plus the array's frozen
    faces; transverse rows: the range plus the array's frozen rows) holds
    everything level s+1 reads, and the owned tile is valid after level k."""
    for n, b in zip(shape, tiles(shape, k, bx=bx)):
        for a in axes(n, b, k):
            frozen_f = {i for i, on in ((0, a.lo_face), (a.e, a.hi_face)) if on}
            frozen_s = {i for i, on in ((0, a.lo_face), (a.e - 1, a.hi_face)) if on}
            valid_c, valid_f, valid_s = set(range(a.e)), set(range(a.e + 1)), set(range(a.e))
            for s in range(1, k + 1):
                C, F, S = _rng(a.cell(s)), _rng(a.face(s)), _rng(a.side(s))
                assert not F & frozen_f and not S & frozen_s  # frozen stays frozen
                # faces along the axis read the cells on both sides and themselves
                assert {f - 1 for f in F} | F <= valid_c and F <= valid_f
                assert S <= valid_c and S <= valid_s  # transverse faces: cell i, themselves
                valid_c, valid_f, valid_s = C, F | frozen_f, S | frozen_s
                # cells read themselves (level s-1 was checked above), the faces
                # c and c+1 along the axis and transverse row c, all at level s
                assert C | {c + 1 for c in C} <= valid_f and C <= valid_s
            lo, hi = a.o0 - a.w0, a.o1 - a.w0
            assert set(range(lo, hi)) <= valid_c & valid_s
            assert set(range(lo, hi + (a.o1 == n))) <= valid_f


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_level_caps_are_the_update_ranges(shape, k):
    """The per-position caps the kernel folds its y/z ranges into select
    exactly the ranges, at every level and for every plane position (the
    extra row/column of the face fields included)."""
    for n, b in zip(shape[1:], tiles(shape, k)[1:]):
        for a in axes(n, b, k):
            for s in range(1, k + 1):
                for rng, levels in ((a.cell(s), a.cell_levels), (a.face(s), a.face_levels),
                                    (a.side(s), a.side_levels)):
                    assert [i for i in range(a.e + 1) if s <= levels(i)] == list(range(*rng))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_window_plane_fits_the_slots_and_one_segment_marches_x(shape, k, itemsize):
    tile = fl.tile_for(shape, k, itemsize)
    assert tile[0] == shape[0]
    ey, ez = fl.window_plane(shape, k, tile)
    assert (ey + 1) * (ez + 1) <= fl.SLOTS[itemsize] * fl.THREADS
    gx, gy, gz = fl.grid(shape, tile)
    assert (gx, gy, gz) == (-(-shape[2] // tile[2]), -(-shape[1] // tile[1]), 1)


# -- the schedule -----------------------------------------------------------


class _Leapfrog:
    """``Leapfrog`` of fused_leapfrog.cu on plane slices (rows ys, cols zs)."""

    def __init__(self, cax, cay, caz, b, idx, idy, idz):
        self.c = (cax, cay, caz, b, idx, idy, idz)

    def vx(self, Vx, P, Pm, ys, zs, a):
        Vx[ys, zs] = Vx[ys, zs] - self.c[0] * (P[ys, zs] - Pm[ys, zs])

    def vy(self, Vy, P, ys, zs, a):
        Vy[ys, zs] = Vy[ys, zs] - self.c[1] * (P[ys, zs] - P[_sh(ys, -1), zs])

    def vz(self, Vz, P, ys, zs, a):
        Vz[ys, zs] = Vz[ys, zs] - self.c[2] * (P[ys, zs] - P[ys, _sh(zs, -1)])

    def p(self, P, Vx, Vx1, Vy, Vz, ys, zs):
        _, _, _, b, idx, idy, idz = self.c
        div = ((Vx1[ys, zs] - Vx[ys, zs]) * idx + (Vy[_sh(ys, 1), zs] - Vy[ys, zs]) * idy) \
            + (Vz[ys, _sh(zs, 1)] - Vz[ys, zs]) * idz
        P[ys, zs] = P[ys, zs] - b * div


class _Pt(_Leapfrog):
    """``Pt`` of fused_pt.cu; `vz` reads T at global plane ``a``."""

    def __init__(self, T, win, th, idx, idy, idz, ralam, bp):
        self.T, self.win = T, win
        self.c = (th, idx, idy, idz, ralam, bp)

    def _relax(self, Q, f, ys, zs):
        q = Q[ys, zs]
        Q[ys, zs] = q + self.c[0] * (f - q)

    def vx(self, Qx, P, Pm, ys, zs, a):
        self._relax(Qx, -self.c[1] * (P[ys, zs] - Pm[ys, zs]), ys, zs)

    def vy(self, Qy, P, ys, zs, a):
        self._relax(Qy, -self.c[2] * (P[ys, zs] - P[_sh(ys, -1), zs]), ys, zs)

    def vz(self, Qz, P, ys, zs, a):
        x, y, z = self.win.x.w0 + a, self.win.y.w0, self.win.z.w0
        Tp = self.T[x, y + ys.start:y + ys.stop, :]
        tz = 0.5 * (Tp[:, z + zs.start:z + zs.stop] + Tp[:, z + zs.start - 1:z + zs.stop - 1])
        self._relax(Qz, -self.c[3] * (P[ys, zs] - P[ys, _sh(zs, -1)]) + self.c[4] * tz, ys, zs)

    def p(self, P, Qx, Qx1, Qy, Qz, ys, zs):
        th, idx, idy, idz, ralam, bp = self.c
        div = ((Qx1[ys, zs] - Qx[ys, zs]) * idx + (Qy[_sh(ys, 1), zs] - Qy[ys, zs]) * idy) \
            + (Qz[ys, _sh(zs, 1)] - Qz[ys, zs]) * idz
        P[ys, zs] = P[ys, zs] - bp * div


def _sh(sl, d):
    return slice(sl.start + d, sl.stop + d)


def _on(lo_hi):
    return slice(*lo_hi) if lo_hi[1] > lo_hi[0] else None


@dataclass(frozen=True)
class _Window:
    x: Axis
    y: Axis
    z: Axis


def march(ins, outs, k, tile, make_ops, land):
    """``igg::march`` for every block of the grid: ``ins``/``outs`` are the
    cell field and the x/y/z face fields."""
    n0, n1, n2 = ins[0].shape
    depth = fl.ring_depth(k)
    for bxi in range(-(-n0 // tile[0])):
        for byi in range(-(-n1 // tile[1])):
            for bzi in range(-(-n2 // tile[2])):
                w = _Window(Axis.make(n0, bxi, tile[0], k), Axis.make(n1, byi, tile[1], k),
                            Axis.make(n2, bzi, tile[2], k))
                _march_block(w, ins, outs, k, depth, make_ops(w), land)


def _march_block(w, ins, outs, k, depth, ops, land):
    ex, ey, ez = w.x.e, w.y.e, w.z.e
    ring = torch.full((4, depth, ey + 1, ez + 1), float("nan"), dtype=ins[0].dtype)
    y0, z0 = w.y.w0, w.z.w0
    pending = {}

    def load(p, i):
        if p > ex:
            return
        gx = w.x.w0 + p
        copies = [(1, ins[1][gx, y0:y0 + ey, z0:z0 + ez], ey, ez)]
        if p < ex:
            copies += [(0, ins[0][gx, y0:y0 + ey, z0:z0 + ez], ey, ez),
                       (2, ins[2][gx, y0:y0 + ey + 1, z0:z0 + ez], ey + 1, ez),
                       (3, ins[3][gx, y0:y0 + ey, z0:z0 + ez + 1], ey, ez + 1)]
        if land == "issue":
            for f, src, r, c in copies:
                ring[f, i, :r, :c] = src
        else:
            pending[p] = (i, copies)

    def land_plane(t):
        i, copies = pending.pop(t, (None, ()))
        for f, src, r, c in copies:
            ring[f, i, :r, :c] = src

    lx, hx = w.x.o0 - w.x.w0, w.x.o1 - w.x.w0
    ly, hy, lz, hz = w.y.o0 - y0, w.y.o1 - y0, w.z.o0 - z0, w.z.o1 - z0
    ty, tz = int(w.y.o1 == w.y.n), int(w.z.o1 == w.z.n)

    def store(b, i, i1):
        if not lx <= b < hx:
            return
        gx = w.x.w0 + b
        gy, gz = slice(w.y.o0, w.y.o1), slice(w.z.o0, w.z.o1)
        oy, oz = slice(ly, hy), slice(lz, hz)
        outs[0][gx, gy, gz] = ring[0, i, oy, oz]
        outs[1][gx, gy, gz] = ring[1, i, oy, oz]
        if b == hx - 1 and w.x.o1 == w.x.n:
            outs[1][gx + 1, gy, gz] = ring[1, i1, oy, oz]
        outs[2][gx, w.y.o0:w.y.o1 + ty, gz] = ring[2, i, ly:hy + ty, oz]
        outs[3][gx, gy, w.z.o0:w.z.o1 + tz] = ring[3, i, oy, lz:hz + tz]

    us = 0

    def slot(d):  # the slot of plane t + d
        i = us + d
        return i + depth if i < 0 else i - depth if i >= depth else i

    for m in range(fl.PLANES):
        load(m, m)
    for t in range(0, ex + k, fl.PLANES):
        if land == "wait":
            for m in range(fl.PLANES):
                land_plane(t + m)
        for m in range(fl.PLANES):
            load(t + fl.PLANES + m, slot(fl.PLANES + m))
        for s in range(1, k + 1):
            ys, yf, zs, zf = (_on(w.y.side(s)), _on(w.y.face(s)), _on(w.z.side(s)),
                              _on(w.z.face(s)))
            for m in range(fl.PLANES):
                a = t - s + 1 + m
                fx_on = w.x.face(s)[0] <= a < w.x.face(s)[1]
                side_on = w.x.side(s)[0] <= a < w.x.side(s)[1]
                i, im = slot(a - t), slot(a - 1 - t)
                if fx_on and ys and zs:
                    ops.vx(ring[1, i], ring[0, i], ring[0, im], ys, zs, a)
                if side_on and yf and zs:
                    ops.vy(ring[2, i], ring[0, i], yf, zs, a)
                if side_on and ys and zf:
                    ops.vz(ring[3, i], ring[0, i], ys, zf, a)
            yc, zc = _on(w.y.cell(s)), _on(w.z.cell(s))
            for m in range(fl.PLANES):
                b = t - s + m
                if w.x.cell(s)[0] <= b < w.x.cell(s)[1] and yc and zc:
                    ib, ib1 = slot(b - t), slot(b + 1 - t)
                    ops.p(ring[0, ib], ring[1, ib], ring[1, ib1], ring[2, ib], ring[3, ib],
                          yc, zc)
        for m in range(fl.PLANES):
            store(t - k + m, slot(m - k), slot(m - k + 1))
        us = slot(fl.PLANES)

CASES = [((37, 45, 70), torch.float32, 2, None), ((37, 45, 70), torch.float32, 6, None),
         ((37, 45, 70), torch.float32, 8, None), ((37, 45, 70), torch.float64, 4, None),
         ((12, 12, 12), torch.float32, 6, None), ((5, 64, 96), torch.float32, 4, None),
         ((37, 45, 70), torch.float32, 4, 8), ((12, 12, 12), torch.float32, 2, 4)]


def _fields(shape, dtype, cells, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in (shape,) * cells + fl.face_shapes(shape)]


@pytest.mark.parametrize("land", ["issue", "wait"])
@pytest.mark.parametrize("shape,dtype,k,bx", CASES)
def test_leapfrog_schedule_equals_plain_version(shape, dtype, k, bx, land):
    ins = _fields(shape, dtype, 1, seed=k)
    outs = [torch.full_like(a, float("nan")) for a in ins]
    march(ins, outs, k, tiles(shape, k, ins[0].element_size(), bx), lambda w: _Leapfrog(*LF),
          land)
    for g, r in zip(outs, fl.fused_leapfrog_steps_reference(*ins, k, *LF)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("land", ["issue", "wait"])
@pytest.mark.parametrize("shape,dtype,k,bx", CASES)
def test_pt_schedule_equals_plain_version(shape, dtype, k, bx, land):
    T, *ins = _fields(shape, dtype, 2, seed=k + 1)
    outs = [torch.full_like(a, float("nan")) for a in ins]
    march(ins, outs, k, tiles(shape, k, T.element_size(), bx), lambda w: _Pt(T, w, *PT), land)
    for g, r in zip(outs, fp.fused_pt_iterations_reference(T, *ins, k, *PT)):
        assert torch.equal(g, r)
