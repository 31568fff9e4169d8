// The x-marching wavefront shared by the two staggered kernels
// (fused_leapfrog.cu, fused_pt.cu).
//
// Geometry.  A block owns an output tile of cells [o0, o1) per axis and the
// faces with the same indices along each face field's own axis; the block
// whose tile reaches the array's top (o1 == n) also owns the top face n,
// which no step updates.  Its window is the tile plus k cells on each side,
// clipped to the array: e cells and e + 1 faces along a staggered field's
// own axis.  Tiles cut y and z; along x a tile is a segment, normally all of
// x (one segment).
//
// Validity (the trapezoid argument of fused_diffusion.cu, staggered): a window
// edge that is an array face is exact; at an interior edge the face there
// cannot be updated (its outer cell is missing), so after level s cells and
// faces closer than s to an interior edge are stale.  Owned outputs sit >= k
// inside every interior edge, so they are exact after k levels.  Each level
// therefore updates only what must be valid after it (the ranges of Axis);
// anything nearer an interior edge may keep any value.
//
// Schedule.  The block walks its window along x (the slowest axis: a (y, z)
// plane is a run of contiguous z rows) and keeps a ring of x planes of each
// field in shared memory.  Iteration u takes kPlanes planes, t = kPlanes*u:
// the velocity (flux) half of level s updates planes a = t-s+1 .. t-s+kPlanes
// and the pressure half planes b = t-s .. t-s+kPlanes-1, in the order V1, P1,
// V2, P2, ... with a barrier between halves (2k barriers per iteration).
// Level s thus runs one plane behind level s-1, and every level updates in
// place:
//   - Vx^s(a) reads P^{s-1}(a-1), P^{s-1}(a): written by the P half of level
//     s-1 earlier in this iteration or before it, and P^s(a-1) is written
//     only after, by the P half of level s;
//   - P^s(b) reads Vx^s(b+1), Vx^s(b), Vy^s(b), Vz^s(b), written by the V half
//     of level s in this iteration or before it, and level s+1 overwrites
//     none of them before its own V half, which comes after;
//   - within a half, no plane reads what the half writes.
// A plane is live from its load (one iteration before it is first stepped)
// until level k's P half has passed it and it is stored, so the ring holds
// k + 2*kPlanes planes.  The next iteration's planes are loaded with cp.async
// while this one steps (`__pipeline_wait_prior(0)` at the top of the next).
// Each thread keeps fixed (y, z) positions of the plane (its slots) for
// loads, every half step and stores, so it stores only what it wrote or
// loaded itself and the store needs no barrier.  Per slot, the levels that
// update each field there are folded once into a small cap (Axis::*_levels),
// so a half step costs one compare per point.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igg {

// One block per SM at the tiles the wrappers choose; its 16 warps share one
// (y, z) plane of each field per level.
constexpr int kThreads = 512;
// Plane positions per thread: (ey + 1) * (ez + 1) <= kSlots<T> * kThreads
// (checked by the wrappers' tile ladder).  float64 tiles are smaller, and
// two slots keep its registers under the 128 a 512-thread block allows.
template <typename T>
constexpr int kSlots = sizeof(T) == 8 ? 2 : 3;
// x planes stepped per iteration (and loaded per iteration, one ahead).
constexpr int kPlanes = 2;
// A level cap that no k reaches (k <= 8 < kAll): the position is updated at
// every level.
constexpr int kAll = 15;

__host__ __device__ constexpr int ring_depth(int k) { return k + 2 * kPlanes; }

__device__ __forceinline__ bool in(int i, int lo, int hi) { return i >= lo && i < hi; }
__device__ __forceinline__ int cap(int lo, int hi) { return max(0, min(min(lo, hi), kAll)); }

// Per axis: the array's cell extent, the window's origin and extent, the
// owned range, and whether each window edge is an array face.
struct Axis {
  int n, w0, e, o0, o1;
  bool lo_face, hi_face;

  __device__ static Axis make(int n, int tile, int b, int k) {
    Axis a;
    a.n = n;
    a.o0 = tile * b;
    a.o1 = min(a.o0 + b, n);
    a.w0 = max(a.o0 - k, 0);
    a.e = min(a.o1 + k, n) - a.w0;
    a.lo_face = a.w0 == 0;
    a.hi_face = a.w0 + a.e == n;
    return a;
  }
  // Update range at level s (1-based), window-local, half open.
  // Cells: every cell, the array's boundary cells included.
  __device__ int cell_lo(int s) const { return lo_face ? 0 : s; }
  __device__ int cell_hi(int s) const { return hi_face ? e : e - s; }
  // Faces along the field's own axis: array faces 0 and n are frozen.
  __device__ int face_lo(int s) const { return lo_face ? 1 : s; }
  __device__ int face_hi(int s) const { return hi_face ? e : e - s + 1; }
  // A face field along a transverse axis: the boundary rows 0 and n-1 are
  // frozen (the model's global-interior transverse index).
  __device__ int side_lo(int s) const { return lo_face ? 1 : s; }
  __device__ int side_hi(int s) const { return hi_face ? e - 1 : e - s; }
  // The same ranges as caps: index i is in the range at level s iff
  // s <= *_levels(i) (the ranges only shrink as s grows).
  __device__ int cell_levels(int i) const {
    return cap(lo_face ? kAll : i, hi_face ? (i < e ? kAll : 0) : e - 1 - i);
  }
  __device__ int face_levels(int i) const {
    return cap(lo_face ? (i >= 1 ? kAll : 0) : i, hi_face ? (i < e ? kAll : 0) : e - i);
  }
  __device__ int side_levels(int i) const {
    return cap(lo_face ? (i >= 1 ? kAll : 0) : i, hi_face ? (i < e - 1 ? kAll : 0) : e - 1 - i);
  }
};

struct Window {
  Axis x, y, z;

  __device__ static Window make(int n0, int n1, int n2, int k, int bx, int by, int bz) {
    return {Axis::make(n0, blockIdx.z, bx, k), Axis::make(n1, blockIdx.y, by, k),
            Axis::make(n2, blockIdx.x, bz, k)};
  }
};

// A slot's flags: the level caps of the four updates (4 bits each), which
// fields it loads and which it stores, and the largest cap of the slot's
// warp (a warp whose slot has nothing to update at a level skips it).
enum : int {
  kCapVx = 0, kCapVy = 4, kCapVz = 8, kCapP = 12,
  kLoadC = 1 << 16, kLoadY = 1 << 17, kLoadZ = 1 << 18,
  kStoreC = 1 << 19, kStoreY = 1 << 20, kStoreZ = 1 << 21, kCapWarp = 24,
};
__device__ __forceinline__ bool upto(int flags, int field, int s) {
  return s <= ((flags >> field) & kAll);
}

// The per-point updates a kernel supplies, on values (v: the face's value,
// p: the cell value at the face's upper side, q: at its lower side):
//   ld(g)             an element the z-face update needs from a cell-shaped
//                     array in global memory (g: the cell above the face, and
//                     g - 1), read for every slot one half step ahead, while
//                     the P half of the level before runs;
//   vx(v, p, q), vy(v, p, q), vz(v, p, q, a, am)   the new x, y, z face
//                     value (a, am: ld(g), ld(g - 1));
//   p(P, vx, vx1, vy, vy1, vz, vz1)   the new cell value from its lower and
//                     upper faces along x, y and z.
// Each half step reads every operand of its slots unconditionally (from
// in-bounds positions: a neighbour index falls back to the slot's own where
// the update is off) and stores only where its level cap allows, so the
// updates compile to straight-line code whose reads overlap.  What a thread
// read or wrote at its own position in the V half stays in registers for
// the P half of the same level: Vx^s and P^{s-1} of the planes b+1 and b,
// and, for the iteration's second P plane, its Vx, Vy and Vz, which the
// first V plane updated.
// march() runs k levels over the block's window and stores its owned tile.
template <typename T, typename Ops>
__device__ __forceinline__ void march(const Window& w, int k, T* __restrict__ smem,
                                      const T* __restrict__ c_in, const T* __restrict__ fx_in,
                                      const T* __restrict__ fy_in, const T* __restrict__ fz_in,
                                      T* __restrict__ c_out, T* __restrict__ fx_out,
                                      T* __restrict__ fy_out, T* __restrict__ fz_out,
                                      const Ops& ops) {
  const int n1 = w.y.n, n2 = w.z.n, ex = w.x.e, ey = w.y.e, ez = w.z.e;
  const int rz = ez + 1, ps = (ey + 1) * rz, depth = ring_depth(k);
  const int slots = (ps + kThreads - 1) / kThreads;
  constexpr int kS = kSlots<T>;
  const int64_t cplane = (int64_t)n1 * n2, yplane = (int64_t)(n1 + 1) * n2,
                zplane = (int64_t)n1 * (n2 + 1);
  // Field f's ring slot i: fields 0 = cells, 1/2/3 = x/y/z faces.
  auto at = [&](int f, int i) { return smem + (f * depth + i) * ps; };

  // Per slot: the plane position c, its flags, the global in-plane offset of
  // a cell-shaped (and y-face) plane, and its global row (the z faces'
  // offset is oc + gy).
  int sc[kS], sf[kS], sgy[kS];
  int64_t soc[kS];
  {
    const int ly = w.y.o0 - w.y.w0, hy = w.y.o1 - w.y.w0;
    const int lz = w.z.o0 - w.z.w0, hz = w.z.o1 - w.z.w0;
    const bool ty = w.y.o1 == n1, tz = w.z.o1 == n2;
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int c = threadIdx.x + j * kThreads, y = c / rz, z = c - y * rz;
      const bool yo = in(y, ly, hy), zo = in(z, lz, hz);
      const int vx = min(w.y.side_levels(y), w.z.side_levels(z));
      const int vy = min(w.y.face_levels(y), w.z.side_levels(z));
      const int vz = min(w.y.side_levels(y), w.z.face_levels(z));
      const int cp = min(w.y.cell_levels(y), w.z.cell_levels(z));
      const int f = (vx << kCapVx) | (vy << kCapVy) | (vz << kCapVz) | (cp << kCapP)
                  | (y < ey && z < ez ? kLoadC : 0) | (z < ez ? kLoadY : 0)
                  | (y < ey ? kLoadZ : 0) | (yo && zo ? kStoreC : 0)
                  | ((yo || (ty && y == hy)) && zo ? kStoreY : 0)
                  | (yo && (zo || (tz && z == hz)) ? kStoreZ : 0);
      const int warp = __reduce_max_sync(0xffffffffu, c < ps ? max(max(vx, vy), max(vz, cp)) : 0);
      // A slot past the plane gets position 0 and no flags: its unused
      // reads stay inside the ring and the arrays.
      sc[j] = c < ps ? c : 0;
      sf[j] = (c < ps ? f : 0) | warp << kCapWarp;
      sgy[j] = c < ps ? w.y.w0 + y : 0;
      soc[j] = c < ps ? (int64_t)(w.y.w0 + y) * n2 + w.z.w0 + z : 0;
    }
  }

  // Window plane p into ring slot i (x faces up to p = ex, the rest up to
  // ex - 1).
  auto load = [&](int p, int i) {
    if (p > ex) return;
    const int64_t gx = w.x.w0 + p;
    const bool cells = p < ex;
    T *dc = at(0, i), *dx = at(1, i), *dy = at(2, i), *dz = at(3, i);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (j >= slots) break;
      const int c = sc[j], f = sf[j];
      const int64_t oc = soc[j];
      if (f & kLoadC) {
        __pipeline_memcpy_async(dx + c, fx_in + gx * cplane + oc, sizeof(T));
        if (cells) __pipeline_memcpy_async(dc + c, c_in + gx * cplane + oc, sizeof(T));
      }
      if (cells && (f & kLoadY)) __pipeline_memcpy_async(dy + c, fy_in + gx * yplane + oc, sizeof(T));
      if (cells && (f & kLoadZ))
        __pipeline_memcpy_async(dz + c, fz_in + gx * zplane + oc + sgy[j], sizeof(T));
    }
  };

  // The owned part of window plane b (slot i; the x faces' plane b+1 in
  // slot i1 when b is the array's last cell plane); only own slots are read.
  const int lx = w.x.o0 - w.x.w0, hx = w.x.o1 - w.x.w0;
  auto store = [&](int b, int i, int i1) {
    if (!in(b, lx, hx)) return;
    const int64_t gx = w.x.w0 + b;
    const bool top_x = b == hx - 1 && w.x.o1 == w.x.n;
    const T *P = at(0, i), *Vx = at(1, i), *Vx1 = at(1, i1), *Vy = at(2, i), *Vz = at(3, i);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (j >= slots) break;
      const int c = sc[j], f = sf[j];
      const int64_t oc = soc[j];
      if (f & kStoreC) {
        c_out[gx * cplane + oc] = P[c];
        fx_out[gx * cplane + oc] = Vx[c];
        if (top_x) fx_out[(gx + 1) * cplane + oc] = Vx1[c];
      }
      if (f & kStoreY) fy_out[gx * yplane + oc] = Vy[c];
      if (f & kStoreZ) fz_out[gx * zplane + oc + sgy[j]] = Vz[c];
    }
  };

  // us = t mod depth; the slot of plane t + d (-depth < d < depth).
  int us = 0;
  auto slot = [&](int d) {
    const int i = us + d;
    return i < 0 ? i + depth : i >= depth ? i - depth : i;
  };
  // ops.ld for the z faces of level s's V planes, for every slot; used in
  // the next V half, so the reads' latency is hidden.  In bounds for every
  // slot: the V planes stay below the array's last plane, and a row or
  // column past the window is at most one row on.
  T aux[kPlanes][kS], auxm[kPlanes][kS];
  int t = 0;
  auto fetch = [&](int s) {
#pragma unroll
    for (int m = 0; m < kPlanes; ++m) {
      const int a = t - s + 1 + m;
      if (s > k || !in(a, w.x.side_lo(s), w.x.side_hi(s))) continue;
      const int64_t gplane = (int64_t)(w.x.w0 + a) * cplane;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        if (j >= slots) break;
        aux[m][j] = ops.ld(gplane + soc[j]);
        auxm[m][j] = ops.ld(gplane + soc[j] - 1);
      }
    }
  };
  for (int m = 0; m < kPlanes; ++m) load(m, m);
  __pipeline_commit();
  for (; t < ex + k; t += kPlanes, us = slot(kPlanes)) {
    __pipeline_wait_prior(0);
    __syncthreads();  // planes t.. are in; every thread is past the last iteration
    for (int m = 0; m < kPlanes; ++m) load(t + kPlanes + m, slot(kPlanes + m));
    __pipeline_commit();
    fetch(1);
    for (int s = 1; s <= k; ++s) {
      // Own-position values the V half leaves for the P half, per V plane m
      // and slot j: P^{s-1} (pv) and Vx^s, Vy^s, Vz^s (vxv, vyv, vzv) at its
      // plane a, and P^{s-1} at plane a-1 of the first V plane (pmv).  P
      // plane m is V plane m-1, and its x faces b+1 are V plane m's.
      T pv[kPlanes][kS], vxv[kPlanes][kS], vyv[kPlanes][kS], vzv[kPlanes][kS], pmv[kS];
#pragma unroll
      for (int m = 0; m < kPlanes; ++m) {
        const int a = t - s + 1 + m, q = m > 0 ? m - 1 : 0;
        const bool fx_on = in(a, w.x.face_lo(s), w.x.face_hi(s));
        const bool side_on = in(a, w.x.side_lo(s), w.x.side_hi(s));
        const int i = slot(a - t);
        const T *P = at(0, i), *Pm = at(0, slot(a - 1 - t));
        T *Vx = at(1, i), *Vy = at(2, i), *Vz = at(3, i);
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (j >= slots) break;
          if (!upto(sf[j], kCapWarp, s)) continue;  // the P half skips it too
          const int c = sc[j], f = sf[j];
          const bool on_x = fx_on && upto(f, kCapVx, s), on_y = side_on && upto(f, kCapVy, s),
                     on_z = side_on && upto(f, kCapVz, s);
          const T p = P[c], pm = m == 0 ? Pm[c] : pv[q][j];
          const T ox = Vx[c], oy = Vy[c], oz = Vz[c];
          const T nx = ops.vx(ox, p, pm);
          const T ny = ops.vy(oy, p, P[on_y ? c - rz : c]);
          const T nz = ops.vz(oz, p, P[on_z ? c - 1 : c], aux[m][j], auxm[m][j]);
          if (on_x) Vx[c] = nx;
          if (on_y) Vy[c] = ny;
          if (on_z) Vz[c] = nz;
          if (m == 0) pmv[j] = pm;
          pv[m][j] = p;
          vxv[m][j] = on_x ? nx : ox;
          vyv[m][j] = on_y ? ny : oy;
          vzv[m][j] = on_z ? nz : oz;
        }
      }
      fetch(s + 1);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kPlanes; ++m) {
        const int b = t - s + m, q = m > 0 ? m - 1 : 0;
        if (!in(b, w.x.cell_lo(s), w.x.cell_hi(s))) continue;
        const int i = slot(b - t);
        T* P = at(0, i);
        const T *Vx = at(1, i), *Vy = at(2, i), *Vz = at(3, i);
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (j >= slots) break;
          if (!upto(sf[j], kCapWarp, s)) continue;
          const int c = sc[j];
          const bool on = upto(sf[j], kCapP, s);
          const T p = ops.p(m == 0 ? pmv[j] : pv[q][j], m == 0 ? Vx[c] : vxv[q][j], vxv[m][j],
                            m == 0 ? Vy[c] : vyv[q][j], Vy[on ? c + rz : c],
                            m == 0 ? Vz[c] : vzv[q][j], Vz[on ? c + 1 : c]);
          if (on) P[c] = p;
        }
      }
      if (s < k) __syncthreads();
    }
    for (int m = 0; m < kPlanes; ++m) store(t - k + m, slot(m - k), slot(m - k + 1));
  }
}

// Dynamic shared memory of the plane rings (four fields) for a (by, bz) tile.
template <typename T>
inline size_t ring_bytes(int n1, int n2, int k, int by, int bz) {
  const size_t ey = min(by + 2 * k, n1), ez = min(bz + 2 * k, n2);
  return 4 * (size_t)ring_depth(k) * (ey + 1) * (ez + 1) * sizeof(T);
}

// Raises the kernel's dynamic shared-memory cap only when a launch needs
// more than this device already allows (one cap per kernel and device).
template <typename Kernel>
inline cudaError_t ensure_smem(Kernel kernel, int* caps, int ncaps, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= ncaps || smem > caps[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < ncaps) caps[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace igg
