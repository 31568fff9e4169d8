// Window geometry and box copies shared by the two staggered kernels
// (fused_leapfrog.cu, fused_pt.cu).
//
// A block owns an output tile of cells [o0, o1) per axis and the faces with
// the same indices along each face field's own axis; the block whose tile
// reaches the array's top (o1 == n) also owns the top face n, which no step
// updates.  Its window is the tile plus k cells on each side, clipped to the
// array: e cells and e + 1 faces along a staggered field's own axis.
//
// Validity (the trapezoid argument of fused_diffusion.cu, staggered): a window
// edge that is an array face is exact; at an interior edge the face there
// cannot be updated (its outer cell is missing), so after step s cells and
// faces closer than s to an interior edge are stale.  Owned outputs sit >= k
// inside every interior edge, so they are exact after k steps.  Each step
// therefore updates only what must be valid after it (the regions below);
// anything nearer an interior edge may keep any value.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igg {

// One block per SM fits (a window set takes most of the shared memory), so
// the block brings all the warps the SM gets.
constexpr int kThreads = 512;

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
  // Update range at step s (1-based), window-local, half open.
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
};

struct Window {
  Axis x, y, z;

  __device__ static Window make(int n0, int n1, int n2, int k, int bx, int by, int bz) {
    return {Axis::make(n0, blockIdx.z, bx, k), Axis::make(n1, blockIdx.y, by, k),
            Axis::make(n2, blockIdx.x, bz, k)};
  }
};

// Calls f(x, y, z) for every point of the box [x0,x1) x [y0,y1) x [z0,z1),
// spread over the block's threads: thread t takes the points t, t +
// kThreads, ... of the box in row-major order, stepping from one to the next
// by carries (no integer division in the loop).
template <typename F>
__device__ __forceinline__ void for_box(int x0, int x1, int y0, int y1, int z0, int z1, F f) {
  const int rx = x1 - x0, ry = y1 - y0, rz = z1 - z0;
  if (rx <= 0 || ry <= 0 || rz <= 0) return;
  const int plane = ry * rz;
  const int dx = kThreads / plane, dq = kThreads - dx * plane;
  const int dy = dq / rz, dz = dq - dy * rz;  // the stride as (dx, dy, dz), dy < ry, dz < rz
  const int t = threadIdx.x;
  int x = t / plane, q = t - x * plane;
  int y = q / rz, z = q - y * rz;
  while (x < rx) {
    f(x0 + x, y0 + y, z0 + z);
    z += dz;
    y += dy;
    x += dx;
    if (z >= rz) {
      z -= rz;
      ++y;
    }
    if (y >= ry) {
      y -= ry;
      ++x;
    }
  }
}

// Copies the box of extents (e0, e1, e2) at origin (s0, s1, s2) of the
// row-major array `src` (inner extents sd1, sd2) to origin (d0, d1, d2) of
// `dst` (inner extents dd1, dd2).  With `async`, `dst` is shared memory and
// every element goes as a cp.async copy, all in flight at once; the caller
// waits for them (`__pipeline_commit`, `__pipeline_wait_prior(0)`).
template <bool async, typename T>
__device__ void copy_box(T* __restrict__ dst, int dd1, int dd2, int d0, int d1, int d2,
                         const T* __restrict__ src, int sd1, int sd2, int s0, int s1, int s2,
                         int e0, int e1, int e2) {
  for_box(0, e0, 0, e1, 0, e2, [&](int x, int y, int z) {
    T* to = dst + ((int64_t)(d0 + x) * dd1 + d1 + y) * dd2 + d2 + z;
    const T* from = src + ((int64_t)(s0 + x) * sd1 + s1 + y) * sd2 + s2 + z;
    if constexpr (async) {
      __pipeline_memcpy_async(to, from, sizeof(T));
    } else {
      *to = *from;
    }
  });
}

// The four staggered fields of one window in shared memory: cells
// (ex, ey, ez), x faces (ex+1, ey, ez), y faces (ex, ey+1, ez), z faces
// (ex, ey, ez+1), each row-major.
template <typename T>
struct Fields {
  T *c, *fx, *fy, *fz;

  __device__ static Fields carve(T* smem, const Window& w) {
    const int ex = w.x.e, ey = w.y.e, ez = w.z.e;
    Fields f;
    f.c = smem;
    f.fx = f.c + ex * ey * ez;
    f.fy = f.fx + (ex + 1) * ey * ez;
    f.fz = f.fy + ex * (ey + 1) * ez;
    return f;
  }

  // Loads the window of the four global arrays (cell extents n0, n1, n2);
  // the caller's __syncthreads() publishes it to the block.
  __device__ void load(const Window& w, const T* c_in, const T* fx_in, const T* fy_in,
                       const T* fz_in) {
    const int n1 = w.y.n, n2 = w.z.n;
    const int x0 = w.x.w0, y0 = w.y.w0, z0 = w.z.w0, ex = w.x.e, ey = w.y.e, ez = w.z.e;
    copy_box<true>(c, ey, ez, 0, 0, 0, c_in, n1, n2, x0, y0, z0, ex, ey, ez);
    copy_box<true>(fx, ey, ez, 0, 0, 0, fx_in, n1, n2, x0, y0, z0, ex + 1, ey, ez);
    copy_box<true>(fy, ey + 1, ez, 0, 0, 0, fy_in, n1 + 1, n2, x0, y0, z0, ex, ey + 1, ez);
    copy_box<true>(fz, ey, ez + 1, 0, 0, 0, fz_in, n1, n2 + 1, x0, y0, z0, ex, ey, ez + 1);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }

  // Stores the owned tile of each field; along its own axis a face field
  // also stores the top face when the tile reaches the array's top.
  __device__ void store(const Window& w, T* c_out, T* fx_out, T* fy_out, T* fz_out) const {
    const int n1 = w.y.n, n2 = w.z.n, ey = w.y.e, ez = w.z.e;
    const int gx = w.x.o0, gy = w.y.o0, gz = w.z.o0;  // owned origin, global
    const int lx = gx - w.x.w0, ly = gy - w.y.w0, lz = gz - w.z.w0;  // ... in the window
    const int rx = w.x.o1 - gx, ry = w.y.o1 - gy, rz = w.z.o1 - gz;
    const int tx = w.x.o1 == w.x.n, ty = w.y.o1 == n1, tz = w.z.o1 == n2;
    copy_box<false>(c_out, n1, n2, gx, gy, gz, c, ey, ez, lx, ly, lz, rx, ry, rz);
    copy_box<false>(fx_out, n1, n2, gx, gy, gz, fx, ey, ez, lx, ly, lz, rx + tx, ry, rz);
    copy_box<false>(fy_out, n1 + 1, n2, gx, gy, gz, fy, ey + 1, ez, lx, ly, lz, rx, ry + ty, rz);
    copy_box<false>(fz_out, n1, n2 + 1, gx, gy, gz, fz, ey, ez + 1, lx, ly, lz, rx, ry, rz + tz);
  }
};

// Dynamic shared memory of one window set (four fields) for tile (bx, by, bz).
template <typename T>
inline size_t fields_bytes(int n0, int n1, int n2, int k, int bx, int by, int bz) {
  const size_t ex = min(bx + 2 * k, n0), ey = min(by + 2 * k, n1), ez = min(bz + 2 * k, n2);
  return (ex * ey * ez + (ex + 1) * ey * ez + ex * (ey + 1) * ez + ex * ey * (ez + 1)) * sizeof(T);
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
