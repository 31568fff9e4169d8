// Temporally blocked 3-D diffusion: k explicit steps per pass over device memory.
//
// Replaces the TPU Pallas kernel implicitglobalgrid_tpu/ops/pallas_stencil.py::
// fused_diffusion_steps (body `_build`, `step_into`).  One step is
//
//     T[i] += ((T[i+x] - 2T[i] + T[i-x])*cx + (T[i+y] - 2T[i] + T[i-y])*cy
//              + (T[i+z] - 2T[i] + T[i-z])*cz) * (1/Cp[i])
//
// on every cell but the array's outermost ring, which stays frozen (bit-exact).
// The arithmetic is written in exactly that order and the file is built with
// --fmad=false, so the result equals the plain PyTorch version
// (`fused_diffusion_steps_reference`) bit for bit.
//
// Bound: HBM bytes.  A launch must read T and Cp once and write T once
// (3 * n0*n1*n2 * sizeof(T)); the ~16 floating-point operations per cell and
// step are far below the card's rate for that traffic.  The design attacks the
// bound with overlapped (trapezoid) tiling: a block owns an output tile
// (bx, by, bz), loads the tile plus a k-deep halo of T and of 1/Cp into shared
// memory once, runs all k steps there (ping-pong between two buffers), and
// writes back only its owned tile.  Device-memory traffic per step therefore
// falls towards 3/k array passes; the price is the recomputed halo: each block
// re-loads and re-steps its neighbours' edge cells.
// The window is clipped to the array: a window edge that is an array face is
// the frozen ring, so cells next to it stay exact; a window edge inside the
// array goes stale one cell deeper per step, and the update region shrinks
// from those edges by one cell per step, so staleness never reaches an owned
// cell (owned cells sit >= k cells inside every interior window edge).
//
// Simple first: no TMA, no warp specialisation, no register queue along z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_diffusion_kernel(const T* __restrict__ tin, const T* __restrict__ cp,
                       T* __restrict__ tout, int n0, int n1, int n2, int k,
                       T cx, T cy, T cz, int bx, int by, int bz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // Owned output tile and its haloed window, both clipped to the array.
  const int ox0 = blockIdx.z * bx, oy0 = blockIdx.y * by, oz0 = blockIdx.x * bz;
  const int ox1 = min(ox0 + bx, n0), oy1 = min(oy0 + by, n1), oz1 = min(oz0 + bz, n2);
  const int wx0 = max(ox0 - k, 0), wy0 = max(oy0 - k, 0), wz0 = max(oz0 - k, 0);
  const int wx1 = min(ox1 + k, n0), wy1 = min(oy1 + k, n1), wz1 = min(oz1 + k, n2);
  const int ex = wx1 - wx0, ey = wy1 - wy0, ez = wz1 - wz0;
  const int sx = ey * ez;  // shared-memory strides of the window, z contiguous
  const int sy = ez;
  const int cells = ex * sx;
  T* a = smem;              // state after even steps
  T* b = smem + cells;      // state after odd steps
  T* minv = smem + 2 * cells;

  // Load T into both buffers (cells a step does not update must hold the same
  // value in both) and 1/Cp, so the k steps are divide-free.
  for (int x = 0; x < ex; ++x) {
    const int64_t gx = (int64_t)(wx0 + x) * n1;
    for (int p = threadIdx.x; p < sx; p += kThreads) {
      const int y = p / ez, z = p - y * ez;
      const int64_t g = (gx + wy0 + y) * n2 + wz0 + z;
      const int s = x * sx + p;
      const T v = tin[g];
      a[s] = v;
      b[s] = v;
      minv[s] = T(1) / cp[g];
    }
  }
  __syncthreads();

  // Window edges that are array faces: the cell there is the frozen ring.
  const bool fxl = wx0 == 0, fxh = wx1 == n0;
  const bool fyl = wy0 == 0, fyh = wy1 == n1;
  const bool fzl = wz0 == 0, fzh = wz1 == n2;
  for (int step = 1; step <= k; ++step) {
    const T* src = (step & 1) ? a : b;
    T* dst = (step & 1) ? b : a;
    // Update region: one cell inside a face edge, `step` cells inside an
    // interior edge (the valid region shrinks by one ring per step).
    const int x0 = fxl ? 1 : step, x1 = fxh ? ex - 1 : ex - step;
    const int y0 = fyl ? 1 : step, y1 = fyh ? ey - 1 : ey - step;
    const int z0 = fzl ? 1 : step, z1 = fzh ? ez - 1 : ez - step;
    const int ry = y1 - y0, rz = z1 - z0;
    if (ry > 0 && rz > 0) {
      for (int x = x0; x < x1; ++x) {
        for (int p = threadIdx.x; p < ry * rz; p += kThreads) {
          const int y = y0 + p / rz, z = z0 + p % rz;
          const int c = x * sx + y * sy + z;
          const T v = src[c];
          const T lap = (src[c + sx] - T(2) * v + src[c - sx]) * cx
                      + (src[c + sy] - T(2) * v + src[c - sy]) * cy
                      + (src[c + 1] - T(2) * v + src[c - 1]) * cz;
          dst[c] = v + lap * minv[c];
        }
      }
    }
    __syncthreads();
  }

  // Write back the owned tile (k is even: the final state is in `a`).
  const T* res = (k & 1) ? b : a;
  const int ry = oy1 - oy0, rz = oz1 - oz0;
  for (int x = ox0; x < ox1; ++x) {
    for (int p = threadIdx.x; p < ry * rz; p += kThreads) {
      const int y = oy0 + p / rz, z = oz0 + p % rz;
      tout[((int64_t)x * n1 + y) * n2 + z] =
          res[(x - wx0) * sx + (y - wy0) * sy + (z - wz0)];
    }
  }
}

template <typename T>
int launch(const void* tin, const void* cp, void* tout, int n0, int n1, int n2,
           int k, T cx, T cy, T cz, int bx, int by, int bz, void* stream) {
  const int wx = min(bx + 2 * k, n0), wy = min(by + 2 * k, n1), wz = min(bz + 2 * k, n2);
  const int smem = (int)(3ull * wx * wy * wz * sizeof(T));
  // Raise the kernel's dynamic shared-memory cap only when a launch needs
  // more than this device already allows (one cap per device and type).
  constexpr int kMaxDevices = 64;
  static int smem_cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > smem_cap[dev]) {
    err = cudaFuncSetAttribute(fused_diffusion_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_cap[dev] = smem;
  }
  const dim3 grid((n2 + bz - 1) / bz, (n1 + by - 1) / by, (n0 + bx - 1) / bx);
  fused_diffusion_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(tin), static_cast<const T*>(cp), static_cast<T*>(tout),
      n0, n1, n2, k, cx, cy, cz, bx, by, bz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).
int igg_fused_diffusion_f32(const void* tin, const void* cp, void* tout, int n0,
                            int n1, int n2, int k, float cx, float cy, float cz,
                            int bx, int by, int bz, void* stream) {
  return launch<float>(tin, cp, tout, n0, n1, n2, k, cx, cy, cz, bx, by, bz, stream);
}

int igg_fused_diffusion_f64(const void* tin, const void* cp, void* tout, int n0,
                            int n1, int n2, int k, double cx, double cy, double cz,
                            int bx, int by, int bz, void* stream) {
  return launch<double>(tin, cp, tout, n0, n1, n2, k, cx, cy, cz, bx, by, bz, stream);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
