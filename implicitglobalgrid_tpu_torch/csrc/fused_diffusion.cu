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
// step are far below the card's rate for that traffic.
//
// Geometry (staggered.cuh's Axis and Window): a block owns a (by, bz) tile of
// y and z and marches along x (all of it, or a segment of bx planes where the
// wrapper cuts x to fill the card); its window is the tile plus k cells a
// side, clipped to the array.  A subset launch (the ring or mid pass of the
// pipelined group schedule) runs the blocks of some (x segment, y tile)
// pairs only; each still steps its whole window and stores what it owns.  A window edge that is an array face is the
// frozen ring, so cells next to it stay exact; an interior window edge goes
// stale one cell deeper per step.  Level s therefore updates Axis::side_lo(s)
// .. side_hi(s) along each axis (one cell inside a face edge, s cells inside
// an interior edge), and the owned tile, k cells inside every interior edge,
// is exact after level k.
//
// Schedule.  Iteration t loads x plane t + kAhead (cp.async, T and Cp, into
// rings of kRing planes) and steps level s at plane t - s, s = 1..k: each
// level runs one plane behind the level before it.  Level s at plane p needs
// T^{s-1} at p-1, p and p+1.  One evolving field leaves no in-place trick: by
// then level s has overwritten p-1 (in the iteration before), so every level
// keeps its own output.  Each thread keeps fixed (y, z) positions of the plane
// (its slots: one or two z-adjacent positions each) and, per position and
// level, the values of the last two planes in registers (a register queue
// along x): T^{s-1}(p+1) is what level s-1 computed a moment ago in this
// iteration, T^{s-1}(p) and T^{s-1}(p-1) what it computed in the two before.
// Only the y neighbours and the z neighbours outside the slot come from
// shared memory: level s-1 writes each plane it steps into a plane of its
// own, double-buffered by plane parity (level 0: the T ring), and level s
// reads it one iteration later.  Level s reads the buffer of parity p and
// level s-1 writes parity p+1 in the same iteration, so one barrier per
// iteration, at its top, orders everything.  1/Cp is computed once per
// loaded plane and position and kept in a register queue k planes deep.  A
// level's cap per position (Axis::side_levels of y and z) is one compare per
// point; neighbour reads are unconditional (guard rows keep them inside the
// buffers); a warp whose slots have nothing to update at a level skips its
// arithmetic and only passes its values on; level k's values at owned
// positions go straight to device memory (the store needs no barrier).
//
// A batch of nb blocks (an ensemble's members, back to back in T, Cp and
// the output) runs in one launch: the members extend the launch grid, and
// member m's x plane p is plane m * n0 + p of the arrays (staggered.cuh).
//
// Simple first: no TMA (the envelope admits every n2 >= 3, so 16-byte row
// strides are not guaranteed), no warp specialisation.

#include "staggered.cuh"

namespace {

using igg::in;
using igg::kThreads;
using igg::Window;

// Planes of T and Cp loaded ahead of the one level 1 reads first, and the
// rings they land in (the planes t-1 .. t+kAhead are live in iteration t).
constexpr int kAhead = 2;
constexpr int kRing = kAhead + 2;
static_assert((kRing & (kRing - 1)) == 0, "the ring index is a mask");

// A slot is E z-adjacent positions of one row (read and written as one
// float2/double2 where E = 2: its z neighbours inside the slot come from
// registers), and a thread has S slots; ceil(ez / E) * ey <= S * kThreads
// (checked by the wrapper's tile ladder).  Each position holds 3k + 2 values
// in registers, and a 512-thread block allows 128 a thread: float64 k >= 6
// takes single positions, and only float32 k = 6 two slots (float32 k = 8
// and float64 k = 6 spilled with two).
template <typename T, int K>
constexpr int kElems = sizeof(T) == 8 && K >= 6 ? 1 : 2;
template <typename T, int K>
constexpr int kSlots = sizeof(T) == 4 && K == 6 ? 2 : 1;

// A plane's row stride: the window's z extent rounded up to whole slots.
__host__ __device__ inline int row_stride(int ez, int e) { return (ez + e - 1) / e * e; }

template <typename T, int E> struct Vec { using type = T; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<double, 2> { using type = double2; };

// E consecutive values at p (aligned to E values), in and out of registers.
template <typename T, int E>
__device__ __forceinline__ void get(const T* p, T (&v)[E]) {
  if constexpr (E == 1) {
    v[0] = p[0];
  } else {
    const auto a = *reinterpret_cast<const typename Vec<T, E>::type*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
}
template <typename T, int E>
__device__ __forceinline__ void put(T* p, const T (&v)[E]) {
  if constexpr (E == 1) {
    p[0] = v[0];
  } else {
    typename Vec<T, E>::type a;
    a.x = v[0];
    a.y = v[1];
    *reinterpret_cast<typename Vec<T, E>::type*>(p) = a;
  }
}

// A slot's flags: position e's level cap (bits 4e..4e+3), the warp's
// largest cap (bits 8-11), whether position e is in the window plane (bit
// 12+e) and whether it is owned (bit 14+e).
enum : int { kCap = igg::kAll, kWarp = 8, kValid = 1 << 12, kOwned = 1 << 14 };

// kSubset: a subset launch (the tiles of selector sel, igg::TileSel).
template <typename T, int K, bool kSubset>
__global__ void __launch_bounds__(kThreads)
fused_diffusion_kernel(const T* __restrict__ tin, const T* __restrict__ cp,
                       T* __restrict__ tout, int n0, int n1, int n2, T cx, T cy, T cz,
                       int bx, int by, int bz, int sel) {
  constexpr int E = kElems<T, K>, S = kSlots<T, K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Window w = Window::make<kSubset>(n0, n1, n2, K, bx, by, bz, sel);
  const int ex = w.x.e, ez = w.z.e, rz = row_stride(ez, E), ps = w.y.e * rz;
  const int64_t plane = (int64_t)n1 * n2;
  // The window's first x plane in the member's arrays.
  const int x0 = w.x.w0 + w.member * n0;
  // A guard of rz + E values before the first plane and after the last keeps
  // every neighbour read in the buffer: reads are unconditional, and off the
  // update range their values are not used.
  T* ring_t = reinterpret_cast<T*>(smem_raw) + rz + E;
  T* ring_c = ring_t + kRing * ps;
  T* levels = ring_c + kRing * ps;
  // Level s's (1 <= s < K) plane buffer for x plane p.
  auto level_plane = [&](int s, int p) { return levels + (2 * (s - 1) + (p & 1)) * ps; };

  // Per slot: the plane index of its first position, its flags and that
  // position's global in-plane offset.
  int sc[S], sf[S];
  int64_t so[S];
  {
    const int ly = w.y.o0 - w.y.w0, hy = w.y.o1 - w.y.w0;
    const int lz = w.z.o0 - w.z.w0, hz = w.z.o1 - w.z.w0, rg = rz / E;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int g = threadIdx.x + j * kThreads, y = g / rg, z = E * (g - y * rg);
      int f = 0, top = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (y >= w.y.e || z + e >= ez) continue;
        const int cap = min(w.y.side_levels(y), w.z.side_levels(z + e));
        top = max(top, cap);
        f |= cap << (4 * e) | kValid << e
           | (in(y, ly, hy) && in(z + e, lz, hz) ? kOwned << e : 0);
      }
      // A slot past the plane gets index 0 and no flags: it writes nothing.
      sc[j] = f ? y * rz + z : 0;
      sf[j] = f | __reduce_max_sync(0xffffffffu, top) << kWarp;
      so[j] = f ? (int64_t)(w.y.w0 + y) * n2 + w.z.w0 + z : 0;
    }
  }

  // Window plane p of T and Cp into their rings (nothing past the window).
  auto load = [&](int p) {
    if (p >= ex) return;
    const int64_t g = (int64_t)(x0 + p) * plane;
    T* dt = ring_t + (p & (kRing - 1)) * ps;
    T* dc = ring_c + (p & (kRing - 1)) * ps;
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!(sf[j] & kValid << e)) continue;
        __pipeline_memcpy_async(dt + sc[j] + e, tin + g + so[j] + e, sizeof(T));
        __pipeline_memcpy_async(dc + sc[j] + e, cp + g + so[j] + e, sizeof(T));
      }
    }
  };

  // Register queues, per level j = s-1 (0 <= j < K), slot and position: T^j
  // at the plane level j stepped in the last iteration (q1) and in the one
  // before (q2); and 1/Cp at planes t-1 .. t-K (minv[s-1] = 1/Cp at t-s).
  T q1[K][S][E], q2[K][S][E], minv[K][S][E];
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) q1[s][j][e] = q2[s][j][e] = minv[s][j][e] = T(0);
    }
  }

  const int lx = w.x.o0 - w.x.w0, hx = w.x.o1 - w.x.w0;
  for (int a = 0; a < kAhead; ++a) {
    load(a);
    __pipeline_commit();
  }
  for (int t = 0; t < ex + K; ++t) {
    __pipeline_wait_prior(kAhead - 1);
    __syncthreads();  // plane t is in; every thread is past the last iteration
    load(t + kAhead);
    __pipeline_commit();
    const T* pt = ring_t + (t & (kRing - 1)) * ps;
    const T* pc = ring_c + (t & (kRing - 1)) * ps;
    // cur: T^{s-1} at plane t-s+1, the x+1 neighbour of level s
    T cur[S][E], rcp[S][E];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      T c[E];
      get(pt + sc[j], cur[j]);
      get(pc + sc[j], c);
#pragma unroll
      for (int e = 0; e < E; ++e) rcp[j][e] = T(1) / c[e];
    }
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int p = t - s;
      const bool x_on = in(p, w.x.side_lo(s), w.x.side_hi(s));
      const T* src = s == 1 ? ring_t + ((t - 1) & (kRing - 1)) * ps : level_plane(s - 1, p);
      T nxt[S][E];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int f = sf[j];
        const T(&v)[E] = q1[s - 1][j];
#pragma unroll
        for (int e = 0; e < E; ++e) nxt[j][e] = v[e];
        if (s > ((f >> kWarp) & kCap)) continue;  // the whole warp passes v on
        const T* a = src + sc[j];
        T up[E], dn[E];
        get(a + rz, up);
        get(a - rz, dn);
        const T zl = a[-1], zr = a[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T v2 = T(2) * v[e];
          const T zp = e + 1 < E ? v[e + 1 < E ? e + 1 : e] : zr;
          const T zm = e > 0 ? v[e > 0 ? e - 1 : e] : zl;
          const T lap = ((cur[j][e] - v2) + q2[s - 1][j][e]) * cx + ((up[e] - v2) + dn[e]) * cy
                      + ((zp - v2) + zm) * cz;
          const T u = v[e] + lap * minv[s - 1][j][e];
          if (x_on && s <= ((f >> (4 * e)) & kCap)) nxt[j][e] = u;
        }
      }
      if (s < K) {
        T* dst = level_plane(s, p);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (sf[j] & kValid) put(dst + sc[j], nxt[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          q2[s - 1][j][e] = q1[s - 1][j][e];
          q1[s - 1][j][e] = cur[j][e];
          cur[j][e] = nxt[j][e];
        }
      }
    }
    // cur is T^K at plane t-K: store the owned positions.
    const int b = t - K;
    if (in(b, lx, hx)) {
      const int64_t g = (int64_t)(x0 + b) * plane;
#pragma unroll
      for (int j = 0; j < S; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (sf[j] & kOwned << e) tout[g + so[j] + e] = cur[j][e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int s = K - 1; s > 0; --s) minv[s][j][e] = minv[s - 1][j][e];
        minv[0][j][e] = rcp[j][e];
      }
    }
  }
}

// Dynamic shared memory for a (by, bz) tile: the T and Cp rings, two planes
// for each of the levels 1 .. k-1, and the two guards.
template <typename T, int K>
size_t smem_bytes(int n1, int n2, int by, int bz) {
  constexpr int E = kElems<T, K>;
  const size_t ey = min(by + 2 * K, n1), rz = row_stride(min(bz + 2 * K, n2), E);
  return ((2 * kRing + 2 * (K - 1)) * ey * rz + 2 * (rz + E)) * sizeof(T);
}

template <typename T, int K, bool kSubset>
cudaError_t prepare(int n1, int n2, int by, int bz, int* smem) {
  *smem = (int)smem_bytes<T, K>(n1, n2, by, bz);
  constexpr int kMaxDevices = 64;
  static int smem_cap[kMaxDevices] = {};
  return igg::ensure_smem(fused_diffusion_kernel<T, K, kSubset>, smem_cap, kMaxDevices, *smem);
}

template <typename T, int K, bool kSubset>
int launch_k(const void* tin, const void* cp, void* tout, int nb, int n0, int n1, int n2, T cx,
             T cy, T cz, int bx, int by, int bz, int sel, void* stream) {
  int smem = 0;
  cudaError_t err = prepare<T, K, kSubset>(n1, n2, by, bz, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = igg::launch_grid(nb, n0, n1, n2, bx, by, bz, sel);
  fused_diffusion_kernel<T, K, kSubset><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(tin), static_cast<const T*>(cp), static_cast<T*>(tout), n0, n1, n2,
      cx, cy, cz, bx, by, bz, sel);
  return (int)cudaGetLastError();
}

// sel: the tile subset (igg::TileSel; kSubset iff it is not kAllTiles).
template <typename T, bool kSubset>
int launch(const void* tin, const void* cp, void* tout, int nb, int n0, int n1, int n2, int k,
           T cx, T cy, T cz, int bx, int by, int bz, int sel, void* stream) {
  switch (k) {
    case 2:
      return launch_k<T, 2, kSubset>(tin, cp, tout, nb, n0, n1, n2, cx, cy, cz, bx, by, bz, sel,
                                     stream);
    case 4:
      return launch_k<T, 4, kSubset>(tin, cp, tout, nb, n0, n1, n2, cx, cy, cz, bx, by, bz, sel,
                                     stream);
    case 6:
      return launch_k<T, 6, kSubset>(tin, cp, tout, nb, n0, n1, n2, cx, cy, cz, bx, by, bz, sel,
                                     stream);
    case 8:
      return launch_k<T, 8, kSubset>(tin, cp, tout, nb, n0, n1, n2, cx, cy, cz, bx, by, bz, sel,
                                     stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// sel: every tile (igg::kAllTiles) or a ring or mid subset (igg::TileSel).
template <typename T>
int dispatch(const void* tin, const void* cp, void* tout, int nb, int n0, int n1, int n2, int k,
             T cx, T cy, T cz, int bx, int by, int bz, int sel, void* stream) {
  if (sel < igg::kAllTiles || sel >= igg::kNumSels) return (int)cudaErrorInvalidValue;
  auto run = sel == igg::kAllTiles ? launch<T, false> : launch<T, true>;
  return run(tin, cp, tout, nb, n0, n1, n2, k, cx, cy, cz, bx, by, bz, sel, stream);
}

template <typename T, int K>
int occupancy_k(int n1, int n2, int by, int bz, int* blocks) {
  int smem = 0;
  cudaError_t err = prepare<T, K, false>(n1, n2, by, bz, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_diffusion_kernel<T, K, false>, kThreads, smem);
}

template <typename T>
int occupancy(int n1, int n2, int k, int by, int bz, int* blocks) {
  switch (k) {
    case 2: return occupancy_k<T, 2>(n1, n2, by, bz, blocks);
    case 4: return occupancy_k<T, 4>(n1, n2, by, bz, blocks);
    case 6: return occupancy_k<T, 6>(n1, n2, by, bz, blocks);
    case 8: return occupancy_k<T, 8>(n1, n2, by, bz, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).  nb: the
// members (blocks of (n0, n1, n2), back to back in every array).
int igg_fused_diffusion_f32(const void* tin, const void* cp, void* tout, int nb, int n0,
                            int n1, int n2, int k, float cx, float cy, float cz,
                            int bx, int by, int bz, int sel, void* stream) {
  return dispatch<float>(tin, cp, tout, nb, n0, n1, n2, k, cx, cy, cz, bx, by, bz, sel, stream);
}

int igg_fused_diffusion_f64(const void* tin, const void* cp, void* tout, int nb, int n0,
                            int n1, int n2, int k, double cx, double cy, double cz,
                            int bx, int by, int bz, int sel, void* stream) {
  return dispatch<double>(tin, cp, tout, nb, n0, n1, n2, k, cx, cy, cz, bx, by, bz, sel, stream);
}

// Resident blocks per SM of the kernel for this item size, k and tile, into
// *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int igg_fused_diffusion_occupancy(int itemsize, int n1, int n2, int k, int by, int bz,
                                  int* blocks) {
  return itemsize == 8 ? occupancy<double>(n1, n2, k, by, bz, blocks)
                       : occupancy<float>(n1, n2, k, by, bz, blocks);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
