// Temporally blocked staggered acoustic leapfrog: k steps per pass over device memory.
//
// Replaces the TPU Pallas kernel implicitglobalgrid_tpu/ops/pallas_leapfrog.py::
// fused_leapfrog_steps (body `_build`, `step_into`).  One step is
//
//     V[f] = V[f] - ca*(P[f] - P[f-1])         at faces f with 1 <= f <= n-1 along
//                                               V's own axis and 1 <= i <= n-2 along
//                                               the two others (all else frozen);
//     P[c] = P[c] - b*(((Vx[c+x]-Vx[c])*idx + (Vy[c+y]-Vy[c])*idy)
//                      + (Vz[c+z]-Vz[c])*idz)  at every cell, from the new V,
//
// with P (n0,n1,n2), Vx (n0+1,n1,n2), Vy (n0,n1+1,n2), Vz (n0,n1,n2+1).  The
// arithmetic is written in exactly that order and the file is built with
// --fmad=false, so the result equals the plain PyTorch version
// (`fused_leapfrog_steps_reference`) bit for bit.
//
// Bound: HBM bytes.  A launch must read the four fields once and write them
// once (8 * n0*n1*n2 * sizeof(T), the face planes aside); the ~20
// floating-point operations per cell and step are far below the card's rate
// for that traffic.  Design (staggered.cuh): a block owns a (y, z) tile and
// marches along x with a ring of x planes of the four fields in shared
// memory, level s one plane behind level s-1, every level in place, the next
// planes' cp.async loads in flight while it steps.  The window is widened by
// k only in y and z (2.4x the owned loads at the (16, 32) tile and k=6, and
// ~1.5x the owned point updates); the real n+1 face arrays are used as they
// are (the TPU kernel's padded face layout exists only for Mosaic's DMA
// alignment).
//
// A batch of nb blocks (an ensemble's members, back to back in each array)
// runs in one launch: the members extend the grid (staggered.cuh).
//
// Simple first: no TMA (the n+1 face arrays' row strides are not multiples
// of 16 bytes in general), no warp specialisation, no register queues.

#include "staggered.cuh"

namespace {

template <typename Real>
struct Leapfrog {
  Real cax, cay, caz, b, idx, idy, idz;

  __device__ Real ld(int64_t) const { return Real(0); }
  __device__ Real vx(Real v, Real p, Real q) const { return v - cax * (p - q); }
  __device__ Real vy(Real v, Real p, Real q) const { return v - cay * (p - q); }
  __device__ Real vz(Real v, Real p, Real q, Real, Real) const { return v - caz * (p - q); }
  __device__ Real p(Real P, Real vx, Real vx1, Real vy, Real vy1, Real vz, Real vz1) const {
    const Real div = ((vx1 - vx) * idx + (vy1 - vy) * idy) + (vz1 - vz) * idz;
    return P - b * div;
  }
};

template <typename Real, bool kSubset>
__global__ void __launch_bounds__(igg::kThreads)
fused_leapfrog_kernel(const Real* __restrict__ p_in, const Real* __restrict__ vx_in,
                      const Real* __restrict__ vy_in, const Real* __restrict__ vz_in,
                      Real* __restrict__ p_out, Real* __restrict__ vx_out,
                      Real* __restrict__ vy_out, Real* __restrict__ vz_out, int n0, int n1,
                      int n2, int k, Leapfrog<Real> ops, int bx, int by, int bz, int sel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const igg::Window w = igg::Window::make<kSubset>(n0, n1, n2, k, bx, by, bz, sel);
  igg::march(w, k, reinterpret_cast<Real*>(smem_raw), p_in, vx_in, vy_in, vz_in, p_out, vx_out,
             vy_out, vz_out, ops);
}

template <typename Real, bool kSubset>
cudaError_t prepare(int n1, int n2, int k, int by, int bz, int* smem) {
  *smem = (int)igg::ring_bytes<Real>(n1, n2, k, by, bz);
  constexpr int kMaxDevices = 64;
  static int smem_cap[kMaxDevices] = {};
  return igg::ensure_smem(fused_leapfrog_kernel<Real, kSubset>, smem_cap, kMaxDevices, *smem);
}

// sel: the tile subset (igg::TileSel; kSubset iff it is not kAllTiles).
template <typename Real, bool kSubset>
int launch(const void* p, const void* vx, const void* vy, const void* vz, void* p_out,
           void* vx_out, void* vy_out, void* vz_out, int nb, int n0, int n1, int n2, int k,
           Real cax, Real cay, Real caz, Real b, Real idx, Real idy, Real idz, int bx, int by,
           int bz, int sel, void* stream) {
  int smem = 0;
  cudaError_t err = prepare<Real, kSubset>(n1, n2, k, by, bz, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = igg::launch_grid(nb, n0, n1, n2, bx, by, bz, sel);
  fused_leapfrog_kernel<Real, kSubset><<<grid, igg::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const Real*>(p), static_cast<const Real*>(vx), static_cast<const Real*>(vy),
      static_cast<const Real*>(vz), static_cast<Real*>(p_out), static_cast<Real*>(vx_out),
      static_cast<Real*>(vy_out), static_cast<Real*>(vz_out), n0, n1, n2, k,
      Leapfrog<Real>{cax, cay, caz, b, idx, idy, idz}, bx, by, bz, sel);
  return (int)cudaGetLastError();
}

template <typename Real>
int occupancy(int n1, int n2, int k, int by, int bz, int* blocks) {
  int smem = 0;
  cudaError_t err = prepare<Real, false>(n1, n2, k, by, bz, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_leapfrog_kernel<Real, false>, igg::kThreads, smem);
}

// sel: every tile (igg::kAllTiles) or a ring or mid subset (igg::TileSel).
template <typename Real>
int dispatch(const void* p, const void* vx, const void* vy, const void* vz, void* p_out,
             void* vx_out, void* vy_out, void* vz_out, int nb, int n0, int n1, int n2, int k,
             Real cax, Real cay, Real caz, Real b, Real idx, Real idy, Real idz, int bx, int by,
             int bz, int sel, void* stream) {
  if (sel < igg::kAllTiles || sel >= igg::kNumSels) return (int)cudaErrorInvalidValue;
  auto run = sel == igg::kAllTiles ? launch<Real, false> : launch<Real, true>;
  return run(p, vx, vy, vz, p_out, vx_out, vy_out, vz_out, nb, n0, n1, n2, k, cax, cay, caz, b,
             idx, idy, idz, bx, by, bz, sel, stream);
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).  nb: the
// members (blocks of (n0, n1, n2), back to back in every array).
int igg_fused_leapfrog_f32(const void* p, const void* vx, const void* vy, const void* vz,
                           void* p_out, void* vx_out, void* vy_out, void* vz_out, int nb, int n0,
                           int n1, int n2, int k, float cax, float cay, float caz, float b,
                           float idx, float idy, float idz, int bx, int by, int bz, int sel,
                           void* stream) {
  return dispatch<float>(p, vx, vy, vz, p_out, vx_out, vy_out, vz_out, nb, n0, n1, n2, k, cax,
                         cay, caz, b, idx, idy, idz, bx, by, bz, sel, stream);
}

int igg_fused_leapfrog_f64(const void* p, const void* vx, const void* vy, const void* vz,
                           void* p_out, void* vx_out, void* vy_out, void* vz_out, int nb, int n0,
                           int n1, int n2, int k, double cax, double cay, double caz, double b,
                           double idx, double idy, double idz, int bx, int by, int bz, int sel,
                           void* stream) {
  return dispatch<double>(p, vx, vy, vz, p_out, vx_out, vy_out, vz_out, nb, n0, n1, n2, k, cax,
                          cay, caz, b, idx, idy, idz, bx, by, bz, sel, stream);
}

// Resident blocks per SM of the kernel for this item size and tile, into
// *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int igg_fused_leapfrog_occupancy(int itemsize, int n1, int n2, int k, int by, int bz,
                                 int* blocks) {
  return itemsize == 8 ? occupancy<double>(n1, n2, k, by, bz, blocks)
                       : occupancy<float>(n1, n2, k, by, bz, blocks);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
