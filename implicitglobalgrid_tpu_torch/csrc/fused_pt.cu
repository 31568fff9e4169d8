// Temporally blocked pseudo-transient (PT) iterations of the porous-convection
// pressure solve: k iterations per pass over device memory.
//
// Replaces the TPU Pallas kernel implicitglobalgrid_tpu/ops/pallas_pt.py::
// fused_pt_iterations (body `_build`, `step_into`).  One iteration is
//
//     f  = -idx*(Pf[f] - Pf[f-1])                   (x faces; likewise y)
//     fz = -idz*(Pf[f] - Pf[f-1]) + ralam*(0.5*(T[f] + T[f-1]))   (z faces)
//     q[f]  = q[f] + th*(f - q[f])                  at the interior faces of
//                                                   fused_leapfrog.cu (all
//                                                   else frozen);
//     Pf[c] = Pf[c] - bp*(((qx[c+x]-qx[c])*idx + (qy[c+y]-qy[c])*idy)
//                         + (qz[c+z]-qz[c])*idz)     at every cell, new q,
//
// with T read-only.  Written in that order and built with --fmad=false, it
// equals the plain PyTorch version (`fused_pt_iterations_reference`) bit for
// bit.
//
// Bound: HBM bytes.  A launch must read T, Pf and the three fluxes once and
// write Pf and the fluxes once (9 * n0*n1*n2 * sizeof(T), the face planes
// aside).  Design: the leapfrog kernel's x-marching wavefront (staggered.cuh)
// with the flux formula.  T is not staged in the shared-memory ring (a fifth
// ring does not fit beside the four at the (16, 32) tile): each level reads
// T with __ldg for the z-face buoyancy, coalesced z rows of a plane that the
// levels before it read one iteration earlier, each level's reads issued
// while the level before it steps its cells, so that their latency (mostly
// L2: the L1 left beside the ring cannot hold k planes of T) overlaps.
//
// A batch of nb blocks (an ensemble's members, back to back in each array,
// T included) runs in one launch: the members extend the grid
// (staggered.cuh).
//
// Simple first: no TMA, no warp specialisation, no register queues.

#include "staggered.cuh"

namespace {

template <typename Real>
struct Pt {
  const Real* __restrict__ t;
  Real th, idx, idy, idz, ralam, bp;

  // T at the z faces' two cells, read a half step ahead.
  __device__ Real ld(int64_t g) const { return __ldg(t + g); }
  __device__ Real vx(Real q, Real p, Real pm) const {
    const Real f = -idx * (p - pm);
    return q + th * (f - q);
  }
  __device__ Real vy(Real q, Real p, Real pm) const {
    const Real f = -idy * (p - pm);
    return q + th * (f - q);
  }
  __device__ Real vz(Real q, Real p, Real pm, Real tp, Real tm) const {
    const Real f = -idz * (p - pm) + ralam * (Real(0.5) * (tp + tm));
    return q + th * (f - q);
  }
  __device__ Real p(Real P, Real qx, Real qx1, Real qy, Real qy1, Real qz, Real qz1) const {
    const Real div = ((qx1 - qx) * idx + (qy1 - qy) * idy) + (qz1 - qz) * idz;
    return P - bp * div;
  }
};

template <typename Real, bool kSubset>
__global__ void __launch_bounds__(igg::kThreads)
fused_pt_kernel(const Real* __restrict__ p_in, const Real* __restrict__ qx_in,
                const Real* __restrict__ qy_in, const Real* __restrict__ qz_in,
                Real* __restrict__ p_out, Real* __restrict__ qx_out, Real* __restrict__ qy_out,
                Real* __restrict__ qz_out, int n0, int n1, int n2, int k, Pt<Real> ops, int bx,
                int by, int bz, int sel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const igg::Window w = igg::Window::make<kSubset>(n0, n1, n2, k, bx, by, bz, sel);
  igg::march(w, k, reinterpret_cast<Real*>(smem_raw), p_in, qx_in, qy_in, qz_in, p_out, qx_out,
             qy_out, qz_out, ops);
}

template <typename Real, bool kSubset>
cudaError_t prepare(int n1, int n2, int k, int by, int bz, int* smem) {
  *smem = (int)igg::ring_bytes<Real>(n1, n2, k, by, bz);
  constexpr int kMaxDevices = 64;
  static int smem_cap[kMaxDevices] = {};
  return igg::ensure_smem(fused_pt_kernel<Real, kSubset>, smem_cap, kMaxDevices, *smem);
}

// sel: the tile subset (igg::TileSel; kSubset iff it is not kAllTiles).
template <typename Real, bool kSubset>
int launch(const void* t, const void* p, const void* qx, const void* qy, const void* qz,
           void* p_out, void* qx_out, void* qy_out, void* qz_out, int nb, int n0, int n1, int n2,
           int k, Real th, Real idx, Real idy, Real idz, Real ralam, Real bp, int bx, int by,
           int bz, int sel, void* stream) {
  int smem = 0;
  cudaError_t err = prepare<Real, kSubset>(n1, n2, k, by, bz, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = igg::launch_grid(nb, n0, n1, n2, bx, by, bz, sel);
  fused_pt_kernel<Real, kSubset><<<grid, igg::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const Real*>(p), static_cast<const Real*>(qx), static_cast<const Real*>(qy),
      static_cast<const Real*>(qz), static_cast<Real*>(p_out), static_cast<Real*>(qx_out),
      static_cast<Real*>(qy_out), static_cast<Real*>(qz_out), n0, n1, n2, k,
      Pt<Real>{static_cast<const Real*>(t), th, idx, idy, idz, ralam, bp}, bx, by, bz, sel);
  return (int)cudaGetLastError();
}

template <typename Real>
int occupancy(int n1, int n2, int k, int by, int bz, int* blocks) {
  int smem = 0;
  cudaError_t err = prepare<Real, false>(n1, n2, k, by, bz, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_pt_kernel<Real, false>,
                                                            igg::kThreads, smem);
}

// sel: every tile (igg::kAllTiles) or a ring or mid subset (igg::TileSel).
template <typename Real>
int dispatch(const void* t, const void* p, const void* qx, const void* qy, const void* qz,
             void* p_out, void* qx_out, void* qy_out, void* qz_out, int nb, int n0, int n1,
             int n2, int k, Real th, Real idx, Real idy, Real idz, Real ralam, Real bp, int bx,
             int by, int bz, int sel, void* stream) {
  if (sel < igg::kAllTiles || sel >= igg::kNumSels) return (int)cudaErrorInvalidValue;
  auto run = sel == igg::kAllTiles ? launch<Real, false> : launch<Real, true>;
  return run(t, p, qx, qy, qz, p_out, qx_out, qy_out, qz_out, nb, n0, n1, n2, k, th, idx, idy,
             idz, ralam, bp, bx, by, bz, sel, stream);
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).  nb: the
// members (blocks of (n0, n1, n2), back to back in every array).
int igg_fused_pt_f32(const void* t, const void* p, const void* qx, const void* qy,
                     const void* qz, void* p_out, void* qx_out, void* qy_out, void* qz_out,
                     int nb, int n0, int n1, int n2, int k, float th, float idx, float idy,
                     float idz, float ralam, float bp, int bx, int by, int bz, int sel,
                     void* stream) {
  return dispatch<float>(t, p, qx, qy, qz, p_out, qx_out, qy_out, qz_out, nb, n0, n1, n2, k, th,
                         idx, idy, idz, ralam, bp, bx, by, bz, sel, stream);
}

int igg_fused_pt_f64(const void* t, const void* p, const void* qx, const void* qy,
                     const void* qz, void* p_out, void* qx_out, void* qy_out, void* qz_out,
                     int nb, int n0, int n1, int n2, int k, double th, double idx, double idy,
                     double idz, double ralam, double bp, int bx, int by, int bz, int sel,
                     void* stream) {
  return dispatch<double>(t, p, qx, qy, qz, p_out, qx_out, qy_out, qz_out, nb, n0, n1, n2, k,
                          th, idx, idy, idz, ralam, bp, bx, by, bz, sel, stream);
}

// Resident blocks per SM of the kernel for this item size and tile, into
// *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int igg_fused_pt_occupancy(int itemsize, int n1, int n2, int k, int by, int bz, int* blocks) {
  return itemsize == 8 ? occupancy<double>(n1, n2, k, by, bz, blocks)
                       : occupancy<float>(n1, n2, k, by, bz, blocks);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
