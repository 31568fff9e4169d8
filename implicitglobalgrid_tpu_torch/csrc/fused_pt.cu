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
// aside).  Design: the leapfrog kernel's (same staggered window, frozen
// faces, trapezoid argument and in-place half steps, staggered.cuh); T is not
// staged in shared memory but read where the buoyancy needs it, so the four
// windows keep the leapfrog kernel's tiles.
//
// Simple first: no TMA, no warp specialisation, no register queue along z.

#include "staggered.cuh"

namespace {

template <typename Real>
__global__ void __launch_bounds__(igg::kThreads)
fused_pt_kernel(const Real* __restrict__ t, const Real* __restrict__ p_in,
                const Real* __restrict__ qx_in, const Real* __restrict__ qy_in,
                const Real* __restrict__ qz_in, Real* __restrict__ p_out,
                Real* __restrict__ qx_out, Real* __restrict__ qy_out, Real* __restrict__ qz_out,
                int n0, int n1, int n2, int k, Real th, Real idx, Real idy, Real idz, Real ralam,
                Real bp, int bx, int by, int bz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const igg::Window w = igg::Window::make(n0, n1, n2, k, bx, by, bz);
  igg::Fields<Real> f = igg::Fields<Real>::carve(reinterpret_cast<Real*>(smem_raw), w);
  f.load(w, p_in, qx_in, qy_in, qz_in);
  __syncthreads();

  Real *P = f.c, *Qx = f.fx, *Qy = f.fy, *Qz = f.fz;
  const int ey = w.y.e, ez = w.z.e;
  const int sx = ey * ez;             // x stride of Pf and qx (y stride: ez)
  const int syx = (ey + 1) * ez;      // x stride of qy (y stride: ez)
  const int szx = ey * (ez + 1), szy = ez + 1;  // strides of qz
  const int x0 = w.x.w0, y0 = w.y.w0, z0 = w.z.w0;
  for (int s = 1; s <= k; ++s) {
    igg::for_box(w.x.face_lo(s), w.x.face_hi(s), w.y.side_lo(s), w.y.side_hi(s),
                 w.z.side_lo(s), w.z.side_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z;
                   const Real q = Qx[c], fx = -idx * (P[c] - P[c - sx]);
                   Qx[c] = q + th * (fx - q);
                 });
    igg::for_box(w.x.side_lo(s), w.x.side_hi(s), w.y.face_lo(s), w.y.face_hi(s),
                 w.z.side_lo(s), w.z.side_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z, v = x * syx + y * ez + z;
                   const Real q = Qy[v], fy = -idy * (P[c] - P[c - ez]);
                   Qy[v] = q + th * (fy - q);
                 });
    igg::for_box(w.x.side_lo(s), w.x.side_hi(s), w.y.side_lo(s), w.y.side_hi(s),
                 w.z.face_lo(s), w.z.face_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z, v = x * szx + y * szy + z;
                   const int64_t g = ((int64_t)(x0 + x) * n1 + y0 + y) * n2 + z0 + z;
                   const Real tz = Real(0.5) * (__ldg(t + g) + __ldg(t + g - 1));
                   const Real q = Qz[v], fz = -idz * (P[c] - P[c - 1]) + ralam * tz;
                   Qz[v] = q + th * (fz - q);
                 });
    __syncthreads();
    igg::for_box(w.x.cell_lo(s), w.x.cell_hi(s), w.y.cell_lo(s), w.y.cell_hi(s),
                 w.z.cell_lo(s), w.z.cell_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z;
                   const int vy = x * syx + y * ez + z, vz = x * szx + y * szy + z;
                   const Real div = ((Qx[c + sx] - Qx[c]) * idx + (Qy[vy + ez] - Qy[vy]) * idy)
                                  + (Qz[vz + 1] - Qz[vz]) * idz;
                   P[c] = P[c] - bp * div;
                 });
    __syncthreads();
  }
  f.store(w, p_out, qx_out, qy_out, qz_out);
}

template <typename Real>
int launch(const void* t, const void* p, const void* qx, const void* qy, const void* qz,
           void* p_out, void* qx_out, void* qy_out, void* qz_out, int n0, int n1, int n2, int k,
           Real th, Real idx, Real idy, Real idz, Real ralam, Real bp, int bx, int by, int bz,
           void* stream) {
  const int smem = (int)igg::fields_bytes<Real>(n0, n1, n2, k, bx, by, bz);
  constexpr int kMaxDevices = 64;
  static int smem_cap[kMaxDevices] = {};
  cudaError_t err = igg::ensure_smem(fused_pt_kernel<Real>, smem_cap, kMaxDevices, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n2 + bz - 1) / bz, (n1 + by - 1) / by, (n0 + bx - 1) / bx);
  fused_pt_kernel<Real><<<grid, igg::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const Real*>(t), static_cast<const Real*>(p), static_cast<const Real*>(qx),
      static_cast<const Real*>(qy), static_cast<const Real*>(qz), static_cast<Real*>(p_out),
      static_cast<Real*>(qx_out), static_cast<Real*>(qy_out), static_cast<Real*>(qz_out), n0,
      n1, n2, k, th, idx, idy, idz, ralam, bp, bx, by, bz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).
int igg_fused_pt_f32(const void* t, const void* p, const void* qx, const void* qy,
                     const void* qz, void* p_out, void* qx_out, void* qy_out, void* qz_out,
                     int n0, int n1, int n2, int k, float th, float idx, float idy, float idz,
                     float ralam, float bp, int bx, int by, int bz, void* stream) {
  return launch<float>(t, p, qx, qy, qz, p_out, qx_out, qy_out, qz_out, n0, n1, n2, k, th, idx,
                       idy, idz, ralam, bp, bx, by, bz, stream);
}

int igg_fused_pt_f64(const void* t, const void* p, const void* qx, const void* qy,
                     const void* qz, void* p_out, void* qx_out, void* qy_out, void* qz_out,
                     int n0, int n1, int n2, int k, double th, double idx, double idy,
                     double idz, double ralam, double bp, int bx, int by, int bz,
                     void* stream) {
  return launch<double>(t, p, qx, qy, qz, p_out, qx_out, qy_out, qz_out, n0, n1, n2, k, th,
                        idx, idy, idz, ralam, bp, bx, by, bz, stream);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
