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
// for that traffic.  Design: overlapped (trapezoid) tiling as in
// fused_diffusion.cu, over the real n+1 face arrays (the TPU kernel's padded
// face layout exists only for Mosaic's DMA alignment and does not enter
// here).  A block loads its window of all four fields into shared memory
// (staggered.cuh), runs the k steps there and writes back its owned tile.
// The step order allows one buffer per field instead of a ping-pong pair:
// the V half reads only old P and each face itself, the P half only new V
// and each cell itself, with a barrier between the halves.
//
// Simple first: no TMA, no warp specialisation, no register queue along z.

#include "staggered.cuh"

namespace {

template <typename Real>
__global__ void __launch_bounds__(igg::kThreads)
fused_leapfrog_kernel(const Real* __restrict__ p_in, const Real* __restrict__ vx_in,
                      const Real* __restrict__ vy_in, const Real* __restrict__ vz_in,
                      Real* __restrict__ p_out, Real* __restrict__ vx_out,
                      Real* __restrict__ vy_out, Real* __restrict__ vz_out, int n0, int n1,
                      int n2, int k, Real cax, Real cay, Real caz, Real b, Real idx, Real idy,
                      Real idz, int bx, int by, int bz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const igg::Window w = igg::Window::make(n0, n1, n2, k, bx, by, bz);
  igg::Fields<Real> f = igg::Fields<Real>::carve(reinterpret_cast<Real*>(smem_raw), w);
  f.load(w, p_in, vx_in, vy_in, vz_in);
  __syncthreads();

  Real *P = f.c, *Vx = f.fx, *Vy = f.fy, *Vz = f.fz;
  const int ey = w.y.e, ez = w.z.e;
  const int sx = ey * ez;             // x stride of P and Vx (y stride: ez)
  const int syx = (ey + 1) * ez;      // x stride of Vy (y stride: ez)
  const int szx = ey * (ez + 1), szy = ez + 1;  // strides of Vz
  for (int s = 1; s <= k; ++s) {
    igg::for_box(w.x.face_lo(s), w.x.face_hi(s), w.y.side_lo(s), w.y.side_hi(s),
                 w.z.side_lo(s), w.z.side_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z;
                   Vx[c] = Vx[c] - cax * (P[c] - P[c - sx]);
                 });
    igg::for_box(w.x.side_lo(s), w.x.side_hi(s), w.y.face_lo(s), w.y.face_hi(s),
                 w.z.side_lo(s), w.z.side_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z, v = x * syx + y * ez + z;
                   Vy[v] = Vy[v] - cay * (P[c] - P[c - ez]);
                 });
    igg::for_box(w.x.side_lo(s), w.x.side_hi(s), w.y.side_lo(s), w.y.side_hi(s),
                 w.z.face_lo(s), w.z.face_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z, v = x * szx + y * szy + z;
                   Vz[v] = Vz[v] - caz * (P[c] - P[c - 1]);
                 });
    __syncthreads();
    igg::for_box(w.x.cell_lo(s), w.x.cell_hi(s), w.y.cell_lo(s), w.y.cell_hi(s),
                 w.z.cell_lo(s), w.z.cell_hi(s), [&](int x, int y, int z) {
                   const int c = x * sx + y * ez + z;
                   const int vy = x * syx + y * ez + z, vz = x * szx + y * szy + z;
                   const Real div = ((Vx[c + sx] - Vx[c]) * idx + (Vy[vy + ez] - Vy[vy]) * idy)
                                  + (Vz[vz + 1] - Vz[vz]) * idz;
                   P[c] = P[c] - b * div;
                 });
    __syncthreads();
  }
  f.store(w, p_out, vx_out, vy_out, vz_out);
}

template <typename Real>
int launch(const void* p, const void* vx, const void* vy, const void* vz, void* p_out,
           void* vx_out, void* vy_out, void* vz_out, int n0, int n1, int n2, int k, Real cax,
           Real cay, Real caz, Real b, Real idx, Real idy, Real idz, int bx, int by, int bz,
           void* stream) {
  const int smem = (int)igg::fields_bytes<Real>(n0, n1, n2, k, bx, by, bz);
  constexpr int kMaxDevices = 64;
  static int smem_cap[kMaxDevices] = {};
  cudaError_t err = igg::ensure_smem(fused_leapfrog_kernel<Real>, smem_cap, kMaxDevices, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n2 + bz - 1) / bz, (n1 + by - 1) / by, (n0 + bx - 1) / bx);
  fused_leapfrog_kernel<Real><<<grid, igg::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const Real*>(p), static_cast<const Real*>(vx), static_cast<const Real*>(vy),
      static_cast<const Real*>(vz), static_cast<Real*>(p_out), static_cast<Real*>(vx_out),
      static_cast<Real*>(vy_out), static_cast<Real*>(vz_out), n0, n1, n2, k, cax, cay, caz, b,
      idx, idy, idz, bx, by, bz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).
int igg_fused_leapfrog_f32(const void* p, const void* vx, const void* vy, const void* vz,
                           void* p_out, void* vx_out, void* vy_out, void* vz_out, int n0,
                           int n1, int n2, int k, float cax, float cay, float caz, float b,
                           float idx, float idy, float idz, int bx, int by, int bz,
                           void* stream) {
  return launch<float>(p, vx, vy, vz, p_out, vx_out, vy_out, vz_out, n0, n1, n2, k, cax, cay,
                       caz, b, idx, idy, idz, bx, by, bz, stream);
}

int igg_fused_leapfrog_f64(const void* p, const void* vx, const void* vy, const void* vz,
                           void* p_out, void* vx_out, void* vy_out, void* vz_out, int n0,
                           int n1, int n2, int k, double cax, double cay, double caz, double b,
                           double idx, double idy, double idz, int bx, int by, int bz,
                           void* stream) {
  return launch<double>(p, vx, vy, vz, p_out, vx_out, vy_out, vz_out, n0, n1, n2, k, cax, cay,
                        caz, b, idx, idy, idz, bx, by, bz, stream);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
