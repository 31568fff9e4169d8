// The diffusion model's per-step update in one pass over the block.
//
// Replaces no Pallas kernel.  The JAX package leaves its per-step update
// (models/diffusion3d.py `_diffusion_update`) to XLA, which fuses it into one
// pass; written as plain PyTorch it is a chain of about a dozen elementwise
// kernels and a clone over whole fields.  This kernel is that fusion, by
// hand.  With c = T at the cell, it computes
//
//     out = c + (s / Cp) * ((((T[x+1] - 2c) + T[x-1]) * ix
//                            + ((T[y+1] - 2c) + T[y-1]) * iy)
//                           + ((T[z+1] - 2c) + T[z-1]) * iz)
//
// on every cell but the block's outermost ring, where out = T.  s = dt*lam
// and ix = 1/dx^2 (likewise iy, iz) come from the wrapper rounded as torch
// rounds them on the card (`ops/diffusion_update.coefficients`): torch
// multiplies a tensor by the reciprocal of a Python scalar it divides by,
// taken in double precision and rounded to the type it computes in, and
// divides s by Cp truly.  The operations are written in the plain version's
// order and the file is built with --fmad=false, so the result equals
// `diffusion_update_reference` on the card bit for bit.  float32 and float64
// compute in their own type.  bfloat16 and float16 compute as torch's
// elementwise kernels do: each operation in float32 with its result rounded
// to the field's type (`Rounded`), the coefficients ix, iy, iz in float32 and
// s in the field's type.
//
// Bound: HBM bytes.  A launch must read T and Cp once and write out once
// (3 * n0*n1*n2 * sizeof(T); 1.61 GB, 0.481 ms at 3.35 TB/s for a 512^3
// float32 block); its ~17 operations a cell are ~2% of the card's float32
// rate at that traffic.  So the design spends nothing on arithmetic and
// everything on keeping a stream of wide loads in flight, each byte fetched
// from HBM once:
//
// * A block of kRows warps owns a tile of kRows y rows by 32*V z cells and
//   marches along x; a thread owns V z-adjacent cells of one row (V = 16
//   bytes of T where the views allow 16-byte accesses, else 1).  It keeps
//   T at x-1, x and x+1 of its cells in registers, and loads T at x+2 and Cp
//   at x+1 while it computes x: the loads of the next plane are in flight
//   through the whole of this one.
// * The y neighbours come from a shared-memory plane of the tile with a
//   one-row rim above and below (loaded by the first and the last warp),
//   double-buffered by plane parity: one barrier per plane.  The z
//   neighbours inside a thread's cells are its registers, across lanes warp
//   shuffles, and beyond the tile's z edges one scalar load by lanes 0 and
//   31.  Rims are the neighbouring tiles' own rows, marched at the same time,
//   so they come from L2.
// * Out is stored and Cp loaded evict-first (read or written once), so L2
//   keeps the T planes that neighbouring tiles read as their rims.
// * The ring is copied in the same pass: no clone of T.
// * The launch cuts x into segments so that the grid fills the card's
//   resident blocks kWaves times over (a segment re-reads one plane of T at
//   each end): a block that finishes early makes room for the next, so the
//   card keeps its loads in flight to the end.
//
// Views: T and Cp are read through their own strides (member, x, y; z must
// be unit-stride, which the wrapper checks), so the boundary windows and the
// interior of the overlapped update (ops/overlap.py) need no copy.  A batch
// of nb members extends the launch grid: one launch, each member exactly as
// a launch of its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;  // y rows of a tile, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kMinSegment = 16;  // the shortest x segment, in planes
// Blocks a launch aims at, in multiples of the card's resident blocks: at
// 512^3 float32 one wave ran at 77% of the bound, 2, 4 and 8 at 87%.
constexpr int kWaves = 4;
constexpr unsigned kFull = 0xffffffffu;

// A bfloat16 or float16 value in the float32 arithmetic of torch's
// elementwise kernels: every operation's result is rounded to S.
template <typename S>
struct Rounded {
  float v;
  Rounded() = default;
  __device__ explicit Rounded(float x) : v(x) {}
};

__device__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ float round_to(float x, __half*) { return __half2float(__float2half_rn(x)); }

template <typename S>
__device__ Rounded<S> rounded(float x) {
  return Rounded<S>(round_to(x, static_cast<S*>(nullptr)));
}
template <typename S>
__device__ Rounded<S> operator+(Rounded<S> a, Rounded<S> b) {
  return rounded<S>(a.v + b.v);
}
template <typename S>
__device__ Rounded<S> operator-(Rounded<S> a, Rounded<S> b) {
  return rounded<S>(a.v - b.v);
}
template <typename S>
__device__ Rounded<S> operator*(Rounded<S> a, Rounded<S> b) {
  return rounded<S>(a.v * b.v);
}
template <typename S>
__device__ Rounded<S> operator/(Rounded<S> a, Rounded<S> b) {
  return rounded<S>(a.v / b.v);
}

// The type a field of S computes in, and the type of its coefficients.
template <typename S>
struct Num {
  using T = S;
  using C = S;
};
template <>
struct Num<__nv_bfloat16> {
  using T = Rounded<__nv_bfloat16>;
  using C = float;
};
template <>
struct Num<__half> {
  using T = Rounded<__half>;
  using C = float;
};

template <typename T>
__device__ T shfl_up(T x) {
  return __shfl_up_sync(kFull, x, 1);
}
template <typename T>
__device__ T shfl_down(T x) {
  return __shfl_down_sync(kFull, x, 1);
}
template <typename S>
__device__ Rounded<S> shfl_up(Rounded<S> x) {
  return Rounded<S>(__shfl_up_sync(kFull, x.v, 1));
}
template <typename S>
__device__ Rounded<S> shfl_down(Rounded<S> x) {
  return Rounded<S>(__shfl_down_sync(kFull, x.v, 1));
}

template <typename S>
struct Args {
  const S* t;
  const S* cp;
  S* out;  // contiguous (nb, n0, n1, n2)
  int n0, n1, n2;
  long long ts[3];  // T's strides (member, x, y); z is unit-stride
  long long cs[3];  // Cp's
  int seg, nseg;    // x planes a segment, segments a member
  typename Num<S>::C ix, iy, iz, s;
};

// V cells of one row as one access, from storage S to the type the kernel
// computes in and back: plain loads of T (read-only path), evict-first loads
// of Cp and stores of out, and shared-memory accesses.
template <typename S, int V>
struct Io;

template <typename T>
struct IoScalar {
  __device__ static void ld(T* r, const T* p) { r[0] = __ldg(p); }
  __device__ static void ldcs(T* r, const T* p) { r[0] = __ldcs(p); }
  __device__ static void stcs(T* p, const T* r) { __stcs(p, r[0]); }
  __device__ static void lds(T* r, const T* p) { r[0] = p[0]; }
  __device__ static void sts(T* p, const T* r) { p[0] = r[0]; }
};

template <>
struct Io<float, 1> : IoScalar<float> {};
template <>
struct Io<double, 1> : IoScalar<double> {};

// bfloat16 and float16: V 16-bit cells as one word W, widened to Rounded on
// load (exactly) and narrowed on store (exactly: a Rounded value is one of S).
template <int V>
struct Word;
template <>
struct Word<1> {
  using type = unsigned short;
};
template <>
struct Word<8> {
  using type = uint4;
};

__device__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ float widen(__half x) { return __half2float(x); }
__device__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ void narrow(__half* p, float x) { *p = __float2half_rn(x); }

template <typename S, int V>
struct IoHalf {
  using T = Rounded<S>;
  using W = typename Word<V>::type;
  __device__ static void set(T* r, W w) {
    const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = T(widen(e[j]));
  }
  __device__ static W get(const T* r) {
    W w;
    S* e = reinterpret_cast<S*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) narrow(e + j, r[j].v);
    return w;
  }
  __device__ static void ld(T* r, const S* p) { set(r, __ldg(reinterpret_cast<const W*>(p))); }
  __device__ static void ldcs(T* r, const S* p) {
    set(r, __ldcs(reinterpret_cast<const W*>(p)));
  }
  __device__ static void stcs(S* p, const T* r) { __stcs(reinterpret_cast<W*>(p), get(r)); }
  __device__ static void lds(T* r, const S* p) { set(r, *reinterpret_cast<const W*>(p)); }
  __device__ static void sts(S* p, const T* r) { *reinterpret_cast<W*>(p) = get(r); }
};

template <int V>
struct Io<__nv_bfloat16, V> : IoHalf<__nv_bfloat16, V> {};
template <int V>
struct Io<__half, V> : IoHalf<__half, V> {};

template <>
struct Io<float, 4> {
  __device__ static void set(float* r, float4 w) {
    r[0] = w.x;
    r[1] = w.y;
    r[2] = w.z;
    r[3] = w.w;
  }
  __device__ static float4 get(const float* r) { return make_float4(r[0], r[1], r[2], r[3]); }
  __device__ static void ld(float* r, const float* p) {
    set(r, __ldg(reinterpret_cast<const float4*>(p)));
  }
  __device__ static void ldcs(float* r, const float* p) {
    set(r, __ldcs(reinterpret_cast<const float4*>(p)));
  }
  __device__ static void stcs(float* p, const float* r) {
    __stcs(reinterpret_cast<float4*>(p), get(r));
  }
  __device__ static void lds(float* r, const float* p) {
    set(r, *reinterpret_cast<const float4*>(p));
  }
  __device__ static void sts(float* p, const float* r) { *reinterpret_cast<float4*>(p) = get(r); }
};

template <>
struct Io<double, 2> {
  __device__ static void set(double* r, double2 w) {
    r[0] = w.x;
    r[1] = w.y;
  }
  __device__ static double2 get(const double* r) { return make_double2(r[0], r[1]); }
  __device__ static void ld(double* r, const double* p) {
    set(r, __ldg(reinterpret_cast<const double2*>(p)));
  }
  __device__ static void ldcs(double* r, const double* p) {
    set(r, __ldcs(reinterpret_cast<const double2*>(p)));
  }
  __device__ static void stcs(double* p, const double* r) {
    __stcs(reinterpret_cast<double2*>(p), get(r));
  }
  __device__ static void lds(double* r, const double* p) {
    set(r, *reinterpret_cast<const double2*>(p));
  }
  __device__ static void sts(double* p, const double* r) {
    *reinterpret_cast<double2*>(p) = get(r);
  }
};

template <typename S, int V>
__global__ void __launch_bounds__(kThreads) diffusion_update_kernel(const Args<S> a) {
  using T = typename Num<S>::T;
  constexpr int kTileZ = 32 * V;
  using IO = Io<S, V>;
  __shared__ __align__(16) S rows[2][kRows + 2][kTileZ];
  const T ix(a.ix), iy(a.iy), iz(a.iz), s(a.s);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int z = blockIdx.x * kTileZ + lane * V;  // this thread's first cell
  const int y0 = blockIdx.y * kRows, y = y0 + w;
  const int m = blockIdx.z / a.nseg;
  const int xa = (blockIdx.z - m * a.nseg) * a.seg, xb = min(xa + a.seg, a.n0);
  const bool own = z < a.n2 && y < a.n1;
  // The rim rows: the first warp loads the row above the tile into
  // shared-memory row 0, the last warp the row below it into row kRows + 1.
  const bool rim_warp = w == 0 || w == kRows - 1;
  const int ry = w == 0 ? y0 - 1 : y0 + kRows, rrow = w == 0 ? 0 : kRows + 1;
  const bool rim = rim_warp && z < a.n2 && ry >= 0 && ry < a.n1;
  // The cells beyond the tile's z edges, for lanes 0 and 31.
  const int rz = lane == 0 ? z - 1 : z + V;
  const bool zrim = (lane == 0 || lane == 31) && y < a.n1 && rz >= 0 && rz < a.n2;

  const S* tm0 = a.t + m * a.ts[0];
  const S* tp = tm0 + y * a.ts[2] + z;
  const S* rp = tm0 + ry * a.ts[2] + z;
  const S* zp = tm0 + y * a.ts[2] + rz;
  const S* cpp = a.cp + m * a.cs[0] + y * a.cs[2] + z;
  const long long oplane = (long long)a.n1 * a.n2;
  S* op = a.out + (long long)m * a.n0 * oplane + (long long)y * a.n2 + z;

  auto load_t = [&](T* r, int x) {
    if (own && x < a.n0 && x >= 0) {
      IO::ld(r, tp + x * a.ts[1]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = T(0);
    }
  };
  auto load_next = [&](T* c, T* r, T& zr, int x) {  // Cp and the rims at plane x
#pragma unroll
    for (int j = 0; j < V; ++j) c[j] = r[j] = T(0);
    zr = T(0);
    if (x >= xb) return;
    if (own) IO::ldcs(c, cpp + x * a.cs[1]);
    if (rim) IO::ld(r, rp + x * a.ts[1]);
    if (zrim) Io<S, 1>::ld(&zr, zp + x * a.ts[1]);
  };

  T tm[V], tc[V], tn[V], cc[V], rc[V], zc;
  load_t(tm, xa - 1);
  load_t(tc, xa);
  load_t(tn, xa + 1);
  load_next(cc, rc, zc, xa);

  for (int x = xa; x < xb; ++x) {
    // The next plane's loads first: they are in flight while this one runs.
    T tq[V], cq[V], rq[V], zq;
    load_t(tq, x + 2 <= xb ? x + 2 : -1);
    load_next(cq, rq, zq, x + 1);

    S(*buf)[kTileZ] = rows[x & 1];
    IO::sts(&buf[w + 1][lane * V], tc);
    if (rim_warp) IO::sts(&buf[rrow][lane * V], rc);
    __syncthreads();

    T up[V], dn[V];
    IO::lds(up, &buf[w][lane * V]);
    IO::lds(dn, &buf[w + 2][lane * V]);
    T zlo = shfl_up(tc[V - 1]);
    T zhi = shfl_down(tc[0]);
    if (lane == 0) zlo = zc;
    if (lane == 31) zhi = zc;
    const bool inner = x >= 1 && x <= a.n0 - 2 && y >= 1 && y <= a.n1 - 2;
    T o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T c = tc[j];
      const T c2 = T(2) * c;
      const T zm = j == 0 ? zlo : tc[j - 1];
      const T zp1 = j == V - 1 ? zhi : tc[j + 1];
      const T lap =
          (((tn[j] - c2) + tm[j]) * ix + ((dn[j] - c2) + up[j]) * iy) + ((zp1 - c2) + zm) * iz;
      const T delta = (s / cc[j]) * lap;
      o[j] = inner && z + j >= 1 && z + j <= a.n2 - 2 ? c + delta : c;
    }
    if (own) IO::stcs(op + x * oplane, o);

#pragma unroll
    for (int j = 0; j < V; ++j) {
      tm[j] = tc[j];
      tc[j] = tn[j];
      tn[j] = tq[j];
      cc[j] = cq[j];
      rc[j] = rq[j];
    }
    zc = zq;
  }
}

template <typename S, int V>
int resident_blocks() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, diffusion_update_kernel<S, V>,
                                                    kThreads, 0) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  return blocks > 0 ? blocks : 1;
}

template <typename S, int V>
int launch(Args<S> a, int nb, cudaStream_t stream) {
  static const int resident = resident_blocks<S, V>();  // one card model: asked once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long gx = (a.n2 + 32 * V - 1) / (32 * V), gy = (a.n1 + kRows - 1) / kRows;
  long long nseg = (long long)kWaves * resident * sms / (gx * gy * nb);
  nseg = nseg < a.n0 / kMinSegment ? nseg : a.n0 / kMinSegment;
  nseg = nseg > 1 ? nseg : 1;
  a.seg = (int)((a.n0 + nseg - 1) / nseg);
  a.nseg = (a.n0 + a.seg - 1) / a.seg;
  if (gy > 65535 || (long long)nb * a.nseg > 65535) return (int)cudaErrorInvalidConfiguration;
  diffusion_update_kernel<S, V>
      <<<dim3((unsigned)gx, (unsigned)gy, (unsigned)(nb * a.nseg)), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(const void* t, const void* cp, void* out, int nb, int n0, int n1, int n2,
             long long tb, long long t0, long long t1, long long cb, long long c0, long long c1,
             int vec, typename Num<S>::C ix, typename Num<S>::C iy, typename Num<S>::C iz,
             typename Num<S>::C s, void* stream) {
  Args<S> a{static_cast<const S*>(t), static_cast<const S*>(cp), static_cast<S*>(out), n0, n1, n2,
            {tb, t0, t1}, {cb, c0, c1}, 0, 0, ix, iy, iz, s};
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == 1) return launch<S, 1>(a, nb, st);
  if (vec == 16 / (int)sizeof(S)) return launch<S, 16 / sizeof(S)>(a, nb, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).  nb: the
// members; t*/c*: T's and Cp's strides in elements (member, x, y); vec: the
// cells a thread accesses at once (1, or 16 bytes' worth where every pointer
// is 16-byte aligned and every stride and n2 a multiple of it).
int igg_diffusion_update_f32(const void* t, const void* cp, void* out, int nb, int n0, int n1,
                             int n2, long long tb, long long t0, long long t1, long long cb,
                             long long c0, long long c1, int vec, float ix, float iy, float iz,
                             float s, void* stream) {
  return dispatch<float>(t, cp, out, nb, n0, n1, n2, tb, t0, t1, cb, c0, c1, vec, ix, iy, iz, s,
                         stream);
}

int igg_diffusion_update_f64(const void* t, const void* cp, void* out, int nb, int n0, int n1,
                             int n2, long long tb, long long t0, long long t1, long long cb,
                             long long c0, long long c1, int vec, double ix, double iy,
                             double iz, double s, void* stream) {
  return dispatch<double>(t, cp, out, nb, n0, n1, n2, tb, t0, t1, cb, c0, c1, vec, ix, iy, iz, s,
                          stream);
}

// bfloat16 and float16: ix, iy, iz and s in float32 (s a value of the type).
int igg_diffusion_update_bf16(const void* t, const void* cp, void* out, int nb, int n0, int n1,
                              int n2, long long tb, long long t0, long long t1, long long cb,
                              long long c0, long long c1, int vec, float ix, float iy, float iz,
                              float s, void* stream) {
  return dispatch<__nv_bfloat16>(t, cp, out, nb, n0, n1, n2, tb, t0, t1, cb, c0, c1, vec, ix, iy,
                                 iz, s, stream);
}

int igg_diffusion_update_f16(const void* t, const void* cp, void* out, int nb, int n0, int n1,
                             int n2, long long tb, long long t0, long long t1, long long cb,
                             long long c0, long long c1, int vec, float ix, float iy, float iz,
                             float s, void* stream) {
  return dispatch<__half>(t, cp, out, nb, n0, n1, n2, tb, t0, t1, cb, c0, c1, vec, ix, iy, iz, s,
                          stream);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
