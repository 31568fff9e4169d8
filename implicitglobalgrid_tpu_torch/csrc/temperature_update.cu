// The porous model's temperature update in one pass over the block.
//
// Replaces no Pallas kernel.  The JAX package leaves its temperature update
// (models/porous_convection3d.py `_temperature_update`) to XLA, which fuses
// it into one pass; written as plain PyTorch it is a chain of about twenty
// elementwise kernels and a clone over whole fields.  This kernel is that
// fusion, by hand.  With c = T at the cell, T+ and T- its neighbours along
// an axis and qDx, qDy, qDz the Darcy fluxes on the cell's faces (qDx at x
// and x+1, and likewise), it computes
//
//     lap   = ((((T+x - 2c) + T-x) * rx2 + ((T+y - 2c) + T-y) * ry2)
//              + ((T+z - 2c) + T-z) * rz2)
//     adv   = max(qDx[x], 0) * ((c - T-x) * rx) + min(qDx[x+1], 0) * ((T+x - c) * rx)
//             + ... y, z ...                                   (summed left to right)
//     out   = c + dt * (lam * lap - iphi * adv)
//
// on every cell but the block's outermost ring, where out = T.  rx2 = 1/dx^2
// and rx = 1/dx (likewise y, z), lam, iphi and dt come from the wrapper
// rounded as torch rounds them on the card (`ops/temperature_update.
// coefficients`): torch multiplies a tensor by the reciprocal of a Python
// scalar it divides by, taken in double precision and rounded to the type it
// computes in.  max and min keep a NaN, as torch's clamp does.  The
// operations are written in the plain version's order and the file is built
// with --fmad=false, so the result equals `temperature_update_reference` on
// the card bit for bit.  float32 and float64 compute in their own type.
// bfloat16 and float16 compute as torch's elementwise kernels do: each
// operation in float32 with its result rounded to the field's type
// (`Rounded`), the coefficients in float32.
//
// Bound: HBM bytes.  A launch must read T and the three face fluxes once and
// write out once: (2 * n0*n1*n2 + (n0+1)*n1*n2 + n0*(n1+1)*n2 + n0*n1*(n2+1))
// * sizeof(T), 336.3 MB and 0.1004 ms at 3.35 TB/s for a 256^3 float32
// block; its 50 operations a cell need 0.0125 ms at the card's float32 rate.
// So the design spends nothing on arithmetic and everything on keeping a
// stream of loads in flight, each byte fetched from HBM once:
//
// * A block of kRows warps owns a tile of kRows y rows by 32*V z cells and
//   marches along x; a thread owns V z-adjacent cells of one row (V = 16
//   bytes of T where T's, qDx's and qDy's views allow 16-byte accesses,
//   else 1).  It keeps T at x-1, x and x+1 in registers and qDx at faces x
//   and x+1: the face x+1 of one plane is the face x of the next, so each
//   qDx plane is loaded once.  While it computes plane x the loads of plane
//   x+1 (T at x+2, qDx at face x+2, qDy, qDz and the rims) are in flight.
// * The y neighbours of T come from a shared-memory plane of the tile with a
//   one-row rim above and below, and qDy's face y+1 from a shared-memory
//   plane of the tile's qDy rows with the face row below the tile: each warp
//   stores the rows it loaded, the first and the last warp the rims.  Both
//   are double-buffered by plane parity: one barrier per plane.
// * The z neighbours of T inside a thread's cells are its registers, across
//   lanes warp shuffles, and beyond the tile's z edges one scalar load by
//   lanes 0 and 31.  qDz's rows are n2+1 long, so they are never all 16-byte
//   aligned: a thread loads its V faces as scalars through the read-only
//   path (the warp's loads cover the same cache lines, fetched once), and
//   its face z+V is the next lane's face z (a shuffle; lane 31 loads it).
// * qDx is loaded and out stored evict-first (read or written once), so L2
//   keeps the T and qDy rows that neighbouring tiles read as their rims.
// * The ring is copied in the same pass: no clone of T.
// * The launch cuts x into segments so that the grid fills the card's
//   resident blocks kWaves times over, in segments of at least kMinSegment
//   planes: a segment re-reads one plane of T at each end and one qDx face
//   from HBM, which at 256^3 weighs more than a ragged last wave (256^3
//   float32, two resident blocks per SM: segments of 16 planes ran at 84.1%
//   of the bound, 32 at 85.9%, 64 at 87.2%, one wave of 256 blocks).
//
// Views: every field is read through its own strides (member, x, y; z must
// be unit-stride, which the wrapper checks).  A batch of nb members extends
// the launch grid: one launch, each member exactly as a launch of its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;  // y rows of a tile, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kMinSegment = 64;  // the shortest x segment, in planes
constexpr int kWaves = 4;         // blocks a launch aims at, in resident blocks
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

// torch's clamp_min(0) and clamp_max(0): NaN stays NaN.  A clamped value of
// S is one of S, so Rounded needs no rounding.
__device__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }
__device__ float clamp_max0(float v) { return isnan(v) ? v : fminf(v, 0.0f); }
__device__ double clamp_min0(double v) { return isnan(v) ? v : fmax(v, 0.0); }
__device__ double clamp_max0(double v) { return isnan(v) ? v : fmin(v, 0.0); }
template <typename S>
__device__ Rounded<S> clamp_min0(Rounded<S> v) {
  return Rounded<S>(clamp_min0(v.v));
}
template <typename S>
__device__ Rounded<S> clamp_max0(Rounded<S> v) {
  return Rounded<S>(clamp_max0(v.v));
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
  const S* qx;
  const S* qy;
  const S* qz;
  S* out;  // contiguous (nb, n0, n1, n2)
  int n0, n1, n2;
  long long ts[3];  // T's strides (member, x, y); z is unit-stride
  long long xs[3];  // qDx's
  long long ys[3];  // qDy's
  long long zs[3];  // qDz's
  int seg, nseg;    // x planes a segment, segments a member
  typename Num<S>::C rx2, ry2, rz2, rx, ry, rz, lam, iphi, dt;
};

// V cells of one row as one access, from storage S to the type the kernel
// computes in and back: plain loads (read-only path), evict-first loads and
// stores, and shared-memory accesses.
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
__global__ void __launch_bounds__(kThreads) temperature_update_kernel(const Args<S> a) {
  using T = typename Num<S>::T;
  constexpr int kTileZ = 32 * V;
  using IO = Io<S, V>;
  using IO1 = Io<S, 1>;
  // One plane of the tile by parity: T's rows with a rim row above and
  // below, and qDy's rows y0 .. y0 + kRows (the last is the face below).
  __shared__ __align__(16) S trows[2][kRows + 2][kTileZ];
  __shared__ __align__(16) S qrows[2][kRows + 1][kTileZ];
  const T rx2(a.rx2), ry2(a.ry2), rz2(a.rz2), rx(a.rx), ry(a.ry), rz(a.rz), lam(a.lam),
      iphi(a.iphi), dt(a.dt);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int z = blockIdx.x * kTileZ + lane * V;  // this thread's first cell
  const int y0 = blockIdx.y * kRows, y = y0 + w;
  const int m = blockIdx.z / a.nseg;
  const int xa = (blockIdx.z - m * a.nseg) * a.seg, xb = min(xa + a.seg, a.n0);
  const bool own = z < a.n2 && y < a.n1;
  // The rims: the first warp loads T's row above the tile into shared row
  // 0, the last warp T's row below it into row kRows + 1 and qDy's face row
  // below it (qDy has n1 + 1 rows) into qDy's row kRows.
  const bool first = w == 0, last = w == kRows - 1;
  const int ry_ = first ? y0 - 1 : y0 + kRows, rrow = first ? 0 : kRows + 1;
  const bool rim = (first || last) && z < a.n2 && ry_ >= 0 && ry_ < a.n1;
  const bool qrim = last && z < a.n2 && y0 + kRows <= a.n1;
  // T beyond the tile's z edges, for lanes 0 and 31; qDz's face z + V for lane 31.
  const int rz_ = lane == 0 ? z - 1 : z + V;
  const bool zrim = (lane == 0 || lane == 31) && y < a.n1 && rz_ >= 0 && rz_ < a.n2;
  const bool qzrim = own && lane == 31;

  const S* tm0 = a.t + m * a.ts[0];
  const S* tp = tm0 + y * a.ts[2] + z;
  const S* rp = tm0 + ry_ * a.ts[2] + z;
  const S* zp = tm0 + y * a.ts[2] + rz_;
  const S* qxp = a.qx + m * a.xs[0] + y * a.xs[2] + z;
  const S* qyp = a.qy + m * a.ys[0] + y * a.ys[2] + z;
  const S* qyr = a.qy + m * a.ys[0] + (y0 + kRows) * a.ys[2] + z;
  const S* qzp = a.qz + m * a.zs[0] + y * a.zs[2] + z;
  const long long oplane = (long long)a.n1 * a.n2;
  S* op = a.out + (long long)m * a.n0 * oplane + (long long)y * a.n2 + z;

  auto zero = [](T* r) {
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = T(0);
  };
  auto load_t = [&](T* r, int x) {
    if (own && x >= 0 && x < a.n0) {
      IO::ld(r, tp + x * a.ts[1]);
    } else {
      zero(r);
    }
  };
  auto load_qx = [&](T* r, int x) {  // face x of qDx (n0 + 1 faces)
    if (own && x >= 0 && x <= a.n0) {
      IO::ldcs(r, qxp + x * a.xs[1]);
    } else {
      zero(r);
    }
  };
  // The rest of plane x: qDy's row and rim, qDz's faces, T's rims.
  auto load_next = [&](T* qy, T* qr, T* qz, T& qe, T* tr, T& zr, int x) {
    zero(qy);
    zero(qr);
    zero(qz);
    zero(tr);
    qe = zr = T(0);
    if (x >= xb) return;
    if (own) {
      IO::ld(qy, qyp + x * a.ys[1]);
#pragma unroll
      for (int j = 0; j < V; ++j) IO1::ld(qz + j, qzp + x * a.zs[1] + j);
    }
    if (qzrim) IO1::ld(&qe, qzp + x * a.zs[1] + V);
    if (qrim) IO::ld(qr, qyr + x * a.ys[1]);
    if (rim) IO::ld(tr, rp + x * a.ts[1]);
    if (zrim) IO1::ld(&zr, zp + x * a.ts[1]);
  };

  T tm[V], tc[V], tn[V], qxc[V], qxn[V], qy[V], qr[V], qz[V], tr[V], qe, zr;
  load_t(tm, xa - 1);
  load_t(tc, xa);
  load_t(tn, xa + 1);
  load_qx(qxc, xa);
  load_qx(qxn, xa + 1);
  load_next(qy, qr, qz, qe, tr, zr, xa);

  for (int x = xa; x < xb; ++x) {
    // The next plane's loads first: they are in flight while this one runs.
    T tq[V], qxq[V], qyq[V], qrq[V], qzq[V], tre[V], qeq, zrq;
    load_t(tq, x + 2 <= xb ? x + 2 : -1);
    load_qx(qxq, x + 2 <= xb ? x + 2 : -1);
    load_next(qyq, qrq, qzq, qeq, tre, zrq, x + 1);

    S(*tb)[kTileZ] = trows[x & 1];
    S(*qb)[kTileZ] = qrows[x & 1];
    IO::sts(&tb[w + 1][lane * V], tc);
    IO::sts(&qb[w][lane * V], qy);
    if (first || last) IO::sts(&tb[rrow][lane * V], tr);
    if (last) IO::sts(&qb[kRows][lane * V], qr);
    __syncthreads();

    T up[V], dn[V], qyn[V];
    IO::lds(up, &tb[w][lane * V]);
    IO::lds(dn, &tb[w + 2][lane * V]);
    IO::lds(qyn, &qb[w + 1][lane * V]);
    T zlo = shfl_up(tc[V - 1]);
    T zhi = shfl_down(tc[0]);
    T qzhi = shfl_down(qz[0]);
    if (lane == 0) zlo = zr;
    if (lane == 31) {
      zhi = zr;
      qzhi = qe;
    }
    const bool inner = x >= 1 && x <= a.n0 - 2 && y >= 1 && y <= a.n1 - 2;
    T o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T c = tc[j];
      const T c2 = T(2) * c;
      const T zm = j == 0 ? zlo : tc[j - 1];
      const T zq = j == V - 1 ? zhi : tc[j + 1];
      const T qz1 = j == V - 1 ? qzhi : qz[j + 1];
      const T lap = (((tn[j] - c2) + tm[j]) * rx2 + ((dn[j] - c2) + up[j]) * ry2) +
                    ((zq - c2) + zm) * rz2;
      const T adv = ((((clamp_min0(qxc[j]) * ((c - tm[j]) * rx) +
                        clamp_max0(qxn[j]) * ((tn[j] - c) * rx)) +
                       clamp_min0(qy[j]) * ((c - up[j]) * ry)) +
                      clamp_max0(qyn[j]) * ((dn[j] - c) * ry)) +
                     clamp_min0(qz[j]) * ((c - zm) * rz)) +
                    clamp_max0(qz1) * ((zq - c) * rz);
      const T delta = dt * (lam * lap - iphi * adv);
      o[j] = inner && z + j >= 1 && z + j <= a.n2 - 2 ? c + delta : c;
    }
    if (own) IO::stcs(op + x * oplane, o);

#pragma unroll
    for (int j = 0; j < V; ++j) {
      tm[j] = tc[j];
      tc[j] = tn[j];
      tn[j] = tq[j];
      qxc[j] = qxn[j];
      qxn[j] = qxq[j];
      qy[j] = qyq[j];
      qr[j] = qrq[j];
      qz[j] = qzq[j];
      tr[j] = tre[j];
    }
    qe = qeq;
    zr = zrq;
  }
}

template <typename S, int V>
int resident_blocks() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, temperature_update_kernel<S, V>,
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
  temperature_update_kernel<S, V>
      <<<dim3((unsigned)gx, (unsigned)gy, (unsigned)(nb * a.nseg)), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(const void* t, const void* qx, const void* qy, const void* qz, void* out, int nb,
             int n0, int n1, int n2, const long long* strides, int vec,
             const typename Num<S>::C* co, void* stream) {
  Args<S> a{static_cast<const S*>(t),
            static_cast<const S*>(qx),
            static_cast<const S*>(qy),
            static_cast<const S*>(qz),
            static_cast<S*>(out),
            n0,
            n1,
            n2,
            {strides[0], strides[1], strides[2]},
            {strides[3], strides[4], strides[5]},
            {strides[6], strides[7], strides[8]},
            {strides[9], strides[10], strides[11]},
            0,
            0,
            co[0],
            co[1],
            co[2],
            co[3],
            co[4],
            co[5],
            co[6],
            co[7],
            co[8]};
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec == 1) return launch<S, 1>(a, nb, st);
  if (vec == 16 / (int)sizeof(S)) return launch<S, 16 / sizeof(S)>(a, nb, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of the launch (0 = launched).  nb: the
// members; strides: 12 values in elements, (member, x, y) of T, qDx, qDy and
// qDz in that order; vec: the cells a thread accesses at once (1, or 16
// bytes' worth where T's, qDx's and qDy's pointers are 16-byte aligned and
// their strides and n2 are multiples of it); co: rx2, ry2, rz2, rx, ry, rz,
// lam, iphi, dt (float32 for bfloat16 and float16, which compute in it).
int igg_temperature_update_f32(const void* t, const void* qx, const void* qy, const void* qz,
                               void* out, int nb, int n0, int n1, int n2,
                               const long long* strides, int vec, const float* co,
                               void* stream) {
  return dispatch<float>(t, qx, qy, qz, out, nb, n0, n1, n2, strides, vec, co, stream);
}

int igg_temperature_update_f64(const void* t, const void* qx, const void* qy, const void* qz,
                               void* out, int nb, int n0, int n1, int n2,
                               const long long* strides, int vec, const double* co,
                               void* stream) {
  return dispatch<double>(t, qx, qy, qz, out, nb, n0, n1, n2, strides, vec, co, stream);
}

int igg_temperature_update_bf16(const void* t, const void* qx, const void* qy, const void* qz,
                                void* out, int nb, int n0, int n1, int n2,
                                const long long* strides, int vec, const float* co,
                                void* stream) {
  return dispatch<__nv_bfloat16>(t, qx, qy, qz, out, nb, n0, n1, n2, strides, vec, co, stream);
}

int igg_temperature_update_f16(const void* t, const void* qx, const void* qy, const void* qz,
                               void* out, int nb, int n0, int n1, int n2,
                               const long long* strides, int vec, const float* co,
                               void* stream) {
  return dispatch<__half>(t, qx, qy, qz, out, nb, n0, n1, n2, strides, vec, co, stream);
}

const char* igg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
