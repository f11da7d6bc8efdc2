// The dycore's per-cell state transforms, for NVIDIA Hopper (sm_90a): the
// de-densitization that feeds the direction-flux kernels, and the two
// conversions between the coupler's fields and the dycore's state.
//
// Replaces no TPU kernel: the JAX package writes these as jnp code that XLA
// fuses (miniweatherml_tpu/dycore/euler.py: convert_coupler_to_dynamics
// :322-339, _dyn_to_coupler_fields :341-356, the prim concatenation of
// _tendencies :1009-1017).  The port ran them as eager PyTorch, one pass
// per operation, with temporaries, stacks and a concatenation.  Their plain
// versions are miniweatherml_tpu_torch/ops/dycore_state.py::*_plain.
//
// Math, per cell; hyc, hyt are the hydrostatic density and density-theta of
// the cell's (member, level); m the sum of the tracers flagged in `mass`
// (the registry's adds_mass), left to right in registry order; qv the
// vapor tracer:
//   dyn_prim_kernel (de-densitization; prim laid out as the concatenation
//     [s0, s1..s3 / r, s4, tr / r], r = s0 + hyc);
//   dyn_from_coupler_kernel (coupler -> dynamics):
//     p = rho_d R_d T + qv R_v T, rho = rho_d + m,
//     theta = (p / C0)^(1 / gamma) / rho,
//     s = [rho - hyc, rho u, rho v, rho w, rho theta - hyt], tr = the tracers;
//   dyn_to_coupler_kernel (dynamics -> coupler):
//     rho = s0 + hyc, u, v, w = s1..s3 / rho, theta = (s4 + hyt) / rho,
//     p = C0 (rho theta)^gamma, rho_d = rho - m, T = p / (rho_d R_d + qv R_v).
// Every add, subtract, multiply and divide is a round-to-nearest intrinsic
// in the plain version's order (no contraction), divisions are IEEE (by a
// number too: the plain versions divide by a 0-d tensor), and the file
// builds with contraction on (cuda_build.FMAD_SOURCES) so that pow rounds
// as PyTorch's own CUDA build does: each kernel gives its plain version's
// values bit for bit on the card.  Coefficients arrive as host doubles and
// are cast to the state type once, as PyTorch casts a Python scalar.
//
// What bounds them on the H100: bytes.  Per cell they move one value of
// every field they read or write and do a handful of operations (two pow
// in the conversions):
//   de-densitization   5 + ntr in, 5 + ntr out;
//   coupler -> dyn     5 + ntr in, 5 + ntr out;
//   dyn -> coupler     5 + the mass tracers and vapor in, 5 out (the
//                      coupler's tracers stay views of tr).
// At 1024x1024x100 f32 (0.419 GB a field) that is 2.0, 2.0 and 1.6 ms with
// Kessler's 3 tracers at 3.35 TB/s.
// Design: a block covers 256 x V consecutive cells of one (member, level)
// plane, V = 4 in f32 and 2 in f64, taken from blockIdx (x: the run in the
// plane, y: the plane), so a block's threads read one hydrostatic value
// each (the same address: one broadcast) and the index math has no 64-bit
// division.  A thread owns V consecutive cells and moves them as 16-byte
// streaming loads and stores where the plane is a whole number of vectors
// and every pointer is 16-byte aligned, else one by one (the same code,
// masked at the plane's end).  A thread issues the loads of the state's
// five fields, or of up to GROUP tracers, before it uses any of them, so
// several of its loads are in flight at once.  The tracer count and the
// mass flags are runtime arguments (at most MAX_TRACERS in the
// conversions, a 64-bit mask and a pointer table); the de-densitization
// takes any count.  Divisions with a zero dividend (most tracers in most
// cells) take div0's shortcut, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "exact_div.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TRACERS = 64;  // the mass mask's bits and the table's size
constexpr int GROUP = 4;         // tracers a thread loads before using them
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }

// a / b, IEEE, with div0's shortcut for a zero dividend (exact_div.cuh)
template <typename T>
__device__ __forceinline__ T quo(T a, T b) {
  if (a == T(0) && b != T(0) && b == b) return signed_zero(a, b);
  return rdiv(a, b);
}

// 16-byte vectors: V values of T.
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int N = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int N = 2; };

// The V cells a thread owns: their index within a field, how many lie in
// the plane, and whether they move as one 16-byte vector.
struct Cells {
  int64_t i;
  int n;
  bool vec;
};

template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void load(const T* __restrict__ p, const Cells& c, T (&o)[N]) {
  if (c.vec) {
    const typename Vec<T>::type v = __ldcs(reinterpret_cast<const typename Vec<T>::type*>(p + c.i));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = e[k];
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = k < c.n ? p[c.i + k] : T(0);
  }
}

template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void store(T* __restrict__ p, const Cells& c, const T (&o)[N]) {
  if (c.vec) {
    typename Vec<T>::type v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = o[k];
    __stcs(reinterpret_cast<typename Vec<T>::type*>(p + c.i), v);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < c.n) p[c.i + k] = o[k];
  }
}

// The cells of plane p a thread owns; n = 0 past the plane's end.
template <typename T>
__device__ __forceinline__ Cells cells_of(int64_t plane, int p, bool aligned) {
  constexpr int N = Vec<T>::N;
  const int64_t c0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * N;
  const int64_t left = plane - c0;
  return Cells{(int64_t)p * plane + c0, left <= 0 ? 0 : left < N ? (int)left : N, aligned};
}

// The tracer fields of a conversion, by pointer (the coupler's tracers are
// separate tensors).
template <typename T>
struct Tracers {
  const T* p[MAX_TRACERS];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dyn_prim_kernel(const T* __restrict__ s, const T* __restrict__ tr, const T* __restrict__ hyc,
                T* __restrict__ prim, int ntr, int64_t plane, int nplanes, bool aligned) {
  constexpr int N = Vec<T>::N;
  const int64_t field = plane * nplanes;
  for (int p = blockIdx.y; p < nplanes; p += gridDim.y) {
    const Cells c = cells_of<T>(plane, p, aligned);
    if (c.n == 0) return;
    const T h = hyc[p];
    T x[5][N];
#pragma unroll
    for (int v = 0; v < 5; ++v) load(s + v * field, c, x[v]);
    T r[N];
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = add(x[0][k], h);
#pragma unroll
    for (int v = 1; v < 4; ++v)
#pragma unroll
      for (int k = 0; k < N; ++k) x[v][k] = quo(x[v][k], r[k]);
#pragma unroll
    for (int v = 0; v < 5; ++v) store(prim + v * field, c, x[v]);
    for (int t0 = 0; t0 < ntr; t0 += GROUP) {
      T q[GROUP][N];
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (t0 + g < ntr) load(tr + (int64_t)(t0 + g) * field, c, q[g]);
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (t0 + g < ntr) {
#pragma unroll
          for (int k = 0; k < N; ++k) q[g][k] = quo(q[g][k], r[k]);
          store(prim + (int64_t)(5 + t0 + g) * field, c, q[g]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dyn_from_coupler_kernel(const T* __restrict__ rho_d, const T* __restrict__ u,
                        const T* __restrict__ v, const T* __restrict__ w,
                        const T* __restrict__ temp, const Tracers<T> trin,
                        const T* __restrict__ hyc, const T* __restrict__ hyt,
                        T* __restrict__ s, T* __restrict__ tr, int ntr, uint64_t mass,
                        int iwv, T R_d, T R_v, T inv_gamma, T C0, int64_t plane,
                        int nplanes, bool aligned) {
  constexpr int N = Vec<T>::N;
  const int64_t field = plane * nplanes;
  for (int p = blockIdx.y; p < nplanes; p += gridDim.y) {
    const Cells c = cells_of<T>(plane, p, aligned);
    if (c.n == 0) return;
    T rd[N], tk[N], m[N] = {}, qv[N] = {};
    load(rho_d, c, rd);
    load(temp, c, tk);
    bool have = false;
    for (int t0 = 0; t0 < ntr; t0 += GROUP) {
      T q[GROUP][N];
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (t0 + g < ntr) load(trin.p[t0 + g], c, q[g]);
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int t = t0 + g;
        if (t < ntr) {
          store(tr + (int64_t)t * field, c, q[g]);
          if ((mass >> t) & 1) {
#pragma unroll
            for (int k = 0; k < N; ++k) m[k] = have ? add(m[k], q[g][k]) : q[g][k];
            have = true;
          }
          if (t == iwv) {
#pragma unroll
            for (int k = 0; k < N; ++k) qv[k] = q[g][k];
          }
        }
      }
    }
    const T hc = hyc[p], ht = hyt[p];
    T rho[N], out[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T press = add(mul(mul(rd[k], R_d), tk[k]), mul(mul(qv[k], R_v), tk[k]));
      rho[k] = have ? add(rd[k], m[k]) : rd[k];
      const T theta = quo(tpow(quo(press, C0), inv_gamma), rho[k]);
      out[k] = sub(mul(rho[k], theta), ht);
    }
    store(s + 4 * field, c, out);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = sub(rho[k], hc);
    store(s, c, out);
    const T* const vel[3] = {u, v, w};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T x[N];
      load(vel[d], c, x);
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = mul(rho[k], x[k]);
      store(s + (1 + d) * field, c, x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dyn_to_coupler_kernel(const T* __restrict__ s, const T* __restrict__ tr,
                      const T* __restrict__ hyc, const T* __restrict__ hyt,
                      T* __restrict__ rho_d, T* __restrict__ u, T* __restrict__ v,
                      T* __restrict__ w, T* __restrict__ temp, uint64_t mass, int iwv,
                      T R_d, T R_v, T gamma, T C0, int64_t plane, int nplanes,
                      bool aligned) {
  constexpr int N = Vec<T>::N;
  const int64_t field = plane * nplanes;
  for (int p = blockIdx.y; p < nplanes; p += gridDim.y) {
    const Cells c = cells_of<T>(plane, p, aligned);
    if (c.n == 0) return;
    const T hc = hyc[p], ht = hyt[p];
    T x[5][N];
#pragma unroll
    for (int q = 0; q < 5; ++q) load(s + q * field, c, x[q]);
    T rho[N], press[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      rho[k] = add(x[0][k], hc);
      const T theta = quo(add(x[4][k], ht), rho[k]);
      press[k] = mul(C0, tpow(mul(rho[k], theta), gamma));
    }
    T* const vel[3] = {u, v, w};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int k = 0; k < N; ++k) x[1 + d][k] = quo(x[1 + d][k], rho[k]);
      store(vel[d], c, x[1 + d]);
    }
    // the tracers this needs, in registry order: the mass ones and vapor
    uint64_t need = mass | (1ull << iwv);
    T m[N] = {}, qv[N] = {};
    bool have = false;
    while (need) {
      int ts[GROUP];
      int ng = 0;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        ts[g] = need ? __ffsll((long long)need) - 1 : -1;
        if (need) {
          need &= need - 1;
          ++ng;
        }
      }
      T q[GROUP][N];
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (g < ng) load(tr + (int64_t)ts[g] * field, c, q[g]);
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (g < ng) {
          if ((mass >> ts[g]) & 1) {
#pragma unroll
            for (int k = 0; k < N; ++k) m[k] = have ? add(m[k], q[g][k]) : q[g][k];
            have = true;
          }
          if (ts[g] == iwv) {
#pragma unroll
            for (int k = 0; k < N; ++k) qv[k] = q[g][k];
          }
        }
      }
    }
    T rd[N], tk[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      rd[k] = have ? sub(rho[k], m[k]) : rho[k];
      tk[k] = quo(press[k], add(mul(rd[k], R_d), mul(qv[k], R_v)));
    }
    store(rho_d, c, rd);
    store(temp, c, tk);
  }
}

// Whether every pointer is 16-byte aligned and a plane a whole number of
// vectors.
template <typename T>
bool vectors(int64_t plane, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* q : ptrs) bits |= reinterpret_cast<uintptr_t>(q);
  return plane % Vec<T>::N == 0 && bits % 16 == 0;
}

template <typename T>
bool grid_of(int64_t plane, int nplanes, dim3& grid) {
  const int64_t per = (int64_t)THREADS * Vec<T>::N;
  const int64_t bx = (plane + per - 1) / per;
  if (plane < 1 || nplanes < 1 || bx > 2147483647LL) return false;
  grid = dim3((unsigned)bx, (unsigned)(nplanes < MAX_GRID_Y ? nplanes : MAX_GRID_Y));
  return true;
}

template <typename T>
int prim(const void* s, const void* tr, const void* hyc, void* out, int ntr,
         long long plane, int nplanes, void* stream) {
  dim3 grid;
  if (ntr < 0 || (ntr > 0 && tr == nullptr) || !grid_of<T>(plane, nplanes, grid))
    return (int)cudaErrorInvalidValue;
  const bool aligned = vectors<T>(plane, {s, tr, out});
  dyn_prim_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(tr), static_cast<const T*>(hyc),
      static_cast<T*>(out), ntr, plane, nplanes, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int from_coupler(const void* const* fields, const void* const* tracers, const void* hyc,
                 const void* hyt, void* s, void* tr, int ntr, uint64_t mass, int iwv,
                 double R_d, double R_v, double inv_gamma, double C0, long long plane,
                 int nplanes, void* stream) {
  dim3 grid;
  if (ntr < 1 || ntr > MAX_TRACERS || iwv < 0 || iwv >= ntr ||
      (ntr < 64 && (mass >> ntr) != 0) || !grid_of<T>(plane, nplanes, grid))
    return (int)cudaErrorInvalidValue;
  Tracers<T> table{};
  uintptr_t bits = 0;
  for (int t = 0; t < ntr; ++t) {
    table.p[t] = static_cast<const T*>(tracers[t]);
    bits |= reinterpret_cast<uintptr_t>(tracers[t]);
  }
  const bool aligned = bits % 16 == 0 &&
      vectors<T>(plane, {fields[0], fields[1], fields[2], fields[3], fields[4], s, tr});
  dyn_from_coupler_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fields[0]), static_cast<const T*>(fields[1]),
      static_cast<const T*>(fields[2]), static_cast<const T*>(fields[3]),
      static_cast<const T*>(fields[4]), table, static_cast<const T*>(hyc),
      static_cast<const T*>(hyt), static_cast<T*>(s), static_cast<T*>(tr), ntr, mass, iwv,
      (T)R_d, (T)R_v, (T)inv_gamma, (T)C0, plane, nplanes, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int to_coupler(const void* s, const void* tr, const void* hyc, const void* hyt,
               void* const* out, int ntr, uint64_t mass, int iwv, double R_d, double R_v,
               double gamma, double C0, long long plane, int nplanes, void* stream) {
  dim3 grid;
  if (ntr < 1 || ntr > MAX_TRACERS || iwv < 0 || iwv >= ntr ||
      (ntr < 64 && (mass >> ntr) != 0) || !grid_of<T>(plane, nplanes, grid))
    return (int)cudaErrorInvalidValue;
  const bool aligned = vectors<T>(plane, {s, tr, out[0], out[1], out[2], out[3], out[4]});
  dyn_to_coupler_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(tr), static_cast<const T*>(hyc),
      static_cast<const T*>(hyt), static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<T*>(out[2]), static_cast<T*>(out[3]), static_cast<T*>(out[4]), mass, iwv,
      (T)R_d, (T)R_v, (T)gamma, (T)C0, plane, nplanes, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dyn_prim_f32(const void* s, const void* tr, const void* hyc, void* out, int ntr,
                 long long plane, int nplanes, void* stream) {
  return prim<float>(s, tr, hyc, out, ntr, plane, nplanes, stream);
}

int dyn_prim_f64(const void* s, const void* tr, const void* hyc, void* out, int ntr,
                 long long plane, int nplanes, void* stream) {
  return prim<double>(s, tr, hyc, out, ntr, plane, nplanes, stream);
}

int dyn_from_coupler_f32(const void* const* fields, const void* const* tracers,
                         const void* hyc, const void* hyt, void* s, void* tr, int ntr,
                         uint64_t mass, int iwv, double R_d, double R_v, double inv_gamma,
                         double C0, long long plane, int nplanes, void* stream) {
  return from_coupler<float>(fields, tracers, hyc, hyt, s, tr, ntr, mass, iwv, R_d, R_v,
                             inv_gamma, C0, plane, nplanes, stream);
}

int dyn_from_coupler_f64(const void* const* fields, const void* const* tracers,
                         const void* hyc, const void* hyt, void* s, void* tr, int ntr,
                         uint64_t mass, int iwv, double R_d, double R_v, double inv_gamma,
                         double C0, long long plane, int nplanes, void* stream) {
  return from_coupler<double>(fields, tracers, hyc, hyt, s, tr, ntr, mass, iwv, R_d, R_v,
                              inv_gamma, C0, plane, nplanes, stream);
}

int dyn_to_coupler_f32(const void* s, const void* tr, const void* hyc, const void* hyt,
                       void* const* out, int ntr, uint64_t mass, int iwv, double R_d,
                       double R_v, double gamma, double C0, long long plane, int nplanes,
                       void* stream) {
  return to_coupler<float>(s, tr, hyc, hyt, out, ntr, mass, iwv, R_d, R_v, gamma, C0, plane,
                           nplanes, stream);
}

int dyn_to_coupler_f64(const void* s, const void* tr, const void* hyc, const void* hyt,
                       void* const* out, int ntr, uint64_t mass, int iwv, double R_d,
                       double R_v, double gamma, double C0, long long plane, int nplanes,
                       void* stream) {
  return to_coupler<double>(s, tr, hyc, hyt, out, ntr, mass, iwv, R_d, R_v, gamma, C0, plane,
                            nplanes, stream);
}

const char* dycore_state_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
