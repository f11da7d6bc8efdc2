// Flux-corrected transport of the dycore's tracers, for NVIDIA Hopper
// (sm_90a): the per-cell multiplier and the scaled tracer divergence of one
// direction.
//
// fct_scale_div replaces the Pallas TPU kernels of
// miniweatherml_tpu/ops/pallas_recon.py: fct_scale_div_pallas (x, lane axis,
// pallas_call at :1084) and fct_scale_div_pallas_sub (y and z, sublane axis,
// pallas_call at :1151), both bodies of _fct_scale_div_kernel.  fct_mult
// replaces the XLA fusion that forms the multiplier
// (miniweatherml_tpu/dycore/euler.py:880-889); it reads the unscaled faces
// directly instead of outflow partials emitted by the flux kernel.
//
// Math (ops/fct.py holds the plain PyTorch versions, operation for
// operation; --fmad=false keeps every product and sum rounded on its own):
//   fct_mult:  mass_avail = max(tr, 0) * vol
//              fo_d = (max(F[f+1], 0) - min(F[f], 0)) / d      (d = dx, dy, dz)
//              mass_out = ((fo_x + fo_y) + fo_z) * dt * vol
//              mult = mass_out > mass_avail ? mass_avail / max(mass_out, tiny) : 1
//              (1 for tracers not flagged positive)
//   fct_scale_div, one direction, face f between cells f-1 and f:
//              fs = F * (F > 0 ? mult[f-1] : F < 0 ? mult[f] : 1), 1 off the axis
//              (on a split axis, off the shard: the neighbour shard's
//              boundary multiplier, from the m_lo / m_hi planes, as the JAX
//              package's _fct_scale_dir with exchange_face_scalar)
//              acc = (fs_lo - fs_hi) * dxi  [+ t_prev before it]
//              epilogue: v = c0*tr0 [+ c1*tr1] + cdt*acc, clamped at 0 for
//              the tracers flagged positive (the SSPRK3 tracer stage update)
// Clamps propagate NaN as torch.clamp does (x < lo ? lo : x).  Coefficients
// arrive as host doubles and are cast to the state type once, as PyTorch
// casts a Python scalar; none is formed in the kernel.
//
// What bounds it on the H100: bytes.  Both kernels do a few flops per value
// moved.  Per tracer cell, in values (4 B in f32, 8 B in f64):
//   fct_mult      reads tr and 6 faces (x, y, z lo/hi; neighbours' faces
//                 come from L1/L2, so ~4 from memory), writes mult: ~5;
//   fct_scale_div reads F (n+1)/n and mult, writes the tendency: ~3 for x;
//                 + t_prev read for z: ~4; + tr0 [+ tr1] for the y pass with
//                 the epilogue: 5-6.
// At 512x512x64 with 9 tracers (151 M values, 0.60 GB per array in f32)
// that is ~3.0 GB for fct_mult and ~1.8 / 2.4 / 3.3 GB for the x / z / y
// passes: ~3.1 ms per right-hand side at 3.35 TB/s.
// fct_mult's design: a block covers rows of one (tracer, ens, level) plane,
// taken from blockIdx (x: rows, y: level, z: tracer x ens), so the index
// math has no 64-bit division.  A tracer whose positive bit is unset is a
// whole plane: its blocks store 1 and read nothing.  Each thread owns VEC
// consecutive cells of a row (4 in f32, 2 in f64) and moves them with
// 16-byte loads of tr, the two Fy rows and the two Fz planes and a 16-byte
// store of mult.  Fx rows hold nx + 1 values and so start at any alignment:
// each lane loads the aligned vector that holds its first value, takes its
// neighbour's vector by shuffle, and picks its VEC + 1 faces at the warp's
// offset.  All of a thread's loads are issued before the first shuffle.
// When nx is no multiple of VEC (or a pointer is not 16-byte aligned) the
// same code moves the cells one by one, masked at the row end.  The
// divisions stay exact IEEE, in fct_mult_plain's order, so the result is
// the plain version's bit for bit; most of their dividends are zero (no
// outflow of a tracer absent from the cell), so they take div0's shortcut
// (exact_div.cuh) instead of the division's slow path.  A march of several
// levels per block, with the next level's loads in flight, needed 96
// registers and ran slower than one level per block at 64 (PERF.md).
// fct_scale_div's design: one thread per output value in a flat grid; it views a
// direction as (outer, n, inner), the view direction_fluxes.cu uses, with
// `inner` fastest, so neighbouring threads read neighbouring addresses for
// x (inner = 1, along the row) and for y and z (inner = nx or ny*nx).  The
// neighbour multipliers a face needs are the neighbouring threads' own
// reads, served by L1/L2.  Writing into t_prev in place is safe: each
// thread reads and writes only its own element of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }

template <typename T> struct Tiny;
template <> struct Tiny<float> { static constexpr float v = 1e-30f; };
template <> struct Tiny<double> { static constexpr double v = 1e-300; };

// 16-byte vectors: VEC values of T.
template <typename T> struct Vec;
template <> struct Vec<float> { using V = float4; static constexpr int N = 4; };
template <> struct Vec<double> { using V = double2; static constexpr int N = 2; };

// VEC values at p[i..]: one 16-byte load when `vec`, else one by one, the
// first `nvalid` of them (0 beyond).
template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void load_cells(const T* __restrict__ p, int64_t i,
                                           int nvalid, bool vec, T (&o)[N]) {
  if (vec) {
    const typename Vec<T>::V v =
        *reinterpret_cast<const typename Vec<T>::V*>(p + i);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int c = 0; c < N; ++c) o[c] = e[c];
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) o[c] = c < nvalid ? p[i + c] : T(0);
  }
}

template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void store_cells(T* __restrict__ p, int64_t i,
                                            int nvalid, bool vec,
                                            const T (&o)[N]) {
  if (vec) {
    typename Vec<T>::V v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int c = 0; c < N; ++c) e[c] = o[c];
    *reinterpret_cast<typename Vec<T>::V*>(p + i) = v;
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < nvalid) p[i + c] = o[c];
  }
}

// The aligned vector of Fx at element a (a multiple of VEC), masked at the
// end of the array.
template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void load_aligned(const T* __restrict__ p,
                                             int64_t a, int64_t total,
                                             T (&o)[N]) {
  const int64_t left = total - a;
  load_cells<T, N>(p, a, left < N ? (int)left : N, left >= N, o);
}

// w[M .. M + N]: the VEC + 1 faces of a lane whose first face sits M values
// into its aligned vector (M is the same for the whole warp).
template <int M, typename T, int N>
__device__ __forceinline__ void pick_faces(const T (&w)[2 * N],
                                           T (&f)[N + 1]) {
  if constexpr (M < N) {
#pragma unroll
    for (int c = 0; c <= N; ++c) f[c] = w[M + c];
  }
}

// Issue the loads of Fx[fx0 + i0 .. fx0 + i0 + N] into fa, fb: on the vector
// path each lane loads the aligned vector that holds its first face (fa;
// lane 31 also the next one, fb), m being the warp's offset into it; one by
// one else (fa, then the last face in fb[0]).  fx_faces picks the faces once
// the loads have landed, so every load of a thread is in flight at once.
template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void load_fx(const T* __restrict__ Fx, int64_t fx0,
                                        int base, int i0, int nvalid,
                                        int64_t fx_total, bool vec,
                                        T (&fa)[N], T (&fb)[N], int& m) {
  if (!vec) {
#pragma unroll
    for (int c = 0; c < N; ++c) fa[c] = c <= nvalid ? Fx[fx0 + i0 + c] : T(0);
    fb[0] = N <= nvalid ? Fx[fx0 + i0 + N] : T(0);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t w0 = fx0 + base + (int64_t)(threadIdx.x - lane) * N;
  m = (int)(w0 & (N - 1));
  const int64_t a = w0 - m + (int64_t)lane * N;
  load_aligned<T, N>(Fx, a, fx_total, fa);
  if (lane == 31) load_aligned<T, N>(Fx, a + N, fx_total, fb);
}

// The VEC + 1 x faces of a lane from what load_fx loaded (on the vector path
// every lane of the warp calls it: the neighbour's vector comes by shuffle).
template <typename T, int N = Vec<T>::N>
__device__ __forceinline__ void fx_faces(const T (&fa)[N], const T (&fb)[N],
                                         int m, bool vec, T (&fx)[N + 1]) {
  if (!vec) {
#pragma unroll
    for (int c = 0; c < N; ++c) fx[c] = fa[c];
    fx[N] = fb[0];
    return;
  }
  T w[2 * N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const T up = __shfl_down_sync(0xffffffffu, fa[c], 1);
    w[c] = fa[c];
    w[N + c] = (threadIdx.x & 31) == 31 ? fb[c] : up;
  }
  switch (m) {
    case 0: pick_faces<0, T, N>(w, fx); break;
    case 1: pick_faces<1, T, N>(w, fx); break;
    case 2: pick_faces<2, T, N>(w, fx); break;
    default: pick_faces<3, T, N>(w, fx); break;
  }
}

// At most 64 registers, so that four 256-thread blocks (32 warps) share an
// SM: 48 KB of loads in flight per SM.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
fct_mult_kernel(const T* __restrict__ tr, const T* __restrict__ Fx,
                const T* __restrict__ Fy, const T* __restrict__ Fz,
                T* __restrict__ mult, int nens, int nz, int ny, int nx,
                int64_t fx_total, uint64_t mask, bool vec, T dt, T dx, T dy,
                T dz, T vol) {
  constexpr int N = Vec<T>::N;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= ny) return;  // whole warps: blockDim.x is a multiple of 32
  const int k = blockIdx.y;
  const int q = blockIdx.z;  // tracer * nens + ens
  const bool flagged = (mask >> (q / nens)) & 1ULL;
  const int64_t row = ((int64_t)q * nz + k) * ny + j;
  const int64_t cell0 = row * nx;                        // tr, mult
  const int64_t fx0 = row * (nx + 1);                    // Fx
  const int64_t fy0 = (((int64_t)q * nz + k) * (ny + 1) + j) * nx;
  const int64_t plane = (int64_t)ny * nx;
  const int64_t fz0 = (((int64_t)q * (nz + 1) + k) * ny + j) * nx;
  for (int base = 0; base < nx; base += blockDim.x * N) {
    const int i0 = base + threadIdx.x * N;
    const int nvalid = nx - i0;  // <= 0 on the lanes past the row's end
    if (!flagged) {
      T ones[N];
#pragma unroll
      for (int c = 0; c < N; ++c) ones[c] = T(1);
      if (nvalid > 0) store_cells<T, N>(mult, cell0 + i0, nvalid, vec, ones);
      continue;
    }
    T fa[N], fb[N], t[N], zl[N], zh[N], yl[N], yh[N], fx[N + 1], out[N];
    int m = 0;
    load_fx<T, N>(Fx, fx0, base, i0, nvalid, fx_total, vec, fa, fb, m);
    if (nvalid > 0) {
      load_cells<T, N>(tr, cell0 + i0, nvalid, vec, t);
      load_cells<T, N>(Fz, fz0 + i0, nvalid, vec, zl);
      load_cells<T, N>(Fz, fz0 + plane + i0, nvalid, vec, zh);
      if (Fy != nullptr) {
        load_cells<T, N>(Fy, fy0 + i0, nvalid, vec, yl);
        load_cells<T, N>(Fy, fy0 + nx + i0, nvalid, vec, yh);
      }
    }
    fx_faces<T, N>(fa, fb, m, vec, fx);
    if (nvalid <= 0) continue;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const T avail = clamp_min(t[c], T(0)) * vol;
      const T fo_x =
          div0(clamp_min(fx[c + 1], T(0)) - clamp_max(fx[c], T(0)), dx);
      T fo_y = T(0);
      if (Fy != nullptr)
        fo_y = div0(clamp_min(yh[c], T(0)) - clamp_max(yl[c], T(0)), dy);
      const T fo_z = div0(clamp_min(zh[c], T(0)) - clamp_max(zl[c], T(0)), dz);
      const T o = (fo_x + fo_y + fo_z) * dt * vol;
      out[c] = o > avail ? div0(avail, clamp_min(o, Tiny<T>::v)) : T(1);
    }
    store_cells<T, N>(mult, cell0 + i0, nvalid, vec, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fct_scale_div_kernel(const T* __restrict__ F, const T* __restrict__ mult,
                     const T* tprev, const T* __restrict__ tr0,
                     const T* __restrict__ tr1, const T* __restrict__ m_lo,
                     const T* __restrict__ m_hi, T* out, int64_t outer, int n,
                     int64_t inner, int64_t per_tr, uint64_t mask, T c0, T c1,
                     T cdt, T dxi) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t line = (int64_t)n * inner;
  if (idx >= outer * line) return;
  const int64_t o = idx / line;
  const int64_t rem = idx - o * line;
  const int a = (int)(rem / inner);
  const int64_t lo = o * (line + inner) + rem;  // face a; face a+1 at lo + inner
  const T Flo = F[lo], Fhi = F[lo + inner];
  const T m = mult[idx];
  // beyond either end: 1, or the neighbour shard's boundary multiplier
  // (plane index o * inner + the position across the line)
  const T m_prev = a > 0 ? mult[idx - inner]
                         : (m_lo != nullptr ? m_lo[o * inner + rem] : T(1));
  const T m_next = a < n - 1
                       ? mult[idx + inner]
                       : (m_hi != nullptr ? m_hi[o * inner + rem - a * inner]
                                          : T(1));
  const T fs_lo = Flo * (Flo > T(0) ? m_prev : (Flo < T(0) ? m : T(1)));
  const T fs_hi = Fhi * (Fhi > T(0) ? m : (Fhi < T(0) ? m_next : T(1)));
  T acc = (fs_lo - fs_hi) * dxi;
  if (tprev != nullptr) acc = tprev[idx] + acc;
  if (tr0 != nullptr) {
    T v = c0 * tr0[idx];
    if (tr1 != nullptr) v = v + c1 * tr1[idx];
    v = v + cdt * acc;
    const int t = (int)(o / per_tr);
    acc = ((mask >> t) & 1ULL) ? clamp_min(v, T(0)) : v;
  }
  out[idx] = acc;
}

inline unsigned blocks_for(int64_t total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

template <typename T>
int scale_div(const void* F, const void* mult, const void* tprev,
              const void* tr0, const void* tr1, const void* m_lo,
              const void* m_hi, void* out, long long outer,
              int n, long long inner, long long per_tr, uint64_t mask,
              double c0, double c1, double cdt, double dxi, void* stream) {
  const int64_t total = (int64_t)outer * n * inner;
  if (total <= 0 || n < 1 || per_tr < 1 ||
      (m_lo == nullptr) != (m_hi == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((total + THREADS - 1) / THREADS > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  fct_scale_div_kernel<T><<<blocks_for(total), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(mult),
      static_cast<const T*>(tprev), static_cast<const T*>(tr0),
      static_cast<const T*>(tr1), static_cast<const T*>(m_lo),
      static_cast<const T*>(m_hi), static_cast<T*>(out), outer, n, inner,
      per_tr, mask, (T)c0, (T)c1, (T)cdt, (T)dxi);
  return (int)cudaGetLastError();
}

template <typename T>
int multiplier(const void* tr, const void* Fx, const void* Fy, const void* Fz,
               void* mult, int ntr, int nens, int nz, int ny, int nx,
               uint64_t mask, double dt, double dx, double dy, double dz,
               double vol, void* stream) {
  constexpr int N = Vec<T>::N;
  if (ntr < 1 || nens < 1 || nz < 1 || ny < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  if (nz > 65535 || (int64_t)ntr * nens > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // 16-byte access needs whole vectors per row and aligned arrays
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(tr) | reinterpret_cast<uintptr_t>(Fx) |
      reinterpret_cast<uintptr_t>(Fy) | reinterpret_cast<uintptr_t>(Fz) |
      reinterpret_cast<uintptr_t>(mult);
  const bool vec = nx % N == 0 && addr_bits % 16 == 0;
  // a row's threads: VEC cells each, a power of two from 32 to THREADS
  int bx = 32;
  while (bx < THREADS && bx * N < nx) bx *= 2;
  const dim3 block(bx, THREADS / bx);
  const dim3 grid((unsigned)((ny + block.y - 1) / block.y), (unsigned)nz,
                  (unsigned)(ntr * nens));
  fct_mult_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tr), static_cast<const T*>(Fx),
      static_cast<const T*>(Fy), static_cast<const T*>(Fz),
      static_cast<T*>(mult), nens, nz, ny, nx,
      (int64_t)ntr * nens * nz * ny * (nx + 1), mask, vec, (T)dt, (T)dx,
      (T)dy, (T)dz, (T)vol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fct_scale_div_f32(const void* F, const void* mult, const void* tprev,
                      const void* tr0, const void* tr1, const void* m_lo,
                      const void* m_hi, void* out,
                      long long outer, int n, long long inner,
                      long long per_tr, uint64_t mask, double c0, double c1,
                      double cdt, double dxi, void* stream) {
  return scale_div<float>(F, mult, tprev, tr0, tr1, m_lo, m_hi, out, outer,
                          n, inner,
                          per_tr, mask, c0, c1, cdt, dxi, stream);
}

int fct_scale_div_f64(const void* F, const void* mult, const void* tprev,
                      const void* tr0, const void* tr1, const void* m_lo,
                      const void* m_hi, void* out,
                      long long outer, int n, long long inner,
                      long long per_tr, uint64_t mask, double c0, double c1,
                      double cdt, double dxi, void* stream) {
  return scale_div<double>(F, mult, tprev, tr0, tr1, m_lo, m_hi, out, outer,
                           n, inner,
                           per_tr, mask, c0, c1, cdt, dxi, stream);
}

int fct_mult_f32(const void* tr, const void* Fx, const void* Fy,
                 const void* Fz, void* mult, int ntr, int nens, int nz, int ny,
                 int nx, uint64_t mask, double dt, double dx, double dy,
                 double dz, double vol, void* stream) {
  return multiplier<float>(tr, Fx, Fy, Fz, mult, ntr, nens, nz, ny, nx, mask,
                           dt, dx, dy, dz, vol, stream);
}

int fct_mult_f64(const void* tr, const void* Fx, const void* Fy,
                 const void* Fz, void* mult, int ntr, int nens, int nz, int ny,
                 int nx, uint64_t mask, double dt, double dx, double dy,
                 double dz, double vol, void* stream) {
  return multiplier<double>(tr, Fx, Fy, Fz, mult, ntr, nens, nz, ny, nx, mask,
                            dt, dx, dy, dz, vol, stream);
}

const char* fct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
