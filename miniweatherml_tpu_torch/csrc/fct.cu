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
// Design: one thread per output value in a flat grid.  fct_scale_div views a
// direction as (outer, n, inner), the view direction_fluxes.cu uses, with
// `inner` fastest, so neighbouring threads read neighbouring addresses for
// x (inner = 1, along the row) and for y and z (inner = nx or ny*nx).  The
// neighbour multipliers a face needs are the neighbouring threads' own
// reads, served by L1/L2.  Writing into t_prev in place is safe: each
// thread reads and writes only its own element of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }

template <typename T> struct Tiny;
template <> struct Tiny<float> { static constexpr float v = 1e-30f; };
template <> struct Tiny<double> { static constexpr double v = 1e-300; };

template <typename T>
__global__ void __launch_bounds__(THREADS)
fct_mult_kernel(const T* __restrict__ tr, const T* __restrict__ Fx,
                const T* __restrict__ Fy, const T* __restrict__ Fz,
                T* __restrict__ mult, int64_t total, int nens, int nz, int ny,
                int nx, uint64_t mask, T dt, T dx, T dy, T dz, T vol) {
  const int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (c >= total) return;
  const int i = (int)(c % nx);
  const int64_t r1 = c / nx;            // (t, e, k, j)
  const int j = (int)(r1 % ny);
  const int64_t r2 = r1 / ny;           // (t, e, k)
  const int k = (int)(r2 % nz);
  const int64_t q = r2 / nz;            // (t, e)
  const int t = (int)(q / nens);
  if (!((mask >> t) & 1ULL)) {
    mult[c] = T(1);
    return;
  }
  const T avail = clamp_min(tr[c], T(0)) * vol;
  const int64_t ix = r1 * (nx + 1) + i;
  const T fo_x = (clamp_min(Fx[ix + 1], T(0)) - clamp_max(Fx[ix], T(0))) / dx;
  T fo_y = T(0);
  if (Fy != nullptr) {
    const int64_t iy = (r2 * (ny + 1) + j) * nx + i;
    fo_y = (clamp_min(Fy[iy + nx], T(0)) - clamp_max(Fy[iy], T(0))) / dy;
  }
  const int64_t plane = (int64_t)ny * nx;
  const int64_t iz = (q * (nz + 1) + k) * plane + (int64_t)j * nx + i;
  const T fo_z = (clamp_min(Fz[iz + plane], T(0)) - clamp_max(Fz[iz], T(0))) / dz;
  const T out = (fo_x + fo_y + fo_z) * dt * vol;
  mult[c] = out > avail ? avail / clamp_min(out, Tiny<T>::v) : T(1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fct_scale_div_kernel(const T* __restrict__ F, const T* __restrict__ mult,
                     const T* tprev, const T* __restrict__ tr0,
                     const T* __restrict__ tr1, T* out, int64_t outer, int n,
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
  const T m_prev = a > 0 ? mult[idx - inner] : T(1);
  const T m_next = a < n - 1 ? mult[idx + inner] : T(1);
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
              const void* tr0, const void* tr1, void* out, long long outer,
              int n, long long inner, long long per_tr, uint64_t mask,
              double c0, double c1, double cdt, double dxi, void* stream) {
  const int64_t total = (int64_t)outer * n * inner;
  if (total <= 0 || n < 1 || per_tr < 1) return (int)cudaErrorInvalidValue;
  if ((total + THREADS - 1) / THREADS > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  fct_scale_div_kernel<T><<<blocks_for(total), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(mult),
      static_cast<const T*>(tprev), static_cast<const T*>(tr0),
      static_cast<const T*>(tr1), static_cast<T*>(out), outer, n, inner,
      per_tr, mask, (T)c0, (T)c1, (T)cdt, (T)dxi);
  return (int)cudaGetLastError();
}

template <typename T>
int multiplier(const void* tr, const void* Fx, const void* Fy, const void* Fz,
               void* mult, int ntr, int nens, int nz, int ny, int nx,
               uint64_t mask, double dt, double dx, double dy, double dz,
               double vol, void* stream) {
  const int64_t total = (int64_t)ntr * nens * nz * ny * nx;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  if ((total + THREADS - 1) / THREADS > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  fct_mult_kernel<T><<<blocks_for(total), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tr), static_cast<const T*>(Fx),
      static_cast<const T*>(Fy), static_cast<const T*>(Fz),
      static_cast<T*>(mult), total, nens, nz, ny, nx, mask, (T)dt, (T)dx,
      (T)dy, (T)dz, (T)vol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fct_scale_div_f32(const void* F, const void* mult, const void* tprev,
                      const void* tr0, const void* tr1, void* out,
                      long long outer, int n, long long inner,
                      long long per_tr, uint64_t mask, double c0, double c1,
                      double cdt, double dxi, void* stream) {
  return scale_div<float>(F, mult, tprev, tr0, tr1, out, outer, n, inner,
                          per_tr, mask, c0, c1, cdt, dxi, stream);
}

int fct_scale_div_f64(const void* F, const void* mult, const void* tprev,
                      const void* tr0, const void* tr1, void* out,
                      long long outer, int n, long long inner,
                      long long per_tr, uint64_t mask, double c0, double c1,
                      double cdt, double dxi, void* stream) {
  return scale_div<double>(F, mult, tprev, tr0, tr1, out, outer, n, inner,
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
