// P3 lookup-table interpolation for NVIDIA Hopper (sm_90a): the ice table
// (trilinear), the ice-rain collection table (quadrilinear of log10 values,
// then 10**) and the generated rain rows (linear).
//
// Replaces the Pallas TPU kernels of miniweatherml_tpu/physics/
// p3_pallas_lookup.py: interp_ice_pallas / interp_collect_pallas /
// interp_rain_pallas (pallas_call in _call, :155) and their lane forms
// interp_ice_lane / interp_collect_lane (_wide_call, :292) and
// interp_rain_lane (:486).  Those build one-hot weight rows and contract
// them with the table on the MXU, because a gather is near-scalar on the
// TPU.  On Hopper a gather from L1/L2 is the natural form, so this is the
// reference's access_lookup_table (micro_p3.F90:1508-1556) as one thread
// per cell.
//
// What bounds it on the H100: bytes.  Per cell it reads 3-4 int32 indices
// and as many fractions and writes K values; the corner reads (8 per ice
// column, 16 per collect column, 2 per rain row) hit the tables through the
// read-only cache: the largest, the collect table at K = 2, is 240 KB in
// f32 and stays in L2.  The thread does the corner sums in the order of the
// plain version (p3_lookup_cuda.py) and writes K contiguous output planes,
// so stores coalesce.  `present` (a device bool, may be null) is the
// presence gate: when it is false the kernel writes zeros and reads no
// table.  Indices are clamped into the table so that no index can fault
// (the index finders never produce one outside it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ISIZE = 50, RIMSIZE = 4, DENSIZE = 5, RCOLLSIZE = 30;
constexpr int THREADS = 256;

__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T f) { return a + f * (b - a); }

template <typename T>
__global__ void ice_kernel(const T* __restrict__ table, int K,
                           const int* __restrict__ i0p,
                           const T* __restrict__ fip,
                           const int* __restrict__ ii0p,
                           const T* __restrict__ fiip,
                           const int* __restrict__ jj0p,
                           const T* __restrict__ fjjp,
                           const bool* __restrict__ present,
                           T* __restrict__ out, int64_t n) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  if (present && !*present) {
    for (int k = 0; k < K; ++k) out[k * n + c] = T(0);
    return;
  }
  const int i0 = clampi(i0p[c], 0, ISIZE - 2);
  const int ii0 = clampi(ii0p[c], 0, RIMSIZE - 2);
  const int jj0 = clampi(jj0p[c], 0, DENSIZE - 2);
  const T fi = fip[c], fii = fiip[c], fjj = fjjp[c];
  for (int k = 0; k < K; ++k) {
    const T* t = table + (int64_t)k * DENSIZE * RIMSIZE * ISIZE;
    auto lin_i = [&](int jj, int ii) {
      const T* row = t + (jj * RIMSIZE + ii) * ISIZE + i0;
      return lerp(__ldg(row), __ldg(row + 1), fi);
    };
    auto lin_ii = [&](int jj) {
      return lerp(lin_i(jj, ii0), lin_i(jj, ii0 + 1), fii);
    };
    out[k * n + c] = lerp(lin_ii(jj0), lin_ii(jj0 + 1), fjj);
  }
}

template <typename T>
__global__ void collect_kernel(const T* __restrict__ table, int K,
                               const int* __restrict__ i0p,
                               const T* __restrict__ fip,
                               const int* __restrict__ ii0p,
                               const T* __restrict__ fiip,
                               const int* __restrict__ jj0p,
                               const T* __restrict__ fjjp,
                               const int* __restrict__ j0p,
                               const T* __restrict__ fjp,
                               const bool* __restrict__ present,
                               T* __restrict__ out, int64_t n) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  if (present && !*present) {
    for (int k = 0; k < K; ++k) out[k * n + c] = T(0);
    return;
  }
  const int i0 = clampi(i0p[c], 0, ISIZE - 2);
  const int ii0 = clampi(ii0p[c], 0, RIMSIZE - 2);
  const int jj0 = clampi(jj0p[c], 0, DENSIZE - 2);
  const int j0 = clampi(j0p[c], 0, RCOLLSIZE - 2);
  const T fi = fip[c], fii = fiip[c], fjj = fjjp[c], fj = fjp[c];
  for (int k = 0; k < K; ++k) {
    const T* t = table + (int64_t)k * DENSIZE * RIMSIZE * ISIZE * RCOLLSIZE;
    auto lin_j = [&](int jj, int ii, int i) {
      const T* row = t + ((jj * RIMSIZE + ii) * ISIZE + i) * RCOLLSIZE + j0;
      return lerp(__ldg(row), __ldg(row + 1), fj);
    };
    auto lin_i = [&](int jj, int ii) {
      return lerp(lin_j(jj, ii, i0), lin_j(jj, ii, i0 + 1), fi);
    };
    auto lin_ii = [&](int jj) {
      return lerp(lin_i(jj, ii0), lin_i(jj, ii0 + 1), fii);
    };
    out[k * n + c] = tpow(T(10), lerp(lin_ii(jj0), lin_ii(jj0 + 1), fjj));
  }
}

template <typename T>
__global__ void rain_kernel(const T* __restrict__ rows, int K, int size,
                            const int* __restrict__ i0p,
                            const T* __restrict__ fip,
                            const bool* __restrict__ present,
                            T* __restrict__ out, int64_t n) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  if (present && !*present) {
    for (int k = 0; k < K; ++k) out[k * n + c] = T(0);
    return;
  }
  const int i0 = clampi(i0p[c], 0, size - 2);
  const T fi = fip[c];
  for (int k = 0; k < K; ++k) {
    const T* row = rows + (int64_t)k * size + i0;
    out[k * n + c] = lerp(__ldg(row), __ldg(row + 1), fi);
  }
}

int blocks_for(long long n, unsigned* blocks) {
  const long long b = (n + THREADS - 1) / THREADS;
  if (n < 0 || b > 2147483647LL) return cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return cudaSuccess;
}

template <typename T>
int launch_ice(const void* table, int K, const void* i0, const void* fi,
               const void* ii0, const void* fii, const void* jj0,
               const void* fjj, const void* present, void* out, long long n,
               void* stream) {
  unsigned blocks;
  if (int e = blocks_for(n, &blocks)) return e;
  if (n == 0) return cudaSuccess;
  ice_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), K, static_cast<const int*>(i0),
      static_cast<const T*>(fi), static_cast<const int*>(ii0),
      static_cast<const T*>(fii), static_cast<const int*>(jj0),
      static_cast<const T*>(fjj), static_cast<const bool*>(present),
      static_cast<T*>(out), (int64_t)n);
  return cudaGetLastError();
}

template <typename T>
int launch_collect(const void* table, int K, const void* i0, const void* fi,
                   const void* ii0, const void* fii, const void* jj0,
                   const void* fjj, const void* j0, const void* fj,
                   const void* present, void* out, long long n, void* stream) {
  unsigned blocks;
  if (int e = blocks_for(n, &blocks)) return e;
  if (n == 0) return cudaSuccess;
  collect_kernel<T><<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), K, static_cast<const int*>(i0),
      static_cast<const T*>(fi), static_cast<const int*>(ii0),
      static_cast<const T*>(fii), static_cast<const int*>(jj0),
      static_cast<const T*>(fjj), static_cast<const int*>(j0),
      static_cast<const T*>(fj), static_cast<const bool*>(present),
      static_cast<T*>(out), (int64_t)n);
  return cudaGetLastError();
}

template <typename T>
int launch_rain(const void* rows, int K, int size, const void* i0,
                const void* fi, const void* present, void* out, long long n,
                void* stream) {
  unsigned blocks;
  if (int e = blocks_for(n, &blocks)) return e;
  if (size < 2) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  rain_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), K, size, static_cast<const int*>(i0),
      static_cast<const T*>(fi), static_cast<const bool*>(present),
      static_cast<T*>(out), (int64_t)n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define P3_LOOKUP_ENTRY(SUF, T)                                               \
  int p3_interp_ice_##SUF(const void* table, int K, const void* i0,           \
                          const void* fi, const void* ii0, const void* fii,   \
                          const void* jj0, const void* fjj,                   \
                          const void* present, void* out, long long n,        \
                          void* stream) {                                     \
    return launch_ice<T>(table, K, i0, fi, ii0, fii, jj0, fjj, present, out,  \
                         n, stream);                                          \
  }                                                                           \
  int p3_interp_collect_##SUF(const void* table, int K, const void* i0,       \
                              const void* fi, const void* ii0,                \
                              const void* fii, const void* jj0,               \
                              const void* fjj, const void* j0,                \
                              const void* fj, const void* present, void* out, \
                              long long n, void* stream) {                    \
    return launch_collect<T>(table, K, i0, fi, ii0, fii, jj0, fjj, j0, fj,    \
                             present, out, n, stream);                        \
  }                                                                           \
  int p3_interp_rain_##SUF(const void* rows, int K, int size, const void* i0, \
                           const void* fi, const void* present, void* out,    \
                           long long n, void* stream) {                       \
    return launch_rain<T>(rows, K, size, i0, fi, present, out, n, stream);    \
  }

P3_LOOKUP_ENTRY(f32, float)
P3_LOOKUP_ENTRY(f64, double)

const char* p3_lookup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
