// P3 sedimentation for NVIDIA Hopper (sm_90a): the fastest fall speed of
// the state (sed_vmax) and the CFL-sub-cycled upstream fall of cloud, rain
// and ice (sed_columns), with the sub-step count read on the device.
//
// Replaces the JAX scheme's sedimentation, miniweatherml_tpu/physics/
// p3.py:1268-1388: the per-cell fall speeds, their maximum and the
// lax.while_loop (:1383) whose trip count nsub never leaves the device.  It
// is no Pallas kernel: XLA runs that loop on the TPU.  The plain versions
// are p3._p3_sed_vmax and p3._p3_sed_columns (a Python loop that reads nsub
// to the host); each kernel is a line-by-line transcription of them.
//
// sed_vmax: one thread per cell on a persistent grid computes the three
// mass-weighted speeds of the current state (rain V_qr from the generated
// vm row, ice V_qit from ice column 2, cloud V_qc from the Stokes law) and
// the block's maximum goes to a device scalar by an atomic max on the bit
// pattern: exact, since every speed is >= 0 (a gated-out cell gives 0), and
// a NaN comes through as the largest pattern, as torch.max lets it
// through.  The caller turns the maximum into nsub = max(ceil(dt vmax /
// (0.9 dz_min)), 1), a 0-d device tensor (after pmax / pmin on a mesh).
//
// sed_columns: one thread per (ens, y, x) column, so a warp covers 32
// neighbouring x columns and every load and store coalesces.  The thread
// reads nsub from device memory and runs the whole sub-cycle loop itself:
// sedimentation is purely vertical, so columns never meet.  Each sub-step
// marches from the top level down; at each level it recomputes the speeds
// with their persisted write-backs (nr, ni, qm, bm, nc), takes the eight
// downward fluxes rho q v, and updates the level from its own flux and the
// flux of the level above, which it carries in registers:
//   dq = dts (flux[k+1] - flux[k]) / (rho dz)[k],  -dts flux[top] / (rho dz)
// at the top, clamped at 0; the bottom level's fluxes feed the surface
// accumulators.  The falls are those of the plain version, in its order:
// qc (and nc with do_predict_nc) at V_qc, qr at V_qr, nr at V_nr, qi at
// V_qit, ni at V_nit, qm and bm at V_qit.  Sub-step 0 reads the inputs, the
// later ones the outputs a thread has written itself.  A count outside
// [1, NSUB_MAX] (a NaN or infinite speed) gives NaN everywhere, where the
// plain version's host read would raise.
//
// The ice table columns (2, 1, 7, 8) in p3_lookup's packed layout and the
// rain vm / vn rows are staged in shared memory once per block by cp.async
// (16 KB + 2.4 KB in f32), and both kernels call p3_interp.cuh's
// interpolations inline, so the lookups cost no launch and no pass over the
// field.  Template parameters: T (f32, f64), the table tier or the
// continuous [approx] tier, and do_predict_nc.
//
// What bounds it on the H100: bytes.  sed_vmax reads 11 fields once;
// sed_columns reads 11 and writes 8 per sub-step (f32: 76 B a cell), plus
// the two surface fields.  Per level it evaluates some ten transcendentals
// (pow, exp, lgamma, log10), but only where the species is present.
//
// Numbers: the file builds with --fmad=false, as p3_cellwise.cu does, so
// every add, multiply and division rounds as in the plain versions (a
// tensor divided by a number is a division there, through _div; a number
// divided by a tensor is PyTorch's reciprocal times the number, written so
// here); pow, exp, lgamma and log10 need not round as PyTorch's do, so the
// kernels agree with their plain versions to a few ulps, and nsub agrees
// unless dt vmax / (0.9 dz_min) lies within those ulps of an integer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "p3_index.cuh"
#include "p3_interp.cuh"
#include "p3_math.cuh"

namespace {

constexpr int VMAX_THREADS = 256, COL_THREADS = 128;
constexpr int ICE_K = 4;  // ice columns 2, 1, 7, 8
constexpr double NSUB_MAX = 65536.0;

// The staged tables: the packed ice table (bs values per (jj, ii) block, es
// per entry) and the vm row followed by the vn row, rsize values each.
template <typename T> struct SedTables {
  const T* ice;
  const T* rain;
  int bs, es, rsize;
};

template <typename T> __host__ __device__ constexpr int ice_w() { return vec_width<T>(ICE_K); }

template <typename T> size_t sed_smem_bytes(bool tab, int rsize) {
  if (!tab) return 0;
  return ice_table_bytes<T>(ICE_K) + (size_t)2 * rsize * sizeof(T);
}

template <typename T, bool TAB>
__device__ SedTables<T> stage_tables(unsigned char* smem, const T* ice, const T* rain,
                                     int rsize) {
  SedTables<T> tb{};
  if (TAB) {
    constexpr int W = ice_w<T>();
    const int kp = round_up(ICE_K, W);
    const size_t ice_bytes = ice_table_bytes<T>(ICE_K);
    for (size_t v = threadIdx.x; v < ice_bytes / 16; v += blockDim.x)
      copy16(smem + 16 * v, reinterpret_cast<const unsigned char*>(ice) + 16 * v);
    stage(smem + ice_bytes, rain, (size_t)2 * rsize * sizeof(T));
    tb.ice = reinterpret_cast<const T*>(smem);
    tb.rain = reinterpret_cast<const T*>(smem + ice_bytes);
    tb.bs = ice_block(kp, W);
    tb.es = ice_entry(kp, W);
    tb.rsize = rsize;
  }
  return tb;
}

// (V_qc, nc) of p3._cloud_sed_speeds, nc written back
template <typename T>
__device__ __forceinline__ T cloud_speed(T qc, T& nc, T rho, T temp) {
  if (!(qc >= T(QSMALL))) return T(0);
  const T qc_c = tmin(qc, T(5.1e-3));
  const T nc_l = cloud_dsd2_nc(qc_c, tmax(nc, T(0)), rho);
  T lamc;
  const T v = cloud_vt(qc_c, nc_l, rho, stokes_acn(mu_visc(temp)), lamc);
  nc = nc_l;
  return v;
}

// (V_qr, V_nr, nr) of p3._rain_sed_speeds, nr written back
template <typename T, bool TAB>
__device__ __forceinline__ void rain_speeds(T qr, T& nr, T rho, T rho_sfc,
                                            const SedTables<T>& tb, T& vq, T& vn) {
  const bool gate = qr >= T(QSMALL);
  const T qr_c = gate ? tmin(qr, T(1.0e-2)) : T(0);
  const T nr_l = rain_dsd2_nr(qr_c, gate ? tmax(nr, T(0)) : T(0));
  if (TAB) {
    vq = vn = T(0);
    if (qr_c >= T(QSMALL)) {
      const T rhofacr = tpow(T(RHO_1000MB) * (T(1) / rho), T(0.54));
      int i0;
      T fi;
      rain_dm_index(qr_c, nr_l, i0, fi);
      vq = rhofacr * rain_interp(tb.rain, tb.rsize, i0, fi);
      vn = rhofacr * rain_interp(tb.rain + tb.rsize, tb.rsize, i0, fi);
    }
  } else {
    vq = vn = tclamp(T(36.34) * tpow(tmax(rho * qr_c, T(0)), T(0.1364)) * tsqrt(rho_sfc / rho),
                     T(0), T(9.1));
  }
  if (gate) nr = nr_l;
}

// (V_qit, V_nit, ni, qm, bm) of p3._ice_sed_speeds, the re-bounds and the
// limited ni written back
template <typename T, bool TAB>
__device__ __forceinline__ void ice_speeds(T qi, T& ni, T& qm, T& bm, T rho,
                                           const SedTables<T>& tb, T& vq, T& vn) {
  if (!TAB) {
    vq = vn = tclamp(T(1.2) * tpow(tmax(rho * qi, T(0)), T(0.0625)), T(0.3), T(3.0));
    return;
  }
  vq = vn = T(0);
  if (!(qi >= T(QSMALL))) return;
  const T qi_c = tmin(qi, T(5.1e-3));
  const T ni_c = tmax(tmax(ni, T(0)), T(NSMALL));
  const bool has_m = qm >= T(QSMALL);
  T qm_c = has_m ? qm : T(0);
  T bm_c = has_m ? tmin(tmax(bm, T(0)), T(5.1e-3)) : T(0);
  const T rr = bulk_rho_rime(qi_c, qm_c, bm_c);
  int i0, ii0, jj0;
  T fi, fii, fjj;
  ice_table_indices(qi_c, ni_c, qm_c, rr, i0, fi, ii0, fii, jj0, fjj);
  clamp_ice_index(i0, ii0, jj0);
  constexpr int W = ice_w<T>();
  T v[ICE_K];
#pragma unroll
  for (int k0 = 0; k0 < ICE_K; k0 += W) {
    T part[W];
    ice_interp<T, W>(tb.ice, tb.bs, tb.es, i0, ii0, jj0, fi, fii, fjj, k0, part);
#pragma unroll
    for (int e = 0; e < W; ++e) v[k0 + e] = part[e];
  }
  const T rfac = tpow(T(RHO_600MB) * (T(1) / rho), T(0.54));
  T ni_l = tmin(ni_c, v[2] * ni_c);
  ni_l = tmax(ni_l, v[3] * ni_l);
  vq = rfac * v[0];
  vn = rfac * v[1];
  ni = ni_l;
  qm = qm_c;
  bm = bm_c;
}

// The atomic-max key of a speed: its bit pattern (>= 0 speeds order as
// their patterns), a NaN the largest pattern, 0 for -0 (and for a negative
// value, which no speed takes).
__device__ __forceinline__ unsigned int speed_key(float v) {
  if (v != v) return 0x7fc00000u;
  return v > 0.0f ? __float_as_uint(v) : 0u;
}
__device__ __forceinline__ unsigned long long speed_key(double v) {
  if (v != v) return 0x7ff8000000000000ull;
  return v > 0.0 ? (unsigned long long)__double_as_longlong(v) : 0ull;
}
__device__ __forceinline__ void atomic_max_key(float* p, unsigned int k) {
  atomicMax(reinterpret_cast<unsigned int*>(p), k);
}
__device__ __forceinline__ void atomic_max_key(double* p, unsigned long long k) {
  atomicMax(reinterpret_cast<unsigned long long*>(p), k);
}

// The fields: qc nc qr nr qi ni qm bm rho dz temp in; qc ... bm, precl,
// preci out.
enum { QC, NC, QR, NR, QI, NI, QM, BM, RHO, DZ, TEMP, NIN };
struct SedPtrs {
  const void* in[NIN];
  void* out[10];
};

template <typename T, bool TAB>
__global__ void __launch_bounds__(VMAX_THREADS)
sed_vmax_kernel(const SedPtrs p, const T* __restrict__ ice, const T* __restrict__ rain,
                int rsize, int64_t n, int nz, int64_t plane, T* __restrict__ vmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SedTables<T> tb = stage_tables<T, TAB>(smem, ice, rain, rsize);
  const T* const* f = reinterpret_cast<const T* const*>(p.in);
  T m = T(0);
  for (int64_t c = (int64_t)blockIdx.x * VMAX_THREADS + threadIdx.x; c < n;
       c += (int64_t)gridDim.x * VMAX_THREADS) {
    const T rho = __ldg(f[RHO] + c);
    T rho_sfc = rho;
    if (!TAB) {
      const int64_t e = c / ((int64_t)nz * plane), r = c % plane;
      rho_sfc = __ldg(f[RHO] + e * nz * plane + r);
    }
    T nc = __ldg(f[NC] + c), nr = __ldg(f[NR] + c), ni = __ldg(f[NI] + c);
    T qm = __ldg(f[QM] + c), bm = __ldg(f[BM] + c);
    T vr, vnr, vi, vni;
    rain_speeds<T, TAB>(__ldg(f[QR] + c), nr, rho, rho_sfc, tb, vr, vnr);
    ice_speeds<T, TAB>(__ldg(f[QI] + c), ni, qm, bm, rho, tb, vi, vni);
    const T vc = cloud_speed(__ldg(f[QC] + c), nc, rho, __ldg(f[TEMP] + c));
    m = tmax(m, tmax(tmax(vr, vi), vc));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = tmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ T warp_max[VMAX_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < VMAX_THREADS / 32; ++w) m = tmax(m, warp_max[w]);
    atomic_max_key(vmax, speed_key(m));
  }
}

template <typename T, bool TAB, bool PNC>
__global__ void __launch_bounds__(COL_THREADS)
sed_columns_kernel(const SedPtrs p, const T* __restrict__ ice, const T* __restrict__ rain,
                   int rsize, const T* __restrict__ nsub_p, double dt, int64_t ncol, int nz,
                   int64_t plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SedTables<T> tb = stage_tables<T, TAB>(smem, ice, rain, rsize);
  const T* const* in = reinterpret_cast<const T* const*>(p.in);
  T* const* out = reinterpret_cast<T* const*>(p.out);
  const T ns = *nsub_p;
  const bool ok = ns >= T(1) && ns <= T(NSUB_MAX);
  const int nsub = ok ? (int)ns : 1;
  // dt / nsub_t: PyTorch's reciprocal of nsub times dt
  const T dts = ok ? T(1) / ns * T(dt) : T(NAN);
  const T rho_h2o = T(RHO_H2O);
  for (int64_t col = (int64_t)blockIdx.x * COL_THREADS + threadIdx.x; col < ncol;
       col += (int64_t)gridDim.x * COL_THREADS) {
    const int64_t e = col / plane, r = col - e * plane;
    const int64_t base = e * nz * plane + r;
    const T rho_sfc = __ldg(in[RHO] + base);
    T pl = T(0), pi = T(0);
    for (int s = 0; s < nsub; ++s) {
      const T* const* src = s == 0 ? in : const_cast<const T* const*>(out);
      T fa[8];  // the fluxes of the level above
      for (int k = nz - 1; k >= 0; --k) {
        const int64_t c = base + (int64_t)k * plane;
        const T rho = __ldg(in[RHO] + c), dz = __ldg(in[DZ] + c);
        T q[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) q[v] = src[v][c];
        T vr, vnr, vi, vni;
        rain_speeds<T, TAB>(q[QR], q[NR], rho, rho_sfc, tb, vr, vnr);
        ice_speeds<T, TAB>(q[QI], q[NI], q[QM], q[BM], rho, tb, vi, vni);
        const T vc = cloud_speed(q[QC], q[NC], rho, __ldg(in[TEMP] + c));
        const T v[8] = {vc, vc, vr, vnr, vi, vni, vi, vi};
        const T mass = rho * dz;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const T flux = rho * q[w] * v[w];
          if (w != NC || PNC) {
            const T dq = k == nz - 1 ? -dts * flux / mass : dts * (fa[w] - flux) / mass;
            out[w][c] = tmax(q[w] + dq, T(0));
          } else {
            out[w][c] = q[w];
          }
          fa[w] = flux;
        }
      }
      // the bottom level's outflow, in the plain version's order
      pl = pl + dts * fa[QC] / rho_h2o;
      pl = pl + dts * fa[QR] / rho_h2o;
      pi = pi + dts * fa[QI] / rho_h2o;
    }
    out[8][col] = pl / T(dt);
    out[9][col] = pi / T(dt);
  }
}

template <typename Kernel>
int grid_for(Kernel kernel, int threads, size_t smem, long long items, unsigned* blocks) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (items + threads - 1) / threads;
  const long long most = (long long)sms * per_sm;
  *blocks = (unsigned)(need < most ? (need > 0 ? need : 1) : most);
  return cudaSuccess;
}

template <typename T>
using VmaxKernel = void (*)(const SedPtrs, const T*, const T*, int, int64_t, int, int64_t,
                            T*);
template <typename T>
using ColKernel = void (*)(const SedPtrs, const T*, const T*, int, const T*, double,
                           int64_t, int, int64_t);

template <typename T> VmaxKernel<T> vmax_kernel(int tab) {
  return tab ? sed_vmax_kernel<T, true> : sed_vmax_kernel<T, false>;
}
template <typename T> ColKernel<T> col_kernel(int tab, int pnc) {
  if (tab) return pnc ? sed_columns_kernel<T, true, true> : sed_columns_kernel<T, true, false>;
  return pnc ? sed_columns_kernel<T, false, true> : sed_columns_kernel<T, false, false>;
}

// shapes, and the staged rain rows: 16-byte copies of 2 rows
int check(int tab, int rsize, size_t item, long long n, int nz, long long plane) {
  if (n < 0 || nz < 1 || plane < 1 || n % ((long long)nz * plane) != 0)
    return cudaErrorInvalidValue;
  if (tab && (rsize < 2 || (2 * (size_t)rsize * item) % 16 != 0))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
int launch_vmax(int tab, const void* const* in, const void* ice, const void* rain, int rsize,
                long long n, int nz, long long plane, void* vmax, void* stream) {
  if (int e = check(tab, rsize, sizeof(T), n, nz, plane)) return e;
  if (n == 0) return cudaSuccess;
  const VmaxKernel<T> kernel = vmax_kernel<T>(tab);
  const size_t smem = sed_smem_bytes<T>(tab, rsize);
  unsigned blocks;
  if (int e = grid_for(kernel, VMAX_THREADS, smem, n, &blocks)) return e;
  SedPtrs p{};
  for (int k = 0; k < NIN; ++k) p.in[k] = in[k];
  kernel<<<blocks, VMAX_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const T*>(ice), static_cast<const T*>(rain), rsize, (int64_t)n, nz,
      (int64_t)plane, static_cast<T*>(vmax));
  return cudaGetLastError();
}

template <typename T>
int launch_columns(int tab, int pnc, const void* const* in, void* const* out,
                   const void* ice, const void* rain, int rsize, const void* nsub, double dt,
                   long long n, int nz, long long plane, void* stream) {
  if (int e = check(tab, rsize, sizeof(T), n, nz, plane)) return e;
  if (n == 0) return cudaSuccess;
  const ColKernel<T> kernel = col_kernel<T>(tab, pnc);
  const size_t smem = sed_smem_bytes<T>(tab, rsize);
  const long long ncol = n / nz;
  unsigned blocks;
  if (int e = grid_for(kernel, COL_THREADS, smem, ncol, &blocks)) return e;
  SedPtrs p{};
  for (int k = 0; k < NIN; ++k) p.in[k] = in[k];
  for (int k = 0; k < 10; ++k) p.out[k] = out[k];
  kernel<<<blocks, COL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const T*>(ice), static_cast<const T*>(rain), rsize,
      static_cast<const T*>(nsub), dt, (int64_t)ncol, nz, (int64_t)plane);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in: qc nc qr nr qi ni qm bm rho dz temp, contiguous (nens, nz, ny, nx) of
// n cells with plane = ny * nx; ice: the packed (2, 1, 7, 8) ice table and
// rain: the (2, rsize) vm / vn rows (both ignored without tab); vmax: a
// zeroed scalar.
#define P3_SED_ENTRY(SUF, T)                                                            \
  int p3_sed_vmax_##SUF(int tab, const void* const* in, const void* ice,               \
                        const void* rain, int rsize, long long n, int nz,              \
                        long long plane, void* vmax, void* stream) {                   \
    return launch_vmax<T>(tab, in, ice, rain, rsize, n, nz, plane, vmax, stream);      \
  }                                                                                     \
  int p3_sed_columns_##SUF(int tab, int pnc, const void* const* in, void* const* out,  \
                           const void* ice, const void* rain, int rsize,               \
                           const void* nsub, double dt, long long n, int nz,           \
                           long long plane, void* stream) {                            \
    return launch_columns<T>(tab, pnc, in, out, ice, rain, rsize, nsub, dt, n, nz,     \
                             plane, stream);                                            \
  }

P3_SED_ENTRY(f32, float)
P3_SED_ENTRY(f64, double)

// The launch of sed_vmax (columns = 0) or sed_columns (columns = 1) over n
// cells of nz levels: blocks, threads per block and shared memory per block.
int p3_sed_launch(int columns, int tab, int pnc, int f64, long long n, int nz,
                  unsigned* blocks, int* threads, long long* smem) {
  if (nz < 1 || n < 0) return cudaErrorInvalidValue;
  const int rsize = 300;
  *threads = columns ? COL_THREADS : VMAX_THREADS;
  const long long items = columns ? n / nz : n;
  size_t sm;
  int e;
  if (f64) {
    sm = sed_smem_bytes<double>(tab, rsize);
    e = columns ? grid_for(col_kernel<double>(tab, pnc), *threads, sm, items, blocks)
                : grid_for(vmax_kernel<double>(tab), *threads, sm, items, blocks);
  } else {
    sm = sed_smem_bytes<float>(tab, rsize);
    e = columns ? grid_for(col_kernel<float>(tab, pnc), *threads, sm, items, blocks)
                : grid_for(vmax_kernel<float>(tab), *threads, sm, items, blocks);
  }
  *smem = (long long)sm;
  return e;
}

const char* p3_sed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
