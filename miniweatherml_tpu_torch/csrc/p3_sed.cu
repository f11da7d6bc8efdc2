// P3 sedimentation for NVIDIA Hopper (sm_90a): one pass that computes every
// cell's fall speeds once, takes their maximum and makes one sub-step of the
// fall (sed_step), and the CFL-sub-cycled fall (sed_columns), which reruns
// the whole sub-cycle only on a step that needs more than one sub-step; the
// sub-step count is read on the device.
//
// Replaces the JAX scheme's sedimentation, miniweatherml_tpu/physics/
// p3.py:1268-1388: the per-cell fall speeds, their maximum (:1329-1341) and
// the lax.while_loop (:1383) whose trip count nsub never leaves the device.
// It is no Pallas kernel: XLA runs that loop on the TPU, and cannot share
// the speeds of the maximum with the loop's first sub-step.  The plain
// versions are p3._p3_sed_step (the speeds once, their maximum and one
// sub-step) and p3._p3_sed_columns (a Python loop that reads nsub to the
// host); each kernel is a line-by-line transcription of them.
//
// sed_step: one thread per (ens, y, x) column, so a warp covers 32
// neighbouring x columns and every load and store coalesces.  The thread
// marches from the top level down; at each level it computes the speeds
// with their persisted write-backs (nr, ni, qm, bm, nc): rain V_qr / V_nr
// from the generated vm / vn rows, ice V_qit / V_nit from ice columns 2 and
// 1 (7 and 8 limit ni), cloud V_qc from the Stokes law; it folds the three
// mass speeds into its maximum, takes the eight downward fluxes rho q v and
// updates the level from its own flux and the flux of the level above,
// which it carries in registers:
//   dq = dts (flux[k+1] - flux[k]) / (rho dz)[k],  -dts flux[top] / (rho dz)
// at the top, clamped at 0, with dts = dt (one sub-step: sed_columns'
// 1 / nsub * dt at nsub = 1); the bottom level's fluxes feed the surface
// rates.  The falls are those of the plain version, in its order: qc (and
// nc with do_predict_nc) at V_qc, qr at V_qr, nr at V_nr, qi at V_qit, ni
// at V_nit, qm and bm at V_qit.  A thread loads a level's 11 inputs when
// it comes to the level: loading them one level ahead took 7-14 more
// registers and was no faster (scripts/p3_sed_variants.py, PERF.md), and
// the launch bounds ask for 8 blocks a SM in f32 (at most 64 registers), so
// that the 262 144 columns of a 512x512 grid make two even waves of the
// card.  The block's maximum (warp shuffle, then shared memory) goes to a device
// scalar by an atomic max on the bit pattern: exact in any order, since
// every speed is >= 0 (a gated-out cell gives 0), and a NaN comes through
// as the largest pattern, as torch.max lets it through.  The caller turns
// the maximum into nsub = max(ceil(dt vmax / (0.9 dz_min)), 1), a 0-d
// device tensor (after pmax / pmin on a mesh).
//
// sed_columns: the same thread layout and level body.  The thread reads
// nsub from device memory.  With `rerun` (the path after sed_step, whose
// outputs it is handed) every block returns at once where nsub = 1: those
// outputs are already the step's.  Otherwise it runs the whole sub-cycle
// loop from the untouched inputs and overwrites them: sedimentation is
// purely vertical, so columns never meet; sub-step 0 reads the inputs, the
// later ones the outputs a thread has written itself, with dts =
// 1 / nsub * dt.  A count outside [1, NSUB_MAX] (a NaN or infinite speed)
// gives NaN everywhere, where the plain version's host read would raise.
//
// The ice table columns (2, 1, 7, 8) in p3_lookup's packed layout and the
// rain vm / vn rows are staged in shared memory once per block by cp.async
// (16 KB + 2.4 KB in f32), and both kernels call p3_interp.cuh's
// interpolations inline, so the lookups cost no launch and no pass over the
// field.  Template parameters: T (f32, f64), the table tier or the
// continuous [approx] tier, and do_predict_nc.
//
// What bounds it on the H100: by the bound's count, bytes on every f32
// state (sed_step reads 11 fields and writes 8, f32: 76 B a cell, plus
// the two surface fields; sed_columns the same per sub-step), operations
// on a mixed f64 one.  Per level a cell present in a species evaluates
// that species' transcendentals (pow, exp, lgamma, log10): 400-1000
// operations a branch in the SASS, and a warp issues every branch any of
// its 32 columns needs.  So a state with hydrometeors runs at 30-50% of
// the bound, one without them at ~65% (PERF.md).
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

constexpr int COL_THREADS = 128;
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

// The speeds of one level's eight falls (V_qc, V_qc, V_qr, V_nr, V_qit,
// V_nit, V_qit, V_qit) from q (qc nc qr nr qi ni qm bm), with their
// write-backs into q; returns the largest of the three mass speeds.
template <typename T, bool TAB>
__device__ __forceinline__ T level_speeds(T (&q)[8], T rho, T temp, T rho_sfc,
                                          const SedTables<T>& tb, T (&v)[8]) {
  T vr, vnr, vi, vni;
  rain_speeds<T, TAB>(q[QR], q[NR], rho, rho_sfc, tb, vr, vnr);
  ice_speeds<T, TAB>(q[QI], q[NI], q[QM], q[BM], rho, tb, vi, vni);
  const T vc = cloud_speed(q[QC], q[NC], rho, temp);
  v[QC] = v[NC] = vc;
  v[QR] = vr;
  v[NR] = vnr;
  v[QI] = v[QM] = v[BM] = vi;
  v[NI] = vni;
  return tmax(tmax(vr, vi), vc);
}

// The eight downward fluxes of one level at the speeds v, and the level's
// new values o from its flux and the carried flux of the level above, fa
// (which takes this level's).
template <typename T, bool PNC>
__device__ __forceinline__ void level_update(const T (&q)[8], const T (&v)[8], T rho,
                                             T dz, bool top, T dts, T (&fa)[8],
                                             T (&o)[8]) {
  const T mass = rho * dz;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const T flux = rho * q[w] * v[w];
    if (w != NC || PNC) {
      const T dq = top ? -dts * flux / mass : dts * (fa[w] - flux) / mass;
      o[w] = tmax(q[w] + dq, T(0));
    } else {
      o[w] = q[w];
    }
    fa[w] = flux;
  }
}

// One level of one sub-step: the speeds with their write-backs, then the
// fluxes and new values; returns the largest of the three mass speeds.
template <typename T, bool TAB, bool PNC>
__device__ __forceinline__ T fall_level(T (&q)[8], T rho, T dz, T temp, T rho_sfc,
                                        bool top, T dts, const SedTables<T>& tb,
                                        T (&fa)[8], T (&o)[8]) {
  T v[8];
  const T m = level_speeds<T, TAB>(q, rho, temp, rho_sfc, tb, v);
  level_update<T, PNC>(q, v, rho, dz, top, dts, fa, o);
  return m;
}

// the 11 inputs of cell c
template <typename T>
__device__ __forceinline__ void load_level(const T* const* in, int64_t c, T (&x)[NIN]) {
#pragma unroll
  for (int f = 0; f < NIN; ++f) x[f] = __ldg(in[f] + c);
}

// the bottom level's outflow, in the plain version's order
template <typename T>
__device__ __forceinline__ void surface(const T (&fa)[8], T dts, T& pl, T& pi) {
  const T rho_h2o = T(RHO_H2O);
  pl = pl + dts * fa[QC] / rho_h2o;
  pl = pl + dts * fa[QR] / rho_h2o;
  pi = pi + dts * fa[QI] / rho_h2o;
}

// launch bounds of 8 blocks a SM (at most 64 registers a thread) in f32,
// so that the 262 144 columns of a 512x512 grid fill two even waves of the
// card rather than two and a fifth; 4 in f64 (128 registers)
template <typename T, bool TAB, bool PNC>
__global__ void __launch_bounds__(COL_THREADS, sizeof(T) == 4 ? 8 : 4)
sed_step_kernel(const SedPtrs p, const T* __restrict__ ice, const T* __restrict__ rain,
                int rsize, double dt, int64_t ncol, int nz, int64_t plane,
                T* __restrict__ vmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SedTables<T> tb = stage_tables<T, TAB>(smem, ice, rain, rsize);
  const T* const* in = reinterpret_cast<const T* const*>(p.in);
  T* const* out = reinterpret_cast<T* const*>(p.out);
  // sed_columns' dts = 1 / nsub * dt at nsub = 1
  const T dts = T(1) / T(1) * T(dt);
  T m = T(0);
  for (int64_t col = (int64_t)blockIdx.x * COL_THREADS + threadIdx.x; col < ncol;
       col += (int64_t)gridDim.x * COL_THREADS) {
    const int64_t e = col / plane, r = col - e * plane;
    const int64_t base = e * nz * plane + r;
    const T rho_sfc = __ldg(in[RHO] + base);
    T fa[8];
    for (int k = nz - 1; k >= 0; --k) {
      const int64_t c = base + (int64_t)k * plane;
      T x[NIN], q[8], o[8];
      load_level(in, c, x);
#pragma unroll
      for (int v = 0; v < 8; ++v) q[v] = x[v];
      m = tmax(m, fall_level<T, TAB, PNC>(q, x[RHO], x[DZ], x[TEMP], rho_sfc,
                                          k == nz - 1, dts, tb, fa, o));
#pragma unroll
      for (int v = 0; v < 8; ++v) out[v][c] = o[v];
    }
    T pl = T(0), pi = T(0);
    surface(fa, dts, pl, pi);
    out[8][col] = pl / T(dt);
    out[9][col] = pi / T(dt);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = tmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ T warp_max[COL_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < COL_THREADS / 32; ++w) m = tmax(m, warp_max[w]);
    atomic_max_key(vmax, speed_key(m));
  }
}

template <typename T, bool TAB, bool PNC>
__global__ void __launch_bounds__(COL_THREADS)
sed_columns_kernel(const SedPtrs p, const T* __restrict__ ice, const T* __restrict__ rain,
                   int rsize, const T* __restrict__ nsub_p, double dt, int rerun,
                   int64_t ncol, int nz, int64_t plane) {
  const T ns = *nsub_p;
  const bool ok = ns >= T(1) && ns <= T(NSUB_MAX);
  const int nsub = ok ? (int)ns : 1;
  // sed_step has written this count's outputs
  if (rerun && ok && nsub == 1) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const SedTables<T> tb = stage_tables<T, TAB>(smem, ice, rain, rsize);
  const T* const* in = reinterpret_cast<const T* const*>(p.in);
  T* const* out = reinterpret_cast<T* const*>(p.out);
  // dt / nsub_t: PyTorch's reciprocal of nsub times dt
  const T dts = ok ? T(1) / ns * T(dt) : T(NAN);
  for (int64_t col = (int64_t)blockIdx.x * COL_THREADS + threadIdx.x; col < ncol;
       col += (int64_t)gridDim.x * COL_THREADS) {
    const int64_t e = col / plane, r = col - e * plane;
    const int64_t base = e * nz * plane + r;
    const T rho_sfc = __ldg(in[RHO] + base);
    T pl = T(0), pi = T(0);
    for (int s = 0; s < nsub; ++s) {
      const T* const* src = s == 0 ? in : const_cast<const T* const*>(out);
      T fa[8];
      for (int k = nz - 1; k >= 0; --k) {
        const int64_t c = base + (int64_t)k * plane;
        T q[8], o[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) q[v] = src[v][c];
        fall_level<T, TAB, PNC>(q, __ldg(in[RHO] + c), __ldg(in[DZ] + c),
                                __ldg(in[TEMP] + c), rho_sfc, k == nz - 1, dts, tb,
                                fa, o);
#pragma unroll
        for (int v = 0; v < 8; ++v) out[v][c] = o[v];
      }
      surface(fa, dts, pl, pi);
    }
    out[8][col] = pl / T(dt);
    out[9][col] = pi / T(dt);
  }
}

// blocks of `threads` for `items` columns: at most as many as fit on the
// card at once (a persistent grid) unless `one_each`, which gives every
// thread one column
template <typename Kernel>
int grid_for(Kernel kernel, int threads, size_t smem, long long items, bool one_each,
             unsigned* blocks) {
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
  const long long most = one_each ? 2147483647LL : (long long)sms * per_sm;
  *blocks = (unsigned)(need < most ? (need > 0 ? need : 1) : most);
  return cudaSuccess;
}

template <typename T>
using StepKernel = void (*)(const SedPtrs, const T*, const T*, int, double, int64_t, int,
                            int64_t, T*);
template <typename T>
using ColKernel = void (*)(const SedPtrs, const T*, const T*, int, const T*, double, int,
                           int64_t, int, int64_t);

template <typename T> StepKernel<T> step_kernel(int tab, int pnc) {
  if (tab) return pnc ? sed_step_kernel<T, true, true> : sed_step_kernel<T, true, false>;
  return pnc ? sed_step_kernel<T, false, true> : sed_step_kernel<T, false, false>;
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

SedPtrs pointers(const void* const* in, void* const* out) {
  SedPtrs p{};
  for (int k = 0; k < NIN; ++k) p.in[k] = in[k];
  for (int k = 0; k < 10; ++k) p.out[k] = out[k];
  return p;
}

template <typename T>
int launch_step(int tab, int pnc, const void* const* in, void* const* out, const void* ice,
                const void* rain, int rsize, double dt, long long n, int nz,
                long long plane, void* vmax, void* stream) {
  if (int e = check(tab, rsize, sizeof(T), n, nz, plane)) return e;
  if (n == 0) return cudaSuccess;
  const StepKernel<T> kernel = step_kernel<T>(tab, pnc);
  const size_t smem = sed_smem_bytes<T>(tab, rsize);
  const long long ncol = n / nz;
  unsigned blocks;
  if (int e = grid_for(kernel, COL_THREADS, smem, ncol, true, &blocks)) return e;
  kernel<<<blocks, COL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pointers(in, out), static_cast<const T*>(ice), static_cast<const T*>(rain), rsize,
      dt, (int64_t)ncol, nz, (int64_t)plane, static_cast<T*>(vmax));
  return cudaGetLastError();
}

template <typename T>
int launch_columns(int tab, int pnc, const void* const* in, void* const* out,
                   const void* ice, const void* rain, int rsize, const void* nsub, double dt,
                   int rerun, long long n, int nz, long long plane, void* stream) {
  if (int e = check(tab, rsize, sizeof(T), n, nz, plane)) return e;
  if (n == 0) return cudaSuccess;
  const ColKernel<T> kernel = col_kernel<T>(tab, pnc);
  const size_t smem = sed_smem_bytes<T>(tab, rsize);
  const long long ncol = n / nz;
  unsigned blocks;
  if (int e = grid_for(kernel, COL_THREADS, smem, ncol, false, &blocks)) return e;
  kernel<<<blocks, COL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pointers(in, out), static_cast<const T*>(ice), static_cast<const T*>(rain), rsize,
      static_cast<const T*>(nsub), dt, rerun, (int64_t)ncol, nz, (int64_t)plane);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in: qc nc qr nr qi ni qm bm rho dz temp, contiguous (nens, nz, ny, nx) of
// n cells with plane = ny * nx; out: qc ... bm like them, then the two
// (nens, ny, nx) surface rates; ice: the packed (2, 1, 7, 8) ice table and
// rain: the (2, rsize) vm / vn rows (both ignored without tab); vmax: a
// zeroed scalar; nsub: the sub-step count, a device scalar; rerun: out
// holds sed_step's outputs, kept where nsub = 1.
#define P3_SED_ENTRY(SUF, T)                                                            \
  int p3_sed_step_##SUF(int tab, int pnc, const void* const* in, void* const* out,     \
                        const void* ice, const void* rain, int rsize, double dt,       \
                        long long n, int nz, long long plane, void* vmax,              \
                        void* stream) {                                                 \
    return launch_step<T>(tab, pnc, in, out, ice, rain, rsize, dt, n, nz, plane, vmax, \
                          stream);                                                      \
  }                                                                                     \
  int p3_sed_columns_##SUF(int tab, int pnc, const void* const* in, void* const* out,  \
                           const void* ice, const void* rain, int rsize,               \
                           const void* nsub, double dt, int rerun, long long n,        \
                           int nz, long long plane, void* stream) {                    \
    return launch_columns<T>(tab, pnc, in, out, ice, rain, rsize, nsub, dt, rerun, n,  \
                             nz, plane, stream);                                        \
  }

P3_SED_ENTRY(f32, float)
P3_SED_ENTRY(f64, double)

// The launch of sed_step (columns = 0) or sed_columns (columns = 1) over n
// cells of nz levels: blocks, threads per block and shared memory per block.
int p3_sed_launch(int columns, int tab, int pnc, int f64, long long n, int nz,
                  unsigned* blocks, int* threads, long long* smem) {
  if (nz < 1 || n < 0) return cudaErrorInvalidValue;
  const int rsize = 300;
  *threads = COL_THREADS;
  const long long items = n / nz;
  size_t sm;
  int e;
  if (f64) {
    sm = sed_smem_bytes<double>(tab, rsize);
    e = columns ? grid_for(col_kernel<double>(tab, pnc), *threads, sm, items, false, blocks)
                : grid_for(step_kernel<double>(tab, pnc), *threads, sm, items, true, blocks);
  } else {
    sm = sed_smem_bytes<float>(tab, rsize);
    e = columns ? grid_for(col_kernel<float>(tab, pnc), *threads, sm, items, false, blocks)
                : grid_for(step_kernel<float>(tab, pnc), *threads, sm, items, true, blocks);
  }
  *smem = (long long)sm;
  return e;
}

const char* p3_sed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
