// Kessler (KW1978) warm-rain microphysics: one whole time step of the
// scheme on the coupler's fields, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel miniweatherml_tpu/physics/kessler_pallas.py::
// kessler_subcycle_pallas (pallas_call at :128), the VMEM-resident form of
// the lax.while_loop in physics/kessler.py:196-240, together with the prep
// and post of MicrophysicsKessler.time_step (physics/kessler.py:89-94,
// 123-131) that the Pallas call took into its input reads.  Per cell, in
// registers: the mixing ratios qv, qc, qr = rho_x / rho_d, the pressure,
// exner = (p / p0)^(Rd/cp) and theta = T / exner; then `rainsplit` passes
// of surface precipitation, upstream rain sedimentation,
// autoconversion/accretion, saturation adjustment and rain evaporation; then
// rho_x = q_x * rho_d and T = theta * exner (the pre-micro exner).  The pass
// count is a global minimum computed on the device beforehand
// (physics/kessler.py::kessler_rainsplit); the kernel reads it through a
// pointer, so the host never waits for it.
//
// What bounds it on the H100: its exact arithmetic.  At rainsplit 1 it moves
// 5 fields in and 5 out (0.6 GB at 512x512x64 f32, 0.18 ms at 3.35 TB/s), but
// each cell also takes ~16 IEEE divisions and up to 7 pow/exp/sqrt, which
// must round as PyTorch's do: f32 powf runs at ~350 G/s on the card, a
// division at ~1.6 T/s (scripts/kernel_variants.py), so two pow and a
// dozen divisions per cell already cost ~0.2 ms.  Builds with approximate
// pow, exp and division (measured only, not bitwise) ran in 0.4-0.7 of the
// time.  Each further pass adds up to 4 pow, an exp and ~9
// divisions per cell.
// Design: a block owns C = 32 consecutive columns (a warp reads one level's
// row of them, coalesced) and L = 8 lanes of levels.  It stages its columns
// in dynamic shared memory: the four prognostics and the pass-invariant
// rho, rhalf = sqrt(rho0 / rho), pc = 3.8 / (exner^(cp/Rd) psl) and exner,
// formed once per cell, plus the pass's rain flux.  The coupler's fields
// arrive by cp.async, every level's copies issued before the first
// arithmetic.  A pass needs no march up the column: sedimentation at level k
// reads the pass's OLD flux at k and k + 1, so every level computes its
// flux, the block synchronizes, and every level updates.  All passes run in
// shared memory; each output is written once.
// Cells without rain or cloud skip work without changing a bit: pow_pos
// returns the +0 that pow gives for a zero base, and div0 (exact_div.cuh)
// the signed zero of a zero dividend without the division's slow path.
// A column of more levels than the block's budget (two blocks per SM) is
// cut into chunks of `kc` levels, staged one after another, with the level
// above a chunk read for its flux: the same code, with the prognostics of
// passes before the last kept in the output arrays between passes.  With
// C = 32 that stages nz <= 100 whole in f32 and nz <= 50 in f64.
// Every add and multiply is a round-to-nearest intrinsic (no contraction),
// divisions and sqrt are IEEE, and the file builds with contraction on so
// that pow and exp round as PyTorch's own CUDA build does: the kernel gives
// the plain PyTorch version's values bit for bit.  Uniform dz only.
//
// The file also holds the sub-cycle count's field work (kessler_min_step):
// the field work of the JAX package's kessler_rainsplit
// (miniweatherml_tpu/physics/kessler.py:134-150, which XLA fuses into one
// reduction; no Pallas kernel): min(dt, the minimum over cells below the
// top, where v > 1e-10, of 0.8 dz_lev / v), with v the rain's fall speed
// from qr = rho_r / rho_d, r and rhalf, and dz_lev the difference of the
// level midpoints (k + 0.5) dz as the plain version forms them.  The grid
// is (column tiles, level, ens), with no blocks for the top level, so a
// block's level and member come from its indices and a column's index is
// 32-bit; a thread takes 8 columns of the level, 256 apart (coalesced
// scalar loads).  A block forms a_k = 0.8 dz_lev once, takes the largest
// speed that passes v > 1e-10 over its cells (warp shuffles, then shared
// memory) and makes one division, a_k / v_max: IEEE division rounds
// correctly, so for a positive a_k it does not grow as the divisor grows,
// and min over cells of a_k / v equals a_k / max v bit for bit.  A NaN
// speed fails the test, as in the plain version.  Cells without rain
// skip the arithmetic (pow_pos gives 0, or NaN where rho_d is 0, and
// neither passes) and the read of their column's bottom density (rhalf
// needs it; that row stays in L2).  The block's step goes to a device
// scalar by an atomic min on the bit patterns of the positive steps, exact
// in any order; a block posts only a step below dt, and the
// first block always posts dt (the clamp).  The caller takes
// ceil(dt / step) on the device, so the host never reads the count.  It
// reads two fields: 134 MB at 512x512x64 f32, 0.04 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace {

constexpr int C = 32;       // columns per block
constexpr int L = 8;        // level lanes per block
constexpr int NFIELD = 8;   // staged per level: th qv qc qr rho rhalf pc pk
// shared memory per block: two blocks per SM (228 KB, 1 KB reserved each)
constexpr int SMEM_BUDGET = 115712;

__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float texp(float a) { return expf(a); }
__device__ __forceinline__ double texp(double a) { return exp(a); }
__device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double tsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

struct Consts {
  double dt, dz, Rd, Rv, p0, kappa, pc_exp, psl, lv, c_cond, cp;
};

// x^e for an exponent e > 0 that is no odd integer: +0 at x = +-0, as pow
// itself gives, without the call (most cells hold no rain).
template <typename T>
__device__ __forceinline__ T pow_pos(T x, T e) {
  return x == T(0) ? T(0) : tpow(x, e);
}

// Rain fall speed, KW eq. 2.15: 36.34 (qr r)^0.1364 rhalf.
template <typename T>
__device__ __forceinline__ T fall_speed(T qr, T r, T rhalf) {
  return mul(mul(T(36.34), pow_pos(mul(qr, r), T(0.1364))), rhalf);
}

// Copy one value from global to shared memory without passing through
// registers (cp.async); stage_wait() waits for the thread's own copies.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(C * L, 3)
kessler_kernel(const T* __restrict__ rho_d, const T* __restrict__ temp,
               const T* __restrict__ rho_v, const T* __restrict__ rho_c,
               const T* __restrict__ rho_r, const int* __restrict__ rainsplit,
               T* __restrict__ wv, T* __restrict__ cl, T* __restrict__ pl,
               T* __restrict__ temp_out, T* __restrict__ precl, int nz,
               int kc, int64_t ncol, const Consts k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s = reinterpret_cast<T*>(smem_raw);
  T* const s_th = s;
  T* const s_qv = s + 1 * kc * C;
  T* const s_qc = s + 2 * kc * C;
  T* const s_qr = s + 3 * kc * C;
  T* const s_rho = s + 4 * kc * C;
  T* const s_rhalf = s + 5 * kc * C;
  T* const s_pc = s + 6 * kc * C;
  T* const s_pk = s + 7 * kc * C;
  T* const s_flux = s + NFIELD * kc * C;  // kc + 1 levels

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t col = (int64_t)blockIdx.x * C + tx;
  const bool live = col < ncol;
  const int64_t g0 = (int64_t)blockIdx.y * nz * ncol + col;  // level 0
  const int rs = *rainsplit;
  const T dt0 = T(k.dt) / T(rs);
  const T dz = T(k.dz), psl = T(k.psl), lv = T(k.lv), cp = T(k.cp);
  const T c_cond = T(k.c_cond), p0 = T(k.p0), Rd = T(k.Rd), Rv = T(k.Rv);
  const T kappa = T(k.kappa), pc_exp = T(k.pc_exp);
  const T rho0 = live ? rho_d[g0] : T(1);
  const int nchunk = (nz + kc - 1) / kc;
  T precl_acc = T(0);

  for (int p = 0; p < rs; ++p) {
    const bool last = p == rs - 1;
    for (int ch = 0; ch < nchunk; ++ch) {
      const int k0 = ch * kc;
      const int n = min(kc, nz - k0);
      // stage the chunk: rho_d, temp and rho_v into the rho, pk and pc
      // slots, and the prognostics' sources (the coupler's rho_c and rho_r
      // on the first pass, the previous pass's values in the outputs after
      // it) into theirs, every copy in flight at once; then form the
      // prognostics and the invariants in place.  A thread reads back only
      // what it copied itself.
      if (live && (p == 0 || nchunk > 1)) {
        for (int lev = ty; lev < n; lev += L) {
          const int64_t g = g0 + (int64_t)(k0 + lev) * ncol;
          const int i = lev * C + tx;
          stage(s_rho + i, rho_d + g);
          stage(s_pk + i, temp + g);
          stage(s_pc + i, rho_v + g);
          if (p == 0) {
            stage(s_qc + i, rho_c + g);
            stage(s_qr + i, rho_r + g);
          } else {
            stage(s_th + i, temp_out + g);
            stage(s_qv + i, wv + g);
            stage(s_qc + i, cl + g);
            stage(s_qr + i, pl + g);
          }
        }
        stage_wait();
        for (int lev = ty; lev < n; lev += L) {
          const int i = lev * C + tx;
          const T rd = s_rho[i], tk = s_pk[i], rv = s_pc[i];
          const T pressure = add(mul(mul(Rd, rd), tk), mul(mul(Rv, rv), tk));
          const T exner = tpow(pressure / p0, kappa);
          if (p == 0) {
            s_th[i] = tk / exner;
            s_qv[i] = rv / rd;
            s_qc[i] = div0(s_qc[i], rd);
            s_qr[i] = div0(s_qr[i], rd);
          }
          s_rhalf[i] = tsqrt(rho0 / rd);
          s_pc[i] = T(3.8) / mul(tpow(exner, pc_exp), psl);
          s_pk[i] = exner;
        }
      }
      __syncthreads();
      // the pass's rain flux from the old rain, at every staged level and
      // at the level above the chunk; the surface precipitation
      if (live) {
        for (int lev = ty; lev < n; lev += L) {
          const int i = lev * C + tx;
          const T qr = s_qr[i], r = mul(T(0.001), s_rho[i]);
          const T vel = fall_speed(qr, r, s_rhalf[i]);
          s_flux[i] = mul(mul(r, qr), vel);
          if (k0 + lev == 0)
            precl_acc = add(precl_acc, div0(mul(mul(rho0, qr), vel), T(1000)));
        }
        if (ty == 0 && k0 + n < nz) {
          const int64_t g = g0 + (int64_t)(k0 + n) * ncol;
          const T rd = rho_d[g];
          const T qr = p == 0 ? div0(rho_r[g], rd) : pl[g];
          const T r = mul(T(0.001), rd);
          s_flux[n * C + tx] =
              mul(mul(r, qr), fall_speed(qr, r, tsqrt(rho0 / rd)));
        }
      }
      __syncthreads();
      if (live) {
        for (int lev = ty; lev < n; lev += L) {
          const int i = lev * C + tx;
          const int64_t g = g0 + (int64_t)(k0 + lev) * ncol;
          const T r = mul(T(0.001), s_rho[i]);
          const T pk = s_pk[i], pc = s_pc[i];
          T th = s_th[i], qv = s_qv[i], qc = s_qc[i], qr = s_qr[i];
          T sed;
          if (k0 + lev < nz - 1) {
            sed = div0(mul(dt0, sub(s_flux[i + C], s_flux[i])), mul(r, dz));
          } else {
            const T vel = fall_speed(qr, r, s_rhalf[i]);
            sed = div0(mul(mul(-dt0, qr), vel), mul(T(0.5), dz));
          }

          // autoconversion + accretion, KW eq. 2.13
          const T qrprod =
              sub(qc, div0(sub(qc, mul(dt0, tmax(mul(T(0.001),
                                                     sub(qc, T(0.001))),
                                                 T(0)))),
                           add(T(1), mul(mul(dt0, T(2.2)),
                                         pow_pos(qr, T(0.875))))));
          qc = tmax(sub(qc, qrprod), T(0));
          qr = tmax(add(add(qr, qrprod), sed), T(0));

          // saturation vapor mixing ratio, KW eq. 2.11
          const T tmp = sub(mul(pk, th), T(36));
          const T qvs =
              mul(pc, texp(mul(T(17.27), sub(mul(pk, th), T(273))) / tmp));
          const T prod =
              sub(qv, qvs) / add(T(1), mul(qvs, c_cond) / mul(tmp, tmp));

          // rain evaporation, KW eq. 2.14
          const T rq = mul(r, qr);
          const T tmp1 = mul(
              mul(dt0, div0(mul(add(T(1.6),
                                    mul(T(124.9), pow_pos(rq, T(0.2046)))),
                                pow_pos(rq, T(0.525))),
                            add(mul(T(2550000), pc) / mul(T(3.8), qvs),
                                T(540000)))),
              tmax(sub(qvs, qv), T(0)) / mul(r, qvs));
          const T ern = tmin(tmp1, tmin(tmax(sub(-prod, qc), T(0)), qr));

          // saturation adjustment, KW eq. 3.10
          const T cond = tmax(prod, -qc);
          th = add(th, mul(lv / mul(cp, pk), sub(cond, ern)));
          qv = tmax(add(sub(qv, cond), ern), T(0));
          qc = add(qc, cond);
          qr = sub(qr, ern);

          if (last) {
            const T rd = s_rho[i];
            wv[g] = mul(qv, rd);
            cl[g] = mul(qc, rd);
            pl[g] = mul(qr, rd);
            temp_out[g] = mul(th, pk);
          } else if (nchunk > 1) {
            wv[g] = qv;
            cl[g] = qc;
            pl[g] = qr;
            temp_out[g] = th;
          } else {
            s_th[i] = th;
            s_qv[i] = qv;
            s_qc[i] = qc;
            s_qr[i] = qr;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live && ty == 0)
    precl[(int64_t)blockIdx.y * ncol + col] = precl_acc / T(rs);
}

constexpr int MIN_THREADS = 256;
constexpr int MIN_V = 8;                         // columns a thread takes
constexpr int MIN_TILE = MIN_THREADS * MIN_V;    // columns a block takes

// The atomic-min key of a step >= +0: its bit pattern, which orders as the
// value does.
__device__ __forceinline__ unsigned int step_key(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long step_key(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
__device__ __forceinline__ void atomic_min_key(float* p, unsigned int k) {
  atomicMin(reinterpret_cast<unsigned int*>(p), k);
}
__device__ __forceinline__ void atomic_min_key(double* p, unsigned long long k) {
  atomicMin(reinterpret_cast<unsigned long long*>(p), k);
}

// A cell's fall speed where it passes v > 1e-10, else 0.  `bottom` is its
// column's bottom density, read only where the cell has rain.
template <typename T>
__device__ __forceinline__ T passing_speed(T rr, T rd, const T* bottom) {
  if (rr == T(0)) return T(0);
  const T qr = rr / rd;
  const T r = mul(T(0.001), rd);
  const T rhalf = tsqrt(*bottom / rd);
  const T vel = fall_speed(qr, r, rhalf);
  return vel > T(1e-10) ? vel : T(0);
}

// Each thread takes every MIN_THREADS-th column of the block's tile, so a
// warp's scalar loads are coalesced at any plane and alignment.
template <typename T>
__global__ void __launch_bounds__(MIN_THREADS)
kessler_min_step_kernel(const T* __restrict__ rho_r, const T* __restrict__ rho_d,
                        T* __restrict__ step, int nens, int nz, int plane, double dt_,
                        double dz_) {
  __shared__ T warp_max[MIN_THREADS / 32];
  const T dt = T(dt_), dz = T(dz_);
  T m = dt;  // the block's step (thread 0's)
  const int p0 = blockIdx.x * MIN_TILE;
  for (int e = blockIdx.z; e < nens; e += gridDim.z) {
    const T* const bottom = rho_d + (int64_t)e * nz * plane;
    for (int k = blockIdx.y; k < nz - 1; k += gridDim.y) {
      const int64_t lev = ((int64_t)e * nz + k) * plane;
      const T* const rr = rho_r + lev;
      const T* const rd = rho_d + lev;
      T v = T(0);
#pragma unroll
      for (int i = 0; i < MIN_V; ++i) {
        const int p = p0 + i * MIN_THREADS + threadIdx.x;
        if (p < plane) v = tmax(v, passing_speed(__ldg(rr + p), __ldg(rd + p), bottom + p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(0xffffffffu, v, o));
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < MIN_THREADS / 32; ++w) v = tmax(v, warp_max[w]);
        if (v > T(0)) {
          // zmid = (k + 0.5) dz in T, and the difference of two of them
          const T dz_lev = sub(mul(add(T(k + 1), T(0.5)), dz), mul(add(T(k), T(0.5)), dz));
          m = tmin(m, mul(T(0.8), dz_lev) / v);
        }
      }
      __syncthreads();  // warp_max is read before the next level writes it
    }
  }
  if (threadIdx.x == 0 &&
      (m < dt || (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)))
    atomic_min_key(step, step_key(m));
}

template <typename T>
int launch_min_step(const void* rho_r, const void* rho_d, void* step, long long n, int nz,
                    long long plane, double dt, double dz, void* stream) {
  if (nz < 2 || plane < 1 || plane > 2147483647LL - MIN_TILE || n < 1 ||
      n % ((long long)nz * plane) != 0 || !(dt > 0.0) || !(dz > 0.0))
    return cudaErrorInvalidValue;
  const long long nens = n / ((long long)nz * plane);
  if (nens > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((plane + MIN_TILE - 1) / MIN_TILE),
                  (unsigned)(nz - 1 < 65535 ? nz - 1 : 65535),
                  (unsigned)(nens < 65535 ? nens : 65535));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // all bits set: above every step's key, so the blocks' steps replace it
  cudaError_t err = cudaMemsetAsync(step, 0xff, sizeof(T), s);
  if (err != cudaSuccess) return err;
  kessler_min_step_kernel<T><<<grid, MIN_THREADS, 0, s>>>(
      static_cast<const T*>(rho_r), static_cast<const T*>(rho_d), static_cast<T*>(step),
      (int)nens, nz, (int)plane, dt, dz);
  return cudaGetLastError();
}

// Levels staged at once for nz levels of T: all of them if they fit the
// budget, else the most that do.
int staged_levels(int nz, int item) {
  const int fit = (SMEM_BUDGET - C * item) / ((NFIELD + 1) * C * item);
  return nz < fit ? nz : fit;
}

template <typename T>
int launch(const void* rho_d, const void* temp, const void* rho_v,
           const void* rho_c, const void* rho_r, const void* rainsplit,
           void* wv, void* cl, void* pl, void* temp_out, void* precl,
           int nens, int nz, long long ncol, double dt, double dz, double Rd,
           double Rv, double cp, double p0, void* stream) {
  if (nz < 2 || nens < 1 || nens > 65535 || ncol < 1)
    return cudaErrorInvalidValue;
  const long long blocks = (ncol + C - 1) / C;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const int kc = staged_levels(nz, (int)sizeof(T));
  const size_t smem = (size_t)(NFIELD * kc + kc + 1) * C * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kessler_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const Consts k{dt, dz, Rd, Rv, p0, Rd / cp, cp / Rd, p0 / 100.0, 2.5e6,
                 4093.0 * 2.5e6 / cp, cp};
  kessler_kernel<T><<<dim3((unsigned)blocks, (unsigned)nens), dim3(C, L),
                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rho_d), static_cast<const T*>(temp),
      static_cast<const T*>(rho_v), static_cast<const T*>(rho_c),
      static_cast<const T*>(rho_r), static_cast<const int*>(rainsplit),
      static_cast<T*>(wv), static_cast<T*>(cl), static_cast<T*>(pl),
      static_cast<T*>(temp_out), static_cast<T*>(precl), nz, kc,
      (int64_t)ncol, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kessler_step_f32(const void* rho_d, const void* temp, const void* rho_v,
                     const void* rho_c, const void* rho_r,
                     const void* rainsplit, void* wv, void* cl, void* pl,
                     void* temp_out, void* precl, int nens, int nz,
                     long long ncol, double dt, double dz, double Rd,
                     double Rv, double cp, double p0, void* stream) {
  return launch<float>(rho_d, temp, rho_v, rho_c, rho_r, rainsplit, wv, cl,
                       pl, temp_out, precl, nens, nz, ncol, dt, dz, Rd, Rv,
                       cp, p0, stream);
}

int kessler_step_f64(const void* rho_d, const void* temp, const void* rho_v,
                     const void* rho_c, const void* rho_r,
                     const void* rainsplit, void* wv, void* cl, void* pl,
                     void* temp_out, void* precl, int nens, int nz,
                     long long ncol, double dt, double dz, double Rd,
                     double Rv, double cp, double p0, void* stream) {
  return launch<double>(rho_d, temp, rho_v, rho_c, rho_r, rainsplit, wv, cl,
                        pl, temp_out, precl, nens, nz, ncol, dt, dz, Rd, Rv,
                        cp, p0, stream);
}

// The sedimentation sub-cycle count's largest stable step, min(dt, the
// minimum over cells below the top of 0.8 dz_lev / v), into the scalar
// `step`, from rho_r and rho_d: contiguous (nens, nz, ny, nx) of n cells,
// plane = ny * nx.
int kessler_min_step_f32(const void* rho_r, const void* rho_d, void* step, long long n,
                         int nz, long long plane, double dt, double dz, void* stream) {
  return launch_min_step<float>(rho_r, rho_d, step, n, nz, plane, dt, dz, stream);
}

int kessler_min_step_f64(const void* rho_r, const void* rho_d, void* step, long long n,
                         int nz, long long plane, double dt, double dz, void* stream) {
  return launch_min_step<double>(rho_r, rho_d, step, n, nz, plane, dt, dz, stream);
}

// Levels of a column the kernel stages at once (nz when it is staged
// whole), and its shared memory per block in bytes.
int kessler_staged_levels(int nz, int item) { return staged_levels(nz, item); }

long long kessler_smem_bytes(int nz, int item) {
  const int kc = staged_levels(nz, item);
  return (long long)(NFIELD * kc + kc + 1) * C * item;
}

const char* kessler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
