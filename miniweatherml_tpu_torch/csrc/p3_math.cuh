// Per-cell arithmetic of the P3 scheme shared by the per-cell phases
// (p3_cellwise.cu) and the sedimentation kernels (p3_sed.cu): constants,
// NaN-propagating max / min / clamp (as torch.clamp and torch.maximum), the
// math functions by type, saturation, and the droplet and raindrop DSD
// limiters.  Each is a line-by-line transcription of its plain version in
// miniweatherml_tpu_torch/physics/p3.py; a file that includes it builds
// with --fmad=false, so every multiply and add rounds on its own as in the
// plain PyTorch versions.  A division of a tensor by a number in the plain
// versions goes through _div (an IEEE division) and is a division here; a
// number divided by a tensor is PyTorch's reciprocal times the number, and
// is written so here.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double PI = 3.141592653589793;
constexpr double R_D = 287.042, CP_D = 1004.64, R_V = 461.505, CP_V = 1859.0;
constexpr double P0 = 1.0e5, CP_L = 4188.0, RHO_H2O = 1000.0;
constexpr double LV = 2501000.0, LF = 333700.0, LS = LV + LF;
constexpr double TMELT = 273.15, QSMALL = 1.0e-14, NSMALL = 1.0e-16;
constexpr double NCCNST = 200.0e6, MAX_TOTAL_NI = 500.0e3;
// (25e-6)**3 as the plain version's Python pow rounds it (one ulp from the
// product of three factors)
constexpr double R25_CUBED = 0x1.19799812dea12p-46;
constexpr double CONS3 = 1.0 / (4.0 * PI / 3.0 * RHO_H2O * R25_CUBED);
constexpr double CONS1 = PI / 6.0 * RHO_H2O;
constexpr double EP_2 = 18.016 / 28.966;
constexpr double MAGNUS_A = 17.625, MAGNUS_B = 243.04;
constexpr double THIRD = 1.0 / 3.0;
// air densities at 600 hPa / 253.15 K and 1000 hPa / 273.15 K (the fall
// speeds' density factors, micro_p3.F90:411)
constexpr double RHO_600MB = 60000.0 / (287.042 * 253.15);
constexpr double RHO_1000MB = 100000.0 / (287.042 * 273.15);

__device__ __forceinline__ float texp(float a) { return expf(a); }
__device__ __forceinline__ double texp(double a) { return exp(a); }
__device__ __forceinline__ float tlog(float a) { return logf(a); }
__device__ __forceinline__ double tlog(double a) { return log(a); }
__device__ __forceinline__ float ttanh(float a) { return tanhf(a); }
__device__ __forceinline__ double ttanh(double a) { return tanh(a); }
__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float tabs(float a) { return fabsf(a); }
__device__ __forceinline__ double tabs(double a) { return fabs(a); }
// NaN-propagating max / min / clamp, as torch.clamp and torch.maximum
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T tclamp(T a, T lo, T hi) {
  return tmin(tmax(a, lo), hi);
}

// -- saturation and helpers (plain: p3.py part A) --------------------------
template <typename T> __device__ T magnus_svp(T temp) {
  const T tc = temp - T(273.15);
  return T(610.94) * texp(T(MAGNUS_A) * tc / (T(MAGNUS_B) + tc));
}
template <typename T> __device__ T magnus_dsvp_dT(T svp, T temp) {
  const T tc = temp - T(273.15);
  return svp * T(MAGNUS_A * MAGNUS_B) / ((T(MAGNUS_B) + tc) * (T(MAGNUS_B) + tc));
}
template <typename T> __device__ T mk_svp_liq(T t) {
  const T logt = tlog(t);
  return texp(T(54.842763) - T(6763.22) / t - T(4.210) * logt + T(0.000367) * t +
              ttanh(T(0.0415) * (t - T(218.8))) *
                  (T(53.878) - T(1331.22) / t - T(9.44523) * logt + T(0.014025) * t));
}
template <typename T> __device__ T mk_svp_ice(T t) {
  if (!(t < T(TMELT))) return mk_svp_liq(t);
  const T logt = tlog(t);
  return texp(T(9.550426) - T(5723.265) / t + T(3.53068) * logt - T(0.00728332) * t);
}
template <typename T> __device__ T qv_sat_liq(T t, T pres) {
  const T e = mk_svp_liq(t);
  return T(EP_2) * e / tmax(pres - e, T(1.0e-3));
}
template <typename T> __device__ T qv_sat_ice(T t, T pres) {
  const T e = mk_svp_ice(t);
  return T(EP_2) * e / tmax(pres - e, T(1.0e-3));
}
template <typename T> __device__ T latent_heat_condensation(T temp) {
  const T tc = temp - T(273.15);
  return (T(2500.8) - T(2.36) * tc + T(0.0016) * tc * tc - T(0.00006) * tc * tc * tc) *
         T(1000.0);
}
template <typename T> __device__ T cp_moist(T rho_d, T rho_v, T rho_c) {
  const T rho = rho_d + rho_v + rho_c;
  return (rho_d * T(CP_D) + rho_v * T(CP_V) + rho_c * T(CP_L)) / rho;
}
template <typename T> __device__ T cbrt_pos(T x) { return tpow(x, T(THIRD)); }
template <typename T> __device__ T cap_ni(T ni, T inv_rho) {
  const T dum = T(MAX_TOTAL_NI) * inv_rho / tmax(ni, T(1e-20));
  return ni >= T(1e-20) ? ni * tmin(dum, T(1)) : ni;
}
// get_rain_dsd2 (p3._rain_dsd2): nr adjusted; lamr_cl the clipped lambda
template <typename T> __device__ T rain_dsd2(T qr, T nr, T& lamr_cl) {
  const T nr1 = tmax(nr, T(NSMALL));
  const T lamr = cbrt_pos(T(CONS1) * nr1 * T(24.0) / tmax(qr, T(QSMALL)));
  lamr_cl = tclamp(lamr, T(1000.0), T(2.0e5));
  const T nr_lim =
      lamr != lamr_cl ? lamr_cl * lamr_cl * lamr_cl * qr / T(24.0 * CONS1) : nr1;
  return qr >= T(QSMALL) ? nr_lim : nr;
}
template <typename T> __device__ T rain_dsd2_nr(T qr, T nr) {
  T lamr_cl;
  return rain_dsd2(qr, nr, lamr_cl);
}
template <typename T> __device__ T cloud_mu(T nc, T rho) {
  const T s = T(0.0005714) * (nc * T(1.0e-6) * rho) + T(0.2714);
  return tclamp(T(1) / (s * s) - T(1), T(2), T(15));
}
// get_cloud_dsd2 (p3._cloud_dsd2): nc adjusted; mu and lamc_cl the shape
// and the clipped lambda
template <typename T> __device__ T cloud_dsd2(T qc, T nc, T rho, T& mu, T& lamc_cl) {
  const T nc1 = tmax(nc, T(NSMALL));
  mu = cloud_mu(nc1, rho);
  const T mval = (mu + T(3)) * (mu + T(2)) * (mu + T(1));
  const T lamc = cbrt_pos(T(CONS1) * nc1 * mval / tmax(qc, T(QSMALL)));
  lamc_cl = tclamp(lamc, (mu + T(1)) * T(2.5e4), (mu + T(1)) * T(1.0e6));
  const T nc_lim =
      lamc != lamc_cl ? lamc_cl * lamc_cl * lamc_cl * qc / (T(CONS1) * mval) : nc1;
  return qc >= T(QSMALL) ? nc_lim : nc;
}
template <typename T> __device__ T cloud_dsd2_nc(T qc, T nc, T rho) {
  T mu, lamc_cl;
  return cloud_dsd2(qc, nc, rho, mu, lamc_cl);
}

__device__ __forceinline__ float tlgamma(float a) { return lgammaf(a); }
__device__ __forceinline__ double tlgamma(double a) { return lgamma(a); }
__device__ __forceinline__ float texpm1(float a) { return expm1f(a); }
__device__ __forceinline__ double texpm1(double a) { return expm1(a); }
__device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double tsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float tlog10(float a) { return log10f(a); }
__device__ __forceinline__ double tlog10(double a) { return log10(a); }
// torch.floor(x).to(torch.int32) on the card (NaN gives 0, as cvt.rzi does)
__device__ __forceinline__ int floor_i32(float a) { return (int)floorf(a); }
__device__ __forceinline__ int floor_i32(double a) { return (int)floor(a); }

// p3_tables.cbrt: pow(x, 1/3) polished by one Newton step
template <typename T> __device__ T cbrt_newton(T x) {
  const T y = tpow(x, T(THIRD));
  return y - (y * y * y - x) / (T(3) * (y * y));
}
// get_cloud_dsd2's clipped lambda for a given mu_c (p3._cloud_lamc)
template <typename T> __device__ T cloud_lamc(T qc, T nc, T mu) {
  const T lamc = cbrt_pos(T(CONS1) * tmax(nc, T(NSMALL)) * (mu + T(3)) * (mu + T(2)) *
                          (mu + T(1)) / tmax(qc, T(QSMALL)));
  return tclamp(lamc, (mu + T(1)) * T(2.5e4), (mu + T(1)) * T(1.0e6));
}
// 9.80616 * RHO_H2O / (18 * mu_visc(temp)) (p3._acn, cloud_sedimentation's
// acn): a number over a tensor, PyTorch's reciprocal times the number
template <typename T> __device__ T mu_visc(T temp) {
  return T(1.496e-6) * tpow(temp, T(1.5)) / (temp + T(120.0));
}
template <typename T> __device__ T stokes_acn(T mu_visc_) {
  return T(1) / (T(18.0) * mu_visc_) * T(9.80616 * RHO_H2O);
}
// (V_qc, lamc) of p3._cloud_vt, mu_c from the droplet number
template <typename T> __device__ T cloud_vt(T qc, T nc, T rho, T acn, T& lamc) {
  const T mu = cloud_mu(nc, rho);
  lamc = cloud_lamc(qc, nc, mu);
  const T v = acn * texp(tlgamma(mu + T(6)) - tlgamma(mu + T(4))) / (lamc * lamc);
  return qc >= T(QSMALL) ? v : T(0);
}
// calc_bulkRhoRime (p3._bulk_rho_rime): qm, bm re-bounded in place; returns
// the bulk rime density (0 where bm < 1e-15)
template <typename T> __device__ T bulk_rho_rime(T qi, T& qm, T& bm) {
  const bool has = bm >= T(1.0e-15);
  const T rr = has ? tclamp(qm / tmax(bm, T(1e-30)), T(50.0), T(900.0)) : T(0);
  T bm2 = has ? qm / tmax(rr, T(50.0)) : T(0);
  T qm2 = has ? qm : T(0);
  if (qm2 > qi && rr > T(0)) {
    qm2 = qi;
    bm2 = qm2 / tmax(rr, T(50.0));
  }
  const bool keep = !(qm2 < T(QSMALL));
  qm = keep ? qm2 : T(0);
  bm = keep ? bm2 : T(0);
  return rr;
}

}  // namespace
