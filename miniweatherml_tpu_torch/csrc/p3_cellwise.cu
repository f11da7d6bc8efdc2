// The P3 scheme's per-cell phases as one fused pass each, for NVIDIA Hopper
// (sm_90a): part1 + in-cloud values (13 inputs, 21 outputs), the
// conservation / prognostic update / end-of-part2 clip (45 inputs + dt, 10
// outputs), and the wrapper's inputs with the saturation Newton (13 inputs,
// 14 outputs).
//
// Replaces the Pallas TPU kernel miniweatherml_tpu/ops/elementwise.py::
// fused_cellwise (pallas_call at :101), which runs a pure per-cell function
// with every array streamed HBM -> VMEM once; its three call sites are
// physics/p3.py:817 (part1), :1248 (update) and :1578 (wrapper inputs).
// Here one executor template, cellwise<Phase, T>, gives each thread one
// cell: it loads the cell's inputs once, calls the phase's __device__ body
// and stores its outputs once.  The bodies are line-by-line transcriptions
// of the plain versions in miniweatherml_tpu_torch/physics/p3.py
// (_p3_part1_cellwise, _p3_update_cellwise, _p3_wrapper_inputs_cellwise):
// built with --fmad=false they do the same IEEE operations in the same
// order (constants folded where the plain Python folds them, integer powers
// as products, cube roots as pow(x, 1/3)), so P3's many gates see the same
// values on both sides.
//
// What bounds it on the H100: bytes.  The eager PyTorch phases are a few
// hundred passes over full-size temporaries; fused, each phase reads its
// inputs and writes its outputs once (update: 55 values per cell, 220 B in
// f32).  The saturation Newton (up to 11 trips of one exp each) and the
// Murphy-Koop svp (exp, log, tanh) are the arithmetic; the update's 45
// inputs make it the register-heaviest phase.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int THREADS = 128;

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
template <typename T> __device__ T rain_dsd2_nr(T qr, T nr) {
  const T nr1 = tmax(nr, T(NSMALL));
  const T lamr = cbrt_pos(T(CONS1) * nr1 * T(24.0) / tmax(qr, T(QSMALL)));
  const T lamr_cl = tclamp(lamr, T(1000.0), T(2.0e5));
  const T nr_lim =
      lamr != lamr_cl ? lamr_cl * lamr_cl * lamr_cl * qr / T(24.0 * CONS1) : nr1;
  return qr >= T(QSMALL) ? nr_lim : nr;
}
template <typename T> __device__ T cloud_mu(T nc, T rho) {
  const T s = T(0.0005714) * (nc * T(1.0e-6) * rho) + T(0.2714);
  return tclamp(T(1) / (s * s) - T(1), T(2), T(15));
}
template <typename T> __device__ T cloud_dsd2_nc(T qc, T nc, T rho) {
  const T nc1 = tmax(nc, T(NSMALL));
  const T mu = cloud_mu(nc1, rho);
  const T mval = (mu + T(3)) * (mu + T(2)) * (mu + T(1));
  const T lamc = cbrt_pos(T(CONS1) * nc1 * mval / tmax(qc, T(QSMALL)));
  const T lamc_cl = tclamp(lamc, (mu + T(1)) * T(2.5e4), (mu + T(1)) * T(1.0e6));
  const T nc_lim =
      lamc != lamc_cl ? lamc_cl * lamc_cl * lamc_cl * qc / (T(CONS1) * mval) : nc1;
  return qc >= T(QSMALL) ? nc_lim : nc;
}

// compute_adjusted_state, guarded-Newton form (microphysics_p3.h:467-550)
template <typename T>
__device__ void adjust_state(T rho, T rho_d, T& rho_v, T& rho_c, T& temp) {
  const T svp = magnus_svp(temp);
  const T pv = rho_v * T(R_V) * temp;
  const bool condensing = pv > svp;
  const bool evaporating = (pv < svp) && (rho_c > T(0));
  const T Lv = latent_heat_condensation(temp);
  const int n_newton = sizeof(T) == 8 ? 10 : 7;
  T lo = condensing ? T(0) : -rho_c;
  T hi = condensing ? rho_v : T(0);
  const T rho_t = rho_d + rho_v + rho_c;
  const T cp0 = (rho_d * T(CP_D) + rho_v * T(CP_V) + rho_c * T(CP_L)) / rho_t;
  const T dcp = T(CP_L - CP_V) / rho_t;

  const T f0 = pv - svp;
  const T dtdx0 = Lv / (rho * cp0);
  const T dsvp0 = magnus_dsvp_dT(svp, temp);
  const T fp0 = T(-R_V) * temp + rho_v * T(R_V) * dtdx0 - dsvp0 * dtdx0;
  const T x1 = -f0 / tmin(fp0, T(-1e-30));
  T x = ((fp0 < T(0)) && (x1 >= lo) && (x1 <= hi)) ? x1 : T(0.5) * (lo + hi);
  T xb = x, fb = T(INFINITY);
  for (int it = 0; it < n_newton + 1; ++it) {
    const T rv = rho_v - x;
    const T cp = cp0 + x * dcp;
    const T dtdx_lin = Lv / (rho * cp);
    const T t_loc = temp + x * dtdx_lin;
    const T svp_loc = magnus_svp(t_loc);
    const T f = rv * T(R_V) * t_loc - svp_loc;
    const T absf = tabs(f);
    if (absf < fb) {
      xb = x;
      fb = absf;
    }
    if (f > T(0)) lo = x; else hi = x;
    const T dtdx = dtdx_lin * (T(1) - x * dcp / cp);
    const T dsvp = magnus_dsvp_dT(svp_loc, t_loc);
    const T fp = T(-R_V) * t_loc + rv * T(R_V) * dtdx - dsvp * dtdx;
    const T xn = x - f / fp;
    x = ((xn >= lo) && (xn <= hi)) ? xn : T(0.5) * (lo + hi);
  }
  x = xb;
  const T cp_lo = cp0 - rho_c * dcp;
  const T t_lo = temp - rho_c * Lv / (rho * cp_lo);
  const T f_lo = (rho_v + rho_c) * T(R_V) * t_lo - magnus_svp(t_lo);
  if (evaporating && f_lo <= T(0)) x = -rho_c;

  if (!(condensing || evaporating)) x = T(0);
  const T rv = tmax(rho_v - x, T(0));
  const T rc = tmax(rho_c + x, T(0));
  const T cp = cp_moist(rho_d, rv, rc);
  temp = temp + x * Lv / (rho * cp);
  rho_v = rv;
  rho_c = rc;
}

// -- the three phases ------------------------------------------------------
template <bool PNC> struct Part1 {
  static constexpr int NIN = 13, NOUT = 21;
  template <typename T> __device__ static void run(const T* in, T* out, T) {
    T qc = in[0], nc = in[1], qr = in[2], nr = in[3], qi = in[4], ni = in[5];
    T qm = in[6], bm = in[7], qv = in[8], theta = in[9];
    const T exner = in[10], pres = in[11], rho = in[12];
    const T inv_rho = T(1) / rho;
    T temp = theta * exner;
    const T cpx = T(CP_D) * exner;

    const T qv_si0 = qv_sat_ice(temp, pres);
    const T sup_i0 = qv / tmax(qv_si0, T(QSMALL)) - T(1);
    const bool small_c1 = qc < T(QSMALL);
    qv = qv + (small_c1 ? qc : T(0));
    theta = theta - (small_c1 ? qc : T(0)) * T(LV) / cpx;
    qc = small_c1 ? T(0) : qc;
    if (PNC) nc = small_c1 ? T(0) : tmax(nc, T(0));
    else nc = small_c1 ? T(0) : T(NCCNST) * inv_rho;
    const bool small_r1 = qr < T(QSMALL);
    qv = qv + (small_r1 ? qr : T(0));
    theta = theta - (small_r1 ? qr : T(0)) * T(LV) / cpx;
    qr = small_r1 ? T(0) : qr;
    nr = small_r1 ? T(0) : nr;
    const bool small_i1 = (qi < T(QSMALL)) || ((qi < T(1.0e-8)) && (sup_i0 < T(-0.1)));
    qv = qv + (small_i1 ? qi : T(0));
    theta = theta - (small_i1 ? qi : T(0)) * T(LS) / cpx;
    if (small_i1) qi = ni = qm = bm = T(0);
    const bool melt1 = (qi >= T(QSMALL)) && (qi < T(1.0e-8)) && (temp >= T(TMELT));
    qr = qr + (melt1 ? qi : T(0));
    theta = theta - (melt1 ? qi : T(0)) * T(LF) / cpx;
    if (melt1) qi = ni = qm = bm = T(0);
    temp = theta * exner;

    const bool skip = (qc < T(QSMALL)) && (qr < T(QSMALL)) && (qi < T(QSMALL)) &&
                      (temp < T(TMELT)) && (sup_i0 < T(-0.05));
    const T qc_in = qc >= T(QSMALL) ? tmin(qc, T(5.1e-3)) : T(0);
    const T qr_in = qr >= T(QSMALL) ? tmin(qr, T(1.0e-2)) : T(0);
    const T qi_in = qi >= T(QSMALL) ? tmin(qi, T(5.1e-3)) : T(0);
    const bool has_qm = (qm >= T(QSMALL)) && (qi >= T(QSMALL));
    const T qm_in = has_qm ? qm : T(0);
    const T bm_in = has_qm ? tmin(tmax(bm, T(0)), T(5.1e-3)) : T(0);
    nc = cloud_dsd2_nc(qc_in, nc, rho);
    nr = rain_dsd2_nr(qr_in, nr);
    const T nc_in = qc >= T(QSMALL) ? tmax(nc, T(0)) : T(0);
    const T nr_in = qr >= T(QSMALL) ? tmax(nr, T(0)) : T(0);
    const T ni_in = cap_ni(qi >= T(QSMALL) ? tmax(ni, T(0)) : T(0), inv_rho);
    const T mu_cd = cloud_mu(tmax(nc, T(NSMALL)), rho);

    out[0] = qc; out[1] = nc; out[2] = qr; out[3] = nr; out[4] = qi;
    out[5] = ni; out[6] = qm; out[7] = bm; out[8] = qv; out[9] = theta;
    out[10] = temp; out[11] = skip ? T(1) : T(0);
    out[12] = qc_in; out[13] = qr_in; out[14] = qi_in; out[15] = qm_in;
    out[16] = bm_in; out[17] = nc_in; out[18] = nr_in; out[19] = ni_in;
    out[20] = mu_cd;
  }
};

template <bool PNC> struct Update {
  static constexpr int NIN = 45, NOUT = 10;
  template <typename T> __device__ static void run(const T* in, T* out, T dt) {
    T au = in[0], ac = in[1], qc_frz = in[2], nc_frz = in[3], qr_frz = in[4];
    T nr_frz = in[5], rim = in[6], shed = in[7];
    const T ncshdc = in[8];
    T berg = in[9], dep = in[10], sub = in[11], ev = in[12], melt = in[13];
    T qinuc = in[14];
    const T ninuc = in[15];
    T qrcol = in[16], nr_col = in[17], nr_self = in[18], ni_self = in[19];
    const T nr_shed_wg = in[20], rho_rime = in[21];
    const bool log_wg = in[22] > T(0.5);
    const T qc_in = in[23], nc_in = in[24], qr_in = in[25], nr_in = in[26];
    const T qi_in = in[27], ni_rate = in[28];
    T qc = in[29], nc = in[30], qr = in[31], nr = in[32], qi = in[33];
    T ni = in[34], qm = in[35], bm = in[36], qv = in[37], theta = in[38];
    const T exner = in[39], inv_rho = in[40], temp = in[41], qv_si = in[42];
    const T pres = in[43];
    const bool skip_lvl = in[44] > T(0.5);

    const T inv_qc = T(1) / tmax(qc_in, T(QSMALL));
    T nc2nr_auto = au * nc_in * inv_qc;
    T nc_accret = ac * nc_in * inv_qc;
    T nc_collect = (rim + shed) * nc_in * inv_qc;
    const T ncautr = au * T(CONS3);
    T ni2nr_melt = melt * ni_rate / tmax(qi_in, T(QSMALL));
    T ni_sub_n = sub * ni_rate / tmax(qi_in, T(QSMALL));
    T nr_evap = ev * nr_in / tmax(qr_in, T(QSMALL));

    const T sinks_qc = (au + ac + qc_frz + rim + shed + berg) * dt;
    const T ratio_qc = (sinks_qc > qc && sinks_qc >= T(1.0e-20))
                           ? qc / tmax(sinks_qc, T(1e-30)) : T(1);
    au = au * ratio_qc; ac = ac * ratio_qc; qc_frz = qc_frz * ratio_qc;
    rim = rim * ratio_qc; shed = shed * ratio_qc; berg = berg * ratio_qc;
    if (qc > T(1.0e-20)) {
      dep = dep * (T(1) - ratio_qc);
      sub = sub * (T(1) - ratio_qc);
    }

    const T sinks_qr = (ev + qrcol + qr_frz) * dt;
    const T sources_qr = qr + (au + ac + melt + shed) * dt;
    const T ratio_qr = (sinks_qr > sources_qr && sinks_qr >= T(1.0e-20))
                           ? sources_qr / tmax(sinks_qr, T(1e-30)) : T(1);
    ev = ev * ratio_qr; qrcol = qrcol * ratio_qr; qr_frz = qr_frz * ratio_qr;

    const T sinks_qi = (sub + melt) * dt;
    const T sources_qi =
        qi + (dep + qinuc + berg + qrcol + rim + qr_frz + qc_frz) * dt;
    const T ratio_qi = (sinks_qi > sources_qi && sinks_qi >= T(1.0e-20))
                           ? sources_qi / tmax(sinks_qi, T(1e-30)) : T(1);
    sub = sub * ratio_qi; melt = melt * ratio_qi;

    // ice_supersat_conservation (_conserve in the plain version)
    const T qv_avail = tmax((qv + (sub + ev) * dt - qv_si) /
                                (T(1) + T(LS * LS) * qv_si / (T(CP_D * R_V) * temp * temp)),
                            T(0));
    {
      const T total = (dep + qinuc) * dt;
      const T ratio = total > qv_avail ? qv_avail / tmax(total, T(1e-300)) : T(1);
      const T dep_l = dep * ratio, qinuc_l = qinuc * ratio;
      if (dep + qinuc > T(QSMALL)) {
        dep = dep_l;
        qinuc = qinuc_l;
      }
    }

    const T sinks_nc = (nc_collect + nc_frz + nc_accret + nc2nr_auto) * dt;
    const T ratio_nc = sinks_nc > nc ? nc / tmax(sinks_nc, T(1e-30)) : T(1);
    nc_collect = nc_collect * ratio_nc; nc_frz = nc_frz * ratio_nc;
    nc_accret = nc_accret * ratio_nc; nc2nr_auto = nc2nr_auto * ratio_nc;
    const T sinks_nr = (nr_col + nr_frz + nr_self + nr_evap) * dt;
    const T sources_nr = nr + (ni2nr_melt + nr_shed_wg + ncshdc + nc2nr_auto) * dt;
    const T ratio_nr =
        sinks_nr > sources_nr ? sources_nr / tmax(sinks_nr, T(1e-30)) : T(1);
    nr_col = nr_col * ratio_nr; nr_frz = nr_frz * ratio_nr;
    nr_self = nr_self * ratio_nr; nr_evap = nr_evap * ratio_nr;
    const T sinks_ni = (ni2nr_melt + ni_sub_n + ni_self) * dt;
    const T sources_ni = ni + (ninuc + nr_frz + nc_frz) * dt;
    const T ratio_ni =
        sinks_ni > sources_ni ? sources_ni / tmax(sinks_ni, T(1e-30)) : T(1);
    ni2nr_melt = ni2nr_melt * ratio_ni; ni_sub_n = ni_sub_n * ratio_ni;
    ni_self = ni_self * ratio_ni;

    // prevent_liq_supersaturation
    const T qv_sources = sub + ev;
    const T qv_sinks_plq = dep + qinuc;
    const T t_end =
        temp + ((qv_sinks_plq - sub) * T(LS) / T(CP_D) - ev * T(LV) / T(CP_D)) * dt;
    const T qsl_end = qv_sat_liq(t_end, pres);
    const T A_plq = T(LV) * qsl_end * dt / T(CP_D) / (T(R_V) * t_end * t_end) *
                    (T(LS) * sub + T(LV) * ev);
    const T floor_ = sizeof(T) == 8 ? T(1e-300) : T(1e-35);
    T frac_plq = (qsl_end - qv + qv_sinks_plq * dt + A_plq) /
                 tmax(qv_sources * dt + A_plq, floor_);
    frac_plq = tclamp(frac_plq, T(0), T(1));
    if (qv_sources < T(QSMALL)) frac_plq = T(0);
    sub = sub * frac_plq;
    ev = ev * frac_plq;

    const T qc_new = qc + dt * (-au - ac - qc_frz - rim - shed - berg);
    const T qr_new = qr + dt * (au + ac - ev - qr_frz - qrcol + melt + shed);
    const T qi_new =
        qi + dt * (qc_frz + qr_frz + qrcol + dep + qinuc + berg - sub - melt + rim);
    const T qv_new = qv + dt * (ev + sub - dep - qinuc);
    const T nr_new = nr + dt * (ncautr - nr_self - nr_frz - nr_col + ni2nr_melt +
                                ncshdc + nr_shed_wg - nr_evap);
    const T ni_new =
        ni + dt * (ninuc + nc_frz + nr_frz - ni_self - ni2nr_melt - ni_sub_n);
    T qm_new = qm + dt * (rim + qr_frz + qrcol + qc_frz -
                          (melt + sub) * qm / tmax(qi, T(QSMALL)));
    T bm_new = bm + dt * (rim / rho_rime + (qr_frz + qrcol + qc_frz) / T(900.0) -
                          (melt + sub) * bm / tmax(qi, T(QSMALL)));
    if (qm_new < T(0)) qm_new = bm_new = T(0);
    if (log_wg) {
      qm_new = qi_new;
      bm_new = qi_new / T(900.0);
    }
    if (PNC) nc = tmax(nc + dt * (-nc_accret - nc2nr_auto - nc_collect - nc_frz), T(0));
    else nc = skip_lvl ? nc : T(NCCNST) * inv_rho;
    qc = qc_new; qr = qr_new; qi = qi_new; qv = qv_new;
    nr = nr_new; ni = ni_new; qm = qm_new; bm = bm_new;
    const T cpx = T(CP_D) * exner;
    theta = theta + dt / cpx *
                        (T(LV) * (-ev) + T(LS) * (dep + qinuc - sub) +
                         T(LF) * (qc_frz + qr_frz + qrcol + rim + berg - melt));
    qc = tmax(qc, T(0)); qr = tmax(qr, T(0)); qi = tmax(qi, T(0));
    qv = tmax(qv, T(0)); nr = tmax(nr, T(0)); ni = tmax(ni, T(0));

    // end-of-part2 clipping
    const bool tiny_c2 = qc < T(QSMALL);
    qv = qv + (tiny_c2 ? qc : T(0));
    theta = theta - (tiny_c2 ? qc * T(LV) / cpx : T(0));
    if (tiny_c2) qc = nc = T(0);
    const bool tiny_r2 = qr < T(QSMALL);
    qv = qv + (tiny_r2 ? qr : T(0));
    theta = theta - (tiny_r2 ? qr * T(LV) / cpx : T(0));
    if (tiny_r2) qr = nr = T(0);
    const bool tiny_i2 = qi < T(QSMALL);
    qv = qv + (tiny_i2 ? qi : T(0));
    theta = theta - (tiny_i2 ? qi * T(LS) / cpx : T(0));
    if (tiny_i2) qi = ni = qm = bm = T(0);
    ni = cap_ni(ni, inv_rho);

    out[0] = qc; out[1] = nc; out[2] = qr; out[3] = nr; out[4] = qi;
    out[5] = ni; out[6] = qm; out[7] = bm; out[8] = qv; out[9] = theta;
  }
};

struct Wrapper {
  static constexpr int NIN = 13, NOUT = 14;
  template <typename T> __device__ static void run(const T* in, T* out, T) {
    const T rho_d = in[0];
    T temp = in[1], rho_c = in[2];
    const T rho_nc = in[3], rho_r = in[4], rho_nr = in[5], rho_i = in[6];
    const T rho_ni = in[7], rho_m = in[8], rho_bm = in[9];
    T rho_v = in[10];
    const T qv_prev_f = in[11], t_prev_f = in[12];
    const T rho = rho_d + rho_c + rho_r + rho_i + rho_v;
    adjust_state(rho, rho_d, rho_v, rho_c, temp);
    const T inv_rd = T(1) / rho_d;
    const T qv = rho_v * inv_rd;
    const T pressure = T(R_D) * rho_d * temp + T(R_V) * rho_v * temp;
    const T exner = tpow(pressure / T(P0), T(R_D / CP_D));
    const bool first = t_prev_f <= T(0);
    out[0] = rho_c * inv_rd; out[1] = rho_nc * inv_rd;
    out[2] = rho_r * inv_rd; out[3] = rho_nr * inv_rd;
    out[4] = rho_i * inv_rd; out[5] = rho_ni * inv_rd;
    out[6] = rho_m * inv_rd; out[7] = rho_bm * inv_rd;
    out[8] = qv; out[9] = temp / exner; out[10] = exner; out[11] = pressure;
    out[12] = first ? qv : qv_prev_f;
    out[13] = first ? temp : t_prev_f;
  }
};

// -- the executor ------------------------------------------------------------
template <int NIN, int NOUT> struct Ptrs {
  const void* in[NIN];
  void* out[NOUT];
};

template <class Phase, typename T>
__global__ void __launch_bounds__(THREADS)
    cellwise(const Ptrs<Phase::NIN, Phase::NOUT> p, int64_t n, T dt) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  T in[Phase::NIN], out[Phase::NOUT];
#pragma unroll
  for (int k = 0; k < Phase::NIN; ++k) in[k] = __ldg(static_cast<const T*>(p.in[k]) + c);
  Phase::run(in, out, dt);
#pragma unroll
  for (int k = 0; k < Phase::NOUT; ++k) static_cast<T*>(p.out[k])[c] = out[k];
}

template <class Phase, typename T>
int launch_phase(const void* const* in, int nin, void* const* out, int nout,
                 long long n, double dt, void* stream) {
  if (nin != Phase::NIN || nout != Phase::NOUT || n < 0) return cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Ptrs<Phase::NIN, Phase::NOUT> p;
  for (int k = 0; k < Phase::NIN; ++k) p.in[k] = in[k];
  for (int k = 0; k < Phase::NOUT; ++k) p.out[k] = out[k];
  cellwise<Phase, T><<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, (int64_t)n, T(dt));
  return cudaGetLastError();
}

template <typename T>
int dispatch(int phase, const void* const* in, int nin, void* const* out, int nout,
             long long n, double dt, void* stream) {
  switch (phase) {
    case 0: return launch_phase<Part1<false>, T>(in, nin, out, nout, n, dt, stream);
    case 1: return launch_phase<Part1<true>, T>(in, nin, out, nout, n, dt, stream);
    case 2: return launch_phase<Update<false>, T>(in, nin, out, nout, n, dt, stream);
    case 3: return launch_phase<Update<true>, T>(in, nin, out, nout, n, dt, stream);
    case 4: return launch_phase<Wrapper, T>(in, nin, out, nout, n, dt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// phase: 0/1 part1 (prescribed / predicted nc), 2/3 update (same), 4 wrapper
int p3_cellwise_f32(int phase, const void* const* in, int nin, void* const* out,
                    int nout, long long n, double dt, void* stream) {
  return dispatch<float>(phase, in, nin, out, nout, n, dt, stream);
}

int p3_cellwise_f64(int phase, const void* const* in, int nin, void* const* out,
                    int nout, long long n, double dt, void* stream) {
  return dispatch<double>(phase, in, nin, out, nout, n, dt, stream);
}

const char* p3_cellwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
