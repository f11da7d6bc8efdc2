// The P3 scheme's per-cell phases as one fused pass each, for NVIDIA Hopper
// (sm_90a): part1 + in-cloud values (13 inputs, 21 outputs), the
// conservation / prognostic update / end-of-part2 clip (45 inputs + dt, 10
// outputs), and the wrapper's inputs with the saturation Newton (13 inputs,
// 14 outputs); the table tier's rates around the lookups (RatesPre,
// RatesPost); and the homogeneous freezing with p3_main_part3 (Part3: 14
// inputs, 10 outputs, 16 with the diagnostics) and the wrapper's output
// pass (WrapperOut: 12 inputs, 11 outputs), the XLA-fused tail of the JAX scheme
// (miniweatherml_tpu/physics/p3.py:1392-1485, :1726-1741).
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
// inputs make it the register-heaviest phase.  RatesPre, the one phase with
// presence flags, has a launch path of its own (rates_pre_kernel below):
// a few 16-byte words of neighbouring cells a thread, and the flags
// reduced per block.  Wrapper and RatesPost have one too (cell_kernel):
// one cell a thread whose body reads each input only where it is needed
// and stores each output once final; RatesPost runs each gated group of
// rates under a real branch on its gate, and Wrapper its Newton only where
// the result is kept and only until a trip leaves x's bits as they were,
// so a warp skips the work none of its cells keeps.  Both still do, on
// every value they keep, the plain version's operations in its order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "p3_index.cuh"
#include "p3_math.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ICE_K = 4;  // the packed ice table's columns 2, 1, 7, 8
constexpr double RHO_RIMEMIN = 50.0, RHO_RIMEMAX = 900.0;

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// The saturation Newton of compute_adjusted_state from its seed (one Newton
// step from x = 0 on the svp already computed): the best iterate ever
// visited, after at most n_newton + 1 trips.  A trip is a dependent chain
// of one exp and three divisions, so a cell ends its loop as soon as it can
// without changing a bit: once a trip leaves x with the bits it started
// with.  The state after such a trip is fixed.  f is a function of x alone,
// so the next trip finds the same f; |f| is not below fb, which that trip
// set to |f| or left at a value |f| was not below, so xb and fb stay; lo or
// hi, whichever f's sign picks, is set to x again, which it already holds;
// and xn and its bracket test are the same, so x is too.  Every later trip
// would change nothing, and the result equals the fixed-count loop's bit
// for bit, NaN iterates included (the bits are compared, not the values,
// so +0 and -0 differ and a NaN repeats only with the same payload).
template <typename T>
__device__ T saturation_newton(T rho, T temp, T rho_v, T rho_c, T svp, T pv, T Lv,
                               bool condensing, T cp0, T dcp) {
  const int n_newton = sizeof(T) == 8 ? 10 : 7;
  T lo = condensing ? T(0) : -rho_c;
  T hi = condensing ? rho_v : T(0);
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
    const T next = ((xn >= lo) && (xn <= hi)) ? xn : T(0.5) * (lo + hi);
    const bool fixed = same_bits(next, x);
    x = next;
    if (fixed) break;
  }
  return xb;
}

// compute_adjusted_state, guarded-Newton form (microphysics_p3.h:467-550).
// The Newton runs only where its result is kept: a cell that neither
// condenses nor evaporates keeps x = 0, and an evaporating cell still
// subsaturated once all its cloud is gone takes the boundary root -rho_c.
template <typename T>
__device__ void adjust_state(T rho, T rho_d, T& rho_v, T& rho_c, T& temp) {
  const T svp = magnus_svp(temp);
  const T pv = rho_v * T(R_V) * temp;
  const bool condensing = pv > svp;
  const bool evaporating = (pv < svp) && (rho_c > T(0));
  const T Lv = latent_heat_condensation(temp);
  T x = T(0);
  if (condensing || evaporating) {
    const T rho_t = rho_d + rho_v + rho_c;
    const T cp0 = (rho_d * T(CP_D) + rho_v * T(CP_V) + rho_c * T(CP_L)) / rho_t;
    const T dcp = T(CP_L - CP_V) / rho_t;
    bool boundary = false;
    if (evaporating) {
      const T cp_lo = cp0 - rho_c * dcp;
      const T t_lo = temp - rho_c * Lv / (rho * cp_lo);
      boundary = (rho_v + rho_c) * T(R_V) * t_lo - magnus_svp(t_lo) <= T(0);
    }
    if (!boundary)
      x = saturation_newton(rho, temp, rho_v, rho_c, svp, pv, Lv, condensing, cp0, dcp);
    if (boundary) x = -rho_c;
  }
  const T rv = tmax(rho_v - x, T(0));
  const T rc = tmax(rho_c + x, T(0));
  const T cp = cp_moist(rho_d, rv, rc);
  temp = temp + x * Lv / (rho * cp);
  rho_v = rv;
  rho_c = rc;
}

// -- the three phases ------------------------------------------------------
// A phase: NIN inputs and NOUT outputs of type T, NIOUT int32 outputs and
// NFLAG presence flags (set where any cell of the field sets them).
template <bool PNC> struct Part1 {
  static constexpr int NIN = 13, NOUT = 21, NIOUT = 0, NFLAG = 0;
  template <typename T>
  __device__ static void run(const T* in, T* out, int*, bool*, double, const T*) {
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
  static constexpr int NIN = 45, NOUT = 10, NIOUT = 0, NFLAG = 0;
  template <typename T>
  __device__ static void run(const T* in, T* out, int*, bool*, double dt_, const T*) {
    const T dt = T(dt_);
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

// A phase body's fields: in(k) gives input k, out(k, v) sets output k.
// ArrayIO reads and writes the executor's register arrays; CellIO (the
// launch path of Wrapper and RatesPost, cell_kernel below) reads an input
// from device memory where the body asks for it and stores an output as
// soon as the body has it, so that neither holds a register longer.
template <typename T> struct ArrayIO {
  const T* x;
  T* o;
  __device__ __forceinline__ T in(int k) const { return x[k]; }
  __device__ __forceinline__ void out(int k, T v) const { o[k] = v; }
};

// The wrapper's inputs: the densities to mixing ratios (the seven that the
// saturation adjustment leaves alone first), the adjustment, pressure /
// exner / theta and the qv_prev / t_prev history.
struct Wrapper {
  static constexpr int NIN = 13, NOUT = 14, NIOUT = 0, NFLAG = 0;
  template <typename T, class IO>
  __device__ static void body(const IO& io, double) {
    const T rho_d = io.in(0), rho_r = io.in(4), rho_i = io.in(6);
    T temp = io.in(1), rho_c = io.in(2), rho_v = io.in(10);
    const T rho = rho_d + rho_c + rho_r + rho_i + rho_v;
    const T inv_rd = T(1) / rho_d;
    io.out(2, rho_r * inv_rd);
    io.out(4, rho_i * inv_rd);
    io.out(1, io.in(3) * inv_rd);
    io.out(3, io.in(5) * inv_rd);
    io.out(5, io.in(7) * inv_rd);
    io.out(6, io.in(8) * inv_rd);
    io.out(7, io.in(9) * inv_rd);
    adjust_state(rho, rho_d, rho_v, rho_c, temp);
    const T qv = rho_v * inv_rd;
    const T pressure = T(R_D) * rho_d * temp + T(R_V) * rho_v * temp;
    const T exner = tpow(pressure / T(P0), T(R_D / CP_D));
    io.out(0, rho_c * inv_rd);
    io.out(8, qv);
    io.out(9, temp / exner);
    io.out(10, exner);
    io.out(11, pressure);
    const T qv_prev_f = io.in(11), t_prev_f = io.in(12);
    const bool first = t_prev_f <= T(0);
    io.out(12, first ? qv : qv_prev_f);
    io.out(13, first ? temp : t_prev_f);
  }
  template <typename T>
  __device__ static void run(const T* in, T* out, int*, bool*, double dt, const T*) {
    body<T>(ArrayIO<T>{in, out}, dt);
  }
};

// The table tier's rates before the lookups (p3._p3_rates_pre_cellwise):
// the rime re-bounds persisted to qm/bm, and the ice, collection and rain
// size index sets; flags: any ice, any ice with rain, any rain.
struct RatesPre {
  static constexpr int NIN = 10, NOUT = 7, NIOUT = 5, NFLAG = 3;
  template <typename T>
  __device__ static void run(const T* in, T* out, int* iout, bool* flag, double, const T*) {
    const T qi = in[0], qr = in[1], qm = in[2], bm = in[3], qi_in = in[4];
    const T qm_in = in[5], bm_in = in[6], ni_in = in[7], qr_in = in[8];
    const T nr_in = in[9];
    T qm_reb = qm_in, bm_reb = bm_in;
    const T rr = bulk_rho_rime(qi_in, qm_reb, bm_reb);
    const bool has_qi = qi >= T(QSMALL), has_qr = qr >= T(QSMALL);
    out[0] = has_qi ? qm_reb : qm;
    out[1] = has_qi ? bm_reb : bm;
    ice_table_indices(qi_in, tmax(ni_in, T(NSMALL)), qm_reb, rr, iout[0], out[2],
                      iout[1], out[3], iout[2], out[4]);
    rain_collection_index(qr_in, tmax(nr_in, T(NSMALL)), iout[3], out[5]);
    rain_dm_index(qr_in, nr_in, iout[4], out[6]);
    flag[0] = has_qi;
    flag[1] = has_qi && has_qr;
    flag[2] = has_qr;
  }
};

// Every process rate of the table tier after the lookups
// (p3._p3_rates_post_cellwise, with p3._p3_warm_ice_rates inlined): the
// update's 25 rate inputs.  Each group of rates that a gate keeps is a
// function below, run under a real branch on its gate, so that a warp none
// of whose cells passes the gate skips the group's transcendentals, and
// its inputs are loaded only where a gate that reads them holds; a cell
// whose gate fails gets the value the plain version gives it there (+0,
// rho_rime 400, ni_rate = ni_in).  What later rates read whatever the
// gates (qv_si, abi, ni_rate, the deposition) is computed in every cell.
// Each value a group keeps is the plain version's, operation for
// operation.
namespace rp {
enum In {
  QC, NC, QR, QI, NI, QV, TEMP, PRES, RHO, QC_IN, QR_IN, QI_IN, QM_IN, BM_IN, NC_IN,
  NR_IN, NI_IN, MU_CD, QV_PREV, T_PREV, TAB7, TAB8, TAB4, TAB2, TAB3, TAB5, TAB10,
  COLL2, COLL1, REVAP_V
};
enum Out {
  AU, AC, QC_FRZ, NC_FRZ, QR_FRZ, NR_FRZ, RIM, SHED, NCSHDC, BERG, DEP, SUB, EV, MELT,
  QINUC, NINUC, QRCOL, NR_COL, NR_SELF, NI_SELF, NR_SHED_WG, RHO_RIME, LOG_WG, NI_RATE,
  QV_SI
};
constexpr double CONS5 = PI / 6.0 * 2.0;
constexpr double CONS6 = (PI / 6.0) * (PI / 6.0) * RHO_H2O * 2.0;

// what the groups share: the gate inputs, and values computed once (each
// read only where the group that sets it ran)
template <typename T> struct Cell {
  T dt, qc, qr, qi, qv, temp, pres, rho, inv_rho, tc, qc_in, qr_in, qi_in;
  bool has_qc, has_qr, has_qi;
  T qv_si, abi, ni_rate, epsi;  // saturation; ni_rate, epsi: the body
  T nr1, lamr;               // rain_size
  T mu_v, dv_diff, cbrt_sc;  // transport
  T qsl;                     // where the Bergeron rate or rain evaporation runs
  T rhofaci, rim0;           // ice_rates (rim0: riming before wet growth)
};

// ice saturation (every cell): qv_si and abi set, the ice supersaturation
// returned
template <typename T> __device__ T saturation(Cell<T>& c) {
  c.qv_si = qv_sat_ice(c.temp, c.pres);
  const T dqsidt = T(LS) * c.qv_si / (T(R_V) * c.temp * c.temp);
  c.abi = T(1) + dqsidt * T(LS) / T(CP_D);
  return c.qv / tmax(c.qv_si, T(QSMALL)) - T(1);
}
// KK2000 autoconversion (gate: qc_in >= 1e-8)
template <typename T, class IO> __device__ T autoconversion(const IO& io, const Cell<T>& c) {
  return T(1350.0) * tpow(tmax(c.qc_in, T(QSMALL)), T(2.47)) *
         tpow(tmax(io.in(NC_IN) * T(1.0e-6) * c.rho, T(NSMALL)), T(-1.79));
}
// accretion (gate: cloud and rain)
template <typename T> __device__ T accretion(const Cell<T>& c) {
  return T(67.0) * tpow(tmax(c.qc_in * c.qr_in, T(1e-300)), T(1.15));
}
// rain self-collection with breakup, and the rain slope lamr (gate: rain)
template <typename T, class IO> __device__ T rain_size(const IO& io, Cell<T>& c) {
  const T nr_in = io.in(NR_IN);
  c.nr1 = tmax(nr_in, T(NSMALL));
  const T dm_r = cbrt_newton(tmax(c.qr_in, T(QSMALL)) / (T(PI * RHO_H2O) * c.nr1));
  const T brk = dm_r < T(280.0e-6) ? T(1) : T(2.0) - texp(T(2300.0) * (dm_r - T(280.0e-6)));
  c.lamr = cbrt_newton(T(PI / 6.0 * RHO_H2O * 24.0) * c.nr1 / tmax(c.qr_in, T(QSMALL)));
  return brk * T(5.78) * nr_in * c.qr_in * c.rho;
}
// Cooper nucleation (gate: below -15 C at 5% ice supersaturation; the rate
// where n_nuc >= 1e-20)
template <typename T, class IO>
__device__ void nucleation(const IO& io, const Cell<T>& c, T& qinuc, T& ninuc) {
  const T n_coop = tmin(T(0.005) * texp(T(0.304) * tmax(-c.tc, T(0))) * T(1.0e3) * c.inv_rho,
                        T(100.0e3) * c.inv_rho);
  const T n_nuc = tmax(n_coop - io.in(NI), T(0)) / c.dt;
  if (n_nuc >= T(1.0e-20)) {
    qinuc = n_nuc * T(4.0 * PI / 3.0 * 900.0 * 1.0e-18);
    ninuc = n_nuc;
  }
}
// Bigg immersion freezing of cloud (gate: cloud, at or below -4 C)
template <typename T, class IO>
__device__ void bigg_cloud(const IO& io, const Cell<T>& c, T& qc_frz, T& nc_frz) {
  const T dum1_frz = texp(T(0.65) * tmin(-c.tc, T(40.0)));
  const T nc_in = io.in(NC_IN), mu_cd = io.in(MU_CD);
  const T lamc_frz = cloud_lamc(c.qc_in, io.in(NC), mu_cd);
  const T cdist1_c = tmax(nc_in, T(NSMALL)) * texp(-tlgamma(mu_cd + T(1)));
  const T l2c = lamc_frz * lamc_frz;
  qc_frz = T(CONS6) * cdist1_c * texp(tlgamma(mu_cd + T(7))) * dum1_frz / (l2c * (l2c * l2c));
  nc_frz = T(CONS5) * cdist1_c * texp(tlgamma(mu_cd + T(4))) * dum1_frz / (lamc_frz * l2c);
}
// ... and of rain (gate: rain, at or below -4 C)
template <typename T> __device__ void bigg_rain(const Cell<T>& c, T& qr_frz, T& nr_frz) {
  const T dum1_frz = texp(T(0.65) * tmin(-c.tc, T(40.0)));
  const T l2r = c.lamr * c.lamr;
  qr_frz = T(CONS6) * c.nr1 * T(5040.0) * dum1_frz / (l2r * (l2r * l2r));
  nr_frz = T(CONS5) * c.nr1 * T(24.0) * dum1_frz / (c.lamr * l2r);
}
// viscosity, vapour diffusivity and the Schmidt number's cube root (gate:
// ice, or rain evaporation)
template <typename T> __device__ void transport(Cell<T>& c) {
  c.mu_v = mu_visc(c.temp);
  c.dv_diff = T(8.794e-5) * tpow(c.temp, T(1.81)) / c.pres;
  c.cbrt_sc = cbrt_newton(c.mu_v / (c.rho * c.dv_diff));
}
// the ice rates (gate: ice): riming and shedding, ice-rain collection,
// self-collection, melting, deposition's epsi and the Bergeron rate, wet
// growth; stores ten outputs
template <typename T, class IO> __device__ void ice_rates(const IO& io, Cell<T>& c) {
  const T tc = c.tc, rho = c.rho, ni_rate = c.ni_rate, qv = c.qv, dv_diff = c.dv_diff;
  const T rhofaci = tpow(T(RHO_600MB) * c.inv_rho, T(0.54));
  c.rhofaci = rhofaci;
  const T collect_qc = rhofaci * io.in(TAB4) * c.qc_in * T(0.5) * rho * ni_rate;
  const T rim = (c.has_qc && tc < T(0)) ? collect_qc : T(0);
  const T shed = (c.has_qc && tc > T(0)) ? collect_qc : T(0);
  c.rim0 = rim;
  io.out(NCSHDC, shed * T(1.0 / 5.2e-7));
  T qrcol = T(0), nr_col = T(0);
  if (c.has_qr) {
    const T n0r = c.nr1 * c.lamr * c.lamr;
    if (tc <= T(0)) qrcol = io.in(COLL2) * n0r * rho * rhofaci * ni_rate;
    nr_col = io.in(COLL1) * n0r * rho * rhofaci * ni_rate;
  }
  io.out(NR_COL, nr_col);
  const T kap = T(1.414e3) * c.mu_v;
  const T eii =
      tclamp(T(0.001) + (c.temp - T(253.15)) * T(0.3 - 0.001) / T(20.0), T(0.001), T(0.3));
  T qm_reb = io.in(QM_IN), bm_reb = io.in(BM_IN);
  bulk_rho_rime(c.qi_in, qm_reb, bm_reb);
  const T fr = qm_reb / tmax(c.qi_in, T(QSMALL));
  const T eii_fact = tclamp(T(1) - (fr - T(0.6)) / T(0.3), T(0), T(1));
  io.out(NI_SELF, io.in(TAB3) * rho * eii * eii_fact * rhofaci * ni_rate * ni_rate);
  const T vent = io.in(TAB5) + io.in(TAB10) * c.cbrt_sc * tsqrt(rhofaci * rho / c.mu_v);
  const T qsat0 = qv_sat_liq(T(TMELT), c.pres);
  T melt = T(0), berg = T(0);
  if (tc > T(0))
    melt = tmax(vent * (tc * kap - rho * T(LV) * dv_diff * (qsat0 - qv)) * T(2.0) * T(PI) /
                    T(LF) * ni_rate,
                T(0));
  if (tc < T(0)) {
    c.epsi = vent * T(2.0) * T(PI) * rho * dv_diff * ni_rate;
    berg = tmax(c.epsi / c.abi * (c.qsl - c.qv_si), T(0));
  }
  io.out(MELT, melt);
  io.out(BERG, berg);
  // wet growth
  const bool cold_mix = (c.qc_in + c.qr_in >= T(1.0e-6)) && tc < T(0);
  const T qwgrth = cold_mix ? tmax(vent * T(2.0) * T(PI) *
                                       (rho * T(LV) * dv_diff * (qsat0 - qv) - tc * kap) /
                                       (T(CP_L) * tc + T(LF)) * ni_rate,
                                   T(0))
                            : T(INFINITY);
  T excess = tmax(rim + qrcol - qwgrth, T(0));
  if (!(excess >= T(1.0e-10))) excess = T(0);
  io.out(LOG_WG, cold_mix && excess >= T(1.0e-10) ? T(1) : T(0));
  const T tot_col = tmax(rim + qrcol, T(1e-30));
  const T wg_frac = rim + qrcol >= T(1.0e-10) ? excess / tot_col : T(0);
  io.out(SHED, shed + excess * (rim / tot_col));
  io.out(RIM, rim * (T(1) - wg_frac));
  io.out(QRCOL, qrcol * (T(1) - wg_frac));
  io.out(NR_SHED_WG, excess * T(1.923e6));
}
// the rime density (gate: riming of at least QSMALL, before wet growth)
template <typename T, class IO> __device__ T rime_density(const IO& io, const Cell<T>& c) {
  const T acn = stokes_acn(c.mu_v);
  const T vi_table = c.rhofaci * io.in(TAB2);
  T lamc_r;
  const T vt_qc = cloud_vt(c.qc_in, io.in(NC_IN), c.rho, acn, lamc_r);
  const T d_c = (io.in(MU_CD) + T(4)) / lamc_r;
  const T i_tc = T(1) / tmin(c.tc, T(-0.001));
  const T ri = tclamp(T(-0.5e6) * d_c * tabs(vi_table - vt_qc) * i_tc, T(1), T(12));
  return ri <= T(8) ? (T(0.051) + T(0.114) * ri - T(0.0055) * ri * ri) * T(1000.0)
                    : T(611.0) + T(72.25) * (ri - T(8));
}
// rain evaporation with the qv_prev / t_prev history (gate: rain, with
// qc_in + qi_in below 1e-6; the rate where subsaturated)
template <typename T, class IO> __device__ T rain_evaporation(const IO& io, const Cell<T>& c) {
  const T temp = c.temp, rho = c.rho, qv = c.qv, qsl = c.qsl, dt = c.dt;
  const T epsr = T(2.0 * PI) * c.nr1 * rho * c.dv_diff *
                 (T(1) / c.lamr * T(0.78 * 2.0) +
                  T(0.32) * tsqrt(rho / c.mu_v) * c.cbrt_sc * io.in(REVAP_V));
  const T dqsldt = T(LV) * qsl / (T(R_V) * temp * temp);
  const T abl = T(1) + dqsldt * T(LV) / T(CP_D);
  const T ssat_r = qv - qsl;
  const bool below = c.tc < T(0);
  const T eps_eff =
      tmax(below ? epsr + c.epsi * (T(1) + T(LS / CP_D) * dqsldt) / c.abi : epsr, T(1.0e-20));
  const T tau_eff = T(1) / eps_eff;
  const T A_c = (qv - io.in(QV_PREV)) / dt - dqsldt * (temp - io.in(T_PREV)) / dt -
                (below ? (qsl - c.qv_si) * (T(1) + T(LS / CP_D) * dqsldt) / c.abi * c.epsi
                       : T(0));
  const T tau_r = T(1) / tmax(epsr, T(1.0e-20));
  const T dtau = T(1) / tau_eff * dt;
  const T w_ts = -texpm1(-dtau) / dtau;
  const T instant = -ssat_r / (abl * tau_r);
  const T equilib = -A_c / abl * tau_eff / tau_r;
  const T ev_big = instant * w_ts + equilib * (T(1) - w_ts);
  T ev = (c.qr_in < T(1.0e-12) && qv / tmax(qsl, T(QSMALL)) < T(0.999)) ? c.qr_in / dt : ev_big;
  ev = tmin(ev, -ssat_r / dt / abl);
  ev = tmin(tmax(ev, T(0)), c.qr_in / dt);
  return ssat_r < T(0) ? ev : T(0);
}
}  // namespace rp

// RatesPost's inputs past its gate inputs, read by the groups from
// registers (x, filled by the body) and its outputs stored through io
template <typename T, class IO> struct Loaded {
  const T* x;
  const IO& io;
  __device__ __forceinline__ T in(int k) const { return x[k]; }
  __device__ __forceinline__ void out(int k, T v) const { io.out(k, v); }
};

struct RatesPost {
  static constexpr int NIN = 30, NOUT = 25, NIOUT = 0, NFLAG = 0;
  template <typename T, class IO>
  __device__ static void body(const IO& io, double dt_) {
    using namespace rp;
    Cell<T> c;
    c.dt = T(dt_);
    c.qc = io.in(QC);
    c.qr = io.in(QR);
    c.qi = io.in(QI);
    c.qv = io.in(QV);
    c.temp = io.in(TEMP);
    c.pres = io.in(PRES);
    c.rho = io.in(RHO);
    c.qc_in = io.in(QC_IN);
    c.qr_in = io.in(QR_IN);
    c.qi_in = io.in(QI_IN);
    c.inv_rho = T(1) / c.rho;
    c.tc = c.temp - T(TMELT);
    c.has_qc = c.qc >= T(QSMALL);
    c.has_qr = c.qr >= T(QSMALL);
    c.has_qi = c.qi >= T(QSMALL);
    c.epsi = T(0);
    c.nr1 = c.lamr = c.mu_v = c.dv_diff = c.cbrt_sc = c.qsl = c.rhofaci = c.rim0 = T(0);
    const bool frz_c = c.has_qc && c.tc <= T(-4.0);
    const bool riming = c.has_qi && c.has_qc && c.tc < T(0);  // rime_density's cells and more
    const bool evap = c.qc_in + c.qi_in < T(1.0e-6) && c.has_qr;

    // Every other input, loaded now where a gate that reads it holds (a
    // lane whose gates fail reads nothing): a warp's loads are in flight
    // together, not one group's after another's.
    T x[NIN];
    x[NI_IN] = io.in(NI_IN);
    x[NC_IN] = c.qc_in >= T(1.0e-8) || frz_c || riming ? io.in(NC_IN) : T(0);
    x[NR_IN] = c.has_qr ? io.in(NR_IN) : T(0);
    x[NI] = c.tc < T(-15.0) ? io.in(NI) : T(0);
    x[NC] = frz_c ? io.in(NC) : T(0);
    x[MU_CD] = frz_c || riming ? io.in(MU_CD) : T(0);
    const In ice_in[] = {QM_IN, BM_IN, TAB7, TAB8, TAB4, TAB3, TAB5, TAB10};
#pragma unroll
    for (int k = 0; k < 8; ++k) x[ice_in[k]] = c.has_qi ? io.in(ice_in[k]) : T(0);
    x[TAB2] = riming ? io.in(TAB2) : T(0);
    x[COLL1] = c.has_qi && c.has_qr ? io.in(COLL1) : T(0);
    x[COLL2] = c.has_qi && c.has_qr && c.tc <= T(0) ? io.in(COLL2) : T(0);
    x[QV_PREV] = evap ? io.in(QV_PREV) : T(0);
    x[T_PREV] = evap ? io.in(T_PREV) : T(0);
    x[REVAP_V] = evap ? io.in(REVAP_V) : T(0);
    const Loaded<T, IO> in{x, io};

    // -- the rates both tiers share (p3._p3_warm_ice_rates); a and b hold
    // a group's outputs until they are stored
    T a = T(0), b = T(0);
    if (c.qc_in >= T(1.0e-8)) a = autoconversion<T>(in, c);
    io.out(AU, a);
    a = T(0);
    if (c.has_qc && c.has_qr) a = accretion(c);
    io.out(AC, a);
    a = T(0);
    if (c.has_qr) a = rain_size<T>(in, c);
    io.out(NR_SELF, a);
    const T sup_i = saturation(c);
    io.out(QV_SI, c.qv_si);
    a = b = T(0);
    if (c.tc < T(-15.0) && sup_i >= T(0.05)) nucleation<T>(in, c, a, b);
    io.out(QINUC, a);
    io.out(NINUC, b);
    a = b = T(0);
    if (frz_c) bigg_cloud<T>(in, c, a, b);
    io.out(QC_FRZ, a);
    io.out(NC_FRZ, b);
    a = b = T(0);
    if (c.has_qr && c.tc <= T(-4.0)) bigg_rain(c, a, b);
    io.out(QR_FRZ, a);
    io.out(NR_FRZ, b);

    // -- the table tier
    c.ni_rate = x[NI_IN];
    if (c.has_qi) {
      T ni_t = tmax(x[NI_IN], T(NSMALL));
      ni_t = tmin(ni_t, x[TAB7] * ni_t);
      ni_t = tmax(ni_t, x[TAB8] * ni_t);
      c.ni_rate = ni_t;
    }
    io.out(NI_RATE, c.ni_rate);
    if (c.has_qi || evap) transport(c);
    if ((c.has_qi && c.tc < T(0)) || evap) c.qsl = qv_sat_liq(c.temp, c.pres);
    a = T(400.0);
    if (c.has_qi) {
      ice_rates<T>(in, c);
      if (c.rim0 >= T(QSMALL) && c.has_qc) a = rime_density<T>(in, c);
    } else {
      const Out ice_out[] = {RIM,   SHED,   NCSHDC,  BERG,       MELT,
                             QRCOL, NR_COL, NI_SELF, NR_SHED_WG, LOG_WG};
#pragma unroll
      for (int k = 0; k < 10; ++k) io.out(ice_out[k], T(0));
    }
    io.out(RHO_RIME, a);
    const T qi_tend = tmin(c.epsi / c.abi, T(1.0 / dt_)) * (c.qv - c.qv_si);
    io.out(DEP, c.tc < T(0) ? tmax(qi_tend, T(0)) : T(0));
    io.out(SUB, tmax(-qi_tend, T(0)));
    a = T(0);
    if (evap) a = rain_evaporation<T>(in, c);
    io.out(EV, a);
  }
  template <typename T>
  __device__ static void run(const T* in, T* out, int*, bool*, double dt, const T*) {
    body<T>(ArrayIO<T>{in, out}, dt);
  }
};

// Homogeneous freezing and p3_main_part3 (p3._p3_part3_cellwise): 14
// inputs (the ten prognostics after sedimentation, part1's temp, exner,
// rho, inv_rho), the ten prognostics out, and with DIAG the six diagnostic
// fields per cell after them (eff_radius_qc, eff_radius_qi, diam_qi,
// rho_qi, vm_qi, equiv_reflectivity; the caller applies the column mask).
// TAB: the table tier's ice lookup, read from global memory (cached on
// chip) where the cell has ice: the ice number limiter's columns 7 and 8
// from the packed (2, 1, 7, 8) table that p3_sed.cu stages, or with DIAG
// every column of the packed (2, 1, 7, 8, 6, 9, 11, 12) table.  The plain
// version gates the lookup on any cell having ice; a cell without ice is
// zeroed at the end, and its diagnostics set to their defaults, whatever
// the lookup gives, so both gates give the same outputs.
template <bool TAB, bool DIAG> struct Part3 {
  static constexpr int NIN = 14, NOUT = DIAG ? 16 : 10, NIOUT = 0, NFLAG = 0;
  template <typename T>
  __device__ static void run(const T* in, T* out, int*, bool*, double, const T* tab) {
    T qc = in[0], nc = in[1], qr = in[2], nr = in[3], qi = in[4], ni = in[5];
    T qm = in[6], bm = in[7], qv = in[8], theta = in[9];
    const T temp = in[10], exner = in[11], rho = in[12], inv_rho = in[13];
    const T cpx = T(CP_D) * exner;

    // homogeneous freezing, cloud then rain, gated on part1's temp
    const bool frz_c = qc >= T(QSMALL) && temp < T(TMELT - 40.0);
    T q_nuc = frz_c ? qc : T(0);
    qm = qm + q_nuc;
    qi = qi + q_nuc;
    bm = bm + q_nuc / T(RHO_RIMEMAX);
    ni = ni + (frz_c ? tmax(nc, T(NSMALL)) : T(0));
    theta = theta + q_nuc * T(LF) / cpx;
    if (frz_c) qc = nc = T(0);
    const bool frz_r = qr >= T(QSMALL) && temp < T(TMELT - 40.0);
    q_nuc = frz_r ? qr : T(0);
    qm = qm + q_nuc;
    qi = qi + q_nuc;
    bm = bm + q_nuc / T(RHO_RIMEMAX);
    ni = ni + (frz_r ? tmax(nr, T(NSMALL)) : T(0));
    theta = theta + q_nuc * T(LF) / cpx;
    if (frz_r) qr = nr = T(0);

    // part3: cloud, rain, ice
    const bool small_c = qc < T(QSMALL);
    qv = qv + (small_c ? qc : T(0));
    theta = theta - (small_c ? qc : T(0)) * T(LV) / cpx;
    T mu_c, lamc, lamr;
    const T nc3 = cloud_dsd2(qc, nc, rho, mu_c, lamc);
    nc = small_c ? T(0) : nc3;
    qc = small_c ? T(0) : qc;
    const bool small_r = qr < T(QSMALL);
    qv = qv + (small_r ? qr : T(0));
    theta = theta - (small_r ? qr : T(0)) * T(LV) / cpx;
    const T nr3 = rain_dsd2(qr, nr, lamr);
    nr = small_r ? T(0) : nr3;
    qr = small_r ? T(0) : qr;
    const bool small_i = qi < T(QSMALL);
    qv = qv + (small_i ? qi : T(0));
    theta = theta - (small_i ? qi : T(0)) * T(LS) / cpx;
    ni = tmax(ni, T(NSMALL));
    bulk_rho_rime(qi, qm, bm);
    ni = cap_ni(ni, inv_rho);
    // the lookup's columns 2, 1, 7, 8 (and with DIAG 6, 9, 11, 12)
    constexpr int K = DIAG ? 8 : ICE_K;
    T col[K] = {};
    if (TAB && qi >= T(QSMALL)) {
      const T rhop = tclamp(qm / tmax(bm, T(1e-30)), T(RHO_RIMEMIN), T(RHO_RIMEMAX));
      int i0, ii0, jj0;
      T fi, fii, fjj;
      ice_table_indices(qi, ni, qm, rhop, i0, fi, ii0, fii, jj0, fjj);
      clamp_ice_index(i0, ii0, jj0);
      constexpr int W = vec_width<T>(K);
      const int kp = round_up(K, W);
      // without DIAG only the limiter's columns 7 and 8 are read
#pragma unroll
      for (int k0 = DIAG || W >= K ? 0 : 2; k0 < K; k0 += W) {
        T v[W];
        ice_interp<T, W>(tab, ice_block(kp, W), ice_entry(kp, W), i0, ii0, jj0, fi, fii,
                         fjj, k0, v);
#pragma unroll
        for (int e = 0; e < W; ++e) col[k0 + e] = v[e];
      }
      ni = tmin(ni, col[2] * ni);
      ni = tmax(ni, col[3] * ni);
    }
    if (small_i) qi = ni = qm = bm = T(0);

    out[0] = qc; out[1] = nc; out[2] = qr; out[3] = nr; out[4] = qi;
    out[5] = ni; out[6] = qm; out[7] = bm; out[8] = qv; out[9] = theta;
    if constexpr (DIAG) {
      // part3's diagnostics (p3.py's order of operations)
      out[10] = small_c ? T(10.0e-6) : T(0.5) * (mu_c + T(3)) / lamc;
      // ze_rain = nr (mu_r + 6)! / mu_r! / lamr^6 at mu_r = 1
      const T l2 = lamr * lamr;
      const T ze_rain =
          small_r ? T(1.0e-22) : tmax(nr * T(5040.0) / (l2 * (l2 * l2)), T(1.0e-22));
      T ze_ice = T(1.0e-22);
      out[11] = T(25.0e-6);
      out[12] = out[13] = out[14] = T(0);
      if (TAB && !small_i) {
        out[14] = col[0] * tpow(T(RHO_600MB) * inv_rho, T(0.54));
        out[11] = col[4];
        out[12] = col[6];
        out[13] = col[7];
        ze_ice = tmax(T(1.0e-22) + T(0.1892) * col[5] * ni * rho, T(1.0e-22));
      }
      out[15] = T(10.0) * tlog10((ze_rain + ze_ice) * T(1.0e18));
    }
  }
};

// MicrophysicsP3.time_step's output pass (p3._p3_wrapper_out_cellwise): the
// nine mixing ratios, theta, exner and rho_d in; the nine densities
// clamped at 0, temp = theta exner and qv_prev = max(qv, 0) out.
struct WrapperOut {
  static constexpr int NIN = 12, NOUT = 11, NIOUT = 0, NFLAG = 0;
  template <typename T>
  __device__ static void run(const T* in, T* out, int*, bool*, double, const T*) {
    const T rho_d = in[11];
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = tmax(in[k] * rho_d, T(0));
    out[9] = in[9] * in[10];
    out[10] = tmax(in[8], T(0));
  }
};

// -- the executor ------------------------------------------------------------
template <class Phase> struct Ptrs {
  const void* in[Phase::NIN];
  void* out[Phase::NOUT];
  int* iout[Phase::NIOUT > 0 ? Phase::NIOUT : 1];
  bool* flags;  // Phase::NFLAG values, zeroed by the caller
  const void* table;  // the packed ice table of a phase that reads it
};

// the phases without presence flags: one cell a thread
template <class Phase, typename T>
__global__ void __launch_bounds__(THREADS)
    cellwise(const Ptrs<Phase> p, int64_t n, double dt) {
  static_assert(Phase::NFLAG == 0, "a phase with flags has a launch path of its own");
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  T in[Phase::NIN], out[Phase::NOUT];
  int iout[Phase::NIOUT > 0 ? Phase::NIOUT : 1];
#pragma unroll
  for (int k = 0; k < Phase::NIN; ++k) in[k] = __ldg(static_cast<const T*>(p.in[k]) + c);
  Phase::run(in, out, iout, nullptr, dt, static_cast<const T*>(p.table));
#pragma unroll
  for (int k = 0; k < Phase::NOUT; ++k) static_cast<T*>(p.out[k])[c] = out[k];
#pragma unroll
  for (int k = 0; k < Phase::NIOUT; ++k) p.iout[k][c] = iout[k];
}

// -- the launch path of Wrapper and RatesPost ---------------------------------
// One cell a thread through CellIO: the body loads an input when it asks
// for it (Wrapper where it first uses it; RatesPost its gate inputs, then
// the others where a gate that reads them holds) and stores each output as
// soon as it is final, so that neither holds a register for the whole body
// as in the executor above.  scripts/p3_rates_variants.py --phase
// rates_post|wrapper times it against the executor and against 16-byte
// words of neighbouring cells a thread (rates_pre's layout): both lost.
template <class Phase, typename T> struct CellIO {
  const Ptrs<Phase>& p;
  int64_t c;
  __device__ __forceinline__ T in(int k) const {
    return __ldg(static_cast<const T*>(p.in[k]) + c);
  }
  __device__ __forceinline__ void out(int k, T v) const { static_cast<T*>(p.out[k])[c] = v; }
};

template <class Phase, typename T>
__global__ void __launch_bounds__(THREADS)
    cell_kernel(const Ptrs<Phase> p, int64_t n, double dt) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n) Phase::template body<T>(CellIO<Phase, T>{p, c}, dt);
}

template <class Phase>
int check_counts(int nin, int nout, int niout, int nflags, long long n) {
  if (nin != Phase::NIN || nout != Phase::NOUT || niout != Phase::NIOUT ||
      nflags != Phase::NFLAG || n < 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <class Phase>
Ptrs<Phase> pointers(const void* const* in, void* const* out, void* const* iout, void* flags,
                     const void* table) {
  Ptrs<Phase> p;
  for (int k = 0; k < Phase::NIN; ++k) p.in[k] = in[k];
  for (int k = 0; k < Phase::NOUT; ++k) p.out[k] = out[k];
  for (int k = 0; k < Phase::NIOUT; ++k) p.iout[k] = static_cast<int*>(iout[k]);
  p.flags = static_cast<bool*>(flags);
  p.table = table;
  return p;
}

// CELLS: the phase's own launch path (cell_kernel), else the executor
template <class Phase, typename T, bool CELLS = false>
int launch_phase(const void* const* in, int nin, void* const* out, int nout,
                 void* const* iout, int niout, void* flags, int nflags, long long n,
                 double dt, const void* table, void* stream) {
  if (int e = check_counts<Phase>(nin, nout, niout, nflags, n)) return e;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto ptrs = pointers<Phase>(in, out, iout, flags, table);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (CELLS)
    cell_kernel<Phase, T><<<(unsigned)blocks, THREADS, 0, s>>>(ptrs, (int64_t)n, dt);
  else
    cellwise<Phase, T><<<(unsigned)blocks, THREADS, 0, s>>>(ptrs, (int64_t)n, dt);
  return cudaGetLastError();
}

// -- rates_pre's launch path: the presence flags reduced per block ---------
// The flags are three bytes of one tensor.  Stored once per warp that sets
// them (the executor above, before this launch path), the 524 288 warps of
// the 512x512x64 grid wrote up to three stores each to those three bytes:
// one L2 slice takes them one after the other, and the rest of the
// traffic that slice serves waits behind them (0.44 ms of a 0.94 ms f32
// call on the mixed state; scripts/p3_rates_variants.py).  Here a block
// takes RP_STEPS * THREADS words of RP_WORD<T> neighbouring cells (4 f32
// or 2 f64: one 16-byte load or store of each field, the int32 indices
// one of 16 or 8 bytes), a thread one word a step at block stride; each
// thread ORs its cells' flags, and the block stores each flag at most
// once, after one __syncthreads_or: 16 384 blocks at 512x512x64 in f32.
// Where a field is not 16-byte aligned, and for the n % RP_WORD cells at
// the end, a thread takes one cell.  Measured there: more steps a block
// (fewer stores) cost more than they save, a resident grid walking the
// cells at grid stride was 4-16% slower, the step loop unrolled (the W
// cells' arithmetic copied per step) took up to twice the time, and the
// math's slow paths cost nothing (fast-math builds ran as fast).  The
// arithmetic is RatesPre::run's, cell by cell.
template <typename T> constexpr int RP_WORD = 16 / sizeof(T);
template <typename T> constexpr int RP_STEPS = 2;

template <int B> struct Word;
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// W neighbouring values of one field from cell c0, in words of up to 16 B
template <typename U, int W>
__device__ __forceinline__ void load_cells(const void* field, int64_t c0, U (&v)[W]) {
  constexpr int B = W * sizeof(U) < 16 ? W * sizeof(U) : 16;
  using Wd = typename Word<B>::type;
  constexpr int NW = W * sizeof(U) / B;
  const Wd* src = reinterpret_cast<const Wd*>(static_cast<const U*>(field) + c0);
  Wd w[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = __ldg(src + j);
  memcpy(v, w, sizeof(v));
}

template <typename U, int W>
__device__ __forceinline__ void store_cells(void* field, int64_t c0, const U (&v)[W]) {
  constexpr int B = W * sizeof(U) < 16 ? W * sizeof(U) : 16;
  using Wd = typename Word<B>::type;
  constexpr int NW = W * sizeof(U) / B;
  Wd w[NW];
  memcpy(w, v, sizeof(v));
  Wd* dst = reinterpret_cast<Wd*>(static_cast<U*>(field) + c0);
#pragma unroll
  for (int j = 0; j < NW; ++j) dst[j] = w[j];
}

// RatesPre on the W cells from c0; ORs their flags into any
template <typename T, int W>
__device__ __forceinline__ void rates_pre_cells(const Ptrs<RatesPre>& p, int64_t c0,
                                                bool (&any)[RatesPre::NFLAG]) {
  using P = RatesPre;
  T in[P::NIN][W], out[P::NOUT][W];
  int iout[P::NIOUT][W];
#pragma unroll
  for (int k = 0; k < P::NIN; ++k) load_cells<T, W>(p.in[k], c0, in[k]);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    T x[P::NIN], o[P::NOUT];
    int io[P::NIOUT];
    bool f[P::NFLAG];
#pragma unroll
    for (int k = 0; k < P::NIN; ++k) x[k] = in[k][e];
    P::run<T>(x, o, io, f, 0.0, nullptr);
#pragma unroll
    for (int k = 0; k < P::NOUT; ++k) out[k][e] = o[k];
#pragma unroll
    for (int k = 0; k < P::NIOUT; ++k) iout[k][e] = io[k];
#pragma unroll
    for (int k = 0; k < P::NFLAG; ++k) any[k] = any[k] || f[k];
  }
#pragma unroll
  for (int k = 0; k < P::NOUT; ++k) store_cells<T, W>(p.out[k], c0, out[k]);
#pragma unroll
  for (int k = 0; k < P::NIOUT; ++k) store_cells<int, W>(p.iout[k], c0, iout[k]);
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    rates_pre_kernel(const Ptrs<RatesPre> p, int64_t n) {
  bool any[RatesPre::NFLAG] = {};
  const int64_t base = (int64_t)blockIdx.x * (RP_STEPS<T> * THREADS * W);
  // not unrolled: each copy of the W cells' arithmetic is a few KB of code
#pragma unroll 1
  for (int j = 0; j < RP_STEPS<T>; ++j) {
    const int64_t c = base + ((int64_t)j * THREADS + threadIdx.x) * W;
    if (c + W <= n) {
      rates_pre_cells<T, W>(p, c, any);
    } else {
      for (int64_t e = c; e < n; ++e) rates_pre_cells<T, 1>(p, e, any);
    }
  }
  // every thread of the block reaches the barriers
#pragma unroll
  for (int k = 0; k < RatesPre::NFLAG; ++k)
    if (__syncthreads_or(any[k]) && threadIdx.x == 0) p.flags[k] = true;
}

template <typename T>
int launch_rates_pre(const void* const* in, int nin, void* const* out, int nout,
                     void* const* iout, int niout, void* flags, int nflags, long long n,
                     void* stream) {
  using P = RatesPre;
  if (int e = check_counts<P>(nin, nout, niout, nflags, n)) return e;
  if (flags == nullptr) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  bool aligned = true;
  for (int k = 0; k < P::NIN; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(in[k]) % 16 == 0;
  for (int k = 0; k < P::NOUT; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(out[k]) % 16 == 0;
  for (int k = 0; k < P::NIOUT; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(iout[k]) % 16 == 0;
  const int w = aligned ? RP_WORD<T> : 1;
  const long long per_block = (long long)RP_STEPS<T> * THREADS * w;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const auto kernel = aligned ? rates_pre_kernel<T, RP_WORD<T>> : rates_pre_kernel<T, 1>;
  kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pointers<P>(in, out, iout, flags, nullptr), (int64_t)n);
  return cudaGetLastError();
}

// the part3 forms (a template argument list's comma would split the
// macro's argument below)
using Part3Approx = Part3<false, false>;
using Part3Tables = Part3<true, false>;
using Part3ApproxDiag = Part3<false, true>;
using Part3TablesDiag = Part3<true, true>;

template <typename T>
int dispatch(int phase, const void* const* in, int nin, void* const* out, int nout,
             void* const* iout, int niout, void* flags, int nflags, long long n,
             double dt, const void* table, void* stream) {
#define P3_PHASE(P) \
  launch_phase<P, T>(in, nin, out, nout, iout, niout, flags, nflags, n, dt, table, stream)
#define P3_CELLS(P) \
  launch_phase<P, T, true>(in, nin, out, nout, iout, niout, flags, nflags, n, dt, table, stream)
  switch (phase) {
    case 0: return P3_PHASE(Part1<false>);
    case 1: return P3_PHASE(Part1<true>);
    case 2: return P3_PHASE(Update<false>);
    case 3: return P3_PHASE(Update<true>);
    case 4: return P3_CELLS(Wrapper);
    case 5:
      return launch_rates_pre<T>(in, nin, out, nout, iout, niout, flags, nflags, n, stream);
    case 6: return P3_CELLS(RatesPost);
    case 7: return P3_PHASE(Part3Approx);
    case 8:
      if (table == nullptr || reinterpret_cast<uintptr_t>(table) % 16 != 0)
        return cudaErrorInvalidValue;
      return P3_PHASE(Part3Tables);
    case 9: return P3_PHASE(WrapperOut);
    case 10: return P3_PHASE(Part3ApproxDiag);
    case 11:
      if (table == nullptr || reinterpret_cast<uintptr_t>(table) % 16 != 0)
        return cudaErrorInvalidValue;
      return P3_PHASE(Part3TablesDiag);
    default: return cudaErrorInvalidValue;
  }
#undef P3_PHASE
#undef P3_CELLS
}

}  // namespace

extern "C" {

// phase: 0/1 part1 (prescribed / predicted nc), 2/3 update (same), 4
// wrapper, 5 rates_pre, 6 rates_post, 7/8 part3 ([approx] / table tier), 9
// wrapper_out, 10/11 part3 with its diagnostics ([approx] / table tier);
// iout: the int32 outputs, flags: the phase's presence flags (zeroed by the
// caller; null when it has none); table: the packed ice table, 16-byte
// aligned, columns (2, 1, 7, 8) for phase 8 and (2, 1, 7, 8, 6, 9, 11, 12)
// for phase 11 (null otherwise)
int p3_cellwise_f32(int phase, const void* const* in, int nin, void* const* out,
                    int nout, void* const* iout, int niout, void* flags, int nflags,
                    long long n, double dt, const void* table, void* stream) {
  return dispatch<float>(phase, in, nin, out, nout, iout, niout, flags, nflags, n, dt,
                         table, stream);
}

int p3_cellwise_f64(int phase, const void* const* in, int nin, void* const* out,
                    int nout, void* const* iout, int niout, void* flags, int nflags,
                    long long n, double dt, const void* table, void* stream) {
  return dispatch<double>(phase, in, nin, out, nout, iout, niout, flags, nflags, n, dt,
                          table, stream);
}

const char* p3_cellwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
