// P3-class microphysics: C++ native twin of the P3 scheme
// (miniweatherml_tpu/physics/p3.py, miniweatherml_tpu_torch/physics/p3.py).
// A copy of native/p3_kernels.cpp that differs only in this header, so
// that miniweatherml_tpu_torch builds its own library from its own tree
// (miniweatherml_tpu_torch/native/__init__.py).
//
// The reference implements P3 natively (Fortran 90 called through bind(C),
// model/modules/helpers/microphysics_p3/micro_p3.F90, entry
// p3_main_fortran declared at model/modules/microphysics_p3.h:7-20).  This
// framework's native tier is C++: the same scheme as the TPU-resident JAX
// path, bit-comparable in double precision, callable from the coupler
// module via ctypes/pure_callback (host execution, like the reference's
// host-staged Fortran call at microphysics_p3.h:364-376).
//
// Two fidelity tiers, matching physics/p3.py:
//   * table tier: after p3_set_tables() receives the parsed v4.1.1 ice /
//     ice-rain-collection tables plus the generated rain fall-speed /
//     ventilation tables (p3_init_a / p3_init_b analogs), every ice and
//     rain process runs the reference's table-driven formulation.
//   * continuous tier: without tables, the [approx] fallbacks.
//
// Array layout: (ncol, nz) row-major -- each column's vertical is
// contiguous, bottom-up.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <vector>

namespace {

constexpr double R_D = 287.042;
constexpr double CP_D = 1004.64;
constexpr double R_V = 461.505;
constexpr double CP_V = 1859.0;
constexpr double CP_L = 4188.0;
constexpr double RHO_H2O = 1000.0;
constexpr double LATVAP = 2501000.0;
constexpr double LATICE = 333700.0;
constexpr double TMELT = 273.15;
constexpr double QSMALL = 1.0e-14;
constexpr double NSMALL = 1.0e-16;
constexpr double NCCNST = 200.0e6;
constexpr double T_HOMOGFRZ = TMELT - 40.0;  // micro_p3_utils.F90:123
constexpr double MAX_TOTAL_NI = 500.0e3;     // micro_p3_utils.F90:112
constexpr double RHO_RIMEMIN = 50.0;         // micro_p3_utils.F90:151
constexpr double RHO_RIMEMAX = 900.0;        // micro_p3_utils.F90:152
constexpr double PI = 3.14159265358979323846;
// 1/(cons2 * (25e-6)^3), cons2 = 4 pi/3 rho_h2o (micro_p3_utils.F90:174-175)
const double CONS3 =
    1.0 / (4.0 * PI / 3.0 * RHO_H2O * 25.0e-6 * 25.0e-6 * 25.0e-6);

// table dims (micro_p3_utils.F90:43-46) and index constant
// 1/(0.1*log10(261.7)) (micro_p3_utils.F90:34)
constexpr int ISIZE = 50, RIMSIZE = 4, DENSIZE = 5, RCOLLSIZE = 30;
constexpr double DUM1_C = 4.135985029041767;
constexpr double MU_R = 1.0;                  // micro_p3_utils.F90:33
constexpr double F1R = 0.78, F2R = 0.32;      // micro_p3_utils:138-139

// table storage, filled by p3_set_tables
bool g_have_tables = false;
std::vector<double> g_ice;      // (DENSIZE, RIMSIZE, ISIZE, 12)
std::vector<double> g_coll;     // (DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, 2)
std::vector<double> g_vn;       // (300,) number-weighted rain fall speed
std::vector<double> g_vm;       // (300,) mass-weighted rain fall speed
std::vector<double> g_revap;    // (300,) rain ventilation integral

double svp_liquid(double temp) {
  double tc = temp - 273.15;
  return 610.94 * std::exp(17.625 * tc / (243.04 + tc));
}

double svp_ice(double temp) {
  double tc = temp - 273.15;
  return 611.21 * std::exp(22.587 * tc / (273.86 + tc));
}

// Murphy & Koop (2005) saturation mixing ratios -- the scheme-internal
// thermodynamics (wv_sat_scream.F90 MurphyKoop_svp + qv_sat; the Magnus
// forms above belong to the wrapper's saturation pre-adjustment only)
constexpr double EP_2 = 18.016 / 28.966;  // micro_p3_utils.F90:133

double mk_svp_liq(double t) {
  double logt = std::log(t);
  return std::exp(54.842763 - 6763.22 / t - 4.210 * logt + 0.000367 * t +
                  std::tanh(0.0415 * (t - 218.8)) *
                      (53.878 - 1331.22 / t - 9.44523 * logt +
                       0.014025 * t));
}

double mk_svp_ice(double t) {
  if (t >= TMELT) return mk_svp_liq(t);
  double logt = std::log(t);
  return std::exp(9.550426 - 5723.265 / t + 3.53068 * logt -
                  0.00728332 * t);
}

double p3_qv_sat_liq(double t, double pres) {
  double e = mk_svp_liq(t);
  return EP_2 * e / std::max(1.0e-3, pres - e);
}

double p3_qv_sat_ice(double t, double pres) {
  double e = mk_svp_ice(t);
  return EP_2 * e / std::max(1.0e-3, pres - e);
}

double latent_heat_condensation(double temp) {
  double tc = temp - 273.15;
  return (2500.8 - 2.36 * tc + 0.0016 * tc * tc - 0.00006 * tc * tc * tc) *
         1000.0;
}

double cp_moist(double rho_d, double rho_v, double rho_c) {
  double rho = rho_d + rho_v + rho_c;
  return (rho_d * CP_D + rho_v * CP_V + rho_c * CP_L) / rho;
}

// -- table index finding + interpolation (mirrors physics/p3_tables.py,
//    itself a vectorization of find_lookupTable_indices_1a/1b + the access
//    routines, micro_p3.F90:1508-1770) ------------------------------------

struct IceIdx {
  int i0, ii0, jj0;
  double fi, fii, fjj;
};

IceIdx ice_table_indices(double qi, double ni, double qm, double rhop) {
  double dum1 =
      (std::log10(std::max(qi, QSMALL) / std::max(ni, 1e-30)) + 18.0) *
          DUM1_C -
      10.0;
  int dumi = (int)std::floor(dum1);
  dum1 = std::clamp(dum1, 1.0, (double)ISIZE);
  dumi = std::clamp(dumi, 1, ISIZE - 1);

  double dum4 = (qm / std::max(qi, QSMALL)) * 3.0 + 1.0;
  int dumii = (int)std::floor(dum4);
  dum4 = std::clamp(dum4, 1.0, (double)RIMSIZE);
  dumii = std::clamp(dumii, 1, RIMSIZE - 1);

  double dum5 = rhop <= 650.0 ? (rhop - 50.0) * 0.005 + 1.0
                              : (rhop - 650.0) * 0.004 + 4.0;
  int dumjj = (int)std::floor(dum5);
  dum5 = std::clamp(dum5, 1.0, (double)DENSIZE);
  dumjj = std::clamp(dumjj, 1, DENSIZE - 1);

  return IceIdx{dumi - 1, dumii - 1, dumjj - 1, dum1 - dumi, dum4 - dumii,
                dum5 - dumjj};
}

double ice_at(int col, int jj, int ii, int i) {
  return g_ice[(((std::size_t)jj * RIMSIZE + ii) * ISIZE + i) * 12 +
               (col - 1)];
}

double interp_ice(int col, const IceIdx& x) {
  auto lin_i = [&](int jj, int ii) {
    return ice_at(col, jj, ii, x.i0) +
           x.fi * (ice_at(col, jj, ii, x.i0 + 1) - ice_at(col, jj, ii, x.i0));
  };
  auto lin_ii = [&](int jj) {
    double a = lin_i(jj, x.ii0);
    double b = lin_i(jj, x.ii0 + 1);
    return a + x.fii * (b - a);
  };
  double t1 = lin_ii(x.jj0);
  double t2 = lin_ii(x.jj0 + 1);
  return t1 + x.fjj * (t2 - t1);
}

double coll_at(int col, int jj, int ii, int i, int j) {
  return g_coll[((((std::size_t)jj * RIMSIZE + ii) * ISIZE + i) * RCOLLSIZE +
                 j) * 2 + (col - 1)];
}

double interp_collect(int col, const IceIdx& x, int j0, double fj) {
  auto lin_j = [&](int jj, int ii, int i) {
    return coll_at(col, jj, ii, i, j0) +
           fj * (coll_at(col, jj, ii, i, j0 + 1) - coll_at(col, jj, ii, i, j0));
  };
  auto lin_i = [&](int jj, int ii) {
    double a = lin_j(jj, ii, x.i0);
    double b = lin_j(jj, ii, x.i0 + 1);
    return a + x.fi * (b - a);
  };
  auto lin_ii = [&](int jj) {
    double a = lin_i(jj, x.ii0);
    double b = lin_i(jj, x.ii0 + 1);
    return a + x.fii * (b - a);
  };
  double t1 = lin_ii(x.jj0);
  double t2 = lin_ii(x.jj0 + 1);
  return std::pow(10.0, t1 + x.fjj * (t2 - t1));
}

void rain_collection_index(double qr, double nr, int* j0, double* fj) {
  bool has_rain = (qr >= QSMALL) && (nr > 0.0);
  double dumlr =
      std::cbrt(std::max(qr, QSMALL) / (PI * RHO_H2O * std::max(nr, 1e-30)));
  double dum3 = (std::log10(dumlr) + 5.0) * 10.70415;
  int dumj = (int)std::floor(dum3);
  dum3 = std::clamp(dum3, 1.0, (double)RCOLLSIZE);
  dumj = std::clamp(dumj, 1, RCOLLSIZE - 1);
  if (!has_rain) {
    dumj = 1;
    dum3 = 1.0;
  }
  *j0 = dumj - 1;
  *fj = dum3 - dumj;
}

void rain_size_index(double dm, int* i0, double* fi) {
  double rd_small = std::clamp((dm * 1e6 + 5.0) * 0.1, 1.0, 20.0);
  double rd_large = std::clamp((dm * 1e6 - 195.0) / 30.0 + 20.0, 20.0, 300.0);
  double rdum = dm <= 195.0e-6 ? rd_small : rd_large;
  int i_small = std::clamp((int)std::floor(rd_small), 1, 20);
  int i_large = std::clamp((int)std::floor(rd_large), 20, 299);
  int idum = dm <= 195.0e-6 ? i_small : i_large;
  *i0 = idum - 1;
  *fi = rdum - idum;
}

// calc_bulkRhoRime (micro_p3.F90:1897-1943): bound the bulk rime density
// to [50, 900] by adjusting bm, cap qm at qi, zero tiny rime.  rho_rime
// is 0 where bm < 1e-15, as the reference passes it to the index finder.
void bulk_rho_rime(double qi_, double* qm_, double* bm_, double* rho_rime) {
  if (*bm_ >= 1.0e-15) {
    *rho_rime = *qm_ / *bm_;
    if (*rho_rime < RHO_RIMEMIN) {
      *rho_rime = RHO_RIMEMIN;
      *bm_ = *qm_ / *rho_rime;
    } else if (*rho_rime > RHO_RIMEMAX) {
      *rho_rime = RHO_RIMEMAX;
      *bm_ = *qm_ / *rho_rime;
    }
  } else {
    *qm_ = 0.0;
    *bm_ = 0.0;
    *rho_rime = 0.0;
  }
  if (*qm_ > qi_ && *rho_rime > 0.0) {
    *qm_ = qi_;
    *bm_ = *qm_ / *rho_rime;
  }
  if (*qm_ < QSMALL) {
    *qm_ = 0.0;
    *bm_ = 0.0;
  }
}

// get_rain_dsd2's nr adjustment (micro_p3.F90:1841-1893, mu_r = 1)
double rain_dsd_nr(double qr_, double nr_) {
  if (qr_ < QSMALL) return nr_;
  double nr1 = std::max(nr_, NSMALL);
  const double cons1 = PI / 6.0 * RHO_H2O;
  double lamr = std::cbrt(cons1 * nr1 * 24.0 / std::max(qr_, QSMALL));
  double lamr_cl = std::clamp(lamr, 2.0 * 500.0, 2.0 * 1.0e5);
  return (lamr != lamr_cl)
             ? lamr_cl * lamr_cl * lamr_cl * qr_ / (24.0 * cons1)
             : nr1;
}

// get_cloud_dsd2's nc adjustment (micro_p3.F90:1774-1837)
double cloud_dsd_nc(double qc_, double nc_, double rho) {
  if (qc_ < QSMALL) return nc_;
  double nc1 = std::max(nc_, NSMALL);
  double s_ = 0.0005714 * (nc1 * 1.0e-6 * rho) + 0.2714;
  double mu_ = std::clamp(1.0 / (s_ * s_) - 1.0, 2.0, 15.0);
  double mval_ = (mu_ + 3.0) * (mu_ + 2.0) * (mu_ + 1.0);
  const double cons1 = PI / 6.0 * RHO_H2O;
  double lamc = std::cbrt(cons1 * nc1 * mval_ / std::max(qc_, QSMALL));
  double lamc_cl = std::clamp(lamc, (mu_ + 1.0) * 2.5e4, (mu_ + 1.0) * 1.0e6);
  return (lamc != lamc_cl)
             ? lamc_cl * lamc_cl * lamc_cl * qc_ / (cons1 * mval_)
             : nc1;
}

double interp_rain(const std::vector<double>& t, int i0, double fi) {
  i0 = std::clamp(i0, 0, (int)t.size() - 2);
  return t[i0] + fi * (t[i0 + 1] - t[i0]);
}

}  // namespace

extern "C" {

// Install the lookup tables (parsed/generated on the Python side by
// physics/p3_tables.py, the p3_init_a/p3_init_b analog).  Sizes fixed:
// ice (5*4*50*12), coll (5*4*50*30*2), vn/vm/revap (300).
void p3_set_tables(const double* ice, const double* coll, const double* vn,
                   const double* vm, const double* revap) {
  g_ice.assign(ice, ice + (std::size_t)DENSIZE * RIMSIZE * ISIZE * 12);
  g_coll.assign(coll,
                coll + (std::size_t)DENSIZE * RIMSIZE * ISIZE * RCOLLSIZE * 2);
  g_vn.assign(vn, vn + 300);
  g_vm.assign(vm, vm + 300);
  g_revap.assign(revap, revap + 300);
  g_have_tables = true;
}

int p3_has_tables() { return g_have_tables ? 1 : 0; }

// Instantaneous saturation adjustment by bisection over n cells
// (identical math to physics/p3.py compute_adjusted_state; 60 halvings).
void p3_adjust_state(std::int64_t n, const double* rho, const double* rho_d,
                     double* rho_v, double* rho_c, double* temp) {
  for (std::int64_t c = 0; c < n; ++c) {
    double rv0 = rho_v[c], rc0 = rho_c[c], t0 = temp[c];
    double svp = svp_liquid(t0);
    double pv = rv0 * R_V * t0;
    bool condensing = pv > svp;
    bool evaporating = (pv < svp) && (rc0 > 0.0);
    double lo = condensing ? 0.0 : (evaporating ? -rc0 : 0.0);
    double hi = condensing ? rv0 : 0.0;
    for (int it = 0; it < 60; ++it) {
      double x = 0.5 * (lo + hi);
      double rv = std::max(rv0 - x, 0.0);
      double rc = std::max(rc0 + x, 0.0);
      double Lv = latent_heat_condensation(t0);
      double cp = cp_moist(rho_d[c], rv, rc);
      double t_loc = t0 + x * Lv / (rho[c] * cp);
      bool super_sat = rv * R_V * t_loc > svp_liquid(t_loc);
      if (super_sat) lo = x; else hi = x;
    }
    double x = (condensing || evaporating) ? 0.5 * (lo + hi) : 0.0;
    double rv = std::max(rv0 - x, 0.0);
    double rc = std::max(rc0 + x, 0.0);
    double Lv = latent_heat_condensation(t0);
    double cp = cp_moist(rho_d[c], rv, rc);
    rho_v[c] = rv;
    rho_c[c] = rc;
    temp[c] = t0 + x * Lv / (rho[c] * cp);
  }
}

// One P3-class microphysics step over (ncol, nz) columns.
// Mirrors physics/p3.py p3_scheme (tables branch when p3_set_tables has
// been called, continuous tier otherwise).  qv_prev/t_prev carry the
// previous call's post-micro qv/T for evaporate_rain's analytic
// supersaturation integration (pass the current qv/T on the first step,
// like the reference wrapper's first_step branch).
void p3_column_step(std::int64_t ncol, std::int64_t nz, double dt, double* qc,
                    double* nc, double* qr, double* nr, double* qi, double* ni,
                    double* qm, double* bm, double* qv, double* theta,
                    const double* exner, const double* pres,
                    const double* rho_d, const double* dz,
                    const double* qv_prev, const double* t_prev,
                    double* precip_liq, double* precip_ice) {
  auto conserve2 = [dt](double avail, double& a, double& b) {
    double total = (a + b) * dt;
    if (total > avail) {
      double r = avail / std::max(total, 1e-300);
      a *= r;
      b *= r;
    }
  };

  std::int64_t n = ncol * nz;
  double vmax = 0.0;
  double dz_min = 1e300;

  // Total density from the *input* state: the JAX path computes rho once at
  // the top of p3_scheme and reuses it for all processes and sedimentation.
  std::vector<double> rho_pre(n), temp_pre(n);
  for (std::int64_t c = 0; c < n; ++c) {
    rho_pre[c] = rho_d[c] * (1.0 + qv[c] + qc[c] + qr[c] + qi[c]);
    temp_pre[c] = theta[c] * exner[c];
  }

  const bool tab = g_have_tables;
  const double rho_600mb = 60000.0 / (287.042 * 253.15);
  const double rho_1000mb = 100000.0 / (287.042 * 273.15);
  // 1 mm shed drops: dropmass = 5.2e-7 kg (micro_p3_utils.F90:57)
  const double inv_dropmass = 1.0 / 5.2e-7;

  // Pass 1: process rates + tendencies, cell-local.
  for (std::int64_t c = 0; c < n; ++c) {
    double temp = theta[c] * exner[c];
    double rho = rho_pre[c];
    double inv_rho = 1.0 / rho;
    // P3-internal latent heats are CONSTANTS (micro_p3_utils.F90:146-147)
    double Lv = LATVAP;
    double Ls = LATVAP + LATICE;
    double Lf = LATICE;

    // p3_main_part1 (:363-481): initial tiny-mass clipping, droplet
    // prescription, tiny-warm-ice instant melt; temp refreshed after
    // (mirrors the JAX scheme).
    double sup_i0_p1;
    {
      double qv_si0 = p3_qv_sat_ice(temp, pres[c]);
      double sup_i0 = qv[c] / std::max(qv_si0, QSMALL) - 1.0;
      sup_i0_p1 = sup_i0;
      if (qc[c] < QSMALL) {
        qv[c] += qc[c];
        theta[c] -= qc[c] * Lv / (CP_D * exner[c]);
        qc[c] = 0.0;
        nc[c] = 0.0;
      } else {
        nc[c] = NCCNST * inv_rho;  // prescribed droplet number (:436)
      }
      if (qr[c] < QSMALL) {
        qv[c] += qr[c];
        theta[c] -= qr[c] * Lv / (CP_D * exner[c]);
        qr[c] = 0.0;
        nr[c] = 0.0;
      }
      if (qi[c] < QSMALL || (qi[c] < 1.0e-8 && sup_i0 < -0.1)) {
        qv[c] += qi[c];
        theta[c] -= qi[c] * Ls / (CP_D * exner[c]);
        qi[c] = 0.0;
        ni[c] = 0.0;
        qm[c] = 0.0;
        bm[c] = 0.0;
      }
      if (qi[c] >= QSMALL && qi[c] < 1.0e-8 && temp >= TMELT) {
        qr[c] += qi[c];
        theta[c] -= qi[c] * Lf / (CP_D * exner[c]);
        qi[c] = 0.0;
        ni[c] = 0.0;
        qm[c] = 0.0;
        bm[c] = 0.0;
      }
      temp = theta[c] * exner[c];  // t_atm refresh (:477)
      temp_pre[c] = temp;  // end-of-part1 t_atm: sedimentation DSDs and
                           // homogeneous freezing use THIS (the reference
                           // never refreshes t_atm after part1)
    }

    // part2's level skip (:588-595): dry, hydrometeor-free, cold and
    // ice-subsaturated levels never reach the prognostic update (matters
    // only for the prescribed-nc reset there; the supersaturation is the
    // part1 pre-clip value, exactly as the reference's frozen
    // qv_supersat_i array)
    const bool skip_lvl = qc[c] < QSMALL && qr[c] < QSMALL &&
                          qi[c] < QSMALL && temp < TMELT &&
                          sup_i0_p1 < -0.05;

    // in-cloud mixing ratios (calculate_incloud_mixingratios,
    // micro_p3_utils.F90:238-292; cld_frac = 1): cell values gated on
    // qsmall with the reference's in-cloud magnitude caps
    const double qc_in = qc[c] >= QSMALL ? std::min(qc[c], 5.1e-3) : 0.0;
    const double qr_in = qr[c] >= QSMALL ? std::min(qr[c], 1.0e-2) : 0.0;
    const double qi_in = qi[c] >= QSMALL ? std::min(qi[c], 5.1e-3) : 0.0;
    const bool has_qm = qm[c] >= QSMALL && qi[c] >= QSMALL;
    const double qm_in = has_qm ? qm[c] : 0.0;
    const double bm_in =
        has_qm ? std::clamp(bm[c], 0.0, 5.1e-3) : 0.0;

    // part2's pre-process DSD limiting, reference order (get_cloud_dsd2
    // micro_p3.F90:626, get_rain_dsd2 :630); adjustments persist to the
    // cell nc/nr.  The helpers guard on q >= QSMALL internally, and
    // qc_in >= QSMALL iff qc[c] >= QSMALL (the in-cloud cap never drops
    // below QSMALL), so the calls are exact.
    nc[c] = cloud_dsd_nc(qc_in, nc[c], rho);
    nr[c] = rain_dsd_nr(qr_in, nr[c]);
    const double nc_in = qc[c] >= QSMALL ? std::max(nc[c], 0.0) : 0.0;
    const double nr_in = qr[c] >= QSMALL ? std::max(nr[c], 0.0) : 0.0;
    // impose_max_total_ni (:637) on the IN-CLOUD ni only; the prognostic
    // ni is capped at end-of-part2 (:921-925) and in part3 (:1073)
    double ni_in = qi[c] >= QSMALL ? std::max(ni[c], 0.0) : 0.0;
    if (ni_in >= 1e-20) {
      ni_in *= std::min(MAX_TOTAL_NI * inv_rho / ni_in, 1.0);
    }

    // cloud gamma-DSD (get_cloud_dsd2, micro_p3.F90:1774-1835)
    double mu_visc0 = 1.496e-6 * std::pow(temp, 1.5) / (temp + 120.0);
    double acn = 9.80616 * RHO_H2O / (18.0 * mu_visc0);
    double sfac = 0.0005714 * (nc_in * 1.0e-6 * rho) + 0.2714;
    double mu_cd = std::clamp(1.0 / (sfac * sfac) - 1.0, 2.0, 15.0);
    auto cloud_lamc = [&](double qc_) {
      double lamc = std::cbrt(PI / 6.0 * RHO_H2O * std::max(nc_in, NSMALL) *
                              (mu_cd + 3.0) * (mu_cd + 2.0) * (mu_cd + 1.0) /
                              std::max(qc_, QSMALL));
      return std::clamp(lamc, (mu_cd + 1.0) * 2.5e4, (mu_cd + 1.0) * 1.0e6);
    };
    auto cloud_vt = [&](double qc_) {
      double lamc = cloud_lamc(qc_);
      double v = acn *
                 std::exp(std::lgamma(mu_cd + 6.0) - std::lgamma(mu_cd + 4.0)) /
                 (lamc * lamc);
      return qc_ >= QSMALL ? v : 0.0;
    };

    double au = 0.0;
    if (qc_in >= 1.0e-8) {
      au = 1350.0 * std::pow(std::max(qc_in, QSMALL), 2.47) *
           std::pow(std::max(nc_in * 1.0e-6 * rho, NSMALL), -1.79);
    }
    double ac = 0.0;
    if (qc[c] >= QSMALL && qr[c] >= QSMALL) {
      ac = 67.0 * std::pow(std::max(qc_in * qr_in, 1e-300), 1.15);
    }
    double dm_r = std::cbrt(std::max(qr_in, QSMALL) /
                            (PI * RHO_H2O * std::max(nr_in, NSMALL)));
    double brk = dm_r < 280.0e-6 ? 1.0 : 2.0 - std::exp(2300.0 * (dm_r - 280.0e-6));
    double nr_self = qr[c] >= QSMALL ? brk * 5.78 * nr_in * qr_in * rho : 0.0;

    double qsl = p3_qv_sat_liq(temp, pres[c]);

    double tc_ = temp - TMELT;
    double qv_si = p3_qv_sat_ice(temp, pres[c]);
    double sup_i = qv[c] / std::max(qv_si, QSMALL) - 1.0;

    // ice nucleation, Cooper 1986 capped at 100e3/rho; crystals of mass
    // mi0 = 4pi/3 * 900e-18 (ice_nucleation micro_p3.F90:2576-2618)
    const double mi0 = 4.0 * PI / 3.0 * 900.0 * 1.0e-18;
    double n_coop = std::min(
        0.005 * std::exp(0.304 * std::max(-tc_, 0.0)) * 1.0e3 * inv_rho,
        100.0e3 * inv_rho);
    double n_nuc_r = std::max(n_coop - ni[c], 0.0) / dt;
    bool nucleate = (tc_ < -15.0) && (sup_i >= 0.05) && (n_nuc_r >= 1.0e-20);
    double qinuc = nucleate ? n_nuc_r * mi0 : 0.0;
    double ninuc = nucleate ? n_nuc_r : 0.0;

    // immersion freezing of cloud and rain, DSD-integrated Bigg 1953
    // (cldliq/rain_immersion_freezing micro_p3.F90:2504-2573; aimm = 0.65,
    // bimm = 2; cons5/cons6 micro_p3_utils.F90:177-178)
    const double aimm = 0.65, bimm = 2.0;
    const double cons5 = PI / 6.0 * bimm;
    const double cons6 = (PI / 6.0) * (PI / 6.0) * RHO_H2O * bimm;
    double dum1_frz = std::exp(aimm * std::min(-tc_, 40.0));
    double qc_frz = 0.0, nc_frz = 0.0, qr_frz = 0.0, nr_frz = 0.0;
    if (qc[c] >= QSMALL && tc_ <= -4.0) {   // T_rainfrz = tmelt - 4
      double lamc_frz = cloud_lamc(qc_in);
      double cdist1_c =
          std::max(nc_in, NSMALL) * std::exp(-std::lgamma(mu_cd + 1.0));
      qc_frz = cons6 * cdist1_c * std::exp(std::lgamma(7.0 + mu_cd)) *
               dum1_frz / std::pow(lamc_frz, 6.0);
      nc_frz = cons5 * cdist1_c * std::exp(std::lgamma(4.0 + mu_cd)) *
               dum1_frz / std::pow(lamc_frz, 3.0);
    }
    if (qr[c] >= QSMALL && tc_ <= -4.0) {
      // mu_r = 1: cdistr = nr, Gamma(8) = 5040, Gamma(5) = 24
      double lamr_frz = std::cbrt(PI / 6.0 * RHO_H2O * 24.0 *
                                  std::max(nr_in, NSMALL) /
                                  std::max(qr_in, QSMALL));
      qr_frz = cons6 * std::max(nr_in, NSMALL) * 5040.0 * dum1_frz /
               std::pow(lamr_frz, 6.0);
      nr_frz = cons5 * std::max(nr_in, NSMALL) * 24.0 * dum1_frz /
               std::pow(lamr_frz, 3.0);
    }

    double dep, sub, berg = 0.0, rim, shed = 0.0, melt;
    double qrcol = 0.0, nr_col = 0.0, ni_self = 0.0, nr_shed_wg = 0.0;
    double ncshdc = 0.0;
    double rho_rime = 400.0;
    double ev;
    double ni_rate = ni_in;
    bool log_wg = false;

    if (tab) {
      // -- table tier (mirrors physics/p3.py tables branch) --------------
      // calc_bulkRhoRime (:1897-1943): re-bounds PERSIST to the
      // prognostic qm/bm (part2 writes qm(k) = qm_incld back)
      double qm_reb = qm_in, bm_reb = bm_in, rho_rime_raw;
      bulk_rho_rime(qi_in, &qm_reb, &bm_reb, &rho_rime_raw);
      if (qi[c] >= QSMALL) {
        qm[c] = qm_reb;
        bm[c] = bm_reb;
      }
      IceIdx idx = ice_table_indices(qi_in, std::max(ni_in, NSMALL), qm_reb,
                                     rho_rime_raw);
      // part2's ni lambda limiter (tables 7/8, micro_p3.F90:662-678):
      // bounds the IN-CLOUD ni the rates see; the prognostic ni stays
      // unlimited until sedimentation/part3 (part2 limits ni_incld only)
      if (qi[c] >= QSMALL) {
        double nil = std::max(ni_in, NSMALL);
        nil = std::min(nil, interp_ice(7, idx) * nil);
        nil = std::max(nil, interp_ice(8, idx) * nil);
        ni_rate = nil;
      }
      double rhofaci = std::pow(rho_600mb * inv_rho, 0.54);
      const double eci = 0.5;
      double collect_qc =
          rhofaci * interp_ice(4, idx) * qc_in * eci * rho * ni_rate;
      bool both_ic = (qi[c] >= QSMALL) && (qc[c] >= QSMALL);
      rim = (both_ic && tc_ < 0.0) ? collect_qc : 0.0;
      shed = (both_ic && tc_ > 0.0) ? collect_qc : 0.0;
      // ncshdc counts ONLY warm-collection shedding (:2071); wet-growth
      // shedding contributes rain number via nr_ice_shed separately
      ncshdc = shed * inv_dropmass;
      double vi_table = rhofaci * interp_ice(2, idx);

      // rime density (calc_rime_density, micro_p3.F90:2413-2490)
      double vt_qc = cloud_vt(qc_in);
      double d_c = (mu_cd + 4.0) / cloud_lamc(qc_in);
      double i_tc = 1.0 / std::min(-0.001, tc_);
      double ri =
          std::clamp(-0.5e6 * d_c * std::fabs(vi_table - vt_qc) * i_tc, 1.0,
                     12.0);
      rho_rime = ri <= 8.0
                     ? (0.051 + 0.114 * ri - 0.0055 * ri * ri) * 1000.0
                     : 611.0 + 72.25 * (ri - 8.0);
      if (!(rim >= QSMALL && qc[c] >= QSMALL)) rho_rime = 400.0;

      // ice-rain collection (ice_rain_collection, micro_p3.F90:2103-2157)
      int j0;
      double fj;
      rain_collection_index(qr_in, std::max(nr_in, NSMALL), &j0, &fj);
      double lamr = std::cbrt(PI / 6.0 * RHO_H2O * 24.0 *
                              std::max(nr_in, NSMALL) /
                              std::max(qr_in, QSMALL));
      double n0r = std::max(nr_in, NSMALL) * lamr * lamr;
      // T <= 0: rain mass + number collected; T > 0: number only
      // (ice_rain_collection, micro_p3.F90:2103-2157)
      if (qi[c] >= QSMALL && qr[c] >= QSMALL) {
        if (tc_ <= 0.0) {
          qrcol =
              interp_collect(2, idx, j0, fj) * n0r * rho * rhofaci * ni_rate;
        }
        nr_col =
            interp_collect(1, idx, j0, fj) * n0r * rho * rhofaci * ni_rate;
      }

      // thermodynamic/ventilation parameters (micro_p3.F90:3564-3572)
      double mu_visc = mu_visc0;
      double dv_diff = 8.794e-5 * std::pow(temp, 1.81) / pres[c];
      double sc_n = mu_visc / (rho * dv_diff);
      double kap = 1.414e3 * mu_visc;
      double eii =
          std::clamp(0.001 + (temp - 253.15) * (0.3 - 0.001) / 20.0, 0.001,
                     0.3);
      double fr = qm_reb / std::max(qi_in, QSMALL);
      double eii_fact = std::clamp(1.0 - (fr - 0.6) / 0.3, 0.0, 1.0);
      bool has_ice_t = qi[c] >= QSMALL;
      if (has_ice_t) {
        ni_self = interp_ice(3, idx) * rho * eii * eii_fact * rhofaci *
                  ni_rate * ni_rate;
      }
      double vent =
          interp_ice(5, idx) +
          interp_ice(10, idx) * std::cbrt(sc_n) *
              std::sqrt(rhofaci * rho / mu_visc);
      double qsat0 = p3_qv_sat_liq(TMELT, pres[c]);
      melt = (has_ice_t && tc_ > 0.0)
                 ? std::max(vent *
                                (tc_ * kap -
                                 rho * Lv * dv_diff * (qsat0 - qv[c])) *
                                2.0 * PI / Lf * ni_rate,
                            0.0)
                 : 0.0;
      // epsi gated at T < 0 (:2346): warm ice melts but does NOT sublimate
      double epsi = (has_ice_t && tc_ < 0.0)
                        ? vent * 2.0 * PI * rho * dv_diff * ni_rate
                        : 0.0;
      double dqsidt = (Lv + LATICE) * qv_si / (R_V * temp * temp);
      double abi = 1.0 + dqsidt * (Lv + LATICE) / CP_D;
      double qi_tend = std::min(epsi / abi, 1.0 / dt) * (qv[c] - qv_si);
      dep = tc_ < 0.0 ? std::max(qi_tend, 0.0) : 0.0;
      sub = std::max(-qi_tend, 0.0);
      // Wegener-Bergeron-Findeisen (ice_deposition_sublimation,
      // micro_p3.F90:3326-3328)
      berg = (has_ice_t && tc_ < 0.0)
                 ? std::max(epsi / abi * (qsl - qv_si), 0.0)
                 : 0.0;

      // rain ventilation (calc_liq_relaxation_timescale + p3_init_b tables)
      double dm_r2 = (MU_R + 1.0) / lamr;
      int i0r;
      double fir;
      rain_size_index(dm_r2, &i0r, &fir);
      double revap_v = interp_rain(g_revap, i0r, fir);
      // cdistr = nr / Gamma(mu_r+1) = nr at mu_r = 1 (get_rain_dsd2,
      // micro_p3.F90:1880)
      double cdistr = std::max(nr_in, NSMALL);
      double gamma_mu2 = 2.0;
      double epsr =
          2.0 * PI * cdistr * rho * dv_diff *
          (F1R * gamma_mu2 / lamr +
           F2R * std::sqrt(rho / mu_visc) * std::cbrt(sc_n) * revap_v);

      // wet growth (ice_cldliq_wet_growth, micro_p3.F90:2259-2319)
      bool cold_mix = (qi[c] >= QSMALL) && (qc_in + qr_in >= 1.0e-6) &&
                      (tc_ < 0.0);
      double qwgrth =
          cold_mix
              ? std::max(vent * 2.0 * PI *
                             (rho * Lv * dv_diff * (qsat0 - qv[c]) -
                              tc_ * kap) /
                             (Lf + CP_L * tc_) * ni_rate,
                         0.0)
              : 1e300;
      double excess = std::max(rim + qrcol - qwgrth, 0.0);
      if (excess < 1.0e-10) excess = 0.0;
      double tot_col = std::max(rim + qrcol, 1e-30);
      double wg_frac = (rim + qrcol >= 1.0e-10) ? excess / tot_col : 0.0;
      shed += excess * (rim / tot_col);
      rim *= (1.0 - wg_frac);
      qrcol *= (1.0 - wg_frac);
      nr_shed_wg = excess * 1.923e6;
      // densify the rime in the prognostic update (:2313, :3196-3200)
      log_wg = cold_mix && excess >= 1.0e-10;

      // rain evaporation: analytically-integrated supersaturation
      // relaxation (evaporate_rain, micro_p3.F90:3383-3537)
      double dqsldt = Lv * qsl / (R_V * temp * temp);
      double abl = 1.0 + dqsldt * Lv / CP_D;
      double ssat_r = qv[c] - qsl;
      double qvp = qv_prev ? qv_prev[c] : qv[c];
      double tp = t_prev ? t_prev[c] : temp;
      bool below = tc_ < 0.0;
      double eps_eff = std::max(
          below ? epsr + epsi * (1.0 + Ls / CP_D * dqsldt) / abi : epsr,
          1.0e-20);
      double tau_eff = 1.0 / eps_eff;
      double A_c = (qv[c] - qvp) / dt - dqsldt * (temp - tp) / dt -
                   (below ? (qsl - qv_si) * (1.0 + Ls / CP_D * dqsldt) / abi *
                                epsi
                          : 0.0);
      double tau_r = 1.0 / std::max(epsr, 1.0e-20);
      double dtau = dt / tau_eff;
      double w_ts = -std::expm1(-dtau) / dtau;
      double instant = -ssat_r / (abl * tau_r);
      double equilib = -A_c / abl * tau_eff / tau_r;
      double ev_big = instant * w_ts + equilib * (1.0 - w_ts);
      ev = (qr_in < 1.0e-12 && qv[c] / std::max(qsl, QSMALL) < 0.999)
               ? qr_in / dt
               : ev_big;
      ev = std::min(ev, -ssat_r / dt / abl);
      ev = std::min(std::max(ev, 0.0), qr_in / dt);
      if (!((qc_in + qi_in < 1.0e-6) && ssat_r < 0.0 && qr[c] >= QSMALL))
        ev = 0.0;
    } else {
      // -- continuous tier ------------------------------------------------
      double subsat = std::max(qsl - qv[c], 0.0) / std::max(qsl, QSMALL);
      double tau_evap = 150.0 / std::max(std::pow(rho * qr_in, 0.35), 1e-4);
      ev = (qr[c] >= QSMALL && qc[c] < QSMALL) ? subsat * qr_in / tau_evap
                                               : 0.0;
      double tau_dep = 300.0 / std::max(std::pow(rho * qi_in, 0.25), 1e-3);
      bool has_ice = (qi[c] >= QSMALL) && (tc_ < 0.0);
      dep = (has_ice && sup_i > 0.0) ? (qv[c] - qv_si) / tau_dep : 0.0;
      sub = (has_ice && sup_i < 0.0) ? (qv_si - qv[c]) / tau_dep : 0.0;
      double vi =
          std::clamp(1.2 * std::pow(std::max(rho * qi[c], 0.0), 0.0625), 0.3,
                     3.0);
      rim = (qi[c] >= QSMALL && qc[c] >= QSMALL && tc_ < 0.0)
                ? 0.7 * 2.0 * vi * qi[c] * qc[c]
                : 0.0;
      melt = (qi[c] >= QSMALL && tc_ > 0.0) ? qi[c] * tc_ / 60.0 : 0.0;
    }

    // number rates tied to mass rates are computed INSIDE the process
    // subroutines, BEFORE the conservation rescalings (ice_melting
    // :2251, ice_deposition_sublimation :3307, evaporate_rain :3532,
    // cloud_water_autoconversion :2778, cloud_rain_accretion :2694,
    // ice_cldliq_collection :2087)
    double ni2nr_melt = melt * ni_rate / std::max(qi_in, QSMALL);
    double ni_sub_n = sub * ni_rate / std::max(qi_in, QSMALL);
    double nr_evap = ev * nr_in / std::max(qr_in, QSMALL);
    double inv_qc = 1.0 / std::max(qc_in, QSMALL);
    double ncautr = au * CONS3;
    double nc2nr_auto = au * nc_in * inv_qc;
    double nc_accret = ac * nc_in * inv_qc;
    double nc_collect = (rim + shed) * nc_in * inv_qc;

    // nc_conservation (micro_p3.F90:2957-2979): rescales nc2nr_auto (the
    // nr_conservation source) even in prescribed-nc mode
    {
      double sink_nc = (nc_collect + nc_frz + nc_accret + nc2nr_auto) * dt;
      double source_nc = nc[c];
      if (sink_nc > source_nc) {
        double r = source_nc / std::max(sink_nc, 1e-30);
        nc_collect *= r;
        nc_frz *= r;
        nc_accret *= r;
        nc2nr_auto *= r;
      }
    }

    // -- conservation rescaling (*_conservation, micro_p3.F90:3029-3106 +
    //    2957-3007; mirrors physics/p3.py) --------------------------------
    double sinks_qc = (au + ac + qc_frz + rim + shed + berg) * dt;
    double ratio_qc = 1.0;
    if (sinks_qc > qc[c] && sinks_qc >= 1.0e-20) {
      ratio_qc = qc[c] / std::max(sinks_qc, 1e-30);
      au *= ratio_qc; ac *= ratio_qc; qc_frz *= ratio_qc;
      rim *= ratio_qc; shed *= ratio_qc; berg *= ratio_qc;
    }
    if (qc[c] > 1.0e-20) {
      dep *= (1.0 - ratio_qc);
      sub *= (1.0 - ratio_qc);
    }

    double sinks_qr = (ev + qrcol + qr_frz) * dt;
    double sources_qr = qr[c] + (au + ac + melt + shed) * dt;
    if (sinks_qr > sources_qr && sinks_qr >= 1.0e-20) {
      double r = sources_qr / std::max(sinks_qr, 1e-30);
      ev *= r; qrcol *= r; qr_frz *= r;
    }

    double sinks_qi = (sub + melt) * dt;
    double sources_qi =
        qi[c] + (dep + qinuc + berg + qrcol + rim + qr_frz + qc_frz) * dt;
    if (sinks_qi > sources_qi && sinks_qi >= 1.0e-20) {
      double r = sources_qi / std::max(sinks_qi, 1e-30);
      sub *= r; melt *= r;
    }

    // ice_supersat_conservation (micro_p3.F90:2856-2886): excess credited
    // with sublimation + rain-evap sources, psychrometrically damped
    if (dep + qinuc > QSMALL) {
      double qv_avail =
          std::max((qv[c] + (sub + ev) * dt - qv_si) /
                       (1.0 + Ls * Ls * qv_si / (CP_D * R_V * temp * temp)),
                   0.0);
      conserve2(qv_avail, dep, qinuc);
    }


    {
      double sinks_nr = (nr_col + nr_frz + nr_self + nr_evap) * dt;
      // sources include nc2nr_autoconv (the reference's nr_conservation
      // source list, micro_p3.F90:2981-3000)
      double sources_nr = nr[c] + (ni2nr_melt + nr_shed_wg + ncshdc +
                                   nc2nr_auto) * dt;
      if (sinks_nr > sources_nr) {
        double r = sources_nr / std::max(sinks_nr, 1e-30);
        nr_col *= r; nr_frz *= r; nr_self *= r; nr_evap *= r;
      }
    }
    {
      double sinks_ni = (ni2nr_melt + ni_sub_n + ni_self) * dt;
      double sources_ni = ni[c] + (ninuc + nr_frz + nc_frz) * dt;
      if (sinks_ni > sources_ni) {
        double r = sources_ni / std::max(sinks_ni, 1e-30);
        ni2nr_melt *= r; ni_sub_n *= r; ni_self *= r;
      }
    }

    // prevent_liq_supersaturation (micro_p3.F90:2888-2955): scale the
    // vapor sources so end-of-step qv stays at/below liquid saturation;
    // number tendencies keep the unscaled rates (mirrors the JAX scheme).
    {
      double qv_sources = sub + ev;
      double qv_sinks_plq = dep + qinuc;
      double t_end = temp + ((qv_sinks_plq - sub) * Ls / CP_D
                             - ev * Lv / CP_D) * dt;
      double qsl_end = p3_qv_sat_liq(t_end, pres[c]);
      double A_plq = Lv * qsl_end * dt / CP_D / (R_V * t_end * t_end) *
                     (Ls * sub + Lv * ev);
      double frac = (qsl_end - qv[c] + qv_sinks_plq * dt + A_plq) /
                    std::max(qv_sources * dt + A_plq, 1e-300);
      frac = std::clamp(frac, 0.0, 1.0);
      if (qv_sources < QSMALL) frac = 0.0;
      sub *= frac;
      ev *= frac;
    }

    double qc_new = qc[c] + dt * (-au - ac - qc_frz - rim - shed - berg);
    double qr_new = qr[c] + dt * (au + ac - ev - qr_frz - qrcol + melt + shed);
    double qi_new = qi[c] + dt * (qc_frz + qr_frz + qrcol + dep + qinuc +
                                  berg - sub - melt + rim);
    double qv_new = qv[c] + dt * (ev + sub - dep - qinuc);
    double nr_new = nr[c] + dt * (ncautr - nr_self - nr_frz - nr_col +
                                  ni2nr_melt + ncshdc +
                                  nr_shed_wg - nr_evap);
    double ni_new = ni[c] + dt * (ninuc + nc_frz + nr_frz - ni_self -
                                  ni2nr_melt - ni_sub_n);
    double qm_new = qm[c] + dt * (rim + qr_frz + qrcol + qc_frz -
                                  (melt + sub) * qm[c] / std::max(qi[c], QSMALL));
    double bm_new =
        bm[c] + dt * (rim / rho_rime + (qr_frz + qrcol + qc_frz) / 900.0 -
                      (melt + sub) * bm[c] / std::max(qi[c], QSMALL));
    // negative rime zeroes BOTH qm and bm (update_prognostic_ice
    // :3188-3191); wet growth densifies: qm = qi, bm = qm / rho_rimeMax
    // (:3196-3200)
    if (qm_new < 0.0) {
      qm_new = 0.0;
      bm_new = 0.0;
    }
    if (log_wg) {
      qm_new = qi_new;
      bm_new = qi_new / 900.0;
    }
    // prescribed droplet number is re-imposed at the end of part2 on
    // every level that reaches the prognostic update
    // (update_prognostic_liquid :3241); skipped levels keep part1's value
    if (!skip_lvl) nc[c] = NCCNST * inv_rho;
    theta[c] += dt / (CP_D * exner[c]) *
                (Lv * (-ev) + Ls * (dep + qinuc - sub) +
                 Lf * (qc_frz + qr_frz + qrcol + rim + berg - melt));

    qc[c] = std::max(qc_new, 0.0);
    qr[c] = std::max(qr_new, 0.0);
    qi[c] = std::max(qi_new, 0.0);
    qv[c] = std::max(qv_new, 0.0);
    nr[c] = std::max(nr_new, 0.0);
    ni[c] = std::max(ni_new, 0.0);
    qm[c] = qm_new;
    bm[c] = bm_new;

    // end-of-part2 clipping (micro_p3.F90:893-920): tiny hydrometeors
    // return to vapor with latent cooling; ni re-capped (:921-925)
    if (qc[c] < QSMALL) {
      qv[c] += qc[c];
      theta[c] -= qc[c] * Lv / (CP_D * exner[c]);
      qc[c] = 0.0;
      nc[c] = 0.0;
    }
    if (qr[c] < QSMALL) {
      qv[c] += qr[c];
      theta[c] -= qr[c] * Lv / (CP_D * exner[c]);
      qr[c] = 0.0;
      nr[c] = 0.0;
    }
    if (qi[c] < QSMALL) {
      qv[c] += qi[c];
      theta[c] -= qi[c] * Ls / (CP_D * exner[c]);
      qi[c] = 0.0;
      ni[c] = 0.0;
      qm[c] = 0.0;
      bm[c] = 0.0;
    }
    if (ni[c] >= 1e-20) {
      ni[c] *= std::min(MAX_TOTAL_NI * inv_rho / ni[c], 1.0);
    }

    if (dz[c] < dz_min) dz_min = dz[c];
  }

  // per-substep sedimentation prep, with the reference's writebacks
  // (rain_sedimentation :3825-3843, ice_sedimentation :4007-4037,
  // cloud_sedimentation :3670-3722; mirrors the JAX sub_body helpers)
  auto rain_sed_prep = [&](double qr_, double* nr_, double rho, double rho0,
                           double* vq, double* vn) {
    bool gate = qr_ >= QSMALL;
    if (!tab) {
      double v = std::clamp(36.34 * std::pow(std::max(rho * qr_, 0.0),
                                             0.1364) *
                                std::sqrt(rho0 / rho),
                            0.0, 9.1);
      *vq = v;
      *vn = v;
      return;
    }
    double qr_c = gate ? std::min(qr_, 1.0e-2) : 0.0;
    double nr_c = gate ? std::max(*nr_, 0.0) : 0.0;
    double nr_l = rain_dsd_nr(qr_c, nr_c);
    if (gate) *nr_ = nr_l;
    double lam = std::cbrt(PI / 6.0 * RHO_H2O * 24.0 *
                           std::max(nr_l, NSMALL) / std::max(qr_c, QSMALL));
    int i0;
    double fi;
    rain_size_index((MU_R + 1.0) / lam, &i0, &fi);
    double rhofacr = std::pow(rho_1000mb / rho, 0.54);
    *vq = gate ? rhofacr * interp_rain(g_vm, i0, fi) : 0.0;
    *vn = gate ? rhofacr * interp_rain(g_vn, i0, fi) : 0.0;
  };
  auto ice_sed_prep = [&](double qi_, double* ni_, double* qm_, double* bm_,
                          double rho, double* vq, double* vn) {
    bool gate = qi_ >= QSMALL;
    if (!tab) {
      double v = std::clamp(
          1.2 * std::pow(std::max(rho * qi_, 0.0), 0.0625), 0.3, 3.0);
      *vq = v;
      *vn = v;
      return;
    }
    double qi_c = gate ? std::min(qi_, 5.1e-3) : 0.0;
    double ni_c = std::max(gate ? std::max(*ni_, 0.0) : 0.0, NSMALL);
    bool has_m = gate && *qm_ >= QSMALL;
    double qm_c = has_m ? *qm_ : 0.0;
    double bm_c = has_m ? std::clamp(*bm_, 0.0, 5.1e-3) : 0.0;
    double rr;
    bulk_rho_rime(qi_c, &qm_c, &bm_c, &rr);
    IceIdx idx = ice_table_indices(qi_c, ni_c, qm_c, rr);
    double rfac = std::pow(rho_600mb / rho, 0.54);
    double ni_l = std::min(ni_c, interp_ice(7, idx) * ni_c);
    ni_l = std::max(ni_l, interp_ice(8, idx) * ni_l);
    if (gate) {
      *ni_ = ni_l;
      *qm_ = qm_c;
      *bm_ = bm_c;
    }
    *vq = gate ? rfac * interp_ice(2, idx) : 0.0;
    *vn = gate ? rfac * interp_ice(1, idx) : 0.0;
  };

  // Stokes cloud fall speed from the CURRENT (qc, nc) gamma DSD, with
  // get_cloud_dsd2's nc adjustment persisted (cloud_sedimentation,
  // micro_p3.F90:3670-3722; acn from the part1 t_atm)
  auto cloud_sed_prep = [&](double qc_, double* nc_, double temp, double rho,
                            double* vq) {
    bool gate = qc_ >= QSMALL;
    double qc_c = gate ? std::min(qc_, 5.1e-3) : 0.0;
    double nc_l = cloud_dsd_nc(qc_c, gate ? std::max(*nc_, 0.0) : 0.0, rho);
    if (gate) *nc_ = nc_l;
    double mu_v = 1.496e-6 * std::pow(temp, 1.5) / (temp + 120.0);
    double acn = 9.80616 * RHO_H2O / (18.0 * mu_v);
    double s_ = 0.0005714 * (nc_l * 1.0e-6 * rho) + 0.2714;
    double mu_cd = std::clamp(1.0 / (s_ * s_) - 1.0, 2.0, 15.0);
    double lamc = std::cbrt(PI / 6.0 * RHO_H2O * std::max(nc_l, NSMALL) *
                            (mu_cd + 3.0) * (mu_cd + 2.0) * (mu_cd + 1.0) /
                            std::max(qc_c, QSMALL));
    lamc = std::clamp(lamc, (mu_cd + 1.0) * 2.5e4, (mu_cd + 1.0) * 1.0e6);
    *vq = gate ? acn * std::exp(std::lgamma(mu_cd + 6.0) -
                                std::lgamma(mu_cd + 4.0)) /
                     (lamc * lamc)
               : 0.0;
  };

  // Global CFL sub-cycle count (matches the JAX path's global max, computed
  // with pre-process rho and post-process hydrometeors; prep on COPIES so
  // the estimate itself does not advance the writebacks).
  for (std::int64_t c = 0; c < n; ++c) {
    std::int64_t col = c / nz;
    double rho0 = rho_pre[col * nz];
    double rho = rho_pre[c];
    double vr, vn_r, vi, vn_i, vc;
    double nr_t = nr[c], ni_t = ni[c], qm_t = qm[c], bm_t = bm[c],
           nc_t = nc[c];
    rain_sed_prep(qr[c], &nr_t, rho, rho0, &vr, &vn_r);
    ice_sed_prep(qi[c], &ni_t, &qm_t, &bm_t, rho, &vi, &vn_i);
    cloud_sed_prep(qc[c], &nc_t, temp_pre[c], rho, &vc);
    vmax = std::max(vmax, std::max(vc, std::max(vr, vi)));
  }
  double nsub = std::max(std::ceil(dt * vmax / (0.9 * dz_min)), 1.0);
  double dts = dt / nsub;

  // Pass 2: sedimentation, per column, upstream differencing.
  std::vector<double> vr_k(nz), vnr_k(nz), vi_k(nz), vni_k(nz), vc_k(nz),
      flux(nz);
  for (std::int64_t col = 0; col < ncol; ++col) {
    double* Qc = qc + col * nz;
    double* Nc = nc + col * nz;
    const double* Tp = temp_pre.data() + col * nz;
    double* Qr = qr + col * nz;
    double* Nr = nr + col * nz;
    double* Qi = qi + col * nz;
    double* Ni = ni + col * nz;
    double* Qm = qm + col * nz;
    double* Bm = bm + col * nz;
    const double* Rho = rho_pre.data() + col * nz;
    const double* Dz = dz + col * nz;
    double pl = 0.0, pi_srf = 0.0;
    double rho0 = Rho[0];

    for (double it = 0; it < nsub; ++it) {
      // recompute fall speeds each sub-step, with the reference's
      // per-substep DSD/limiter/rime writebacks (matches JAX sub_body)
      for (std::int64_t k = 0; k < nz; ++k) {
        rain_sed_prep(Qr[k], &Nr[k], Rho[k], rho0, &vr_k[k], &vnr_k[k]);
        ice_sed_prep(Qi[k], &Ni[k], &Qm[k], &Bm[k], Rho[k], &vi_k[k],
                     &vni_k[k]);
        cloud_sed_prep(Qc[k], &Nc[k], Tp[k], Rho[k], &vc_k[k]);
      }
      auto fall = [&](double* Q, const double* V, double* srf) {
        for (std::int64_t k = 0; k < nz; ++k) flux[k] = Rho[k] * Q[k] * V[k];
        if (srf) *srf += dts * flux[0] / RHO_H2O;
        for (std::int64_t k = 0; k < nz - 1; ++k) {
          Q[k] += dts * (flux[k + 1] - flux[k]) / (Rho[k] * Dz[k]);
        }
        Q[nz - 1] += -dts * flux[nz - 1] / (Rho[nz - 1] * Dz[nz - 1]);
        for (std::int64_t k = 0; k < nz; ++k) Q[k] = std::max(Q[k], 0.0);
      };
      fall(Qc, vc_k.data(), &pl);
      fall(Qr, vr_k.data(), &pl);
      // nr falls at the number-weighted V_nr (rain_sedimentation,
      // micro_p3.F90:3785-3791: V_qr for qr, V_nr for nr)
      fall(Nr, vnr_k.data(), nullptr);
      fall(Qi, vi_k.data(), &pi_srf);
      // ni falls at the number-weighted V_nit (micro_p3.F90:4025-4037)
      fall(Ni, vni_k.data(), nullptr);
      fall(Qm, vi_k.data(), nullptr);
      fall(Bm, vi_k.data(), nullptr);
    }
    precip_liq[col] = pl / dt;
    precip_ice[col] = pi_srf / dt;
  }

  // Pass 3: homogeneous freezing + p3_main_part3 final consistency
  // (mirrors physics/p3.py; per-cell, so pass structure is equivalent to
  // the JAX element-wise formulation).
  for (std::int64_t c = 0; c < n; ++c) {
    double rho = rho_pre[c];
    double inv_rho = 1.0 / rho;
    // constant P3-internal latent heats (micro_p3_utils.F90:146-147)
    double Lv = LATVAP;
    double Ls = LATVAP + LATICE;
    double Lf = LATICE;
    double cpex = CP_D * exner[c];
    const double cons1 = PI / 6.0 * RHO_H2O;

    // homogeneous freezing of cloud and rain (homogeneous_freezing,
    // micro_p3.F90:4145-4200, called after sedimentation at :1452-1454):
    // below T_homogfrz all remaining liquid freezes instantly into rimed
    // ice packed at rho_rimeMax, with latent heating.
    // the reference gates on t_atm frozen at END OF PART1 (p3_main
    // passes t_atm(i,:), never refreshed by part2/sedimentation)
    double t_cur = temp_pre[c];
    if (qc[c] >= QSMALL && t_cur < T_HOMOGFRZ) {
      double q_nuc = qc[c];
      qm[c] += q_nuc;
      qi[c] += q_nuc;
      bm[c] += q_nuc / RHO_RIMEMAX;
      ni[c] += std::max(nc[c], NSMALL);
      theta[c] += q_nuc * Lf / cpex;
      qc[c] = 0.0;
      nc[c] = 0.0;
    }
    if (qr[c] >= QSMALL && t_cur < T_HOMOGFRZ) {
      double q_nuc = qr[c];
      qm[c] += q_nuc;
      qi[c] += q_nuc;
      bm[c] += q_nuc / RHO_RIMEMAX;
      ni[c] += std::max(nr[c], NSMALL);
      theta[c] += q_nuc * Lf / cpex;
      qr[c] = 0.0;
      nr[c] = 0.0;
    }

    // p3_main_part3 (micro_p3.F90:977-1137): prognostic effects only (the
    // diagnostic outputs are discarded by the reference wrapper).

    // cloud (:1020-1035)
    bool small_c = qc[c] < QSMALL;
    if (small_c) {
      qv[c] += qc[c];
      theta[c] -= qc[c] * Lv / cpex;
    }
    double nc_eff = std::max(nc[c], NSMALL);
    double s_c = 0.0005714 * (nc_eff * 1.0e-6 * rho) + 0.2714;
    double mu_c3 = std::clamp(1.0 / (s_c * s_c) - 1.0, 2.0, 15.0);
    double mval = (mu_c3 + 3.0) * (mu_c3 + 2.0) * (mu_c3 + 1.0);
    double lamc3 =
        std::cbrt(cons1 * nc_eff * mval / std::max(qc[c], QSMALL));
    double lamc3_cl =
        std::clamp(lamc3, (mu_c3 + 1.0) * 2.5e4, (mu_c3 + 1.0) * 1.0e6);
    double nc_lim = (lamc3 != lamc3_cl)
                        ? lamc3_cl * lamc3_cl * lamc3_cl * qc[c] /
                              (cons1 * mval)
                        : nc_eff;
    nc[c] = small_c ? 0.0 : nc_lim;
    qc[c] = small_c ? 0.0 : qc[c];

    // rain (:1037-1060); mu_r = 1 constant
    bool small_r = qr[c] < QSMALL;
    if (small_r) {
      qv[c] += qr[c];
      theta[c] -= qr[c] * Lv / cpex;
    }
    double nr_eff = std::max(nr[c], NSMALL);
    double lamr3 =
        std::cbrt(cons1 * nr_eff * 24.0 / std::max(qr[c], QSMALL));
    double lamr3_cl = std::clamp(lamr3, 2.0 * 500.0, 2.0 * 1.0e5);
    double nr_lim = (lamr3 != lamr3_cl)
                        ? lamr3_cl * lamr3_cl * lamr3_cl * qr[c] /
                              (24.0 * cons1)
                        : nr_eff;
    nr[c] = small_r ? 0.0 : nr_lim;
    qr[c] = small_r ? 0.0 : qr[c];

    // ice (:1062-1126)
    bool small_i = qi[c] < QSMALL;
    if (small_i) {
      qv[c] += qi[c];
      theta[c] -= qi[c] * Ls / cpex;
    }
    ni[c] = std::max(ni[c], NSMALL);
    // calc_bulkRhoRime (:1904-1943): bound rho_rime to [50, 900] (bm
    // adjusts), qm <= qi, tiny qm zeroed
    bool has_bm = bm[c] >= 1.0e-15;
    double rho_rime3 =
        has_bm ? std::clamp(qm[c] / std::max(bm[c], 1e-30), RHO_RIMEMIN,
                            RHO_RIMEMAX)
               : 0.0;
    bm[c] = has_bm ? qm[c] / std::max(rho_rime3, RHO_RIMEMIN) : 0.0;
    qm[c] = has_bm ? qm[c] : 0.0;
    if (qm[c] > qi[c] && rho_rime3 > 0.0) {
      qm[c] = qi[c];
      bm[c] = qm[c] / std::max(rho_rime3, RHO_RIMEMIN);
    }
    if (qm[c] < QSMALL) {
      qm[c] = 0.0;
      bm[c] = 0.0;
    }
    // total-ice-number cap (:1073)
    if (ni[c] >= 1e-20) {
      ni[c] *= std::min(MAX_TOTAL_NI * inv_rho / ni[c], 1.0);
    }
    if (tab) {
      // normalized lambda-limiter factors (tables 7/8, :1085-1097)
      double rhop3 = std::clamp(qm[c] / std::max(bm[c], 1e-30), RHO_RIMEMIN,
                                RHO_RIMEMAX);
      IceIdx idx3 = ice_table_indices(qi[c], ni[c], qm[c], rhop3);
      ni[c] = std::min(ni[c], interp_ice(7, idx3) * ni[c]);
      ni[c] = std::max(ni[c], interp_ice(8, idx3) * ni[c]);
    }
    if (small_i) {
      qi[c] = 0.0;
      ni[c] = 0.0;
      qm[c] = 0.0;
      bm[c] = 0.0;
    }
  }
}

}  // extern "C"
