// The P3 table index finders as __device__ functions: the arithmetic of
// miniweatherml_tpu_torch/physics/p3_tables.py's ice_table_indices
// (find_lookupTable_indices_1a), rain_collection_index (_1b) and
// rain_size_index (_3) transcribed once -- log10, floor, the clamps and the
// wheres in the same order -- for the rates_pre phase (p3_cellwise.cu) and
// the sedimentation kernels (p3_sed.cu).  Include after p3_math.cuh's
// requirements: a file built with --fmad=false.  Indices are 0-based int32
// base indices; fractions are the Fortran-style dum - dumi.
#pragma once

#include "p3_interp.cuh"
#include "p3_math.cuh"

namespace {

// 1/(0.1*log10(261.7)) (micro_p3_utils.F90:34)
constexpr double DUM1_C = 4.135985029041767;

// find_lookupTable_indices_1a (micro_p3.F90:1620-1677): size, rime
// fraction and rime density axes
template <typename T>
__device__ void ice_table_indices(T qi, T ni, T qm, T rhop, int& i0, T& fi,
                                  int& ii0, T& fii, int& jj0, T& fjj) {
  T dum1 = (tlog10(tmax(qi, T(QSMALL)) / tmax(ni, T(1e-30))) + T(18.0)) * T(DUM1_C) -
           T(10.0);
  const int dumi = clampi(floor_i32(dum1), 1, ISIZE - 1);
  dum1 = tclamp(dum1, T(1.0), T(ISIZE));
  T dum4 = (qm / tmax(qi, T(QSMALL))) * T(3.0) + T(1.0);
  const int dumii = clampi(floor_i32(dum4), 1, RIMSIZE - 1);
  dum4 = tclamp(dum4, T(1.0), T(RIMSIZE));
  T dum5 = rhop <= T(650.0) ? (rhop - T(50.0)) * T(0.005) + T(1.0)
                            : (rhop - T(650.0)) * T(0.004) + T(4.0);
  const int dumjj = clampi(floor_i32(dum5), 1, DENSIZE - 1);
  dum5 = tclamp(dum5, T(1.0), T(DENSIZE));
  i0 = dumi - 1;
  fi = dum1 - T(dumi);
  ii0 = dumii - 1;
  fii = dum4 - T(dumii);
  jj0 = dumjj - 1;
  fjj = dum5 - T(dumjj);
}

// find_lookupTable_indices_1b (micro_p3.F90:1681-1720): the rain size axis
// of the ice-rain collection table
template <typename T>
__device__ void rain_collection_index(T qr, T nr, int& j0, T& fj) {
  const bool has_rain = (qr >= T(QSMALL)) && (nr > T(0));
  const T dumlr =
      cbrt_newton(tmax(qr, T(QSMALL)) / (T(PI * RHO_H2O) * tmax(nr, T(1e-30))));
  T dum3 = (tlog10(dumlr) + T(5.0)) * T(10.70415);
  int dumj = clampi(floor_i32(dum3), 1, RCOLLSIZE - 1);
  dum3 = tclamp(dum3, T(1.0), T(RCOLLSIZE));
  if (!has_rain) {
    dumj = 1;
    dum3 = T(1);
  }
  j0 = dumj - 1;
  fj = dum3 - T(dumj);
}

// find_lookupTable_indices_3's size mapping (micro_p3.F90:1725-1770): a
// number-weighted mean size -> (i0, fi) into the 300-entry rain rows
template <typename T>
__device__ void rain_size_index(T dm, int& i0, T& fi) {
  const T rd_small = tclamp((dm * T(1e6) + T(5.0)) * T(0.1), T(1.0), T(20.0));
  const T rd_large =
      tclamp((dm * T(1e6) - T(195.0)) / T(30.0) + T(20.0), T(20.0), T(300.0));
  const bool small = dm <= T(195.0e-6);
  const T rdum = small ? rd_small : rd_large;
  const int idum = small ? clampi(floor_i32(rd_small), 1, 20)
                         : clampi(floor_i32(rd_large), 20, 299);
  i0 = idum - 1;
  fi = rdum - T(idum);
}

// The rain size index of a (qr, nr) pair: lambda from the cube root, the
// mean size (mu_r + 1) / lambda = 2 / lambda (a number over a tensor:
// PyTorch's reciprocal times 2)
template <typename T>
__device__ void rain_dm_index(T qr, T nr, int& i0, T& fi) {
  const T lam = cbrt_newton(T(PI / 6.0 * RHO_H2O * 24.0) * tmax(nr, T(NSMALL)) /
                            tmax(qr, T(QSMALL)));
  rain_size_index(T(1) / lam * T(2.0), i0, fi);
}

}  // namespace
