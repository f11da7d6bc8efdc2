// The direction-flux kernels in the reduced-operation limiter algebra, for
// NVIDIA Hopper (sm_90a): the form the Pallas TPU megakernels of
// miniweatherml_tpu/ops/pallas_recon.py, direction_fluxes_pallas
// (pallas_call at :536) and direction_fluxes_pallas_sub (:941), take by
// default (opt=True, _weno_edges_block_opt at :127-247), with exact
// reciprocals (direction_fluxes_opt_f32 / _f64) and with the approximate
// reciprocal of fast_weights=True (direction_fluxes_fast_f32; f32 only, as
// pl.reciprocal(approx=True) is).  Every form of the kernels --
// x and y/z, whole axis and halo strips, bare, accumulating and stage
// update, tracer bounds 1, 3 and 9 -- in each algebra; a translation unit of
// its own so that it builds in parallel with the reference one.  The
// kernels, their design and what bounds them are in direction_fluxes.cuh.

#include "direction_fluxes.cuh"

extern "C" {

// Copy the reduced-operation table of one order (opt_coef_table's float64
// values; exactly the layout's size) into constant memory on the current
// device, as f64 and cast to f32.
int direction_fluxes_opt_set_coef(int ord, const double* table, int n) {
  return set_coef<ALG_OPT>(ord, table, n);
}

DIRECTION_FLUXES_ENTRY(direction_fluxes_opt_f32, float, ALG_OPT)
DIRECTION_FLUXES_ENTRY(direction_fluxes_fast_f32, float, ALG_FAST)
DIRECTION_FLUXES_ENTRY(direction_fluxes_opt_f64, double, ALG_OPT)

const char* direction_fluxes_opt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
