// The direction-flux kernels in the reference limiter algebra with the
// approximate reciprocal, for NVIDIA Hopper (sm_90a): the form the Pallas
// TPU megakernels of miniweatherml_tpu/ops/pallas_recon.py,
// direction_fluxes_pallas (pallas_call at :536) and
// direction_fluxes_pallas_sub (:941), take with fast_weights=True when
// they run the reference-ordered limiter (_weno_edges_block at :58-124,
// pl.reciprocal(approx=True) at :69-74): with a cutoff, or with
// opt=False.  Both normalisations take tot > eps ? rcp(tot) : 1 and each
// weight is idl * rcp(tv^2 + eps), rcp being rcp.approx.ftz.f32; f32 only,
// as pl.reciprocal(approx=True) is.  Every form of the kernels -- x and
// y/z, whole axis and halo strips, bare, accumulating and stage update,
// tracer bounds 1, 3 and 9 -- in a translation unit of its own, so that it
// builds in parallel with the other two.  The kernels, their design and
// what bounds them are in direction_fluxes.cuh.

#include "direction_fluxes.cuh"

extern "C" {

// Copy the limiter table of one order (weno_coef_table's float64 values)
// into constant memory on the current device, as f64 and cast to f32.
int direction_fluxes_ref_fast_set_coef(int ord, const double* table, int n) {
  return set_coef<ALG_REF_FAST>(ord, table, n);
}

DIRECTION_FLUXES_ENTRY(direction_fluxes_ref_fast_f32, float, ALG_REF_FAST)

const char* direction_fluxes_ref_fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
