// The direction-flux kernels (direction_fluxes.cuh) in the reference
// limiter algebra: exact WENO weights in the term order of
// ops/weno_fused.py::reconstruct_edges_shifted, the JAX XLA path's.  The
// kernels, their design and what bounds them are in the header.

#include "direction_fluxes.cuh"

extern "C" {

// Copy the limiter table of one order (weno_coef_table's float64 values)
// into constant memory on the current device, as f64 and cast to f32.
int direction_fluxes_set_coef(int ord, const double* table, int n) {
  return set_coef<ALG_REF>(ord, table, n);
}

DIRECTION_FLUXES_ENTRY(direction_fluxes_f32, float, ALG_REF)
DIRECTION_FLUXES_ENTRY(direction_fluxes_f64, double, ALG_REF)

const char* direction_fluxes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
