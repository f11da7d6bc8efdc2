// The Kessler MLP surrogate's forward pass, per cell, for NVIDIA Hopper
// (sm_90a): the five input fields [T, rho_d, rho_v, rho_c, rho_r] min-max
// normalised, every dense layer x W + b with LeakyReLU(0.1) between layers,
// the outputs denormalised and rho_v, rho_c, rho_r clamped at 0, written to
// four fields.
//
// Replaces the JAX package's MicrophysicsKesslerSurrogate._nn_forward
// (miniweatherml_tpu/physics/kessler_surrogate.py:60-76), jnp code that XLA
// fuses into a few passes; no Pallas kernel.  The plain version is
// miniweatherml_tpu_torch/physics/kessler_surrogate_cuda.py::
// surrogate_forward_plain, which writes each dot product as an ordered sum
// (k ascending from x_0 W_0j, then + b_j).  Here every add and multiply is
// a round-to-nearest intrinsic in that order and each normalisation a
// division, so the kernel gives the plain version's values bit for bit in
// f32 and f64 (no TF32, no contraction).
//
// Design: one thread per cell on a persistent grid.  The parameters (a
// header of the layer count and the nlayers + 1 widths, the two scaling
// tables, then each layer's W, n_in x n_out row-major, and b) arrive by
// device pointer in the fields' type and each block stages them in shared
// memory once; every thread reads the same weight at once, a broadcast.
// The activations stay in registers: the layer loop runs at run time, but
// the loops over a layer's inputs and outputs are unrolled to the width cap
// MAXW with an exit at the layer's width, so every index into them is a
// constant.  A model of any depth whose parameters fit in a block's shared
// memory is taken; one wider than MAXW is refused (the wrapper raises).
// MAXW is one build-time constant (SURROGATE_MAXW, default 16, the
// wrapper's MAX_WIDTH; scripts/torch_port_measure.py surrogate builds other
// values to time them: at 32 the shipped model ran 1.4-1.6x slower).
//
// What bounds it on the H100: bytes.  It reads 5 fields and writes 4 (36 B
// a cell in f32: 0.60 GB, 0.18 ms at 512x512x64); the shipped 5 -> 10 -> 4
// model does 90 multiply-adds a cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SURROGATE_MAXW
#define SURROGATE_MAXW 16
#endif

constexpr int THREADS = 128;
constexpr int MAXW = SURROGATE_MAXW;
constexpr int NIN = 5, NOUT = 4;
constexpr int NSCALE = 2 * (NIN + NOUT);  // scl_in (5, 2), scl_out (4, 2)

struct Fields {
  const void* in[NIN];
  void* out[NOUT];
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
surrogate_kernel(const Fields f, const T* __restrict__ params, int nparams, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const p = reinterpret_cast<T*>(smem);
  for (int i = threadIdx.x; i < nparams; i += THREADS) p[i] = params[i];
  __syncthreads();
  // the header: nlayers, then the widths (small integers, exact in T)
  const int nlayers = (int)p[0];
  const T* const width = p + 1;
  const T* const scl_in = width + nlayers + 1;
  const T* const scl_out = scl_in + 2 * NIN;
  for (int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x; c < n;
       c += (int64_t)gridDim.x * THREADS) {
    T x[MAXW], y[MAXW];
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      const T v = __ldg(static_cast<const T*>(f.in[k]) + c);
      x[k] = quo(sub(v, scl_in[2 * k]), sub(scl_in[2 * k + 1], scl_in[2 * k]));
    }
    const T* w = scl_out + 2 * NOUT;
    int ni = NIN;
    for (int l = 0; l < nlayers; ++l) {
      const int no = (int)width[l + 1];
      const T* const b = w + ni * no;
      const bool hidden = l + 1 < nlayers;
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j >= no) break;
        T acc = mul(x[0], w[j]);
#pragma unroll
        for (int k = 1; k < MAXW; ++k) {
          if (k >= ni) break;
          acc = add(acc, mul(x[k], w[k * no + j]));
        }
        acc = add(acc, b[j]);
        // LeakyReLU(0.1), as PyTorch's: a > 0 ? a : a * 0.1
        y[j] = (hidden && !(acc > T(0))) ? mul(acc, T(0.1)) : acc;
      }
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j >= no) break;
        x[j] = y[j];
      }
      w = b + no;
      ni = no;
    }
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
      T v = add(mul(x[j], sub(scl_out[2 * j + 1], scl_out[2 * j])), scl_out[2 * j]);
      // rho_v, rho_c, rho_r clamped at +0 (NaN passes, as torch.clamp_min)
      if (j > 0 && v <= T(0)) v = T(0);
      static_cast<T*>(f.out[j])[c] = v;
    }
  }
}

// The model's shape: nlayers >= 1, widths in [1, MAXW], the first NIN and
// the last NOUT, and the parameter count they imply (header included).
int check(int nlayers, const int* width, long long nparams) {
  if (nlayers < 1 || width[0] != NIN || width[nlayers] != NOUT) return -1;
  long long count = 1 + (nlayers + 1) + NSCALE;
  for (int l = 0; l < nlayers; ++l) {
    if (width[l] < 1 || width[l] > MAXW || width[l + 1] < 1 || width[l + 1] > MAXW)
      return -1;
    count += (long long)width[l] * width[l + 1] + width[l + 1];
  }
  return count == nparams ? 0 : -1;
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* params, int nparams,
           int nlayers, const int* width, long long n, void* stream) {
  if (n < 0 || check(nlayers, width, nparams) != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Fields f;
  for (int k = 0; k < NIN; ++k) f.in[k] = in[k];
  for (int k = 0; k < NOUT; ++k) f.out[k] = out[k];
  const size_t smem = (size_t)nparams * sizeof(T);
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(surrogate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, surrogate_kernel<T>, THREADS,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + THREADS - 1) / THREADS;
  const long long most = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  surrogate_kernel<T><<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const T*>(params), nparams, (int64_t)n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in: temp, rho_d, rho_v, rho_c, rho_r; out: temp, rho_v, rho_c, rho_r; n
// cells each, contiguous.  params: nparams values of the fields' type (the
// header, the scaling tables and the layers, as pack_mlp packs them);
// width: the nlayers + 1 layer widths the header holds, checked here.
int surrogate_forward_f32(const void* const* in, void* const* out, const void* params,
                          int nparams, int nlayers, const int* width, long long n,
                          void* stream) {
  return launch<float>(in, out, params, nparams, nlayers, width, n, stream);
}

int surrogate_forward_f64(const void* const* in, void* const* out, const void* params,
                          int nparams, int nlayers, const int* width, long long n,
                          void* stream) {
  return launch<double>(in, out, params, nparams, nlayers, width, n, stream);
}

const char* surrogate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
