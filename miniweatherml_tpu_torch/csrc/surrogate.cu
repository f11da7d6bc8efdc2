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
// a round-to-nearest intrinsic in that order and each normalisation an
// IEEE division, so both forms below give the plain version's values bit
// for bit in f32 and f64.  No tensor cores: a wgmma or mma would sum in
// its own order (and in TF32 for f32), and the shipped model does 90
// multiply-adds on 36 B a cell in f32, ~5 FLOP/B, far below the card's
// ridge, so bytes bound it.
//
// The parameters arrive by device pointer in the fields' type, packed as
// the wrapper's pack_mlp packs them: a header (the layer count, then the
// nlayers + 1 widths), scl_in (5, 2), scl_out (4, 2), then each layer's W
// (n_in x n_out, row-major) and b.
//
// Two forms; the wrapper picks one from the widths.
//
// (a) fixed: a model 5 -> H -> 4 whose H is a template parameter, built for
// H = 10 only (the shipped model and ml.train.train_mlp's default).  Every
// weight offset is a constant.  Each block stages the weights once in shared
// memory in its own layout, a row of 12 values per hidden unit (its five
// input weights, its bias, its four output weights, two pads), so three
// (f32) or six (f64) 16-byte broadcast loads bring a unit's weights, and
// each weight serves the V = 4 consecutive cells a thread owns.  A thread
// streams its hidden units in order and adds each one's products into the
// four output sums at once (k ascending, as the plain version sums), so
// only 5V inputs, 4V sums and V activations are live.  The fields move as
// 16-byte vectors (f64: two per field) where the pointers are aligned, with
// a scalar tail.  Persistent grid.  Bound: bytes (36 B a cell in f32, 0.18
// ms at 512x512x64).
//
// (b) general: any depth, widths and parameter size, shaped like a GEMM on
// the CUDA cores.  A block takes a tile of M cells and keeps their
// activations in shared memory, act[unit][cell], in two buffers it swaps
// between layers.  For each layer it walks the outputs in column blocks of
// NB; each thread owns a 4 x 4 tile of (cells x outputs) sums (1 x 4 on a
// layer too narrow for 4 x 4 to keep every thread busy that still fits one
// column block), and the weights
// W[k0:k0 + KC, n0:n0 + NB] stream from global memory (L2) through a
// shared chunk of 2048, k ascending, so the order of every sum is the
// plain version's.  The launcher picks the largest
// M <= 256 whose buffers fit (two blocks per SM where they can); for
// layers too wide for even M = 4 in shared memory the activations live in
// a global scratch buffer the wrapper allocates (GACT), one slice per
// resident block.  Bound: operations for wide models; with no contraction
// a multiply and an add are two instructions, so the card's FP pipes reach
// at most half the FMA peak the bound is stated against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NIN = 5, NOUT = 4;
constexpr int NSCALE = 2 * (NIN + NOUT);  // scl_in (5, 2), scl_out (4, 2)
constexpr int SMEM_MAX = 232448;          // a block's shared memory (227 KB)

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

// LeakyReLU(0.1), as PyTorch's: a > 0 ? a : a * 0.1
template <typename T>
__device__ __forceinline__ T leaky(T a) { return a > T(0) ? a : mul(a, T(0.1)); }

// rho_v, rho_c, rho_r clamped at +0 (NaN passes, as torch.clamp_min)
template <typename T>
__device__ __forceinline__ T clamp0(T v) { return v <= T(0) ? T(0) : v; }

// 16 bytes of T: one vector load or store moves N values.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static void get(float* d, float4 v) { d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w; }
  __device__ static float4 make(const float* s) { return make_float4(s[0], s[1], s[2], s[3]); }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static void get(double* d, double2 v) { d[0] = v.x; d[1] = v.y; }
  __device__ static double2 make(const double* s) { return make_double2(s[0], s[1]); }
};

// R values: 16-byte vectors from 16-byte aligned memory where R * sizeof(T)
// is a multiple of 16, else scalars.
template <typename T, int R>
__device__ __forceinline__ void load_vec(T (&d)[R], const T* s) {
  using V = Vec16<T>;
  if constexpr (R % V::N == 0) {
#pragma unroll
    for (int i = 0; i < R / V::N; ++i)
      V::get(d + i * V::N, reinterpret_cast<const typename V::type*>(s)[i]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = s[i];
  }
}

// -- (a) the fixed form ------------------------------------------------------

constexpr int FIX_THREADS = 256;
constexpr int FIX_V = 4;    // consecutive cells a thread owns
constexpr int UNIT_ROW = 12;  // w1[0..4][j], b1[j], w2[j][0..3], two pads

// V cells of field `p` from cell c0: vectors when `full` (all V in range and
// the pointer 16-byte aligned), else scalars, 0 past n.
template <typename T>
__device__ __forceinline__ void load_cells(T (&d)[FIX_V], const T* __restrict__ p, int64_t c0,
                                           bool full, int64_t n) {
  using V = Vec16<T>;
  if (full) {
#pragma unroll
    for (int i = 0; i < FIX_V / V::N; ++i)
      V::get(d + i * V::N, __ldcs(reinterpret_cast<const typename V::type*>(p + c0) + i));
  } else {
#pragma unroll
    for (int i = 0; i < FIX_V; ++i) d[i] = c0 + i < n ? p[c0 + i] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_cells(T* __restrict__ p, const T (&s)[FIX_V], int64_t c0,
                                            bool full, int64_t n) {
  using V = Vec16<T>;
  if (full) {
#pragma unroll
    for (int i = 0; i < FIX_V / V::N; ++i)
      __stcs(reinterpret_cast<typename V::type*>(p + c0) + i, V::make(s + i * V::N));
  } else {
#pragma unroll
    for (int i = 0; i < FIX_V; ++i)
      if (c0 + i < n) p[c0 + i] = s[i];
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(FIX_THREADS)
surrogate_fixed(const Fields f, const T* __restrict__ params, int64_t n, int aligned) {
  __shared__ __align__(16) T s_unit[H * UNIT_ROW];
  // lo_in [0, 5), rng_in [8, 13), b2 [16, 20), lo_out [20, 24), rng_out [24, 28)
  __shared__ __align__(16) T s_tab[28];
  const T* const si = params + 1 + 3;  // after the header: 1, 5, H, 4
  const T* const so = si + 2 * NIN;
  const T* const w1 = so + 2 * NOUT;
  const T* const b1 = w1 + NIN * H;
  const T* const w2 = b1 + H;
  const T* const b2 = w2 + H * NOUT;
  for (int i = threadIdx.x; i < H * UNIT_ROW; i += FIX_THREADS) {
    const int j = i / UNIT_ROW, r = i % UNIT_ROW;
    s_unit[i] = r < NIN ? w1[r * H + j]
              : r == NIN ? b1[j]
              : r < NIN + 1 + NOUT ? w2[j * NOUT + (r - NIN - 1)] : T(0);
  }
  if (threadIdx.x < NIN) {
    const int k = threadIdx.x;
    s_tab[k] = si[2 * k];
    s_tab[8 + k] = sub(si[2 * k + 1], si[2 * k]);
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + NOUT) {
    const int q = threadIdx.x - 32;
    s_tab[16 + q] = b2[q];
    s_tab[20 + q] = so[2 * q];
    s_tab[24 + q] = sub(so[2 * q + 1], so[2 * q]);
  }
  __syncthreads();
  const int64_t nchunk = (n + FIX_V - 1) / FIX_V;
  for (int64_t c = (int64_t)blockIdx.x * FIX_THREADS + threadIdx.x; c < nchunk;
       c += (int64_t)gridDim.x * FIX_THREADS) {
    const int64_t c0 = c * FIX_V;
    const bool full = aligned && c0 + FIX_V <= n;
    T x[NIN][FIX_V];
#pragma unroll
    for (int k = 0; k < NIN; ++k) load_cells(x[k], static_cast<const T*>(f.in[k]), c0, full, n);
#pragma unroll
    for (int k = 0; k < NIN; ++k)
#pragma unroll
      for (int i = 0; i < FIX_V; ++i) x[k][i] = quo(sub(x[k][i], s_tab[k]), s_tab[8 + k]);
    T o[NOUT][FIX_V];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      T w[UNIT_ROW];
      load_vec(w, s_unit + j * UNIT_ROW);
#pragma unroll
      for (int i = 0; i < FIX_V; ++i) {
        T a = mul(x[0][i], w[0]);
#pragma unroll
        for (int k = 1; k < NIN; ++k) a = add(a, mul(x[k][i], w[k]));
        const T y = leaky(add(a, w[NIN]));
#pragma unroll
        for (int q = 0; q < NOUT; ++q) {
          const T p = mul(y, w[NIN + 1 + q]);
          o[q][i] = j == 0 ? p : add(o[q][i], p);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NOUT; ++q) {
      T v[FIX_V];
#pragma unroll
      for (int i = 0; i < FIX_V; ++i) {
        const T a = add(mul(add(o[q][i], s_tab[16 + q]), s_tab[24 + q]), s_tab[20 + q]);
        v[i] = q > 0 ? clamp0(a) : a;
      }
      store_cells(static_cast<T*>(f.out[q]), v, c0, full, n);
    }
  }
}

// -- (b) the general form ----------------------------------------------------

constexpr int GEN_THREADS = 256;
constexpr int TN = 4;            // outputs in a thread's tile
constexpr int MAX_TILE = 256;    // cells per block tile (at most GEN_THREADS)
constexpr int WCHUNK = 2048;     // weights per staged chunk (KC x NB)
constexpr int PER = WCHUNK / GEN_THREADS;  // chunk values a thread stages
constexpr int GACT_TILE = 8;     // cells per tile with activations in global memory
constexpr int TAB = 32;          // lo_in, rng_in (8 each), lo_out, rng_out (4 each), pads

struct Plan {
  int M;        // cells per tile
  bool gact;    // activations in global scratch
  int maxw;     // widest layer (inputs and outputs included)
  size_t smem;  // dynamic shared memory per block in bytes
};

Plan plan_for(int M, int maxw, int item, bool gact) {
  Plan p;
  p.M = M;
  p.gact = gact;
  p.maxw = maxw;
  p.smem = (size_t)(TAB + WCHUNK + (gact ? 0 : 2 * (size_t)maxw * M)) * item;
  return p;
}

// The largest tile whose activations fit two blocks to an SM, else one;
// else global activations at GACT_TILE cells.
Plan general_plan(int nlayers, const int* width, int item) {
  int maxw = 0;
  for (int l = 0; l <= nlayers; ++l) maxw = width[l] > maxw ? width[l] : maxw;
  const size_t budget[2] = {(size_t)SMEM_MAX / 2 - 1024, (size_t)SMEM_MAX};
  for (int b = 0; b < 2; ++b)
    for (int M = MAX_TILE; M >= 4; M /= 2) {
      const Plan p = plan_for(M, maxw, item, false);
      if (p.smem <= budget[b]) return p;
    }
  return plan_for(GACT_TILE, maxw, item, true);
}

// Rows [k0, k0 + KC) of W's columns [n0, n0 + NB) into wch[kk * NB + nn],
// 0 outside W; NB is a power of two, nb_log2 its log.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* wch, const T* __restrict__ w, int K, int N,
                                            int n0, int k0, int nb_log2) {
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * GEN_THREADS;
    const int k = k0 + (i >> nb_log2), col = n0 + (i & ((1 << nb_log2) - 1));
    wch[i] = k < K && col < N ? __ldg(w + (int64_t)k * N + col) : T(0);
  }
}

// One dense layer on the tile: y[n][m] = act(sum_k x[k][m] W[k][n] + b[n]),
// each thread a TMV x TN tile of (cells x outputs) per column block of NB
// outputs.  The weights stream through wch a chunk of KC rows at a time.
// NB is the least power of two of output groups that covers the layer, up
// to what the threads hold, so a narrow layer stages more rows a chunk.
template <typename T, int TMV>
__device__ __forceinline__ void dense_layer(const T* x, T* y, const T* __restrict__ w,
                                            const T* __restrict__ b, int K, int N, int M,
                                            bool hidden, T* wch) {
  const int cg = M / TMV;
  int og = GEN_THREADS / cg;
  while (og > 1 && og / 2 >= (N + TN - 1) / TN) og /= 2;
  const int NB = TN * og;
  const int KC = WCHUNK / NB;
  const int nb_log2 = __ffs(NB) - 1;
  const int m0 = (threadIdx.x % cg) * TMV;
  const int nn0 = (threadIdx.x / cg) * TN;
  for (int n0 = 0; n0 < N; n0 += NB) {
    const bool active = nn0 < NB && n0 + nn0 < N;
    T acc[TMV][TN];
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = K - k0 < KC ? K - k0 : KC;
      __syncthreads();  // the last chunk's readers done; the layer's inputs written
      stage_chunk(wch, w, K, N, n0, k0, nb_log2);
      __syncthreads();
      if (active) {
        int kk = 0;
        if (k0 == 0) {  // the first product of every sum
          T xv[TMV], wv[TN];
          load_vec(xv, x + m0);
          load_vec(wv, wch + nn0);
#pragma unroll
          for (int i = 0; i < TMV; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = mul(xv[i], wv[j]);
          kk = 1;
        }
        for (; kk < kc; ++kk) {
          T xv[TMV], wv[TN];
          load_vec(xv, x + (int64_t)(k0 + kk) * M + m0);
          load_vec(wv, wch + kk * NB + nn0);
#pragma unroll
          for (int i = 0; i < TMV; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = add(acc[i][j], mul(xv[i], wv[j]));
        }
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + nn0 + j;
        if (col < N) {
          const T bj = b[col];
#pragma unroll
          for (int i = 0; i < TMV; ++i) {
            const T a = add(acc[i][j], bj);
            y[(int64_t)col * M + m0 + i] = hidden ? leaky(a) : a;
          }
        }
      }
    }
  }
}

template <typename T, bool GACT>
__global__ void __launch_bounds__(GEN_THREADS, 2)
surrogate_general(const Fields f, const T* __restrict__ params, int nlayers, int64_t n,
                  const Plan pl, T* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tab = reinterpret_cast<T*>(smem);
  T* const wch = tab + TAB;
  const int M = pl.M;
  T* act_a;
  if constexpr (GACT)
    act_a = scratch + (int64_t)blockIdx.x * 2 * pl.maxw * M;
  else
    act_a = wch + WCHUNK;
  T* const act_b = act_a + (int64_t)pl.maxw * M;
  const T* const width = params + 1;  // the header's widths (exact in T)
  const T* const si = width + nlayers + 1;
  const T* const so = si + 2 * NIN;
  if (threadIdx.x < NIN) {
    const int k = threadIdx.x;
    tab[k] = si[2 * k];
    tab[8 + k] = sub(si[2 * k + 1], si[2 * k]);
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + NOUT) {
    const int q = threadIdx.x - 32;
    tab[16 + q] = so[2 * q];
    tab[20 + q] = sub(so[2 * q + 1], so[2 * q]);
  }
  const int64_t ntile = (n + M - 1) / M;
  for (int64_t t = blockIdx.x; t < ntile; t += gridDim.x) {
    const int64_t c0 = t * M;
    __syncthreads();  // tab written; the previous tile's outputs read
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      const T* const in = static_cast<const T*>(f.in[k]);
      for (int m = threadIdx.x; m < M; m += GEN_THREADS) {
        const T v = c0 + m < n ? in[c0 + m] : T(0);
        act_a[k * M + m] = quo(sub(v, tab[k]), tab[8 + k]);
      }
    }
    T* x = act_a;
    T* y = act_b;
    const T* w = so + 2 * NOUT;
    int K = NIN;
    for (int l = 0; l < nlayers; ++l) {
      const int N = (int)width[l + 1];
      const T* const b = w + (int64_t)K * N;
      const bool hidden = l + 1 < nlayers;
      // 4 cells a thread, or 1 on a layer where 4 would leave threads idle
      // and 1 still takes every output in one column block (more threads
      // take part at no more passes over the weights)
      if ((M / 4) * ((N + TN - 1) / TN) < GEN_THREADS && N <= TN * (GEN_THREADS / M))
        dense_layer<T, 1>(x, y, w, b, K, N, M, hidden, wch);
      else
        dense_layer<T, 4>(x, y, w, b, K, N, M, hidden, wch);
      T* const tmp = x;
      x = y;
      y = tmp;
      w = b + N;
      K = N;
    }
    __syncthreads();  // the last layer's outputs written
#pragma unroll
    for (int q = 0; q < NOUT; ++q) {
      T* const out = static_cast<T*>(f.out[q]);
      for (int m = threadIdx.x; m < M; m += GEN_THREADS)
        if (c0 + m < n) {
          const T a = add(mul(x[q * M + m], tab[20 + q]), tab[16 + q]);
          out[c0 + m] = q > 0 ? clamp0(a) : a;
        }
    }
  }
}

// -- launchers -----------------------------------------------------------------

// The model's shape: nlayers >= 1, widths >= 1, the first NIN and the last
// NOUT, and the parameter count they imply (header included).
int check(int nlayers, const int* width, long long nparams) {
  if (nlayers < 1 || width[0] != NIN || width[nlayers] != NOUT) return -1;
  long long count = 1 + (nlayers + 1) + NSCALE;
  for (int l = 0; l < nlayers; ++l) {
    if (width[l] < 1 || width[l + 1] < 1) return -1;
    count += (long long)width[l] * width[l + 1] + width[l + 1];
  }
  return count == nparams ? 0 : -1;
}

Fields fields_of(const void* const* in, void* const* out) {
  Fields f;
  for (int k = 0; k < NIN; ++k) f.in[k] = in[k];
  for (int k = 0; k < NOUT; ++k) f.out[k] = out[k];
  return f;
}

template <typename K>
cudaError_t persistent_blocks(K kernel, int threads, size_t smem, long long need,
                              unsigned* blocks) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  *blocks = (unsigned)(need < most ? need : most);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int H>
int launch_fixed(const Fields& f, const T* params, long long n, cudaStream_t s) {
  unsigned blocks;
  const long long need = ((n + FIX_V - 1) / FIX_V + FIX_THREADS - 1) / FIX_THREADS;
  cudaError_t err = persistent_blocks(surrogate_fixed<T, H>, FIX_THREADS, 0, need, &blocks);
  if (err != cudaSuccess) return err;
  int aligned = 1;
  for (int k = 0; k < NIN; ++k) aligned &= aligned16(f.in[k]);
  for (int k = 0; k < NOUT; ++k) aligned &= aligned16(f.out[k]);
  surrogate_fixed<T, H><<<blocks, FIX_THREADS, 0, s>>>(f, params, (int64_t)n, aligned);
  return cudaGetLastError();
}

// Resident blocks of the GACT form: one per SM (its scratch holds one tile's
// two activation buffers per block).
cudaError_t gact_blocks(unsigned* blocks) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = (unsigned)sms;
  return cudaSuccess;
}

template <typename T>
int launch_general(const Fields& f, const T* params, int nlayers, const int* width, long long n,
                   void* scratch, long long nscratch, cudaStream_t s) {
  const Plan pl = general_plan(nlayers, width, (int)sizeof(T));
  const long long ntile = (n + pl.M - 1) / pl.M;
  unsigned blocks;
  cudaError_t err;
  if (pl.gact) {
    unsigned most;
    err = gact_blocks(&most);
    if (err != cudaSuccess) return err;
    err = persistent_blocks(surrogate_general<T, true>, GEN_THREADS, pl.smem,
                            ntile < most ? ntile : most, &blocks);
    if (err != cudaSuccess) return err;
    if (scratch == nullptr || nscratch < (long long)blocks * 2 * pl.maxw * pl.M)
      return cudaErrorInvalidValue;
    surrogate_general<T, true><<<blocks, GEN_THREADS, pl.smem, s>>>(
        f, params, nlayers, (int64_t)n, pl, static_cast<T*>(scratch));
  } else {
    err = persistent_blocks(surrogate_general<T, false>, GEN_THREADS, pl.smem, ntile, &blocks);
    if (err != cudaSuccess) return err;
    surrogate_general<T, false><<<blocks, GEN_THREADS, pl.smem, s>>>(
        f, params, nlayers, (int64_t)n, pl, nullptr);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* params, int nparams,
           int nlayers, const int* width, long long n, int form, void* scratch,
           long long nscratch, void* stream) {
  if (n < 0 || check(nlayers, width, nparams) != 0) return cudaErrorInvalidValue;
  const bool fixed10 = nlayers == 2 && width[1] == 10;
  if (form == 0 && !fixed10) return cudaErrorInvalidValue;  // no such instantiation
  if (form != 0 && form != 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Fields f = fields_of(in, out);
  const T* p = static_cast<const T*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) return launch_fixed<T, 10>(f, p, n, s);
  return launch_general<T>(f, p, nlayers, width, n, scratch, nscratch, s);
}

}  // namespace

extern "C" {

// in: temp, rho_d, rho_v, rho_c, rho_r; out: temp, rho_v, rho_c, rho_r; n
// cells each, contiguous.  params: nparams values of the fields' type (the
// header, the scaling tables and the layers, as pack_mlp packs them);
// width: the nlayers + 1 layer widths the header holds, checked here.
// form: 0 the fixed form (5 -> 10 -> 4 only), 1 the general form; scratch:
// nscratch values of the fields' type for the general form's activations
// when surrogate_scratch asks for them, else null.
int surrogate_forward_f32(const void* const* in, void* const* out, const void* params,
                          int nparams, int nlayers, const int* width, long long n, int form,
                          void* scratch, long long nscratch, void* stream) {
  return launch<float>(in, out, params, nparams, nlayers, width, n, form, scratch, nscratch,
                       stream);
}

int surrogate_forward_f64(const void* const* in, void* const* out, const void* params,
                          int nparams, int nlayers, const int* width, long long n, int form,
                          void* scratch, long long nscratch, void* stream) {
  return launch<double>(in, out, params, nparams, nlayers, width, n, form, scratch, nscratch,
                        stream);
}

// Values of `item` bytes the general form needs as global scratch for this
// model (0 when its activations fit in shared memory); negative on a CUDA
// error.
long long surrogate_scratch(int nlayers, const int* width, int item) {
  const Plan pl = general_plan(nlayers, width, item);
  if (!pl.gact) return 0;
  unsigned blocks;
  if (gact_blocks(&blocks) != cudaSuccess) return -1;
  return (long long)blocks * 2 * pl.maxw * pl.M;
}

// The general form's cells per tile and dynamic shared memory per block
// for this model (tile negative when its activations live in scratch).
int surrogate_general_tile(int nlayers, const int* width, int item, long long* smem) {
  const Plan pl = general_plan(nlayers, width, item);
  *smem = (long long)pl.smem;
  return pl.gact ? -pl.M : pl.M;
}

const char* surrogate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
