// P3 lookup-table interpolation for NVIDIA Hopper (sm_90a): the ice table
// (trilinear), the ice-rain collection table (quadrilinear of log10 values,
// then 10**) and the generated rain rows (linear).
//
// Replaces the Pallas TPU kernels of miniweatherml_tpu/physics/
// p3_pallas_lookup.py: interp_ice_pallas / interp_collect_pallas /
// interp_rain_pallas (pallas_call in _call, :155) and their lane forms
// interp_ice_lane / interp_collect_lane (_wide_call, :292) and
// interp_rain_lane (:486).  Those build one-hot weight rows and contract
// them with the table on the MXU, because a gather is near-scalar on the
// TPU.  On Hopper a gather from shared memory or L1/L2 is the natural form,
// so this is the reference's access_lookup_table (micro_p3.F90:1508-1556),
// one thread per cell.
//
// What bounds it on the H100: bytes, if the table reads stay on the chip.
// Per cell a lookup reads 3-4 int32 indices and as many fractions and
// writes K values (52 B per cell for the ice lookup at K = 7 in f32).  The
// table reads are many more (8 corners per ice column, 16 per collection
// column).  When neighbouring cells are alike (a storm's own states) they
// hit the same few table rows and cost little; when they are unlike they
// scatter over the table.  So the design streams the cells with enough
// loads in flight, and makes the table reads few, wide and on-chip:
//  - Both kernels run a persistent grid (as many blocks as the SMs hold at
//    once) in which a thread walks cells with the grid's stride, and each
//    thread loads the next cell's indices and fractions before it works on
//    the current one, so its input loads are always in flight.
//  - The ice and collection lookups read tables packed for the gather
//    (p3_lookup_cuda.py: pack_ice / pack_collect, which DeviceTables makes
//    once per column set), the K columns of a table point innermost as one
//    entry of kp values: K rounded up to W, the power of two (at most 16
//    bytes) that a thread loads at once.  Ice: value (k, jj, ii, i) at
//    (jj * RIMSIZE + ii) * bs + i * es + k.  In shared memory the 16-byte
//    loads of 8 threads are served at once when they fall in different
//    bank groups, so entries are es = kp values apart if that is an odd
//    number of vectors, else kp + W (neighbouring i0 then start in
//    different groups), and each (jj, ii) block takes bs = ISIZE * es + W
//    values, so that the blocks start in different groups too (without
//    that skew cells at a clipped i0 read with up to 8-way bank
//    conflicts).  Collection: value (k, jj, ii, i, j) at
//    (((jj * RIMSIZE + ii) * ISIZE + i) * RCOLLSIZE + j) * kp + k, so the
//    entries j0 and j0 + 1 of one (jj, ii, i) row are 2 kp values in a
//    row.  A cell reads its corners by vector loads: 16
//    float4 loads for ice at K = 7 in f32 (56 values), 16 float2 loads for
//    the collection table at K = 2 (32 values).
//  - The ice table (48 KB at K = 7 in f32, 80 KB in f64) is staged whole in
//    shared memory by cp.async, once per block, so a corner read is an LDS;
//    the corners are read in two rounds of 4 (jj0, then jj0 + 1), which
//    keeps the kernel within 64 registers at two blocks per SM.  A table
//    larger than a block's shared memory is refused.
//  - The collection table (248 KB at K = 2 in f32, 496 KB in f64) does
//    not fit in shared memory and is read from L1/L2, all 16 corner loads
//    of a cell issued before its arithmetic (staging 18 of its 20 (jj, ii)
//    blocks in f32 was faster only on uniformly scattered indices, and
//    slower on a storm's own).  Each value then takes an exact pow(10, v):
//    ~348 G powf/s on the card, ~0.1 ms for the 33.6 M of a 512x512x64 f32
//    call, half of that call's bytes bound.
//  - Outputs are K contiguous planes, so stores coalesce.
// Every add and multiply is a round-to-nearest intrinsic in the order of
// the plain version (ice: fi, fii, fjj; collection: fj, fi, fii, fjj, then
// 10**), and the file builds with contraction on so that pow rounds as
// PyTorch's own CUDA build does: each kernel gives its plain version's
// values bit for bit.  `present` (a device bool, may be null) is the
// presence gate: when it is false the kernel writes zeros and reads no
// table.  Indices are clamped into the table so that no index can fault
// (the index finders never produce one outside it).  The ice and rain
// interpolations and the table staging are p3_interp.cuh's, which the
// sedimentation kernels (p3_sed.cu) call inline too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p3_interp.cuh"

namespace {

constexpr int ICE_THREADS = 512, ICE_PER_SM = 2, RAIN_THREADS = 256;
// Threads per block of the collection kernel (one block per SM): a thread
// holds 16 vectors of corner loads and the next cell's inputs (at most 96
// registers in f32, 128 in f64).
template <typename T> __host__ __device__ constexpr int collect_threads() {
  return sizeof(T) == 4 ? 640 : 512;
}
// A block's shared memory on sm_90 (227 KB): the largest ice table staged.
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float pow10(float v) { return powf(10.0f, v); }
__device__ __forceinline__ double pow10(double v) { return pow(10.0, v); }

// Zeros for K planes of n cells, thread `first` of `stride`: 16 bytes a
// store where every plane starts 16-byte aligned, else one value a store.
template <typename T>
__device__ void write_zeros(T* __restrict__ out, int K, int64_t n,
                            int64_t first, int64_t stride) {
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    for (int64_t c = first * V; c < n; c += stride * V)
      for (int k = 0; k < K; ++k)
        *reinterpret_cast<float4*>(out + k * n + c) = make_float4(0, 0, 0, 0);
    return;
  }
  for (int64_t c = first; c < n; c += stride)
    for (int k = 0; k < K; ++k) out[k * n + c] = T(0);
}

// One cell's D indices and D fractions, loaded together.
template <typename T, int D> struct Cell {
  int idx[D];
  T frac[D];
};
template <typename T, int D>
__device__ __forceinline__ Cell<T, D> load_cell(
    const int* const (&idx)[D], const T* const (&frac)[D], int64_t c) {
  Cell<T, D> v;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v.idx[d] = __ldg(idx[d] + c);
    v.frac[d] = __ldg(frac[d] + c);
  }
  return v;
}

// Trilinear ice lookup from the packed table staged in shared memory.  A
// persistent grid: each thread walks cells with the grid's stride and loads
// the next cell's inputs before it works on the current one (the first
// cell's before the staging).  The 8 corners are read in two rounds of 4,
// those of jj0 and then of jj0 + 1.
template <typename T, int W>
__global__ void __launch_bounds__(ICE_THREADS, ICE_PER_SM)
ice_kernel(const T* __restrict__ packed, int K,
           const int* __restrict__ i0p, const T* __restrict__ fip,
           const int* __restrict__ ii0p, const T* __restrict__ fiip,
           const int* __restrict__ jj0p, const T* __restrict__ fjjp,
           const bool* __restrict__ present, T* __restrict__ out, int64_t n) {
  const int64_t first = (int64_t)blockIdx.x * ICE_THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * ICE_THREADS;
  if (present && !*present) {
    write_zeros(out, K, n, first, stride);
    return;
  }
  const int* const idx[3] = {i0p, ii0p, jj0p};
  const T* const frac[3] = {fip, fiip, fjjp};
  Cell<T, 3> next{};
  if (first < n) next = load_cell(idx, frac, first);
  const int kp = round_up(K, W), es = ice_entry(kp, W);
  const int bs = ice_block(kp, W);
  extern __shared__ __align__(16) unsigned char smem[];
  stage(smem, packed, (size_t)BLOCKS * bs * sizeof(T));
  const T* tab = reinterpret_cast<const T*>(smem);
  for (int64_t c = first; c < n; c += stride) {
    const Cell<T, 3> cell = next;
    if (c + stride < n) next = load_cell(idx, frac, c + stride);
    int i0 = cell.idx[0], ii0 = cell.idx[1], jj0 = cell.idx[2];
    clamp_ice_index(i0, ii0, jj0);
    const T fi = cell.frac[0], fii = cell.frac[1], fjj = cell.frac[2];
    for (int k0 = 0; k0 < K; k0 += W) {
      T v[W];
      ice_interp<T, W>(tab, bs, es, i0, ii0, jj0, fi, fii, fjj, k0, v);
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (k0 + e < K) out[(k0 + e) * n + c] = v[e];
    }
  }
}

// Quadrilinear collection lookup, 10** of the interpolated log10 values,
// the table read from L1/L2; a persistent grid with the next cell's inputs
// loaded ahead, as for the ice lookup.  All 16 corner loads of a cell (of W
// columns) are issued before its arithmetic.
template <typename T, int W>
__global__ void __launch_bounds__(collect_threads<T>(), 1)
collect_kernel(const T* __restrict__ packed, int K,
               const int* __restrict__ i0p, const T* __restrict__ fip,
               const int* __restrict__ ii0p, const T* __restrict__ fiip,
               const int* __restrict__ jj0p, const T* __restrict__ fjjp,
               const int* __restrict__ j0p, const T* __restrict__ fjp,
               const bool* __restrict__ present, T* __restrict__ out,
               int64_t n) {
  using V = typename VecOf<T, W>::V;
  constexpr int THREADS = collect_threads<T>();
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  if (present && !*present) {
    write_zeros(out, K, n, first, stride);
    return;
  }
  const int* const idx[4] = {i0p, ii0p, jj0p, j0p};
  const T* const frac[4] = {fip, fiip, fjjp, fjp};
  Cell<T, 4> next{};
  if (first < n) next = load_cell(idx, frac, first);
  const int kp = round_up(K, W), row = RCOLLSIZE * kp, bs = ISIZE * row;
  for (int64_t c = first; c < n; c += stride) {
    const Cell<T, 4> cell = next;
    if (c + stride < n) next = load_cell(idx, frac, c + stride);
    const int i0 = clampi(cell.idx[0], 0, ISIZE - 2);
    const int ii0 = clampi(cell.idx[1], 0, RIMSIZE - 2);
    const int jj0 = clampi(cell.idx[2], 0, DENSIZE - 2);
    const int j0 = clampi(cell.idx[3], 0, RCOLLSIZE - 2);
    const T fi = cell.frac[0], fii = cell.frac[1];
    const T fjj = cell.frac[2], fj = cell.frac[3];
    for (int k0 = 0; k0 < K; k0 += W) {
      // row s = (jj - jj0) * 4 + (ii - ii0) * 2 + (i - i0) of block
      // (jj, ii); its entries j0 and j0 + 1 are 2 kp values in a row
      V v[8][2];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int b = (jj0 + (s >> 2)) * RIMSIZE + ii0 + ((s >> 1) & 1);
        const T* p = packed + b * bs + (i0 + (s & 1)) * row + j0 * kp + k0;
        v[s][0] = __ldg(reinterpret_cast<const V*>(p));
        v[s][1] = __ldg(reinterpret_cast<const V*>(p + kp));
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        if (k0 + e >= K) break;
        T lj[8];
#pragma unroll
        for (int s = 0; s < 8; ++s)
          lj[s] = lerp(elem(v[s][0], e), elem(v[s][1], e), fj);
        T li[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) li[s] = lerp(lj[2 * s], lj[2 * s + 1], fi);
        const T l0 = lerp(li[0], li[1], fii), l1 = lerp(li[2], li[3], fii);
        out[(k0 + e) * n + c] = pow10(lerp(l0, l1, fjj));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(RAIN_THREADS)
rain_kernel(const T* __restrict__ rows, int K, int size,
            const int* __restrict__ i0p, const T* __restrict__ fip,
            const bool* __restrict__ present, T* __restrict__ out,
            int64_t n) {
  const int64_t c = (int64_t)blockIdx.x * RAIN_THREADS + threadIdx.x;
  if (c >= n) return;
  if (present && !*present) {
    for (int k = 0; k < K; ++k) out[k * n + c] = T(0);
    return;
  }
  const int i0 = i0p[c];
  const T fi = fip[c];
  for (int k = 0; k < K; ++k)
    out[k * n + c] = rain_interp(rows + (int64_t)k * size, size, i0, fi);
}

int blocks_for(long long n, int per_block, unsigned* blocks) {
  const long long b = (n + per_block - 1) / per_block;
  if (n < 0 || b > 2147483647LL) return cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return cudaSuccess;
}

// Caps `blocks` at `per_sm` blocks per SM of the current card (a
// persistent grid: the blocks that `kernel` keeps resident at once with
// `smem` bytes of shared memory each, which it is allowed here).
template <typename Kernel>
int persistent(Kernel kernel, int per_sm, size_t smem, unsigned* blocks) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (*blocks > (unsigned)(sms * per_sm)) *blocks = sms * per_sm;
  return cudaSuccess;
}

template <typename T>
using IceKernel = void (*)(const T*, int, const int*, const T*, const int*,
                           const T*, const int*, const T*, const bool*, T*,
                           int64_t);
template <typename T>
using CollectKernel = void (*)(const T*, int, const int*, const T*,
                               const int*, const T*, const int*, const T*,
                               const int*, const T*, const bool*, T*,
                               int64_t);

// The kernel, shared memory per block and grid of a lookup of K columns
// over n cells.
template <typename T>
int ice_config(int K, long long n, IceKernel<T>* kernel, size_t* smem,
               unsigned* blocks) {
  if (K < 1 || ice_table_bytes<T>(K) > (size_t)SMEM_MAX)
    return cudaErrorInvalidValue;
  if (int e = blocks_for(n, ICE_THREADS, blocks)) return e;
  *smem = ice_table_bytes<T>(K);
  const int W = vec_width<T>(K);
  if constexpr (sizeof(T) == 4)
    *kernel = W == 1 ? ice_kernel<T, 1>
            : W == 2 ? ice_kernel<T, 2> : ice_kernel<T, 4>;
  else
    *kernel = W == 1 ? ice_kernel<T, 1> : ice_kernel<T, 2>;
  return persistent(*kernel, ICE_PER_SM, *smem, blocks);
}

template <typename T>
int collect_config(int K, long long n, CollectKernel<T>* kernel,
                   size_t* smem, unsigned* blocks) {
  if (K < 1) return cudaErrorInvalidValue;
  if (int e = blocks_for(n, collect_threads<T>(), blocks)) return e;
  *smem = 0;
  const int W = vec_width<T>(K);
  if constexpr (sizeof(T) == 4)
    *kernel = W == 1 ? collect_kernel<T, 1>
            : W == 2 ? collect_kernel<T, 2> : collect_kernel<T, 4>;
  else
    *kernel = W == 1 ? collect_kernel<T, 1> : collect_kernel<T, 2>;
  return persistent(*kernel, 1, *smem, blocks);
}

template <typename T>
int launch_ice(const void* packed, int K, const void* i0, const void* fi,
               const void* ii0, const void* fii, const void* jj0,
               const void* fjj, const void* present, void* out, long long n,
               void* stream) {
  IceKernel<T> kernel;
  size_t smem;
  unsigned blocks;
  if (int e = ice_config<T>(K, n, &kernel, &smem, &blocks)) return e;
  if (n == 0) return cudaSuccess;
  kernel<<<blocks, ICE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(packed), K, static_cast<const int*>(i0),
      static_cast<const T*>(fi), static_cast<const int*>(ii0),
      static_cast<const T*>(fii), static_cast<const int*>(jj0),
      static_cast<const T*>(fjj), static_cast<const bool*>(present),
      static_cast<T*>(out), (int64_t)n);
  return cudaGetLastError();
}

template <typename T>
int launch_collect(const void* packed, int K, const void* i0, const void* fi,
                   const void* ii0, const void* fii, const void* jj0,
                   const void* fjj, const void* j0, const void* fj,
                   const void* present, void* out, long long n, void* stream) {
  CollectKernel<T> kernel;
  size_t smem;
  unsigned blocks;
  if (int e = collect_config<T>(K, n, &kernel, &smem, &blocks)) return e;
  if (n == 0) return cudaSuccess;
  kernel<<<blocks, collect_threads<T>(), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(packed), K,
      static_cast<const int*>(i0), static_cast<const T*>(fi),
      static_cast<const int*>(ii0), static_cast<const T*>(fii),
      static_cast<const int*>(jj0), static_cast<const T*>(fjj),
      static_cast<const int*>(j0), static_cast<const T*>(fj),
      static_cast<const bool*>(present), static_cast<T*>(out), (int64_t)n);
  return cudaGetLastError();
}

template <typename T>
int launch_rain(const void* rows, int K, int size, const void* i0,
                const void* fi, const void* present, void* out, long long n,
                void* stream) {
  unsigned blocks;
  if (int e = blocks_for(n, RAIN_THREADS, &blocks)) return e;
  if (size < 2) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  rain_kernel<T><<<blocks, RAIN_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), K, size, static_cast<const int*>(i0),
      static_cast<const T*>(fi), static_cast<const bool*>(present),
      static_cast<T*>(out), (int64_t)n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ``table`` of the ice and collection entries is the packed table
// (p3_lookup_cuda.py: pack_ice / pack_collect) of K columns.
#define P3_LOOKUP_ENTRY(SUF, T)                                               \
  int p3_interp_ice_##SUF(const void* table, int K, const void* i0,           \
                          const void* fi, const void* ii0, const void* fii,   \
                          const void* jj0, const void* fjj,                   \
                          const void* present, void* out, long long n,        \
                          void* stream) {                                     \
    return launch_ice<T>(table, K, i0, fi, ii0, fii, jj0, fjj, present, out,  \
                         n, stream);                                          \
  }                                                                           \
  int p3_interp_collect_##SUF(const void* table, int K, const void* i0,       \
                              const void* fi, const void* ii0,                \
                              const void* fii, const void* jj0,               \
                              const void* fjj, const void* j0,                \
                              const void* fj, const void* present, void* out, \
                              long long n, void* stream) {                    \
    return launch_collect<T>(table, K, i0, fi, ii0, fii, jj0, fjj, j0, fj,    \
                             present, out, n, stream);                        \
  }                                                                           \
  int p3_interp_rain_##SUF(const void* rows, int K, int size, const void* i0, \
                           const void* fi, const void* present, void* out,    \
                           long long n, void* stream) {                       \
    return launch_rain<T>(rows, K, size, i0, fi, present, out, n, stream);    \
  }

P3_LOOKUP_ENTRY(f32, float)
P3_LOOKUP_ENTRY(f64, double)

// The launch of the ice (collect = 0) or collection (collect = 1) kernel
// for K columns and n cells: its blocks, threads per block and shared
// memory per block (the staged ice table; 0 for the collection kernel).
int p3_lookup_launch(int collect, int K, int f64, long long n,
                     unsigned* blocks, int* threads, long long* smem) {
  size_t sm = 0;
  int e;
  *threads = !collect ? ICE_THREADS
           : f64 ? collect_threads<double>() : collect_threads<float>();
  if (collect && f64) {
    CollectKernel<double> k;
    e = collect_config<double>(K, n, &k, &sm, blocks);
  } else if (collect) {
    CollectKernel<float> k;
    e = collect_config<float>(K, n, &k, &sm, blocks);
  } else if (f64) {
    IceKernel<double> k;
    e = ice_config<double>(K, n, &k, &sm, blocks);
  } else {
    IceKernel<float> k;
    e = ice_config<float>(K, n, &k, &sm, blocks);
  }
  *smem = (long long)sm;
  return e;
}

const char* p3_lookup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
