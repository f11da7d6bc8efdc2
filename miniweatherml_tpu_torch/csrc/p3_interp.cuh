// The P3 table interpolations as __device__ functions, shared by the lookup
// kernels (p3_lookup.cu) and the sedimentation kernels (p3_sed.cu), which
// call them inline on a table staged in shared memory.
//
// The packed ice table (p3_lookup_cuda.py mirrors this layout: pack_ice,
// ice_offset): an entry holds the K columns of one table point, kp =
// round_up(K, W) values, W being the power of two (at most 16 bytes) of
// values a thread loads at once; entries are es values apart, kp rounded up
// to an odd number of vectors, and a (jj, ii) block holds ISIZE entries and
// W values of skew, so that neighbouring entries and blocks start in
// different shared-memory banks.  Every add and multiply is a
// round-to-nearest intrinsic in the order of the plain versions
// (p3_lookup_cuda.py: interp_ice_plain / interp_rain_plain), so a file
// includes this header whatever its --fmad flag and gets their values bit
// for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ISIZE = 50, RIMSIZE = 4, DENSIZE = 5, RCOLLSIZE = 30;
constexpr int BLOCKS = DENSIZE * RIMSIZE;  // (jj, ii) blocks of a table

// The vector of W values of type T that a thread loads at once.
template <typename T, int W> struct VecOf;
template <> struct VecOf<float, 1> { using V = float; };
template <> struct VecOf<float, 2> { using V = float2; };
template <> struct VecOf<float, 4> { using V = float4; };
template <> struct VecOf<double, 1> { using V = double; };
template <> struct VecOf<double, 2> { using V = double2; };

__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ float elem(const float2& v, int e) {
  return e == 0 ? v.x : v.y;
}
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double elem(double v, int) { return v; }
__device__ __forceinline__ double elem(const double2& v, int e) {
  return e == 0 ? v.x : v.y;
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// a + f (b - a), each operation rounded on its own (the plain version's lerp)
template <typename T>
__device__ __forceinline__ T lerp(T a, T b, T f) {
  return add_rn(a, mul_rn(f, sub_rn(b, a)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

template <typename T>
__host__ __device__ constexpr int vec_width(int K) {
  int w = 1;
  while (w < K && w * (int)sizeof(T) < 16) w *= 2;
  return w;
}
__host__ __device__ constexpr int ice_entry(int kp, int W) {
  return kp / W % 2 ? kp : kp + W;
}
__host__ __device__ constexpr int ice_block(int kp, int W) {
  return ISIZE * ice_entry(kp, W) + W;
}

// Bytes of a packed K-column ice table's (jj, ii) blocks: what a kernel
// stages in shared memory.
template <typename T>
__host__ __device__ constexpr size_t ice_table_bytes(int K) {
  return (size_t)BLOCKS * ice_block(round_up(K, vec_width<T>(K)), vec_width<T>(K)) *
         sizeof(T);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

// The block copies `bytes` (a multiple of 16) from src to shared memory
// (cp.async; waited for and made visible to the block on return).
__device__ void stage(unsigned char* smem, const void* src, size_t bytes) {
  for (size_t v = threadIdx.x; v < bytes / 16; v += blockDim.x)
    copy16(smem + 16 * v, static_cast<const unsigned char*>(src) + 16 * v);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Columns k0 ... k0 + W - 1 of a trilinear ice lookup in a packed table
// `tab` (bs values per (jj, ii) block, es per entry); indices already
// clamped into the table.  The 8 corners are read in two rounds of 4,
// those of jj0 and then of jj0 + 1.
template <typename T, int W>
__device__ __forceinline__ void ice_interp(const T* tab, int bs, int es, int i0,
                                           int ii0, int jj0, T fi, T fii, T fjj,
                                           int k0, T (&out)[W]) {
  using V = typename VecOf<T, W>::V;
  T lii[2][W];  // (jj0 + a)'s value of columns k0 ... k0 + W - 1
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    // corner s = (ii - ii0) * 2 + (i - i0) of block (jj0 + a, ii)
    V v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      v[s] = *reinterpret_cast<const V*>(tab + ((jj0 + a) * RIMSIZE + ii0 + (s >> 1)) * bs +
                                         (i0 + (s & 1)) * es + k0);
#pragma unroll
    for (int e = 0; e < W; ++e)
      lii[a][e] = lerp(lerp(elem(v[0], e), elem(v[1], e), fi),
                       lerp(elem(v[2], e), elem(v[3], e), fi), fii);
  }
#pragma unroll
  for (int e = 0; e < W; ++e) out[e] = lerp(lii[0][e], lii[1][e], fjj);
}

// The ice lookup's index clamps (the index finders never produce an index
// outside the table; the clamp keeps any input from faulting).
__device__ __forceinline__ void clamp_ice_index(int& i0, int& ii0, int& jj0) {
  i0 = clampi(i0, 0, ISIZE - 2);
  ii0 = clampi(ii0, 0, RIMSIZE - 2);
  jj0 = clampi(jj0, 0, DENSIZE - 2);
}

// Linear lookup into one row of `size` values, i0 clipped to [0, size - 2].
template <typename T>
__device__ __forceinline__ T rain_interp(const T* row, int size, int i0, T fi) {
  const int i = clampi(i0, 0, size - 2);
  return lerp(row[i], row[i + 1], fi);
}

}  // namespace
