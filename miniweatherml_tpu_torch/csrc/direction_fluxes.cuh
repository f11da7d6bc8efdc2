// Fused WENO reconstruction + upwind Riemann fluxes + state divergence for
// one direction of the compressible-Euler dycore, for NVIDIA Hopper (sm_90a):
// the kernels, templated on the limiter algebra, and DIRECTION_FLUXES_ENTRY,
// which declares one extern "C" entry point.  direction_fluxes.cu builds
// them in the reference algebra, direction_fluxes_opt.cu in the
// reduced-operation algebra, exact and with approximate reciprocals, and
// direction_fluxes_ref_fast.cu in the reference algebra with approximate
// reciprocals, each into a library of its own.
//
// Replaces the Pallas TPU megakernels of miniweatherml_tpu/ops/pallas_recon.py:
// direction_fluxes_pallas (x, stencil on the last axis, pallas_call at :536)
// and direction_fluxes_pallas_sub (y and z, stencil on axis -2, pallas_call
// at :941), in both of their forms: the whole axis (self_bc: halos from the
// block's own edges) and the halo-strip form of a split x or y axis (lo / hi
// strips from the ring neighbours, and a face mode per end, bc=(bc_lo,
// bc_hi)).  The y/z kernel also carries the sub kernel's two epilogues of
// the state output (pallas_recon.py:804-813, 853-866, 583-607): `acc`, the
// running state tendency, which it reads and adds its divergence to in
// place, and `rk`, the SSPRK3 stage update of the last direction: the sum
// takes gravity, Coriolis, the 2-D v = 0 and the immersed blend (the
// port's XLA-path forms: Coriolis from the stage's state, not from the
// prim block) and becomes c0*b0 [+ c1*b1] + cdt*tendency, in the order of
// ops/direction_fluxes.py::stage_update.  Each output cell is read and
// written by one thread, so `acc` is updated in place with no race.
//
// Math (the JAX XLA path, dycore/euler.py:475-613 plus div):
//   halo fill (periodic wrap; wall/open edge copy, wall zeroes the normal
//   velocity; or, in the halo-strip form, the hp = (ord-1)/2 + 1 cells of
//   the lo / hi strips a shard's neighbours sent) -> WENO edges of every
//   variable in the algebra ALG (ALG_REF: exact weights in the term order
//   of ops/weno_fused.py::reconstruct_edges_shifted, the JAX XLA path's;
//   ALG_REF_FAST: the same with approximate reciprocals, the Pallas
//   kernels' pallas_recon.py::_weno_edges_block with fast_weights, in the
//   term order of ops/weno_fused.py::reconstruct_edges_recip;
//   ALG_OPT / ALG_FAST: the Pallas kernels' reduced-operation algebra,
//   pallas_recon.py::_weno_edges_block_opt, in the term order of
//   ops/weno_fused.py::reconstruct_edges_opt, with IEEE or approximate
//   reciprocals) -> face limits, densitized with the
//   hydrostatic background (cell profile for x/y, face profile for z) ->
//   wall/open face overwrite (each end by its own mode: the strip form sets
//   it only on the shards that hold the global boundary) -> upwind Riemann solve -> state divergence
//   -(F[f+1] - F[f]) * div_scale, and the unscaled tracer faces.
//
// What bounds it on the H100: operations.  The reference limiter costs about
// 200 floating-point operations per variable per cell (ord 5: 33 smoothness
// terms, two normalisations, four weights with IEEE divisions, 2 x 14 edge
// terms), the reduced-operation one about 140 (ord 5: shared differences,
// one normalisation, five reciprocals, the high-order edge folded into the
// low-order blend), against one value read per variable and one written
// per output; bytes come second (~0.32 ms per call at 512x512x64 with 8
// variables).  Every result of ALG_REF and ALG_OPT equals the plain PyTorch
// version bit for bit: each add, subtract and multiply is a round-to-nearest
// intrinsic (never contracted into an FMA), divisions and reciprocals are
// IEEE, terms come in the plain version's order,
// and the file builds with contraction on only so that pow rounds as
// PyTorch's own pow kernel does.  Without FMAs the floor is about twice the
// operation bound.  Tensor cores do not apply: the limiter is nonlinear per
// cell, its linear parts are 3- to 9-wide dot products, and each result
// must round as the plain f32/f64 arithmetic does.
//
// Design (issue-bound, so the instruction count comes first):
//  * The limiter tables of each order (ops/weno_fused.py::weno_coef_table
//    and opt_coef_table, the tables' doubles cast to the type) live in
//    __constant__ memory and are indexed by compile-time offsets after
//    unrolling, so every coefficient is a constant-bank operand of its
//    multiply: no loads.
//  * The algebra is a template parameter (ALG_REF, ALG_OPT, ALG_FAST,
//    ALG_REF_FAST) of every kernel, so each form compiles only its own
//    limiter.  ALG_FAST takes the five reciprocals of the opt algebra as one
//    MUFU.RCP each (rcp.approx.ftz.f32) in place of the IEEE division's
//    instruction sequence, ALG_REF_FAST the reference algebra's two (three
//    with a cutoff) normalisations and its K weights likewise; both exist
//    in f32 only, as the Pallas kernels' approximate reciprocal does.
//  * Order, type, direction kind (x: unit stride; y/z: strided), a bound
//    on the tracer count (1, 3 or 9; the tracer loop is unrolled and
//    guarded) and the form (whole axis or halo strips: a runtime branch on
//    the strip pointer cost the whole-axis x kernel 6-8% through register
//    spills, PERF.md) are template parameters; tile sizes are compile-time
//    constants; the grid is (line tiles, planes, chunks) for y/z and (x
//    tiles, rows, planes) for x, so the background profile's index is
//    plane * hps + face * has and no index needs a runtime division.  The
//    periodic wrap and edge copy run only for cells outside the axis.
//  * y and z (fluxes_tiled): a block of 8 warps stages a tile of 32 lines
//    (consecutive x positions, so every load and store of a warp is
//    contiguous) x 8 cells along the direction, plus the halos, of every
//    variable in shared memory, and a warp takes four of its lines with 8
//    lanes along the direction on each, as the x kernel's warp takes a
//    row: a lane forms one variable's stencil at a time from shared memory,
//    so its registers do not grow with the variable count (64 in f32, 32
//    warps an SM, where a thread marching a line with a register window of
//    every variable held 128 and 16, PERF.md).  Neighbours' edges and
//    fluxes come by shuffle, and across a step's edge through shared
//    memory, so the limiter runs n + 2 times a line per chunk; the
//    divergences and tracer faces go back through shared memory and out
//    coalesced, where the epilogue applies.
//  * x (unit stride): a lane per line would make every store of a warp
//    touch 32 rows (measured 2-3x slower than y/z), so instead a warp owns
//    30 consecutive cells of one row: lane i forms the edges of cell
//    x0 - 1 + i from a stencil gathered with warp shuffles out of two
//    coalesced loads per variable, takes its left neighbour's right edges
//    and its right neighbour's face fluxes by shuffle, and writes its
//    cell's divergence and its left face.  No shared memory, no
//    synchronisation, and 32/30 of the limiter work.
//  * No asynchronous copies or TMA: the loads are not where the time goes.
//  * The epilogue form (none / accumulate / stage) is a template parameter
//    of the y/z kernel, so the bare form compiles without it; the stage's
//    options (b1, gravity, Coriolis, 2-D, immersed) are runtime flags, each
//    tested once per cell.  The accumulator adds a read of the 5-variable
//    state (0.34 GB at 512x512x64 f32), the stage update reads b0, b1 and
//    the immersed proportion as well (up to 1.08 GB in all, beside the bare
//    call's 1.07 GB), against a kernel that is operation-bound; each cell's
//    reads are coalesced across the warp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int IDR = 0, IDU = 1, IDV = 2, IDW = 3, IDT = 4, NS = 5;
constexpr int BC_PERIODIC = 0, BC_WALL = 2;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int COEF_MAX = 104;  // longest limiter table (ord 9: 103 values)
constexpr int NTR_MAX = 9;
// epilogue forms of the y/z kernel, and the stage update's option flags
// (ops/direction_fluxes.py::_GRAV, _FCOR, _SIM2D)
constexpr int EPI_NONE = 0, EPI_ACC = 1, EPI_STAGE = 2;
constexpr int ST_GRAV = 1, ST_FCOR = 2, ST_SIM2D = 4;
// limiter algebras: the reference order with exact weights (ALG_REF,
// ops/weno_fused.py::reconstruct_edges_shifted), the reduced-operation
// algebra with exact reciprocals (ALG_OPT) and with approximate ones
// (ALG_FAST, f32 only; ops/weno_fused.py::reconstruct_edges_opt), and the
// reference algebra with approximate reciprocals (ALG_REF_FAST, f32 only;
// ops/weno_fused.py::reconstruct_edges_recip)
constexpr int ALG_REF = 0, ALG_OPT = 1, ALG_FAST = 2, ALG_REF_FAST = 3;
// whether an algebra reads the reference table (weno_coef_table) and takes
// a cutoff, or the reduced-operation one (opt_coef_table)
__host__ __device__ constexpr bool ref_table(int alg) {
  return alg == ALG_REF || alg == ALG_REF_FAST;
}

// the tables of each order: weno_coef_table's (reference algebra) and
// opt_coef_table's (reduced-operation algebra), as f32 and f64; a library
// fills the one its algebras read
__constant__ float c_coef_f32[4][COEF_MAX];
__constant__ double c_coef_f64[4][COEF_MAX];
__constant__ float c_opt_f32[4][COEF_MAX];
__constant__ double c_opt_f64[4][COEF_MAX];

template <typename T>
__device__ __forceinline__ T coef(int slot, int i);
template <>
__device__ __forceinline__ float coef<float>(int slot, int i) {
  return c_coef_f32[slot][i];
}
template <>
__device__ __forceinline__ double coef<double>(int slot, int i) {
  return c_coef_f64[slot][i];
}
template <typename T>
__device__ __forceinline__ T opt_coef(int slot, int i);
template <>
__device__ __forceinline__ float opt_coef<float>(int slot, int i) {
  return c_opt_f32[slot][i];
}
template <>
__device__ __forceinline__ double opt_coef<double>(int slot, int i) {
  return c_opt_f64[slot][i];
}

__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }

// Every add, subtract and multiply of the arithmetic below rounds on its
// own (round-to-nearest intrinsics, never contracted into an FMA), as the
// plain PyTorch version's separate kernels do; the file itself builds with
// contraction on so that pow rounds as PyTorch's own pow kernel does.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// Support of each candidate polynomial inside the ord-wide stencil and the
// layout of the coefficient table (ops/weno_fused.py::weno_coef_table).
template <int ORD>
struct Limiter {
  static constexpr int K = ORD == 3 ? 3 : 4;
  static constexpr int HS = (ORD - 1) / 2;
  static constexpr int SLOT = (ORD - 3) / 2;
  __host__ __device__ static constexpr int start(int k) {
    return ORD == 3 ? (k == 1 ? 1 : 0) : (k == 3 ? 0 : HS - 2 + k);
  }
  __host__ __device__ static constexpr int width(int k) {
    return ORD == 3 ? (k == 2 ? 3 : 2) : (k == 3 ? ORD : 3);
  }
  __host__ __device__ static constexpr int tv_off(int k) {
    return k == 0 ? 0 : tv_off(k - 1) + width(k - 1) * (width(k - 1) + 1) / 2;
  }
  __host__ __device__ static constexpr int edge_off(int k) {
    return k == 0 ? tv_off(K) : edge_off(k - 1) + 2 * width(k - 1);
  }
  static constexpr int IDL_OFF = edge_off(K);
  static constexpr int SIZE = IDL_OFF + K;
};
static_assert(Limiter<9>::SIZE <= COEF_MAX, "coefficient table too long");

// 1 / v: an IEEE division, or with FAST the hardware's approximate
// reciprocal (one MUFU.RCP, ~1 ulp; subnormals flush to zero), the
// counterpart of the Pallas kernels' pl.reciprocal(approx=True)
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
template <typename T, bool FAST>
__device__ __forceinline__ T recip(T v) {
  if constexpr (FAST) {
    static_assert(std::is_same<T, float>::value,
                  "the approximate reciprocal is f32 only");
    return rcp_approx(v);
  } else {
    return T(1) / v;
  }
}

// Limited left/right edge values of one cell from its ord-wide stencil, in
// the reference algebra: with FAST (ALG_REF_FAST) every reciprocal of the
// two normalisations and of the weights is the approximate one and each
// weight is idl times it (pallas_recon.py::_weno_edges_block with
// fast_weights), else both normalisations take the IEEE reciprocal and the
// weights an IEEE division (reconstruct_edges_shifted).
template <int ORD, typename T, bool FAST>
__device__ __forceinline__ void weno_edges(const T (&s)[ORD], T cutoff,
                                           T& left, T& right) {
  using L = Limiter<ORD>;
  constexpr int K = L::K, SLOT = L::SLOT;
  const T eps = T(1e-20);
  T tv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int st = L::start(k), w = L::width(k);
    int o = L::tv_off(k);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < w; ++i)
#pragma unroll
      for (int j = i; j < w; ++j)
        acc = add(acc, mul(mul(coef<T>(SLOT, o++), s[st + i]), s[st + j]));
    tv[k] = acc;
  }
  auto convexify = [&](T (&v)[K]) {
    T tot = v[0];
#pragma unroll
    for (int k = 1; k < K; ++k) tot = add(tot, v[k]);
    const T inv = tot > eps ? recip<T, FAST>(tot) : T(1);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = mul(v[k], inv);
  };
  convexify(tv);
  T w[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if constexpr (FAST)
      w[k] = mul(coef<T>(SLOT, L::IDL_OFF + k),
                 recip<T, true>(add(mul(tv[k], tv[k]), eps)));
    else
      w[k] = coef<T>(SLOT, L::IDL_OFF + k) / add(mul(tv[k], tv[k]), eps);
  convexify(w);
  if (cutoff > T(0)) {
#pragma unroll
    for (int k = 0; k < K - 1; ++k) w[k] = w[k] > cutoff ? w[k] : T(0);
    convexify(w);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int st = L::start(k), wd = L::width(k);
      const int o = L::edge_off(k) + e * wd;
      T ek = T(0);
#pragma unroll
      for (int i = 0; i < wd; ++i) ek = add(ek, mul(coef<T>(SLOT, o + i), s[st + i]));
      acc = add(acc, mul(w[k], ek));
    }
    if (e == 0) left = acc; else right = acc;
  }
}

// Layout of the reduced-operation table (ops/weno_fused.py::opt_coef_table):
// the low-order candidates' smoothness forms (width - 1 forms of width taps
// each; none at ord 5, which takes the Jiang-Shu form), the H = ORD / 2 even
// high-order forms (H pair coefficients, then the centre one) and the H odd
// ones, gamma (ord 3 and 5: the high-order edge as the exact combination of
// the low-order ones, 2 x (K - 1)), the edge forms of the candidates that
// keep one (the low-order ones when gamma is set, else all K), and the K
// ideal weights.
template <int ORD>
struct OptLimiter {
  using L = Limiter<ORD>;
  static constexpr int K = L::K, H = ORD / 2;
  static constexpr bool GAMMA = ORD <= 5;
  static constexpr int NEDGE = GAMMA ? K - 1 : K;
  __host__ __device__ static constexpr int low_off(int k) {
    return k == 0 ? 0
                  : low_off(k - 1) +
                        (ORD == 5 ? 0 : (L::width(k - 1) - 1) * L::width(k - 1));
  }
  static constexpr int EV_OFF = low_off(K - 1);
  static constexpr int OD_OFF = EV_OFF + H * (H + 1);
  static constexpr int GAMMA_OFF = OD_OFF + H * H;
  __host__ __device__ static constexpr int edge_off(int k) {
    return k == 0 ? GAMMA_OFF + (GAMMA ? 2 * (K - 1) : 0)
                  : edge_off(k - 1) + 2 * L::width(k - 1);
  }
  static constexpr int IDL_OFF = edge_off(NEDGE);
  static constexpr int SIZE = IDL_OFF + K;
  // the tap whose coefficient the table holds as 0 and the plain version
  // never adds (ops/weno_fused.py::opt_dropped): the middle tap of the
  // centred candidate's first form, (1, 0, -1)
  __host__ __device__ static constexpr bool dropped(int k, int m, int q) {
    return ORD >= 7 && k == 1 && m == 0 && q == 1;
  }
};
static_assert(OptLimiter<3>::SIZE == 22 && OptLimiter<5>::SIZE == 38 &&
                  OptLimiter<7>::SIZE == 75 && OptLimiter<9>::SIZE == 94,
              "opt table layout differs from ops/weno_fused.py");

// The floor of the opt weights' denominators (the Pallas kernels' tiny),
// the double constant cast to the type as the plain version's is.
template <typename T>
__device__ __forceinline__ T opt_tiny();
template <>
__device__ __forceinline__ float opt_tiny<float>() {
  return static_cast<float>(1e-35);
}
template <>
__device__ __forceinline__ double opt_tiny<double>() {
  return 1e-300;
}

// Limited left/right edge values of one cell in the reduced-operation
// algebra (pallas_recon.py::_weno_edges_block_opt): every linear form and
// sum starts from its first term and adds in the plain version's order.
template <int ORD, typename T, bool FAST>
__device__ __forceinline__ void weno_edges_opt(const T (&s)[ORD], T& left,
                                               T& right) {
  using L = Limiter<ORD>;
  using O = OptLimiter<ORD>;
  constexpr int K = L::K, H = O::H, SLOT = L::SLOT;
  T tv[K];
  // the high-order indicator on pair sums and differences
  T P[H], M[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    P[i] = add(s[i], s[ORD - 1 - i]);
    M[i] = sub(s[i], s[ORD - 1 - i]);
  }
  T th = T(0);
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const int o = O::EV_OFF + e * (H + 1);
    T f = mul(opt_coef<T>(SLOT, o + H), s[H]);
#pragma unroll
    for (int i = 0; i < H; ++i) f = add(f, mul(opt_coef<T>(SLOT, o + i), P[i]));
    th = e == 0 ? mul(f, f) : add(th, mul(f, f));
  }
#pragma unroll
  for (int d = 0; d < H; ++d) {
    const int o = O::OD_OFF + d * H;
    T f = mul(opt_coef<T>(SLOT, o), M[0]);
#pragma unroll
    for (int i = 1; i < H; ++i) f = add(f, mul(opt_coef<T>(SLOT, o + i), M[i]));
    th = add(th, mul(f, f));
  }
  tv[K - 1] = th;
  if constexpr (ORD == 5) {
    // Jiang-Shu: 13/12 d^2 + 1/4 f^2 on shared first differences
    const T e0 = sub(s[0], s[1]), e1 = sub(s[2], s[1]);
    const T e2 = sub(s[2], s[3]), e3 = sub(s[4], s[3]);
    const T d0 = add(e0, e1), d1 = add(e1, e2), d2 = add(e2, e3);
    const T m13 = sub(e2, e1);
    const T f0 = add(d0, mul(T(2), e1)), f2 = add(d2, mul(T(2), e2));
    const T c1312 = T(13.0 / 12.0), c14 = T(0.25);
    tv[0] = add(mul(c1312, mul(d0, d0)), mul(c14, mul(f0, f0)));
    tv[1] = add(mul(c1312, mul(d1, d1)), mul(c14, mul(m13, m13)));
    tv[2] = add(mul(c1312, mul(d2, d2)), mul(c14, mul(f2, f2)));
  } else {
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      const int st = L::start(k), w = L::width(k);
      T acc = T(0);
#pragma unroll
      for (int m = 0; m < w - 1; ++m) {
        const int o = O::low_off(k) + m * w;
        T f = T(0);
        bool started = false;
#pragma unroll
        for (int q = 0; q < w; ++q) {
          if (O::dropped(k, m, q)) continue;
          const T t = mul(opt_coef<T>(SLOT, o + q), s[st + q]);
          f = started ? add(f, t) : t;
          started = true;
        }
        acc = m == 0 ? mul(f, f) : add(acc, mul(f, f));
      }
      tv[k] = acc;
    }
  }
  // one normalisation: w_k = idl_k / (TV_k^2 + eps T^2 + tiny)
  T tsum = tv[0];
#pragma unroll
  for (int k = 1; k < K; ++k) tsum = add(tsum, tv[k]);
  const T tiny = opt_tiny<T>();
  const T e2 = add(mul(T(1e-20), mul(tsum, tsum)), tiny);
  T w[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    w[k] = mul(opt_coef<T>(SLOT, O::IDL_OFF + k),
               recip<T, FAST>(add(mul(tv[k], tv[k]), e2)));
  T tot = w[0];
#pragma unroll
  for (int k = 1; k < K; ++k) tot = add(tot, w[k]);
  const T inv = recip<T, FAST>(tot);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < O::NEDGE; ++k) {
      T cw;
      if constexpr (O::GAMMA)
        cw = mul(add(w[k], mul(opt_coef<T>(SLOT, O::GAMMA_OFF + e * (K - 1) + k),
                               w[K - 1])),
                 inv);
      else
        cw = mul(w[k], inv);
      const int st = L::start(k), wd = L::width(k);
      const int o = O::edge_off(k) + e * wd;
      T ek = mul(opt_coef<T>(SLOT, o), s[st]);
#pragma unroll
      for (int i = 1; i < wd; ++i) ek = add(ek, mul(opt_coef<T>(SLOT, o + i), s[st + i]));
      const T t = mul(cw, ek);
      acc = k == 0 ? t : add(acc, t);
    }
    if (e == 0) left = acc; else right = acc;
  }
}

// The limiter of the algebra ALG (the opt forms take no cutoff: the
// wrapper selects them only at cutoff 0, as _weno_edges does).
template <int ORD, typename T, int ALG>
__device__ __forceinline__ void edges(const T (&s)[ORD], T cutoff, T& left,
                                      T& right) {
  if constexpr (ref_table(ALG))
    weno_edges<ORD, T, ALG == ALG_REF_FAST>(s, cutoff, left, right);
  else
    weno_edges_opt<ORD, T, ALG == ALG_FAST>(s, left, right);
}

// One direction's view of the arrays: a value is
// base[v * vstride + plane * pstride + cell * astride + line * lstride];
// the tracer faces likewise with the t* strides (n + 1 faces per line), and
// the halo strips (hp cells per line) with the s* strides.
struct Geom {
  int64_t vstride, pstride, astride, lstride;
  int64_t tvstride, tpstride, tastride, tlstride;
  int n, nlines, ntr;
  int hps, has;  // background index: plane * hps + face * has
  int bc, nid;
};

// The halo-strip form's view: the strips (hp cells per line, at the s*
// strides) and each end's face mode (0 none, else bc).  The whole-axis
// kernels take the plain Geom, so that they compile as they did before the
// strip form existed (a runtime branch on the strip pointer, or a larger
// Geom, cost the whole-axis x kernel 4-8% through register allocation,
// PERF.md).
struct StripGeom : Geom {
  int64_t svstride, spstride, sastride, slstride;
  const void* lo;
  const void* hi;
  int hp, blo, bhi;
};

template <bool STRIPS>
using GeomOf = typename std::conditional<STRIPS, StripGeom, Geom>::type;

constexpr int XROWS = 4;  // rows (warps) per block of the x kernel

// Offset of the x kernel thread's row in the halo strips, from its block
// and thread indices (the grid is (x tiles, row blocks, planes)).
// Recomputed where a strip is read, so that no register holds it through
// the kernel.
__device__ __forceinline__ int64_t strip_row(const StripGeom& g) {
  return (int64_t)blockIdx.z * g.spstride +
         (int64_t)(blockIdx.y * XROWS + threadIdx.y) * g.slstride;
}

// Value of variable v at cell a (any integer) of the line at `line`, with
// the boundary rule for cells outside [0, n): in the halo-strip form
// (STRIPS) the strips' cells at the line's offset strip(g) (a cell further
// out than the strips feeds only results that are not written, and reads
// the outermost one), else the wrap or the edge copy.  STRIPS is a
// template parameter so that the whole-axis instantiations carry none of
// the strip form's code; `strip` is called only there.
template <bool STRIPS, typename T, typename StripLine>
__device__ __forceinline__ T load_bc(const T* __restrict__ line,
                                     const GeomOf<STRIPS>& g, StripLine strip,
                                     int v, int a) {
  if (a < 0 || a >= g.n) {
    if constexpr (STRIPS) {
      const T* s = static_cast<const T*>(a < 0 ? g.lo : g.hi) + strip(g);
      int k = a < 0 ? a + g.hp : a - g.n;
      k = k < 0 ? 0 : (k >= g.hp ? g.hp - 1 : k);
      return s[v * g.svstride + k * g.sastride];
    }
    if (g.bc == BC_PERIODIC) {
      a %= g.n;
      if (a < 0) a += g.n;
    } else {
      if (g.bc == BC_WALL && v == g.nid) return T(0);
      a = a < 0 ? 0 : g.n - 1;
    }
  }
  return line[v * g.vstride + a * g.astride];
}

// Upwind flux of one face from the limits on its two sides (the right
// edges `a` of the cell before it, the left edges `b` of the cell after):
// densitize with the hydrostatic background, overwrite at open/wall
// boundaries, and solve the acoustic/advective upwind Riemann problem.
// Keeps what the tracer faces need.
template <typename T>
struct Face {
  T F[NS];
  T rL, rR, ru_upw, r_upw;
  bool useL, lo, hi;
};

template <bool STRIPS, typename T>
__device__ __forceinline__ void riemann(const T (&a)[NS], const T (&b)[NS],
                                        T hr, T ht, int f,
                                        const GeomOf<STRIPS>& g, T C0,
                                        T gamma, Face<T>& o) {
  const T CS = T(350);
  const int nid = g.nid;
  o.rL = add(a[IDR], hr);
  o.rR = add(b[IDR], hr);
  T SL[NS], SR[NS];
  SL[IDR] = o.rL;
  SR[IDR] = o.rR;
#pragma unroll
  for (int v = IDU; v <= IDW; ++v) {
    SL[v] = mul(a[v], o.rL);
    SR[v] = mul(b[v], o.rR);
  }
  SL[IDT] = add(a[IDT], ht);
  SR[IDT] = add(b[IDT], ht);
  // The face overwrite, once per form: the strip form with each end's own
  // mode, the whole axis with bc at both ends.  One loop for both forms
  // (with the ends' modes, or only the wall test, found per form) compiled
  // every whole-axis kernel to other SASS than the loop of its own, with
  // local-memory spills in some x kernels (PERF.md), so the loop is kept
  // twice.
  if constexpr (STRIPS) {
    o.lo = g.blo != 0 && f == 0;
    o.hi = g.bhi != 0 && f == g.n;
    const bool wall = (o.lo && g.blo == BC_WALL) ||
                      (o.hi && g.bhi == BC_WALL);
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      if (o.lo) SL[v] = SR[v];
      if (o.hi) SR[v] = SL[v];
      if (wall && v == nid) {
        SL[v] = T(0);
        SR[v] = T(0);
      }
    }
  } else {
    o.lo = g.bc != BC_PERIODIC && f == 0;
    o.hi = g.bc != BC_PERIODIC && f == g.n;
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      if (o.lo) SL[v] = SR[v];
      if (o.hi) SR[v] = SL[v];
      if (g.bc == BC_WALL && (o.lo || o.hi) && v == nid) {
        SL[v] = T(0);
        SR[v] = T(0);
      }
    }
  }
  T ruL = T(0), ruR = T(0);
#pragma unroll
  for (int v = IDU; v <= IDW; ++v)
    if (v == nid) {
      ruL = SL[v];
      ruR = SR[v];
    }
  const T pL = mul(C0, tpow(SL[IDT], gamma));
  const T pR = mul(C0, tpow(SR[IDT], gamma));
  const T w1 = mul(T(0.5), sub(pR, mul(CS, ruR)));
  const T w2 = mul(T(0.5), add(pL, mul(CS, ruL)));
  const T p_upw = add(w1, w2);
  o.ru_upw = sub(w2, w1) / CS;
  o.useL = add(ruL, ruR) > T(0);
  o.r_upw = o.useL ? SL[IDR] : SR[IDR];
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    T fl = mul(o.ru_upw, o.useL ? SL[v] : SR[v]) / o.r_upw;
    if (v == IDR) fl = o.ru_upw;
    if (v == nid) fl = add(fl, p_upw);
    o.F[v] = fl;
  }
}

// A tracer's face value from the limits beside the face.
template <typename T>
__device__ __forceinline__ T tracer_face(const Face<T>& o, T left_cell_right,
                                         T right_cell_left) {
  T tL = mul(left_cell_right, o.rL);
  T tR = mul(right_cell_left, o.rR);
  if (o.lo) tL = tR;
  if (o.hi) tR = tL;
  return mul(o.ru_upw, o.useL ? tL : tR) / o.r_upw;
}

// -(F[f+1] - F[f]) * div_scale
template <typename T>
__device__ __forceinline__ T divergence(T fr, T fl, T ds) {
  return mul(-sub(fr, fl), ds);
}

// The stage update's operands: the step's base b0, the previous stage b1
// (null in stage 1), the hydrostatic cell density (index plane * cps + cell
// * cas) and the immersed proportion (null without), with the host's
// coefficients cast to the type.
template <typename T>
struct Stage {
  const T* b0;
  const T* b1;
  const T* hyc;
  const T* imm;
  T c0, c1, cdt, grav, fcor, fac;
  int flags, cps, cas;
};

// What the epilogue reads of one cell besides the divergence: its
// accumulator entries and, for the stage update, its bases b0 and b1.
template <typename T, int EPI>
struct EpiIn {
  T acc[NS];
  T b0[EPI == EPI_STAGE ? NS : 1], b1[EPI == EPI_STAGE ? NS : 1];
};

// Every read of the cell at `at` (its variable-0 offset), issued together
// before any of its writes: the compiler cannot move a read of the output
// buffer past a write to it, so reads interleaved with the writes would
// each wait out the memory latency in turn.
template <typename T, int EPI>
__device__ __forceinline__ void epi_load(EpiIn<T, EPI>& in,
                                         const T* __restrict__ sdiv,
                                         const Stage<T>& e, int64_t at,
                                         int64_t vs) {
#pragma unroll
  for (int v = 0; v < NS; ++v) in.acc[v] = sdiv[at + v * vs];
  if constexpr (EPI == EPI_STAGE) {
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      in.b0[v] = e.b0[at + v * vs];
      in.b1[v] = e.b1 != nullptr ? e.b1[at + v * vs] : T(0);
    }
  }
}

// The stage's state from the summed tendency t of the cell at `at` (plane
// p, cell c along the direction), in the order of
// ops/direction_fluxes.py::stage_update; s is the state the tendency was
// taken of (b1 when given, else b0).
template <typename T, int EPI>
__device__ __forceinline__ void stage_update(T (&t)[NS],
                                             const EpiIn<T, EPI>& in,
                                             const Stage<T>& e, int64_t at,
                                             int p, int c) {
  const bool has_b1 = e.b1 != nullptr;
  T s[NS];
#pragma unroll
  for (int v = 0; v < NS; ++v) s[v] = has_b1 ? in.b1[v] : in.b0[v];
  if (e.flags & ST_GRAV)
    t[IDW] = sub(t[IDW], mul(e.grav, add(s[IDR], e.hyc[p * e.cps + c * e.cas])));
  if (e.flags & ST_FCOR) {
    t[IDU] = add(t[IDU], mul(e.fcor, s[IDV]));
    t[IDV] = sub(t[IDV], mul(e.fcor, s[IDU]));
  }
  if (e.flags & ST_SIM2D) t[IDV] = T(0);
  if (e.imm != nullptr) {
    const T prop = e.imm[at];
    const T rest = sub(T(1), prop);
#pragma unroll
    for (int v = 0; v < NS; ++v)
      t[v] = add(mul(prop, mul(e.fac, s[v])), mul(rest, t[v]));
  }
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    T o = mul(e.c0, in.b0[v]);
    if (has_b1) o = add(o, mul(e.c1, in.b1[v]));
    t[v] = add(o, mul(e.cdt, t[v]));
  }
}

// ---------------------------------------------------------------- y and z
// A block of TW warps owns a tile of TL neighbouring lines (consecutive x
// positions) and one chunk [a0, a1) of cells along the direction, which it
// walks in steps of TG cells; step k covers cells c = a0 - 1 + k TG + i,
// i < TG, of every line (cell a0 - 1 only for its right edges, cell a1 only
// for face a1).  A step has three phases:
//  * stage: the block copies rows c - HS .. c + TG - 1 + HS of every
//    variable of its lines into shared memory, a row of a line per thread
//    with neighbouring threads on neighbouring lines, so each load of a warp
//    is contiguous (cells outside the axis by the boundary rule);
//  * solve: a warp takes 32 / TG lines, TG lanes along the direction on each,
//    as the x kernel's warp takes a row.  Lane i forms the edges of its cell
//    from ORD shared-memory reads, one variable at a time, takes its left
//    neighbour's right edges and face fluxes by shuffle (lane 0 takes those
//    of the step before's last lane through shared memory), solves face c,
//    and puts the divergence of cell c - 1 and the tracers' values on face
//    c into an output tile;
//  * store: the block writes the output tile back, a row of a line per
//    thread (coalesced), applying the epilogue there: a cell's accumulator
//    and stage bases are all read before any of its writes.
// A lane holds one variable's stencil at a time, so its registers do not
// grow with the variable count; each output cell is read and written by
// one thread, so `acc` is updated in place with no race.
constexpr int TW = 8;             // warps per block
constexpr int TG = 8;             // cells of a line per warp step
constexpr int TT = TW * WARP;     // threads per block
constexpr int TL = TT / TG;       // lines per tile
constexpr int TROWS = TT / TL;    // rows of the tile a pass of the block copies
static_assert(TG >= 8 && TG <= WARP && WARP % TG == 0, "lanes per line");

// The smallest row pitch >= w at which the lanes of a warp (TG cells on
// each of its 32 / TG lines, which lie TW lines apart) and the threads of a
// stage or store pass (TL neighbouring lines, 32 / TL rows) each fall on 32
// different banks: TW * pitch = TG (mod 2 TG).
__host__ __device__ constexpr int bank_pitch(int w) {
  return (TW * w) % (2 * TG) == TG ? w : bank_pitch(w + 1);
}

// The tile's shared-memory layout: per variable and line, R staged rows at
// a pitch RP, and TG output rows at a pitch OP.
template <int ORD>
struct Tile {
  static constexpr int HS = (ORD - 1) / 2;
  static constexpr int R = TG + 2 * HS;
  static constexpr int RP = bank_pitch(R);
  static constexpr int OP = bank_pitch(TG);
  static_assert(R <= 2 * TROWS, "a stage copies a line's rows in two passes");
};

// Bytes of dynamic shared memory of a block: the staged rows and the output
// rows of every variable, and two steps' carries (right edges of every
// variable, state fluxes) per line.
template <int ORD, typename T, int NTRB>
size_t tiled_smem(int ntr) {
  using TI = Tile<ORD>;
  return sizeof(T) * ((size_t)(NS + ntr) * TL * (TI::RP + TI::OP) +
                      2 * TL * (2 * NS + NTRB));
}

// Blocks per SM the registers must allow: in f32 4 (64 registers, 32
// warps), 3 (80) in the reference algebras, whose limiter spills at 64; 2
// (128 registers) in f64 (PERF.md).
template <typename T, int ALG>
constexpr int min_blocks_tiled() {
  return sizeof(T) == 8 ? 2 : ref_table(ALG) ? 3 : 4;
}

template <int ORD, typename T, int NTRB, bool STRIPS, int EPI, int ALG>
__global__ void __launch_bounds__(TT, min_blocks_tiled<T, ALG>())
fluxes_tiled(const T* __restrict__ prim, const T* __restrict__ hyr,
             const T* __restrict__ hyt, T* __restrict__ sdiv,
             T* __restrict__ tf, const GeomOf<STRIPS> g, const T C0,
             const T gamma, const T cutoff, const T ds, const Stage<T> st,
             const int chunk) {
  using TI = Tile<ORD>;
  constexpr int HS = TI::HS, R = TI::R, RP = TI::RP, OP = TI::OP;
  constexpr int CW = 2 * NS + NTRB;  // carry of a line: eR of each variable, F
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int ntr = g.ntr;
  T* const tin = reinterpret_cast<T*>(tile_smem);
  T* const tout = tin + (NS + ntr) * TL * RP;
  T* const carry = tout + (NS + ntr) * TL * OP;
  const int p = blockIdx.y, a0 = blockIdx.z * chunk;
  const int a1 = min(a0 + chunk, g.n);
  const int steps = (a1 - a0 + 2 + TG - 1) / TG;
  // stage and store: row tr of line tl
  const int tl = threadIdx.x % TL, tr = threadIdx.x / TL;
  const int l = blockIdx.x * TL + tl;
  const bool in_tile = l < g.nlines;
  const int64_t obase = p * g.pstride + (int64_t)l * g.lstride;
  const int64_t tbase = p * g.tpstride + (int64_t)l * g.tlstride;
  const T* const line = prim + obase;
  // solve: lane sl of the line ll
  const int lane = threadIdx.x % WARP;
  const int sl = lane % TG, ll = lane / TG * TW + threadIdx.x / WARP;
  const bool first = sl == 0, last = sl == TG - 1;

  // line l's offset in the halo strips
  const auto strip = [=](const auto& sg) {
    return (int64_t)p * sg.spstride + (int64_t)l * sg.slstride;
  };
  // rows r0 .. r0 + R - 1 of every variable of line tl, into tin
  auto stage = [&](int r0) {
    T* const to = tin + tl * RP;
    if (!in_tile) {
      for (int v = 0; v < NS + ntr; ++v) {
        to[v * TL * RP + tr] = T(0);
        if (tr + TROWS < R) to[v * TL * RP + tr + TROWS] = T(0);
      }
    } else if (r0 >= 0 && r0 + R <= g.n) {
      const T* from = line + (r0 + tr) * g.astride;
      const int64_t far = TROWS * g.astride;
#pragma unroll
      for (int v = 0; v < NS; ++v) {
        to[v * TL * RP + tr] = from[v * g.vstride];
        if (tr + TROWS < R)
          to[v * TL * RP + tr + TROWS] = from[v * g.vstride + far];
      }
#pragma unroll
      for (int q = 0; q < NTRB; ++q) {
        if (q < ntr) {
          const int v = NS + q;
          to[v * TL * RP + tr] = from[v * g.vstride];
          if (tr + TROWS < R)
            to[v * TL * RP + tr + TROWS] = from[v * g.vstride + far];
        }
      }
    } else {
      for (int v = 0; v < NS + ntr; ++v) {
        to[v * TL * RP + tr] = load_bc<STRIPS>(line, g, strip, v, r0 + tr);
        if (tr + TROWS < R)
          to[v * TL * RP + tr + TROWS] =
              load_bc<STRIPS>(line, g, strip, v, r0 + tr + TROWS);
      }
    }
  };

  // the edges, faces, divergences and tracer faces of step k's cells
  auto solve = [&](int k) {
    const int c = a0 - 1 + k * TG + sl;
    const T* const s_in = tin + ll * RP + sl;
    T* const s_out = tout + ll * OP + sl;
    const T* const crd = carry + ((k + 1) & 1) * TL * CW + ll * CW;
    T* const cwr = carry + (k & 1) * TL * CW + ll * CW;
    T eL[NS], eRl[NS];
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      T s[ORD], eR;
#pragma unroll
      for (int q = 0; q < ORD; ++q) s[q] = s_in[v * TL * RP + q];
      edges<ORD, T, ALG>(s, cutoff, eL[v], eR);
      const T up = __shfl_up_sync(FULL, eR, 1, TG);
      eRl[v] = first ? crd[v] : up;  // right edge of cell c - 1
      if (last) cwr[v] = eR;
    }
    // face c (cell a0 - 1's result and the lanes past a1 are not stored;
    // their profile index is clamped into the axis)
    const int h = p * g.hps + (c < 0 ? 0 : (c > g.n ? g.n : c)) * g.has;
    Face<T> o;
    riemann<STRIPS>(eRl, eL, hyr[h], hyt[h], c, g, C0, gamma, o);
#pragma unroll
    for (int v = 0; v < NS; ++v) {
      const T up = __shfl_up_sync(FULL, o.F[v], 1, TG);
      if (last) cwr[NS + v] = o.F[v];
      s_out[v * TL * OP] = divergence(o.F[v], first ? crd[NS + v] : up, ds);
    }
#pragma unroll
    for (int q = 0; q < NTRB; ++q) {
      if (q < ntr) {
        T s[ORD], left, right;
#pragma unroll
        for (int i = 0; i < ORD; ++i) s[i] = s_in[(NS + q) * TL * RP + i];
        edges<ORD, T, ALG>(s, cutoff, left, right);
        const T up = __shfl_up_sync(FULL, right, 1, TG);
        const T rl = first ? crd[2 * NS + q] : up;
        if (last) cwr[2 * NS + q] = right;
        s_out[(NS + q) * TL * OP] = tracer_face(o, rl, left);
      }
    }
  };

  // step k's output rows of line tl: the divergence of cell d (the
  // accumulator or the stage's state under the epilogue) and the tracer
  // faces of face d + 1 (each chunk writes its own faces, the last also
  // face n)
  auto store = [&](int k) {
    const int d = a0 - 2 + k * TG + tr;
    const T* const from = tout + tl * OP + tr;
    if (in_tile && d >= a0 && d < a1) {
      const int64_t at = obase + d * g.astride;
      if constexpr (EPI == EPI_NONE) {
#pragma unroll
        for (int v = 0; v < NS; ++v)
          sdiv[at + v * g.vstride] = from[v * TL * OP];
      } else {
        EpiIn<T, EPI> in;
        epi_load(in, sdiv, st, at, g.vstride);
        T t[NS];
#pragma unroll
        for (int v = 0; v < NS; ++v) t[v] = add(in.acc[v], from[v * TL * OP]);
        if constexpr (EPI == EPI_STAGE) stage_update(t, in, st, at, p, d);
#pragma unroll
        for (int v = 0; v < NS; ++v) sdiv[at + v * g.vstride] = t[v];
      }
    }
    const int f = d + 1;
    if (in_tile && f >= a0 && f <= a1 && (f < a1 || a1 == g.n)) {
      const int64_t at = tbase + f * g.tastride;
#pragma unroll
      for (int q = 0; q < NTRB; ++q)
        if (q < ntr) tf[at + q * g.tvstride] = from[(NS + q) * TL * OP];
    }
  };

  stage(a0 - 1 - HS);
  __syncthreads();
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    solve(k);
    __syncthreads();
    if (k + 1 < steps) stage(a0 - 1 + (k + 1) * TG - HS);
    store(k);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------- x
// A warp owns XT = 30 consecutive cells of one row; lane i forms the edges
// of cell x0 - 1 + i from a stencil gathered with warp shuffles out of two
// coalesced loads per variable, solves the face on its left (edges of the
// neighbour by shuffle), and writes the divergence of its cell (the next
// face's fluxes by shuffle).  Loads and stores of a warp are contiguous
// along the row, and no register or shared memory carries between steps.
constexpr int XT = WARP - 2;

// x: blocks of 4 warps per SM, 8 in f32 (64 registers), 3 in f64 (170).
template <typename T>
constexpr int min_blocks_x() { return sizeof(T) == 8 ? 3 : 8; }

template <int ORD, typename T, bool STRIPS>
__device__ __forceinline__ void row_stencil(const T* __restrict__ row,
                                            const GeomOf<STRIPS>& g, int v,
                                            int base, bool inside, int lane,
                                            T (&s)[ORD]) {
  constexpr int HS = (ORD - 1) / 2;
  const auto strip = [](const auto& sg) { return strip_row(sg); };
  const T A = inside ? row[v * g.vstride + base + lane]
                     : load_bc<STRIPS>(row, g, strip, v, base + lane);
  T B = T(0);
  if (lane < 2 * HS)
    B = inside ? row[v * g.vstride + base + WARP + lane]
               : load_bc<STRIPS>(row, g, strip, v, base + WARP + lane);
#pragma unroll
  for (int q = 0; q < ORD; ++q) {
    const T fa = __shfl_sync(FULL, A, (lane + q) & (WARP - 1));
    const T fb = __shfl_sync(FULL, B, (lane + q) & (WARP - 1));
    s[q] = lane + q < WARP ? fa : fb;
  }
}

template <int ORD, typename T, int NTRB, bool STRIPS, int ALG>
__global__ void __launch_bounds__(WARP * XROWS, min_blocks_x<T>())
fluxes_x(const T* __restrict__ prim, const T* __restrict__ hyr,
         const T* __restrict__ hyt, T* __restrict__ sdiv,
         T* __restrict__ tf, const GeomOf<STRIPS> g, const T C0,
         const T gamma, const T cutoff, const T ds) {
  constexpr int HS = (ORD - 1) / 2;
  const int lane = threadIdx.x;
  const int l = blockIdx.y * XROWS + threadIdx.y;
  if (l >= g.nlines) return;  // whole warps only
  const int p = blockIdx.z, x0 = blockIdx.x * XT;
  const int64_t rowoff = p * g.pstride + l * g.lstride;
  const int64_t trow = p * g.tpstride + l * g.tlstride;
  const T* row = prim + rowoff;
  const int base = x0 - 1 - HS;  // first cell of lane 0's stencil
  const bool inside = base >= 0 && base + WARP + 2 * HS <= g.n;
  const int c = x0 - 1 + lane;   // this lane's cell; face c is on its left
  const int h = p * g.hps;
  const T hr = hyr[h], ht = hyt[h];

  T eL[NS], eRl[NS];
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    T s[ORD], eR;
    row_stencil<ORD, T, STRIPS>(row, g, v, base, inside, lane, s);
    edges<ORD, T, ALG>(s, cutoff, eL[v], eR);
    eRl[v] = __shfl_up_sync(FULL, eR, 1);  // right edge of cell c-1
  }
  Face<T> o;
  riemann<STRIPS>(eRl, eL, hr, ht, c, g, C0, gamma, o);  // lane 0's unused
  const bool own = lane >= 1 && lane <= XT && c < g.n;
#pragma unroll
  for (int v = 0; v < NS; ++v) {
    const T fr = __shfl_down_sync(FULL, o.F[v], 1);
    if (own) sdiv[rowoff + v * g.vstride + c] = divergence(fr, o.F[v], ds);
  }
  const bool wface = lane >= 1 && ((lane <= XT && c < g.n) || c == g.n);
#pragma unroll
  for (int q = 0; q < NTRB; ++q) {
    if (q < g.ntr) {
      T s[ORD], left, right;
      row_stencil<ORD, T, STRIPS>(row, g, NS + q, base, inside, lane, s);
      edges<ORD, T, ALG>(s, cutoff, left, right);
      const T rl = __shfl_up_sync(FULL, right, 1);
      if (wface) tf[trow + q * g.tvstride + c] = tracer_face(o, rl, left);
    }
  }
}

// The y/z kernel in its epilogue form: the stage update when it has a
// base b0, else the accumulator when `accumulate`, else the bare form.
template <int ORD, typename T, int NTRB, bool STRIPS, int EPI, int ALG>
void launch_tiled_form(const dim3& grid, size_t smem, cudaStream_t s,
                       const T* prim, const T* hyr, const T* hyt, T* sdiv,
                       T* tf, const GeomOf<STRIPS>& g, T C0, T gamma,
                       T cutoff, T ds, const Stage<T>& st, int chunk) {
  auto kernel = fluxes_tiled<ORD, T, NTRB, STRIPS, EPI, ALG>;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return;  // the error stays for cudaGetLastError
  kernel<<<grid, TT, smem, s>>>(prim, hyr, hyt, sdiv, tf, g, C0, gamma, cutoff,
                                ds, st, chunk);
}

template <int ORD, typename T, int NTRB, bool STRIPS, int ALG>
void launch_kind(int axis, int planes, int chunk, cudaStream_t s,
                 const T* prim, const T* hyr, const T* hyt, T* sdiv, T* tf,
                 const GeomOf<STRIPS>& g, T C0, T gamma, T cutoff, T ds,
                 bool accumulate, const Stage<T>& st) {
  if (axis == 0) {
    const dim3 grid((g.n + XT - 1) / XT, (g.nlines + XROWS - 1) / XROWS,
                    planes);
    fluxes_x<ORD, T, NTRB, STRIPS, ALG><<<grid, dim3(WARP, XROWS), 0, s>>>(
        prim, hyr, hyt, sdiv, tf, g, C0, gamma, cutoff, ds);
    return;
  }
  const dim3 grid((g.nlines + TL - 1) / TL, planes, (g.n + chunk - 1) / chunk);
  const size_t smem = tiled_smem<ORD, T, NTRB>(g.ntr);
  if (st.b0 != nullptr)
    launch_tiled_form<ORD, T, NTRB, STRIPS, EPI_STAGE, ALG>(
        grid, smem, s, prim, hyr, hyt, sdiv, tf, g, C0, gamma, cutoff, ds, st,
        chunk);
  else if (accumulate)
    launch_tiled_form<ORD, T, NTRB, STRIPS, EPI_ACC, ALG>(
        grid, smem, s, prim, hyr, hyt, sdiv, tf, g, C0, gamma, cutoff, ds, st,
        chunk);
  else
    launch_tiled_form<ORD, T, NTRB, STRIPS, EPI_NONE, ALG>(
        grid, smem, s, prim, hyr, hyt, sdiv, tf, g, C0, gamma, cutoff, ds, st,
        chunk);
}

template <int ORD, typename T, int NTRB, int ALG>
cudaError_t launch_ntr(int axis, int planes, int chunk, cudaStream_t s,
                       const T* prim, const T* hyr, const T* hyt, T* sdiv,
                       T* tf, const StripGeom& g, T C0, T gamma, T cutoff,
                       T ds, bool accumulate, const Stage<T>& st) {
  if (g.lo != nullptr)
    launch_kind<ORD, T, NTRB, true, ALG>(axis, planes, chunk, s, prim, hyr,
                                         hyt, sdiv, tf, g, C0, gamma, cutoff,
                                         ds, accumulate, st);
  else
    launch_kind<ORD, T, NTRB, false, ALG>(
        axis, planes, chunk, s, prim, hyr, hyt, sdiv, tf,
        static_cast<const Geom&>(g), C0, gamma, cutoff, ds, accumulate, st);
  return cudaGetLastError();
}

template <int ORD, typename T, int ALG>
cudaError_t launch_ord(int axis, int planes, int chunk, cudaStream_t s,
                       const T* prim, const T* hyr, const T* hyt, T* sdiv,
                       T* tf, const StripGeom& g, T C0, T gamma, T cutoff,
                       T ds, bool accumulate, const Stage<T>& st) {
  if (g.ntr <= 1)
    return launch_ntr<ORD, T, 1, ALG>(axis, planes, chunk, s, prim, hyr, hyt,
                                      sdiv, tf, g, C0, gamma, cutoff, ds,
                                      accumulate, st);
  if (g.ntr <= 3)
    return launch_ntr<ORD, T, 3, ALG>(axis, planes, chunk, s, prim, hyr, hyt,
                                      sdiv, tf, g, C0, gamma, cutoff, ds,
                                      accumulate, st);
  return launch_ntr<ORD, T, NTR_MAX, ALG>(axis, planes, chunk, s, prim, hyr,
                                          hyt, sdiv, tf, g, C0, gamma, cutoff,
                                          ds, accumulate, st);
}

// axis 0 = x, 1 = y, 2 = z on (nvar, nens, nz, ny, nx) arrays
// lo / hi: the halo strips (hp = (ord-1)/2 + 1 cells along the axis, else
// shaped like prim), or both null for the whole axis; bc_lo / bc_hi: the face
// mode of each end (0 none, else bc).
// accumulate: sdiv holds the running state tendency, which the divergence
// is added to (y and z only).  b0 (with accumulate): the stage update, with
// b1 (or null), the (nens, nz) hydrostatic cell density hyc, the immersed
// proportion imm (nens, nz, ny, nx, or null), the ST_* flags and the
// coefficients; its result replaces the tendency in sdiv.
template <typename T, int ALG>
int launch(const void* prim, const void* hyr, const void* hyt, void* sdiv,
           void* tf, const void* lo, const void* hi, int axis, int nvar,
           int nens, int nz, int ny, int nx, int bc, int bc_lo, int bc_hi,
           int normal_id, int ord, double C0, double gamma, double cutoff,
           double div_scale, int accumulate, const void* b0, const void* b1,
           const void* hyc, const void* imm, int flags, double c0, double c1,
           double cdt, double grav, double fcor, double fac, void* stream) {
  const int ntr = nvar - NS;
  if (ntr < 0 || ntr > NTR_MAX || axis < 0 || axis > 2 || nens < 1 ||
      nz < 1 || ny < 1 || nx < 1 || (lo == nullptr) != (hi == nullptr) ||
      (lo != nullptr && axis == 2) || (bc_lo != 0 && bc_lo != bc) ||
      (bc_hi != 0 && bc_hi != bc) || (accumulate && axis == 0) ||
      (b0 != nullptr && (!accumulate || hyc == nullptr)) ||
      (b0 == nullptr && (b1 != nullptr || imm != nullptr)) ||
      (!ref_table(ALG) && cutoff != 0.0))
    return cudaErrorInvalidValue;
  const int64_t cells = (int64_t)nens * nz * ny * nx;
  const int hp = (ord - 1) / 2 + 1;
  StripGeom g{};
  g.vstride = cells;
  g.ntr = ntr;
  g.bc = bc;
  g.nid = normal_id;
  g.lo = lo;
  g.hi = hi;
  g.hp = hp;
  g.blo = bc_lo;
  g.bhi = bc_hi;
  Stage<T> st{static_cast<const T*>(b0), static_cast<const T*>(b1),
              static_cast<const T*>(hyc), static_cast<const T*>(imm),
              (T)c0, (T)c1, (T)cdt, (T)grav, (T)fcor, (T)fac, flags,
              axis == 2 ? nz : 1, axis == 2 ? 1 : 0};
  int planes;
  if (axis == 0) {
    planes = nens * nz;
    g.n = nx, g.nlines = ny;
    g.pstride = (int64_t)ny * nx, g.astride = 1, g.lstride = nx;
    g.tpstride = (int64_t)ny * (nx + 1), g.tastride = 1, g.tlstride = nx + 1;
    g.spstride = (int64_t)ny * hp, g.sastride = 1, g.slstride = hp;
    g.hps = 1, g.has = 0;
  } else if (axis == 1) {
    planes = nens * nz;
    g.n = ny, g.nlines = nx;
    g.pstride = (int64_t)ny * nx, g.astride = nx, g.lstride = 1;
    g.tpstride = (int64_t)(ny + 1) * nx, g.tastride = nx, g.tlstride = 1;
    g.spstride = (int64_t)hp * nx, g.sastride = nx, g.slstride = 1;
    g.hps = 1, g.has = 0;
  } else {
    planes = nens;
    g.n = nz, g.nlines = ny * nx;
    g.pstride = (int64_t)nz * ny * nx, g.astride = (int64_t)ny * nx;
    g.lstride = 1;
    g.tpstride = (int64_t)(nz + 1) * ny * nx, g.tastride = (int64_t)ny * nx;
    g.tlstride = 1;
    g.hps = nz + 1, g.has = 1;
  }
  g.tvstride = g.tpstride * planes;
  g.svstride = g.spstride * planes;
  // y/z: the whole axis is one chunk, unless the grid would hold fewer
  // than 512 blocks; then it halves the chunks while they stay >= 64 cells
  const int64_t ltiles = ((int64_t)g.nlines + TL - 1) / TL;
  int chunk = g.n;
  while (ltiles * planes * ((g.n + chunk - 1) / chunk) < 512 && chunk >= 128)
    chunk = (chunk + 1) / 2;
  const bool fits = axis == 0 ? (g.nlines + XROWS - 1) / XROWS <= 65535
                              : ltiles <= 2147483647LL &&
                                    (g.n + chunk - 1) / chunk <= 65535;
  if (!fits || planes > 65535) return cudaErrorInvalidConfiguration;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const T*>(prim);
  auto hr = static_cast<const T*>(hyr);
  auto ht = static_cast<const T*>(hyt);
  auto sd = static_cast<T*>(sdiv);
  auto tfp = static_cast<T*>(tf);
  const T pc0 = (T)C0, ga = (T)gamma, co = (T)cutoff, ds = (T)div_scale;
  const bool acc = accumulate != 0;
  switch (ord) {
    case 3: return launch_ord<3, T, ALG>(axis, planes, chunk, s, p, hr, ht, sd, tfp, g, pc0, ga, co, ds, acc, st);
    case 5: return launch_ord<5, T, ALG>(axis, planes, chunk, s, p, hr, ht, sd, tfp, g, pc0, ga, co, ds, acc, st);
    case 7: return launch_ord<7, T, ALG>(axis, planes, chunk, s, p, hr, ht, sd, tfp, g, pc0, ga, co, ds, acc, st);
    case 9: return launch_ord<9, T, ALG>(axis, planes, chunk, s, p, hr, ht, sd, tfp, g, pc0, ga, co, ds, acc, st);
    default: return cudaErrorInvalidValue;
  }
}

// Copy the limiter table of one order (the float64 values of
// weno_coef_table for ALG_REF, of opt_coef_table otherwise) into the
// constant memory of the current device, as f64 and cast to f32.  The opt
// table must have exactly the layout's size.
template <int ALG>
int set_coef(int ord, const double* table, int n) {
  if (ord != 3 && ord != 5 && ord != 7 && ord != 9) return cudaErrorInvalidValue;
  const int opt_size[4] = {OptLimiter<3>::SIZE, OptLimiter<5>::SIZE,
                           OptLimiter<7>::SIZE, OptLimiter<9>::SIZE};
  const int slot = (ord - 3) / 2;
  if (n < 1 || n > COEF_MAX || (!ref_table(ALG) && n != opt_size[slot]))
    return cudaErrorInvalidValue;
  float f[COEF_MAX];
  for (int i = 0; i < n; ++i) f[i] = (float)table[i];
  cudaError_t err =
      ref_table(ALG)
          ? cudaMemcpyToSymbol(c_coef_f64, table, n * sizeof(double),
                               slot * COEF_MAX * sizeof(double))
          : cudaMemcpyToSymbol(c_opt_f64, table, n * sizeof(double),
                               slot * COEF_MAX * sizeof(double));
  if (err != cudaSuccess) return err;
  return ref_table(ALG)
             ? cudaMemcpyToSymbol(c_coef_f32, f, n * sizeof(float),
                                  slot * COEF_MAX * sizeof(float))
             : cudaMemcpyToSymbol(c_opt_f32, f, n * sizeof(float),
                                  slot * COEF_MAX * sizeof(float));
}

}  // namespace

// One extern "C" entry point, NAME, launching the kernels of type T in the
// algebra ALG (the 35 parameters that ops/direction_fluxes.py::_bind
// declares).
#define DIRECTION_FLUXES_ENTRY(NAME, T, ALG)                                  \
  int NAME(const void* prim, const void* hyr, const void* hyt, void* sdiv,    \
           void* tf, const void* lo, const void* hi, int axis, int nvar,      \
           int nens, int nz, int ny, int nx, int bc, int bc_lo, int bc_hi,    \
           int normal_id, int ord, double C0, double gamma, double cutoff,    \
           double div_scale, int accumulate, const void* b0, const void* b1,  \
           const void* hyc, const void* imm, int flags, double c0, double c1, \
           double cdt, double grav, double fcor, double fac, void* stream) {  \
    return launch<T, ALG>(prim, hyr, hyt, sdiv, tf, lo, hi, axis, nvar,       \
                          nens, nz, ny, nx, bc, bc_lo, bc_hi, normal_id, ord, \
                          C0, gamma, cutoff, div_scale, accumulate, b0, b1,   \
                          hyc, imm, flags, c0, c1, cdt, grav, fcor, fac,      \
                          stream);                                            \
  }
