"""Time designs of the flux kernel's y/z form against each other.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/flux_strided_variants.py [--parent DIR] [--reps N]
                                          [--designs a,b,...]

Each design is the package's ``csrc/direction_fluxes.cu`` (the reference
algebra) and ``csrc/direction_fluxes_opt.cu`` (the reduced-operation
algebra: exact in f32 and f64, approximate reciprocals in f32), each with a
``direction_fluxes.cuh`` inlined, built for WENO order 5 only (to keep the
builds short) with the package's nvcc flags into
``chip_smoke_out/flux_strided_variants/`` (git-ignored):

  march      the header of the tree at ``--parent`` (a ``git archive`` of a
             commit before ``fluxes_tiled``): a thread per line, marching
             through 64-cell segments with an ord-wide register window of
             every variable; left out without ``--parent``;
  split      the march with a line's variables split over 2 threads (up to
             3 tracers) or 4 (9 tracers), the state edges shared by
             shuffle (SPLIT_MARCH); left out without ``--parent``;
  tiled      the package's ``fluxes_tiled`` (8 warps a block, 8 cells of a
             line per warp step; 4 blocks an SM in f32, 3 in its reference
             algebras, 2 in f64);
  tiled_g16  16 cells of a line per warp step (TG);
  tiled_ref4 4 blocks an SM (64 registers) in the f32 reference algebras;
  tiled_b3   3 blocks an SM (80 registers) in every f32 algebra;
  tiled_f64b1  1 block an SM in f64.

It prints each design's registers and spill bytes of its ord-5 y/z
instantiations (the ptxas report), then times in turns (the designs in
order, then backwards; CUDA events, each call queued behind device sleep,
the median of ``--reps``):

  * the benchmark's grid, the 1024x1024x100 f32 supercell, in the fast
    and in the reference algebra: z accumulating and y with the stage
    update (b1), at 8 variables and at 14 (the state's tracers repeated);
  * the city, 400x400x60x2 f32 at 6 variables, fast algebra: z accumulating
    and y with the stage update and its immersed blend;
  * the 512x512x64 f64 supercell at 8 variables, opt and reference
    algebras: z accumulating and y with the stage update;
  * the halo-strip form: shard (0, 0) of the 512x512x64 f32 state split
    2x2, y with the stage update, fast algebra.

Every design's outputs (the state's and the tracer faces) equal the first
design's bit for bit on every case; the f64 outputs also equal the plain
version's.  The last line, prefixed ``RESULT ``, is JSON with the card's
name and power limit, the build seconds, the ptxas rows and the times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# the libraries each design builds: the reference algebra's, and the
# reduced-operation one's with exact and approximate reciprocals
LIBS = ("direction_fluxes", "direction_fluxes_opt")


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/direction_fluxes.cuh no longer holds the "
                           f"text this script edits:\n{old}")
    return src.replace(old, new)


def _source(root: str, lib: str) -> str:
    """``csrc/<lib>.cu`` of the tree at ``root`` with its header inlined,
    for order 5 only."""
    csrc = os.path.join(root, "miniweatherml_tpu_torch", "csrc")
    with open(os.path.join(csrc, lib + ".cu")) as f:
        src = f.read()
    with open(os.path.join(csrc, "direction_fluxes.cuh")) as f:
        src = _replace(src, '#include "direction_fluxes.cuh"\n',
                       f.read().replace("#pragma once\n", ""))
    src, n = re.subn(r"\n *case [379]: return launch_ord<[379],[^\n]*", "",
                     src)
    if n != 3:
        raise RuntimeError(f"{root}: the order switch has changed")
    return src


def designs(package: str, parent: str | None) -> dict[str, str]:
    """The sources of every design, from one library's source."""
    out = {} if parent is None else {"march": parent,
                                     "split": split_march(parent)}
    out["tiled"] = package
    out["tiled_g16"] = _replace(package, "constexpr int TG = 8;",
                                "constexpr int TG = 16;")
    blocks = "return sizeof(T) == 8 ? 2 : ref_table(ALG) ? 3 : 4;"
    out["tiled_ref4"] = _replace(package, blocks,
                                 "return sizeof(T) == 8 ? 2 : 4;")
    out["tiled_b3"] = _replace(package, blocks,
                               "return sizeof(T) == 8 ? 2 : 3;")
    out["tiled_f64b1"] = _replace(
        package, blocks, "return sizeof(T) == 8 ? 1 : ref_table(ALG) ? 3 : 4;")
    return out


# The second design: the march with a line's variables split over K
# threads (K = 2 up to 3 tracers, 4 at 9): thread q of a line marches the
# variables v = j K + q with their register windows, the state edges go to
# every thread of the line by shuffle, each solves the face (the same
# arithmetic in each), and each writes its own variables' divergences (the
# stage update's other operands read from the bases) and tracer faces.
SPLIT_MARCH = r"""// ---------------------------------------------------------------- y and z
template <int NTRB>
__host__ __device__ constexpr int split_k() { return NTRB >= 9 ? 4 : 2; }
template <int NTRB>
__host__ __device__ constexpr int split_lines() {
  return WARP / split_k<NTRB>();
}
constexpr unsigned SPLIT_FULL = 0xffffffffu;

template <bool STRIPS, typename T>
__device__ __forceinline__ T split_load(const T* __restrict__ line,
                                        const GeomOf<STRIPS>& g, int p, int l,
                                        int v, int a) {
  if (a < 0 || a >= g.n) {
    if constexpr (STRIPS) {
      const T* s = static_cast<const T*>(a < 0 ? g.lo : g.hi) +
                   (int64_t)p * g.spstride + (int64_t)l * g.slstride;
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

template <typename T>
constexpr int min_blocks_strided() { return sizeof(T) == 8 ? 8 : 24; }

template <int ORD, typename T, int NTRB, bool STRIPS, int EPI, int ALG>
__global__ void __launch_bounds__(WARP, min_blocks_strided<T>())
fluxes_strided(const T* __restrict__ prim, const T* __restrict__ hyr,
               const T* __restrict__ hyt, T* __restrict__ sdiv,
               T* __restrict__ tf, const GeomOf<STRIPS> g, const T C0,
               const T gamma, const T cutoff, const T ds, const Stage<T> st) {
  constexpr int K = split_k<NTRB>(), NV = NS + NTRB, NL = (NV + K - 1) / K;
  constexpr int HS = (ORD - 1) / 2;
  const int q = threadIdx.x % K, gb = threadIdx.x - q;
  const int lraw = blockIdx.x * (WARP / K) + threadIdx.x / K;
  const bool live = lraw < g.nlines;
  const int l = live ? lraw : g.nlines - 1;
  const int p = blockIdx.y, a0 = blockIdx.z * SEG;
  const int a1 = min(a0 + SEG, g.n);
  const int64_t obase = p * g.pstride + (int64_t)l * g.lstride;
  const int64_t tbase = p * g.tpstride + (int64_t)l * g.tlstride;
  const T* const line = prim + obase;
  const int nv = NS + g.ntr;
  T w[NL][ORD], eR[NL], pre[NL], Fp[NS];
#pragma unroll 1
  for (int c = a0 - 1; c <= a1; ++c) {
    const bool first = c < a0;
    T eLl[NL], eRc[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int v = j * K + q;
      const bool have = v < nv;
      if (first) {
#pragma unroll
        for (int i = 0; i < ORD; ++i)
          w[j][i] =
              have ? split_load<STRIPS>(line, g, p, l, v, c - HS + i) : T(0);
      } else {
#pragma unroll
        for (int i = 0; i < ORD - 1; ++i) w[j][i] = w[j][i + 1];
        w[j][ORD - 1] = pre[j];
      }
      pre[j] = have ? split_load<STRIPS>(line, g, p, l, v, c + 1 + HS) : T(0);
      edges<ORD, T, ALG>(w[j], cutoff, eLl[j], eRc[j]);
    }
    Face<T> o;
    if (!first) {
      T eL[NS], eRs[NS];
#pragma unroll
      for (int v = 0; v < NS; ++v) {
        eL[v] = __shfl_sync(SPLIT_FULL, eLl[v / K], gb + v % K);
        eRs[v] = __shfl_sync(SPLIT_FULL, eR[v / K], gb + v % K);
      }
      const int h = p * g.hps + c * g.has;
      riemann<STRIPS>(eRs, eL, hyr[h], hyt[h], c, g, C0, gamma, o);
      if (c > a0 && live) {
        const int64_t at = obase + (int64_t)(c - 1) * g.astride;
        const int64_t vs = g.vstride;
        if constexpr (EPI == EPI_NONE) {
#pragma unroll
          for (int v = 0; v < NS; ++v)
            if (v % K == q) sdiv[at + v * vs] = divergence(o.F[v], Fp[v], ds);
        } else {
          EpiIn<T, EPI> in;
#pragma unroll
          for (int v = 0; v < NS; ++v) {
            in.acc[v] = v % K == q ? sdiv[at + v * vs] : T(0);
            if constexpr (EPI == EPI_STAGE) {
              in.b0[v] = st.b0[at + v * vs];
              in.b1[v] = st.b1 != nullptr ? st.b1[at + v * vs] : T(0);
            }
          }
          T t[NS];
#pragma unroll
          for (int v = 0; v < NS; ++v)
            t[v] = add(in.acc[v], divergence(o.F[v], Fp[v], ds));
          if constexpr (EPI == EPI_STAGE) stage_update(t, in, st, at, p, c - 1);
#pragma unroll
          for (int v = 0; v < NS; ++v)
            if (v % K == q) sdiv[at + v * vs] = t[v];
        }
      }
#pragma unroll
      for (int v = 0; v < NS; ++v) Fp[v] = o.F[v];
    }
    const bool wface = !first && live && (c < a1 || c == g.n);
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int v = j * K + q;
      if (wface && v >= NS && v < nv)
        tf[tbase + (v - NS) * g.tvstride + (int64_t)c * g.tastride] =
            tracer_face(o, eR[j], eLl[j]);
      eR[j] = eRc[j];
    }
  }
}

"""


def split_march(src: str) -> str:
    """``src`` (a tree's flux source before ``fluxes_tiled``) with its y/z
    march replaced by SPLIT_MARCH."""
    a = src.index("// ---------------------------------------------------"
                  "------------- y and z\n")
    b = src.index("// ---------------------------------------------------"
                  "------------------- x\n")
    src = src[:a] + SPLIT_MARCH + src[b:]
    return _replace(
        src, "const dim3 grid((g.nlines + WARP - 1) / WARP, planes,",
        "const dim3 grid((g.nlines + split_lines<NTRB>() - 1) / "
        "split_lines<NTRB>(), planes,")


def _ptxas_rows(path: str):
    """(kernel, type, tracer bound, strips, epilogue, algebra, registers,
    spill store bytes, spill load bytes) of each flux entry function in a
    ptxas report."""
    rows, cur, frame = [], None, (0, 0)
    with open(path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                frame = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if m and cur:
                k = re.search(r"(fluxes_[a-z]+)ILi5E([fd])Li(\d+)ELb([01])E"
                              r"(?:Li(\d)E)?Li(\d)E", cur)
                if k:
                    rows.append((k.group(1), "f32" if k.group(2) == "f"
                                 else "f64", int(k.group(3)),
                                 k.group(4) == "1", k.group(5), k.group(6),
                                 int(m.group(1)), *frame))
                cur, frame = None, (0, 0)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--designs", default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flux_strided_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import miniweatherml_tpu_torch.ops.direction_fluxes as df
    from miniweatherml_tpu_torch import cuda_build
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    if not df.__file__.startswith(root):
        raise RuntimeError(f"imported {df.__file__}, not the tree at {root}")

    srcs = {lib: designs(_source(root, lib), None if a.parent is None
                         else _source(a.parent, lib)) for lib in LIBS}
    names = list(srcs["direction_fluxes"])
    if a.designs:
        names = a.designs.split(",")
    out_dir = os.path.join(root, "chip_smoke_out", "flux_strided_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(name, lib) for name in names for lib in LIBS]

    def build_lib(job):
        name, lib = job
        cu = os.path.join(out_dir, f"{name}_{lib}.cu")
        with open(cu, "w") as f:
            f.write(srcs[lib][name])
        t0 = time.perf_counter()
        r = subprocess.run([cuda_build._nvcc(), *cuda_build.nvcc_flags(lib),
                            "-o", os.path.join(out_dir, f"{name}_{lib}.so"),
                            cu], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{r.stderr}")
        with open(os.path.join(out_dir, f"{name}_{lib}.ptxas.txt"), "w") as f:
            f.write(r.stderr)
        return time.perf_counter() - t0
    with ThreadPoolExecutor(len(jobs)) as pool:
        secs = {f"{n} {lib}": s for (n, lib), s in
                zip(jobs, pool.map(build_lib, jobs))}
    print(f"builds (s): {secs}", flush=True)
    ptxas = {}
    for name, lib in jobs:
        rows = _ptxas_rows(os.path.join(out_dir, f"{name}_{lib}.ptxas.txt"))
        ptxas[f"{name} {lib}"] = rows
        for kern, t, ntrb, strips, epi, alg, regs, st, ld in rows:
            if kern == "fluxes_x" or (alg == "1" and t == "f32"):
                continue  # the y/z kernel in the forms the paths run
            print(f"{name} {kern} {t} tracers <= {ntrb}"
                  f"{' strips' if strips else ''} epilogue {epi} algebra "
                  f"{cs.FLUX_ALGEBRAS[alg]}: {regs} registers, {st} B spill "
                  f"stores, {ld} B spill loads", flush=True)

    def use(name):
        """The flux wrappers on design ``name``'s builds inside the block
        (each build's first launch on the card copies the tables)."""
        stack = contextlib.ExitStack()
        for lib in LIBS:
            stack.enter_context(df.LIBRARIES[lib].use(
                os.path.join(out_dir, f"{name}_{lib}.so")))
        return stack

    card = cs._card()
    cases = []  # (tag, args, acc, rk, kw)

    def supercell(nx, ny, nz, dtype, kws, tracers=(8,)):
        state, _, dycore = build(cs._bench_cfg(nx, ny, nz, 1, dtype), "cuda")
        prim = cs._prim(state, dycore)
        g, c = state.grid, dycore._consts(state)
        hy = dycore._hy(state)
        b0, b1 = cs._stage_bases(state, dycore)
        dt = dycore.compute_time_step(state)
        rk = cs._stage(state, dycore, b0, b1, dt)
        acc = torch.randn((5,) + tuple(prim.shape[1:]), dtype=prim.dtype,
                          device=prim.device)
        for nv in tracers:
            p = prim if nv == 8 else torch.cat(
                [prim] + [prim[5:]] * ((nv - 5) // 3 - 1)).contiguous()
            for kw in kws:
                tag = (f"{nx}x{ny}x{nz} {dtype} nvar {nv} "
                       f"{'opt' if kw.get('opt') else 'ref'}"
                       f"{' fast' if kw.get('fast_weights') else ''}")
                cases.append((f"{tag} z accumulating",
                              (p, -3, g.nz, c.bc_z, 3, c.C0, c.gamma, hy[2],
                               hy[3], dycore.mats, 0.0, 1.0 / g.dz), acc,
                              None, kw))
                cases.append((f"{tag} y stage update", (
                    p, -2, g.ny, c.bc_y, 2, c.C0, c.gamma, hy[0], hy[1],
                    dycore.mats, 0.0, 1.0 / g.dy), acc, rk, kw))
        return state, prim, dycore, b0, b1, dt

    fast = {"opt": True, "fast_weights": True}
    supercell(1024, 1024, 100, "float32", (fast, {}), tracers=(8, 14))
    state, _, dycore = cs._flux_state("city", "float32")
    prim = cs._prim(state, dycore)
    g, c = state.grid, dycore._consts(state)
    hy = dycore._hy(state)
    b0, b1 = cs._stage_bases(state, dycore)
    dt = dycore.compute_time_step(state)
    acc = torch.randn((5,) + tuple(prim.shape[1:]), dtype=prim.dtype,
                      device=prim.device)
    tag = f"city {g.nx}x{g.ny}x{g.nz}x{g.nens} float32 nvar {prim.shape[0]}"
    cases.append((f"{tag} z accumulating", (
        prim, -3, g.nz, c.bc_z, 3, c.C0, c.gamma, hy[2], hy[3], dycore.mats,
        0.0, 1.0 / g.dz), acc, None, fast))
    cases.append((f"{tag} y stage update", (
        prim, -2, g.ny, c.bc_y, 2, c.C0, c.gamma, hy[0], hy[1], dycore.mats,
        0.0, 1.0 / g.dy), acc, cs._stage(state, dycore, b0, b1, dt), fast))
    del state
    supercell(512, 512, 64, "float64", ({"opt": True}, {}))
    # the strip form: y of shard (0, 0) of the 512x512x64 f32 state split
    # 2x2, with the stage update into the shard's cells
    state, prim, dycore, b0, b1, dt = supercell(512, 512, 64, "float32",
                                                (fast,), tracers=())
    g, c = state.grid, dycore._consts(state)
    hy = dycore._hy(state)
    block, strips = cs._shard_case(prim.narrow(-1, 0, g.nx // 2).contiguous(),
                                   -2, c.bc_y, 2, 0)

    def cut(t):
        return t.narrow(-1, 0, g.nx // 2).narrow(-2, 0, g.ny // 2)
    acc = torch.randn((5,) + tuple(block.shape[1:]), dtype=block.dtype,
                      device=block.device)
    cases.append((f"strips {tuple(block.shape[2:])} float32 nvar 8 y stage "
                  "update", (block, -2, block.shape[-2], c.bc_y, 2, c.C0,
                             c.gamma, hy[0], hy[1], dycore.mats, 0.0,
                             1.0 / g.dy, strips), acc,
                  cs._stage(state, dycore, b0, b1, dt, crop=cut), fast))
    del state, prim

    # bit for bit: every design against the first, one case at a time;
    # the f64 cases also against the plain version
    for tag, args, acc, rk, kw in cases:
        want = None
        for name in names:
            with use(name):
                n0 = cs.profiling.counter("direction_fluxes.tiled_launches")
                got = df.direction_fluxes(*args, acc=acc.clone(), rk=rk,
                                          **kw)
                assert cs.profiling.counter(
                    "direction_fluxes.tiled_launches") == n0 + 1
            if want is None:
                want = got
                if args[0].dtype == torch.float64:
                    plain = df.direction_fluxes_plain(*args, acc=acc.clone(),
                                                      rk=rk, **kw)
                    if not all(torch.equal(x, y) for x, y in zip(plain, got)):
                        raise AssertionError(f"{name} {tag}: not bitwise "
                                             "equal to the plain version")
                    del plain
            elif not all(torch.equal(x, y) for x, y in zip(want, got)):
                raise AssertionError(f"{name} {tag}: not bitwise equal to "
                                     f"{names[0]}")
            del got
        del want
        torch.cuda.empty_cache()
        print(f"{tag}: every design bit for bit with {names[0]}", flush=True)

    times = {}
    for name in names + names[::-1]:
        with use(name):
            for tag, args, acc, rk, kw in cases:
                buf = acc.clone()
                ms = cs._time_ms(lambda: df.direction_fluxes(
                    *args, acc=buf, rk=rk, **kw), reps=a.reps)
                del buf
                times.setdefault(tag, {}).setdefault(name, []).append(ms)
                print(f"{name} {tag}: {ms:.4f} ms  [{card}]", flush=True)
    for tag, by in times.items():
        print(f"{tag}: " + ", ".join(
            f"{n} {min(v):.3f}/{max(v):.3f}" for n, v in by.items())
            + " ms", flush=True)
    print("RESULT " + json.dumps({"card": card, "builds_s": secs,
                                  "ptxas": ptxas, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
