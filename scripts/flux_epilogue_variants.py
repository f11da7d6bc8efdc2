"""Time variants of the flux kernel's accumulator / stage-update epilogue.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/flux_epilogue_variants.py [--root DIR] [--reps N]

Each variant is the package's ``csrc/direction_fluxes.cu`` (with its header
``direction_fluxes.cuh`` inlined) with one change to
where the epilogue reads a cell's accumulator entries and stage bases,
built for WENO order 5 only (to keep the builds short) with the package's
nvcc flags into ``chip_smoke_out/flux_variants/`` (git-ignored):

  package       as the package has it: a cell's reads all issued before
                its writes, at the step that writes it;
  per_variable  each variable read, combined and written in turn (the
                compiler keeps each read behind the previous write to the
                same buffer);
  prefetch_acc  the accumulator read at the top of the step that writes
                the cell (in flight during the limiter work), the bases
                at the write;
  prefetch_all  the accumulator and the bases read at the top of the step.

For each variant, in turns (package ... prefetch_all, then backwards): the
z accumulating and y stage-update calls on the 512x512x64 Kessler state in
f32 and f64 (CUDA events, as chip_smoke.py times them; each result checked
bit for bit against the plain version), then run_benchmark's ms/step of the
512x512x64 f32 Kessler chain and the 400x400x60x2 f32 city, 10 steps each,
with the variant's library in place of the package's.  Prints one line per
measurement and a last JSON line (prefixed "RESULT ") with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# The epilogue of the package's march() (csrc/direction_fluxes.cuh) and the
# places each variant changes.
_DECL = "  T Fp[NS];      // state fluxes of the previous face\n"
_TOP = ("    const bool first = c < a0;\n"
        "    // the state variables' edges of cell c\n")
_LOAD = ("          EpiIn<T, EPI> in;\n"
         "          epi_load(in, sdiv, st, at, g.vstride);\n")
_COMBINE = """          T t[NS];
#pragma unroll
          for (int v = 0; v < NS; ++v)
            t[v] = add(in.acc[v], divergence(o.F[v], Fp[v], ds));
          if constexpr (EPI == EPI_STAGE) stage_update(t, in, st, at, p, c - 1);
#pragma unroll
          for (int v = 0; v < NS; ++v) sdiv[at + v * g.vstride] = t[v];
"""
_PER_VARIABLE = """#pragma unroll
          for (int v = 0; v < NS; ++v) {
            T t = add(sdiv[at + v * g.vstride], divergence(o.F[v], Fp[v], ds));
            if constexpr (EPI == EPI_STAGE) {
              const bool h1 = st.b1 != nullptr;
              const T* s = h1 ? st.b1 : st.b0;
              if (v == IDW && (st.flags & ST_GRAV))
                t = sub(t, mul(st.grav, add(s[at], st.hyc[p * st.cps + (c - 1) * st.cas])));
              if (v == IDU && (st.flags & ST_FCOR)) t = add(t, mul(st.fcor, s[at + IDV * g.vstride]));
              if (v == IDV && (st.flags & ST_FCOR)) t = sub(t, mul(st.fcor, s[at + IDU * g.vstride]));
              if (v == IDV && (st.flags & ST_SIM2D)) t = T(0);
              const T b0 = st.b0[at + v * g.vstride];
              const T b1 = h1 ? st.b1[at + v * g.vstride] : T(0);
              if (st.imm != nullptr) {
                const T prop = st.imm[at];
                t = add(mul(prop, mul(st.fac, h1 ? b1 : b0)), mul(sub(T(1), prop), t));
              }
              T o2 = mul(st.c0, b0);
              if (h1) o2 = add(o2, mul(st.c1, b1));
              t = add(o2, mul(st.cdt, t));
            }
            sdiv[at + v * g.vstride] = t;
          }
"""


def _top(load: str) -> str:
    return ("    const bool first = c < a0;\n"
            "    if constexpr (EPI != EPI_NONE) {\n"
            "      if (c > a0) {\n"
            "        const int64_t atp = obase + (int64_t)(c - 1) * g.astride;\n"
            f"        {load}\n"
            "      }\n"
            "    }\n"
            "    // the state variables' edges of cell c\n")


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/direction_fluxes.cuh no longer holds the "
                           f"text this script edits:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """The variant sources of ``src``, each built for order 5 only."""
    for o in (3, 7, 9):
        src = _replace(
            src, f"    case {o}: return launch_ord<{o}, T, ALG>(axis, planes, s, p, "
            "hr, ht, sd, tfp, g, pc0, ga, co, ds, acc, st);\n", "")
    late_bases = """          if constexpr (EPI == EPI_STAGE) {
            for (int v = 0; v < NS; ++v) {
              in.b0[v] = st.b0[at + v * g.vstride];
              in.b1[v] = st.b1 != nullptr ? st.b1[at + v * g.vstride] : T(0);
            }
          }
"""
    pre = _replace(src, _DECL, _DECL + "  EpiIn<T, EPI> in;\n")
    return {
        "package": src,
        "per_variable": _replace(src, _LOAD + _COMBINE, _PER_VARIABLE),
        "prefetch_acc": _replace(_replace(pre, _TOP, _top(
            "for (int v = 0; v < NS; ++v) in.acc[v] = sdiv[atp + v * "
            "g.vstride];")), _LOAD, late_bases),
        "prefetch_all": _replace(_replace(pre, _TOP, _top(
            "epi_load(in, sdiv, st, atp, g.vstride);")), _LOAD, ""),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=7)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flux_epilogue_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import miniweatherml_tpu_torch.ops.direction_fluxes as df
    from miniweatherml_tpu_torch import cuda_build
    from miniweatherml_tpu_torch.experiments import simple_city
    from miniweatherml_tpu_torch.experiments.community_benchmark import (
        run_benchmark)
    if not df.__file__.startswith(root):
        raise RuntimeError(f"imported {df.__file__}, not the tree at {root}")

    out_dir = os.path.join(root, "chip_smoke_out", "flux_variants")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(root, "miniweatherml_tpu_torch", "csrc")
    with open(os.path.join(csrc, "direction_fluxes.cu")) as f:
        src = f.read()
    with open(os.path.join(csrc, "direction_fluxes.cuh")) as f:
        src = _replace(src, '#include "direction_fluxes.cuh"\n',
                       f.read().replace("#pragma once\n", ""))
    srcs = variants(src)
    names = list(srcs)
    flags = cuda_build.nvcc_flags("direction_fluxes")

    def build(name):
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(srcs[name])
        t0 = time.perf_counter()
        r = subprocess.run([cuda_build._nvcc(), *flags, "-I", csrc, "-o",
                            os.path.join(out_dir, f"lib{name}.so"), cu],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
        return time.perf_counter() - t0
    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(build, names)))
    print(f"builds (s): {secs}", flush=True)
    ref = df._LIBRARIES["ref"]
    libs = {n: df._bind(ctypes.CDLL(os.path.join(out_dir, f"lib{n}.so")),
                        ref[0], ref[2].values())
            for n in names}

    def use(name):
        df._libs[ref[0]] = libs[name]
        df._coef_devices.clear()  # the next launch copies the tables
    card = cs._card()
    res = {"forms": {}, "steps": {}}
    turns = names + names[::-1]
    for dtype in ("float32", "float64"):
        state, _, dycore = cs._flux_state("kessler", dtype)
        prim = cs._prim(state, dycore)
        g, c = state.grid, dycore._consts(state)
        hy = dycore._hy(state)
        b0, b1 = cs._stage_bases(state, dycore)
        dt = dycore.compute_time_step(state)
        y = (prim, -2, g.ny, c.bc_y, 2, c.C0, c.gamma, hy[0], hy[1],
             dycore.mats, 0.0, 1.0 / g.dy)
        z = (prim, -3, g.nz, c.bc_z, 3, c.C0, c.gamma, hy[2], hy[3],
             dycore.mats, 0.0, 1.0 / g.dz)
        xdiv = df.direction_fluxes_plain(
            prim, -1, g.nx, c.bc_x, 1, c.C0, c.gamma, hy[0], hy[1],
            dycore.mats, 0.0, 1.0 / g.dx)[0].contiguous()
        forms = (("z accumulating", z, None),
                 ("y stage update, b1", y, cs._stage(state, dycore, b0, b1,
                                                     dt)),
                 ("y stage update, stage 1", y,
                  cs._stage(state, dycore, b0, None, dt)))
        refs = [df.direction_fluxes_plain(*args, acc=xdiv.clone(), rk=rk)[0]
                for _, args, rk in forms]
        for name in turns:
            use(name)
            for (tag, args, rk), ref in zip(forms, refs):
                got = df.direction_fluxes(*args, acc=xdiv.clone(), rk=rk)[0]
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} {tag} {dtype}: not bitwise "
                                         "equal to the plain version")
                buf = xdiv.clone()
                ms = cs._time_ms(lambda: df.direction_fluxes(
                    *args, acc=buf, rk=rk), reps=a.reps)
                res["forms"].setdefault(f"{name} {dtype} {tag}", []).append(
                    ms)
                print(f"{name} {dtype} {tag}: {ms:.4f} ms  [{card}]",
                      flush=True)
        del state, prim, b0, b1, xdiv, refs, forms
        torch.cuda.empty_cache()
    for chain, cfg, build_chain in (
            ("kessler", cs._bench_cfg(512, 512, 64, 10, "float32"), None),
            ("city", cs._city_cfg("city", 400, 400, 60, 2, "float32",
                                  steps=10), simple_city.build_chain)):
        for name in turns:
            use(name)
            kw = {} if build_chain is None else {"build": build_chain}
            state, r = run_benchmark(cfg, "cuda", quiet=True, **kw)
            ms = 1e3 * r["elapsed_s"] / r["steps"]
            res["steps"].setdefault(f"{name} {chain}", []).append(ms)
            print(f"{name} {chain}: {ms:.3f} ms/step  [{card}]", flush=True)
            del state
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps({"card": card, "builds_s": secs,
                                  "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
