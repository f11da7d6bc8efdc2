"""Time variants of the P3 sedimentation pass (``sed_step``) on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/p3_sed_variants.py [--reps N]

Each variant is a text edit of ``csrc/p3_sed.cu``, built with the package's
nvcc flags into ``chip_smoke_out/p3_sed_variants/`` (git-ignored) and
launched through the package's wrappers (``physics/p3_sed_cuda.py``):

  package      the package's build: a thread loads each level's 11 inputs
               when it comes to the level; launch bounds of 8 blocks of
               128 threads a SM in f32 (4 in f64), so at most 64 (128)
               registers a thread
  prefetch     sed_step loads each level's inputs one level ahead, before
               the arithmetic and stores of the level above
  no_min_blocks  launch bounds without a number of blocks a SM
  prefetch_no_min_blocks  both (sed_step as first written)
  persistent   sed_step on sed_columns' persistent grid (as many blocks as
               fit on the card at once, each thread marching several
               columns) instead of one column a thread

On what one step of the early-storm, mixed-regime and all-active
512x512x64 P3 chains hands the sedimentation (``chip_smoke.py``'s
``_p3_step_rates_sed``), f32 and f64, each variant's sed_step alone and
sed_step + the sub-step count + the rerun of sed_columns, as ``p3_scheme``
runs them, are timed with CUDA events, each call queued behind device sleep
(the median of N calls after a warm call), and their outputs checked
against the package's build with ``torch.equal``.  Prints the registers and
spills of each build and one ``RESULT`` JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chip_smoke_out", "p3_sed_variants")

_PLAIN = ("    T fa[8];\n"
          "    for (int k = nz - 1; k >= 0; --k) {\n"
          "      const int64_t c = base + (int64_t)k * plane;\n"
          "      T x[NIN], q[8], o[8];\n"
          "      load_level(in, c, x);\n")
_PREFETCH = ("    T fa[8], x[NIN];\n"
             "    load_level(in, base + (int64_t)(nz - 1) * plane, x);\n"
             "    for (int k = nz - 1; k >= 0; --k) {\n"
             "      const int64_t c = base + (int64_t)k * plane;\n"
             "      T nx[NIN], q[8], o[8];\n"
             "      load_level(in, k > 0 ? c - plane : c, nx);\n")
_STORE = ("      for (int v = 0; v < 8; ++v) out[v][c] = o[v];\n"
          "    }\n"
          "    T pl = T(0), pi = T(0);\n")
_STORE_NEXT = ("      for (int v = 0; v < 8; ++v) out[v][c] = o[v];\n"
               "#pragma unroll\n"
               "      for (int f = 0; f < NIN; ++f) x[f] = nx[f];\n"
               "    }\n"
               "    T pl = T(0), pi = T(0);\n")
_BOUNDS = "__launch_bounds__(COL_THREADS, sizeof(T) == 4 ? 8 : 4)"
_NO_MIN = "__launch_bounds__(COL_THREADS)"
_GRID = "grid_for(kernel, COL_THREADS, smem, ncol, true, &blocks)"
_PERSISTENT = "grid_for(kernel, COL_THREADS, smem, ncol, false, &blocks)"
VARIANTS = {
    "package": [],
    "prefetch": [(_PLAIN, _PREFETCH), (_STORE, _STORE_NEXT)],
    "no_min_blocks": [(_BOUNDS, _NO_MIN)],
    "prefetch_no_min_blocks": [(_PLAIN, _PREFETCH), (_STORE, _STORE_NEXT),
                               (_BOUNDS, _NO_MIN)],
    "persistent": [(_GRID, _PERSISTENT)],
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _build(name: str, src: str, flags) -> str:
    from miniweatherml_tpu_torch import cuda_build
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(OUT, f"lib{name}.so")
    cmd = [cuda_build._nvcc(), *flags, "-I",
           os.path.join(ROOT, "miniweatherml_tpu_torch", "csrc"), "-o", so,
           path]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    funcs = re.findall(r"Compiling entry function '(\S+)'", res.stderr)
    regs = re.findall(r"Used (\d+) registers", res.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", res.stderr)
    rows = [r for r in zip(funcs, regs, spills) if "sed_step" in r[0]]
    print(f"built {name}: sed_step (entry function, registers, spill "
          f"stores) {rows}", flush=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("p3_sed_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from miniweatherml_tpu_torch import cuda_build
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as SED

    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(ROOT, "miniweatherml_tpu_torch", "csrc",
                           "p3_sed.cu")) as f:
        source = f.read()
    srcs = {}
    for name, edits in VARIANTS.items():
        src = source
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: edit does not apply")
            src = src.replace(old, new)
        srcs[name] = src
    flags = cuda_build.nvcc_flags("p3_sed")
    with ThreadPoolExecutor(len(srcs)) as pool:
        sos = dict(zip(srcs, pool.map(lambda kv: _build(kv[0], kv[1], flags),
                                      srcs.items())))

    def count(dt, v, dz):
        return torch.clamp(torch.ceil(dt * v / (0.9 * dz.min())), min=1.0)

    res = {}
    for chain, build in cs._p3_step_chains():
        for dtype in ("float32", "float64"):
            with SED.LIBRARY.use(sos["package"]):
                seen = cs._p3_step_rates_sed(build, dtype)
            args, kw = seen["sed_step"]
            fields, (rho, temp, dz, dt, dtab) = args[:8], args[8:13]
            del seen

            def step():
                return SED.sed_step(*args, **kw)

            def whole():
                v, one = SED.sed_step(*args, **kw)
                return SED.sed_columns(*fields, rho, temp, dz, dt,
                                       count(dt, v, dz), dtab, rerun=one,
                                       **kw)
            with SED.LIBRARY.use(sos["package"]):
                want = whole()
            line = {}
            for name, so in sos.items():
                with SED.LIBRARY.use(so):
                    got = whole()
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(want, got)):
                        raise AssertionError(f"{name} {chain} {dtype}: "
                                             "differs from the package's "
                                             "build")
                    del got
                    line[name] = {"sed_step": cs._time_ms(step, a.reps),
                                  "with_count_and_rerun": cs._time_ms(
                                      whole, a.reps)}
            res[f"{chain} {dtype}"] = line
            print(f"{chain} {dtype}", json.dumps(line), flush=True)
            del args, kw, fields, rho, temp, dz, dtab, want
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps({"card": _card(), "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
