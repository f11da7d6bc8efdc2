"""Time variants of P3's ``rates_pre`` kernel on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/p3_rates_variants.py [--reps N] [--parent DIR]

Each variant is a text edit of ``csrc/p3_cellwise.cu`` (or of a header it
includes), or the package's source with other nvcc flags, built into
``chip_smoke_out/p3_rates_variants/<variant>/`` (git-ignored) and launched
through the package's wrapper (``physics/p3_cellwise_cuda.py``):

  package       the package's build: a block of 128 threads takes 2 steps
                of 128 words of 16 bytes (4 neighbouring cells in f32, 2 in
                f64), a thread one word a step at block stride; each thread
                ORs its cells' presence flags and the block stores each
                flag at most once, after __syncthreads_or
  w1_s<k>       one cell a thread a step, k steps a block
  w16B_s<k>     the package's 16-byte words, k steps a block
  unrolled_w16B_s4  4 steps, the step loop unrolled (the words' arithmetic
                copied per step)
  warp_stores   one cell a thread on a grid that covers the cells, each flag
                stored once by every warp that sets it (the executor's
                flags before this launch path)
  no_flags      warp_stores without the flag stores (timing only: the flags
                come out unset)
  resident      a resident grid (as many blocks as fit on the card at once)
                walking the cells at grid stride, one cell a thread a step,
                flags reduced as the package's
  resident_w16B the same with the package's 16-byte words
  fast_math     the package with --use_fast_math in place of --fmad=false
                (timing only: every approximation at once)
  fast_div      the package with --prec-div=false (timing only)
  fast_pow      the package with float pow as __powf (timing only; f64
                unchanged)
  fast_log10    the package with float log10 as __log10f (timing only; f64
                unchanged)
  parent        with ``--parent DIR``: DIR's own p3_cellwise.cu and headers,
                unedited (a tree from before this launch path is the
                warp_stores design as it was shipped)

On what one step of the early-storm, mixed-regime and all-active
512x512x64 P3 chains hands ``rates_pre`` (``chip_smoke.py``'s
``_p3_step_rates_sed``), f32 and f64, each variant is timed with CUDA
events, each call queued behind device sleep (the median of N calls after
a warm call), in turns: every variant in order, then in the reverse order.
Every variant that is not timing only must equal the package's build with
``torch.equal`` (fields, indices and flags).  Prints the registers and
spills of each build's rates_pre entry functions and one ``RESULT`` JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "miniweatherml_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "chip_smoke_out", "p3_rates_variants")

_STORE = ("    if (__syncthreads_or(any[k]) && threadIdx.x == 0) "
          "p.flags[k] = true;\n")
_WARP_STORE = ("    if (__any_sync(0xffffffffu, any[k]) && (threadIdx.x & 31) "
               "== 0) p.flags[k] = true;\n")
_NO_STORE = "    (void)any[k];\n"
_WORD = "template <typename T> constexpr int RP_WORD = "
_STEPS = "template <typename T> constexpr int RP_STEPS = "
# the package's kernel and launcher, from the kernel's template line to the
# part3 aliases after the launcher
_KERNEL = ("template <typename T, int W>\n__global__ void "
           "__launch_bounds__(THREADS)\n    rates_pre_kernel(",
           "// the part3 forms")
# a resident grid (as many blocks as fit on the card at once) walking the
# cells at grid stride, each thread one word of {word} a step; flags as
# the package's
_RESIDENT = """template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    rates_pre_kernel(const Ptrs<RatesPre> p, int64_t n) {
  bool any[RatesPre::NFLAG] = {};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t groups = n / W;
  for (int64_t g = t; g < groups; g += stride) rates_pre_cells<T, W>(p, g * W, any);
  for (int64_t c = groups * W + t; c < n; c += stride) rates_pre_cells<T, 1>(p, c, any);
#pragma unroll
  for (int k = 0; k < RatesPre::NFLAG; ++k)
    if (__syncthreads_or(any[k]) && threadIdx.x == 0) p.flags[k] = true;
}

template <typename T>
int launch_rates_pre(const void* const* in, int nin, void* const* out, int nout,
                     void* const* iout, int niout, void* flags, int nflags, long long n,
                     void* stream) {
  using P = RatesPre;
  if (int e = check_counts<P>(nin, nout, niout, nflags, n)) return e;
  if (flags == nullptr) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  bool aligned = true;
  for (int k = 0; k < P::NIN; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(in[k]) % 16 == 0;
  for (int k = 0; k < P::NOUT; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(out[k]) % 16 == 0;
  for (int k = 0; k < P::NIOUT; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(iout[k]) % 16 == 0;
  const int w = aligned ? {word} : 1;
  const auto kernel = aligned ? rates_pre_kernel<T, {word}> : rates_pre_kernel<T, 1>;
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n / w + THREADS - 1) / THREADS;
  const long long most = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(need < most ? (need > 0 ? need : 1) : most);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pointers<P>(in, out, iout, flags, nullptr), (int64_t)n);
  return cudaGetLastError();
}

"""


def _shape(word: str, steps: int):
    """Edits giving each thread, in f32 and f64 alike, words of ``word``
    cells (a number, or "16 / sizeof(T)": one 16-byte word) and ``steps``
    words."""
    return [(SRC, (_WORD, ";\n"), f"{_WORD}{word}"),
            (SRC, (_STEPS, ";\n"), f"{_STEPS}{steps}")]


_STEP_LOOP = "#pragma unroll 1\n  for (int j = 0; j < RP_STEPS<T>; ++j) {"
_UNROLLED = "#pragma unroll\n  for (int j = 0; j < RP_STEPS<T>; ++j) {"
_POW = ("__device__ __forceinline__ float tpow(float a, float b) "
        "{ return powf(a, b); }")
_LOG10 = ("__device__ __forceinline__ float tlog10(float a) "
          "{ return log10f(a); }")
SRC, MATH = "p3_cellwise.cu", "p3_math.cuh"
_VEC = "16 / sizeof(T)"
# name: ([(file, old, new)], nvcc flags dropped, nvcc flags added,
# timing only); ``old`` may be a (start, end) pair: the text from start up
# to end
VARIANTS = {
    "package": ([], (), (), False),
    "warp_stores": (_shape("1", 1) + [(SRC, _STORE, _WARP_STORE)], (), (),
                    False),
    "no_flags": (_shape("1", 1) + [(SRC, _STORE, _NO_STORE)], (), (), True),
    **{f"w1_s{k}": (_shape("1", k), (), (), False)
       for k in (1, 2, 4, 8, 16, 32)},
    **{f"w16B_s{k}": (_shape(_VEC, k), (), (), False)
       for k in (1, 4, 8, 16, 32)},
    "unrolled_w16B_s4": (_shape(_VEC, 4) + [(SRC, _STEP_LOOP, _UNROLLED)],
                         (), (), False),
    "resident": ([(SRC, _KERNEL, _RESIDENT.replace("{word}", "1"))], (), (),
                 False),
    "resident_w16B": ([(SRC, _KERNEL, _RESIDENT.replace(
        "{word}", "RP_WORD<T>"))], (), (), False),
    "fast_math": ([], ("--fmad=false",), ("--use_fast_math",), True),
    "fast_div": ([], (), ("--prec-div=false",), True),
    "fast_pow": ([(MATH, _POW, _POW.replace("powf(", "__powf("))], (), (),
                 True),
    "fast_log10": ([(MATH, _LOG10, _LOG10.replace("log10f(", "__log10f("))],
                   (), (), True),
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sources(csrc: str, edits) -> dict[str, str]:
    """{file name: text} of p3_cellwise.cu and every header beside it, with
    ``edits`` applied (each must apply)."""
    files = {os.path.basename(p): open(p).read()
             for p in [os.path.join(csrc, SRC)]
             + sorted(glob.glob(os.path.join(csrc, "*.cuh")))}
    for name, old, new in edits:
        text = files[name]
        if isinstance(old, tuple):
            i = text.find(old[0])
            j = text.find(old[1], i)
            if i < 0 or j < i:
                raise RuntimeError(f"edit of {name} does not apply: {old!r}")
            old = text[i:j]
        if old not in text:
            raise RuntimeError(f"edit of {name} does not apply: {old!r}")
        files[name] = text.replace(old, new)
    return files


def _build(name: str, files: dict[str, str], flags) -> tuple[str, list]:
    """Write the variant's sources into its own directory (so its .cu finds
    its own headers first), build it, and return (library path, ptxas rows
    of its rates_pre entry functions)."""
    from miniweatherml_tpu_torch import cuda_build
    import chip_smoke as cs
    work = os.path.join(OUT, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for fname, text in files.items():
        with open(os.path.join(work, fname), "w") as f:
            f.write(text)
    so = os.path.join(work, f"lib{name}.so")
    cmd = [cuda_build._nvcc(), *flags, "-o", so, os.path.join(work, SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    report = os.path.join(work, "ptxas.txt")
    with open(report, "w") as f:
        f.write(res.stderr)
    rows = [(cs._kernel_name(m), regs, st, ld)
            for m, regs, st, ld, _, _ in cs._ptxas_report(name, report)
            if "RatesPre" in m]
    print(f"built {name}: rates_pre entry functions (kernel, registers, "
          f"spill stores, spill loads) {rows}", flush=True)
    return so, rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--parent", default=None,
                    help="root of another tree whose p3_cellwise.cu is "
                         "built unedited as the variant 'parent'")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("p3_rates_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from miniweatherml_tpu_torch import cuda_build
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw

    os.makedirs(OUT, exist_ok=True)
    base = cuda_build.nvcc_flags("p3_cellwise")
    jobs, timing_only = {}, set()
    for name, (edits, drop, add, t_only) in VARIANTS.items():
        flags = [f for f in base if f not in drop] + list(add)
        jobs[name] = (_sources(CSRC, edits), flags)
        if t_only:
            timing_only.add(name)
    if a.parent:
        jobs["parent"] = (_sources(os.path.join(
            os.path.abspath(a.parent), "miniweatherml_tpu_torch", "csrc"),
            []), list(base))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: _build(kv[0], *kv[1]), jobs.items())))
    libs = {name: cw._bind(ctypes.CDLL(so)) for name, (so, _) in built.items()}
    order = list(libs)

    res = {"registers": {n: rows for n, (_, rows) in built.items()},
           "timing_only": sorted(timing_only)}
    for chain, build in cs._p3_step_chains():
        for dtype in ("float32", "float64"):
            cw._lib = libs["package"]
            seen = cs._p3_step_rates_sed(build, dtype)
            _, arrays, _ = seen["rates_pre"][0]
            del seen

            def run():
                return cw._launch("rates_pre", False, arrays)
            want = run()
            line = {"equal": {}}
            for name in order:
                cw._lib = libs[name]
                got = run()
                torch.cuda.synchronize()
                line["equal"][name] = all(torch.equal(x, y)
                                          for x, y in zip(want, got))
                if name not in timing_only and not line["equal"][name]:
                    raise AssertionError(f"{name} {chain} {dtype}: differs "
                                         "from the package's build")
                del got
            times = {name: [] for name in order}
            for name in order + order[::-1]:
                cw._lib = libs[name]
                times[name].append(cs._time_ms(run, a.reps))
            cw._lib = libs["package"]
            line["ms"] = times
            res[f"{chain} {dtype}"] = line
            print(f"{chain} {dtype}", json.dumps(line), flush=True)
            del arrays, want
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps({"card": _card(), "result": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
