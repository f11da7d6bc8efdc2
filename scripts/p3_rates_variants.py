"""Time variants of P3's per-cell kernels ``rates_pre``, ``rates_post`` and
the wrapper inputs on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/p3_rates_variants.py [--phase rates_pre|rates_post|wrapper]
                                      [--reps N] [--parent DIR]

Each variant is a text edit of ``csrc/p3_cellwise.cu`` (or of a header it
includes), or the package's source with other nvcc flags, built into
``chip_smoke_out/p3_rates_variants/<phase>/<variant>/`` (git-ignored) and
launched through the package's wrapper (``physics/p3_cellwise_cuda.py``).
``--phase rates_pre`` (the default):

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

``--phase rates_post``: the package runs each gated group of rates under a
real branch on its gate, one cell a thread on cell_kernel (the gate inputs
loaded first, then every other input where a gate that reads it holds,
outputs stored once final); the parent runs every group in every cell and
selects by the gates, on the executor (every input in registers first,
every output stored last):

  late          each group's inputs loaded inside its branch, where the
                group first uses them (the package's first design)
  executor      the package's body on the executor: the branches alone
  words         the package's body on 16-byte words of 4 (f32) or 2 (f64)
                neighbouring cells a thread, every input loaded as words
                first and every output stored as words last (rates_pre's
                layout; one cell a thread where a field is not 16-byte
                aligned)

``--phase wrapper``: the package skips the saturation Newton where its
result is thrown away (no condensation or evaporation, or the boundary
root) and ends a cell's Newton once a trip leaves x with the bits it had,
one cell a thread on cell_kernel (the seven fields the adjustment leaves
alone stored before it):

  executor      the package's body on the executor (every output last)
  no_skip       the Newton in every cell, as the parent
  no_stop       every trip in every cell, as the parent
  warp_stop     the loop left once every cell of the warp has repeated its
                bits
  skip_only     the skip alone, on the executor (no_stop + executor)
  stop_only     the early end alone, on the executor (no_skip + executor)
  words         as for rates_post

For both: fast_math (timing only, as above) and no_math (timing only:
cell_kernel loads every input and stores every output, with no
arithmetic but their sum; the floor of the layout).  With ``--parent DIR``
every phase also has the variant ``parent``: DIR's own p3_cellwise.cu and
headers, unedited.

On what one step of the early-storm, mixed-regime and all-active
512x512x64 P3 chains hands the phase (``chip_smoke.py``'s
``_p3_step_rates_sed``), f32 and f64, each variant is timed with CUDA
events, each call queued behind device sleep (the median of N calls after
a warm call), in turns: every variant in order, then in the reverse order.
Every variant that is not timing only must equal the package's build with
``torch.equal`` (fields, indices and flags).  Prints the registers and
spills of each build's entry functions of the phase and one ``RESULT``
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
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
RATES_PRE = {
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


# the launch path of rates_post and the wrapper (cell_kernel) and the
# executor, by phase
_CASE = {"rates_post": "    case 6: return P3_CELLS(RatesPost);\n",
         "wrapper": "    case 4: return P3_CELLS(Wrapper);\n"}


def _executor(phase):
    return [(SRC, _CASE[phase], _CASE[phase].replace("P3_CELLS", "P3_PHASE"))]


# 16-byte words of neighbouring cells a thread for a phase on cell_kernel:
# every input loaded as words, the body run cell by cell on them, every
# output stored as words (one cell a thread where a field is not 16-byte
# aligned, and for the cells past the last whole word)
_WORDS = """template <class Phase, typename T, int W> struct WordIO {
  const T (&x)[Phase::NIN][W];
  T (&o)[Phase::NOUT][W];
  int e;
  __device__ __forceinline__ T in(int k) const { return x[k][e]; }
  __device__ __forceinline__ void out(int k, T v) const { o[k][e] = v; }
};

template <class Phase, typename T, int W>
__global__ void __launch_bounds__(THREADS)
    word_kernel(const Ptrs<Phase> p, int64_t n, double dt) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * W;
  if (c + W <= n) {
    T x[Phase::NIN][W], o[Phase::NOUT][W];
#pragma unroll
    for (int k = 0; k < Phase::NIN; ++k) load_cells<T, W>(p.in[k], c, x[k]);
#pragma unroll
    for (int e = 0; e < W; ++e) Phase::template body<T>(WordIO<Phase, T, W>{x, o, e}, dt);
#pragma unroll
    for (int k = 0; k < Phase::NOUT; ++k) store_cells<T, W>(p.out[k], c, o[k]);
  } else {
    for (int64_t e = c; e < n; ++e) Phase::template body<T>(CellIO<Phase, T>{p, e}, dt);
  }
}

template <class Phase, typename T>
int launch_words(const void* const* in, int nin, void* const* out, int nout,
                 void* const* iout, int niout, void* flags, int nflags, long long n,
                 double dt, void* stream) {
  if (int e = check_counts<Phase>(nin, nout, niout, nflags, n)) return e;
  if (n == 0) return cudaSuccess;
  bool aligned = true;
  for (int k = 0; k < Phase::NIN; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(in[k]) % 16 == 0;
  for (int k = 0; k < Phase::NOUT; ++k) aligned = aligned && reinterpret_cast<uintptr_t>(out[k]) % 16 == 0;
  constexpr int W = 16 / sizeof(T);
  const long long per_block = (long long)THREADS * (aligned ? W : 1);
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const auto kernel = aligned ? word_kernel<Phase, T, W> : word_kernel<Phase, T, 1>;
  kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pointers<Phase>(in, out, iout, flags, nullptr), (int64_t)n, dt);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int phase,"""


def _words(phase):
    call = _CASE[phase].split("return ")[0] + (
        f"return launch_words<{'RatesPost' if phase == 'rates_post' else 'Wrapper'}"
        ", T>(in, nin, out, nout, iout, niout, flags, nflags, n, dt, stream);\n")
    return [(SRC, "template <typename T>\nint dispatch(int phase,", _WORDS),
            (SRC, _CASE[phase], call)]


# cell_kernel moving every input and output, with no arithmetic but the
# inputs' sum (timing only)
_BODY_CALL = "  if (c < n) Phase::template body<T>(CellIO<Phase, T>{p, c}, dt);\n"
_NO_MATH = """  if (c < n) {
    const CellIO<Phase, T> io{p, c};
    T s = T(0);
#pragma unroll
    for (int k = 0; k < Phase::NIN; ++k) s += io.in(k);
#pragma unroll
    for (int k = 0; k < Phase::NOUT; ++k) io.out(k, s);
  }
"""
_FAST = ([], ("--fmad=false",), ("--use_fast_math",), True)
# RatesPost's inputs as its groups read them
_LOADED = ("  const IO& io;\n"
           "  __device__ __forceinline__ T in(int k) const { return x[k]; }")
# the wrapper's levers: the Newton where its result is thrown away, and the
# end of a cell's loop at repeated bits
_NO_SKIP = [(SRC, "  if (condensing || evaporating) {\n    const T rho_t",
             "  {\n    const T rho_t"),
            (SRC, "    if (!boundary)\n      x = saturation_newton(",
             "    x = saturation_newton("),
            (SRC, "    if (boundary) x = -rho_c;\n  }\n",
             "    if (boundary) x = -rho_c;\n  }\n"
             "  if (!(condensing || evaporating)) x = T(0);\n")]
_NO_STOP = [(SRC, "    if (fixed) break;\n", "    (void)fixed;\n")]
_WARP_STOP = [(SRC, "    if (fixed) break;\n",
               "    if (__all_sync(__activemask(), fixed)) break;\n")]
# name: ([(file, old, new)], nvcc flags dropped, nvcc flags added, timing
# only), by phase
VARIANTS = {
    "rates_pre": RATES_PRE,
    "rates_post": {
        "package": ([], (), (), False),
        "late": ([(SRC, _LOADED, _LOADED.replace("x[k]", "io.in(k)"))],
                 (), (), False),
        "executor": (_executor("rates_post"), (), (), False),
        "words": (_words("rates_post"), (), (), False),
        "fast_math": _FAST,
        "no_math": ([(SRC, _BODY_CALL, _NO_MATH)], (), (), True)},
    "wrapper": {
        "package": ([], (), (), False),
        "executor": (_executor("wrapper"), (), (), False),
        "no_skip": (_NO_SKIP, (), (), False),
        "no_stop": (_NO_STOP, (), (), False),
        "warp_stop": (_WARP_STOP, (), (), False),
        "skip_only": (_NO_STOP + _executor("wrapper"), (), (), False),
        "stop_only": (_NO_SKIP + _executor("wrapper"), (), (), False),
        "words": (_words("wrapper"), (), (), False),
        "fast_math": _FAST,
        "no_math": ([(SRC, _BODY_CALL, _NO_MATH)], (), (), True)},
}
# each phase's entry functions in the ptxas report (mangled names)
_ENTRY = {"rates_pre": "8RatesPreE", "rates_post": "9RatesPostE",
          "wrapper": "7WrapperE"}


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
        if text.count(old) != 1:
            raise RuntimeError(f"edit of {name} does not apply once: {old!r}")
        files[name] = text.replace(old, new)
    return files


def _build(phase: str, name: str, files: dict[str, str],
           flags) -> tuple[str, list]:
    """Write the variant's sources into its own directory (so its .cu finds
    its own headers first), build it, and return (library path, ptxas rows
    of the phase's entry functions)."""
    from miniweatherml_tpu_torch import cuda_build
    import chip_smoke as cs
    work = os.path.join(OUT, phase, name)
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
    rows = [(cs._entry_label("p3_cellwise", m), regs, st, ld)
            for m, regs, st, ld, _, _ in cs._ptxas_report(name, report)
            if _ENTRY[phase] in m]
    print(f"built {name}: {phase} entry functions (kernel, registers, "
          f"spill stores, spill loads) {rows}", flush=True)
    return so, rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="rates_pre", choices=sorted(VARIANTS))
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
    for name, (edits, drop, add, t_only) in VARIANTS[a.phase].items():
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
            lambda kv: _build(a.phase, kv[0], *kv[1]), jobs.items())))
    sos = {name: so for name, (so, _) in built.items()}
    order = list(sos)

    res = {"registers": {n: rows for n, (_, rows) in built.items()},
           "timing_only": sorted(timing_only)}
    for chain, build in cs._p3_step_chains():
        for dtype in ("float32", "float64"):
            with cw.LIBRARY.use(sos["package"]):
                seen = cs._p3_step_rates_sed(build, dtype)
                _, arrays, dt = seen[a.phase][0]
                del seen

                def run():
                    return cw._launch(a.phase, False, arrays, dt)
                want = run()
            line = {"equal": {}}
            for name in order:
                with cw.LIBRARY.use(sos[name]):
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
                with cw.LIBRARY.use(sos[name]):
                    times[name].append(cs._time_ms(run, a.reps))
            line["ms"] = times
            res[f"{chain} {dtype}"] = line
            print(f"{chain} {dtype}", json.dumps(line), flush=True)
            del arrays, want
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps({"card": _card(), "phase": a.phase,
                                  "result": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
