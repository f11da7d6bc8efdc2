"""Time variants of the P3 ice and collection lookup kernels on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/p3_lookup_variants.py [--parent DIR] [--reps N]

Each variant is a text edit of ``csrc/p3_lookup.cu``, built with the
package's nvcc flags into ``chip_smoke_out/p3_lookup_variants/`` (git-ignored)
and launched through the package's wrappers (``physics/p3_lookup_cuda.py``):

  package       the package's build
  noprefetch    each thread loads a cell's indices and fractions when it
                comes to the cell, not one cell ahead
  scalar_zeros  with the presence gate false, zeros written one value a
                store, not 16 bytes
  noskew        ice (jj, ii) blocks of ISIZE * es values, without the skew
                that starts them in different shared-memory banks (tables
                packed to match)
  even_entries  ice entries kp values apart, not an odd number of vectors
                (tables packed to match)
  ice_256x5, ice_256x6  the ice kernel with blocks of 256 threads, 5 or 6
                per SM (at most 48 or 40 registers a thread) instead of
                2 of 512 (64)
  coll_floor    every collection corner load from the table's first
                entries (not bitwise: the kernel without its scattered
                table reads)

With ``--parent DIR`` (a ``git archive`` of an earlier tree) that tree's
``csrc/p3_lookup.cu`` is built with its own flags and called on the
canonical K-major tables ("parent"; "parent_equal" says whether it equals
the plain version bit for bit).

Every variant is timed with CUDA events, queued behind device sleep so that
they time the card and not the host (the median of N single calls after a
warm call, and the mean of N back-to-back calls) at 512x512x64 cells on
``chip_smoke.py`` phase 8's seeded index sets at every K of the path, and on
the index sets one step of the early-storm and of the all-active 512x512x64
P3 chain hands the lookups, f32 and f64.  Bitwise variants are checked against the plain
versions with ``torch.equal``.  Prints one ``RESULT`` JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chip_smoke_out", "p3_lookup_variants")

# variant -> (edits of the source, bitwise)
VARIANTS = {
    "package": ([], True),
    "noprefetch": ([(f"    const Cell<T, {d}> cell = next;\n"
                     f"    if (c + stride < n) next = load_cell(idx, frac, "
                     f"c + stride);\n",
                     f"    const Cell<T, {d}> cell = load_cell(idx, frac, c);\n")
                    for d in (3, 4)], True),
    "scalar_zeros": ([("  if (n % V == 0 && reinterpret_cast<uintptr_t>(out) "
                       "% 16 == 0) {", "  if (false) {")], True),
    "noskew": ([("  return ISIZE * ice_entry(kp, W) + W;",
                 "  return ISIZE * ice_entry(kp, W);")], True),
    "even_entries": ([("  return kp / W % 2 ? kp : kp + W;", "  return kp;")],
                     True),
    "ice_256x5": ([("ICE_THREADS = 512, ICE_PER_SM = 2",
                    "ICE_THREADS = 256, ICE_PER_SM = 5")], True),
    "ice_256x6": ([("ICE_THREADS = 512, ICE_PER_SM = 2",
                    "ICE_THREADS = 256, ICE_PER_SM = 6")], True),
    "coll_floor": ([("        const T* p = packed + b * bs + (i0 + (s & 1)) * row "
                     "+ j0 * kp + k0;", "        const T* p = packed + k0;")],
                   False),
}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    print(f"built {name}: (entry function, registers, spill stores) "
          f"{list(zip(funcs, regs, spills))}", flush=True)
    return so


def _parent_lib(parent: str):
    """The parent tree's lookup library (its own flags), bound for calls on
    canonical tables."""
    from miniweatherml_tpu_torch import cuda_build
    with open(os.path.join(parent, "miniweatherml_tpu_torch",
                           "cuda_build.py")) as f:
        fmad = re.search(r"FMAD_SOURCES = \(([^)]*)\)", f.read()).group(1)
    flags = cuda_build.NVCC_FLAGS + (
        f"--fmad={'true' if 'p3_lookup' in fmad else 'false'}",)
    with open(os.path.join(parent, "miniweatherml_tpu_torch", "csrc",
                           "p3_lookup.cu")) as f:
        lib = ctypes.CDLL(_build("parent", f.read(), flags))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for t in ("f32", "f64"):
        getattr(lib, f"p3_interp_ice_{t}").argtypes = [P, I] + [P] * 8 + [
            L, P]
        getattr(lib, f"p3_interp_collect_{t}").argtypes = [P, I] + [
            P] * 10 + [L, P]
    return lib


def _timings(fn, reps):
    """(median of single calls, mean of back-to-back calls) in ms, CUDA
    events; each single call, and the back-to-back run, is queued behind
    device sleep, so that the events time the card's work and not the
    host's launches."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    single = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        single.append(e0.elapsed_time(e1))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * reps)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return float(np.median(single)), e0.elapsed_time(e1) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=15)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("p3_lookup_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from miniweatherml_tpu_torch import cuda_build
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(ROOT, "miniweatherml_tpu_torch", "csrc",
                           "p3_lookup.cu")) as f:
        source = f.read()
    srcs = {}
    for name, (edits, _) in VARIANTS.items():
        src = source
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: edit does not apply")
            src = src.replace(old, new)
        srcs[name] = src
    flags = cuda_build.nvcc_flags("p3_lookup")
    with ThreadPoolExecutor(len(srcs)) as pool:
        sos = dict(zip(srcs, pool.map(lambda kv: _build(kv[0], kv[1], flags),
                                      srcs.items())))
    parent = _parent_lib(a.parent) if a.parent else None
    # the package's layout functions, and those of the variants that
    # change the ice layout
    package_layout = {"ice_block": LK.ice_block, "ice_entry": LK.ice_entry}
    layouts = {
        "noskew": {"ice_block": lambda K, dtype: LK.ISIZE * LK.ice_entry(
            K, dtype)},
        "even_entries": {"ice_entry": LK.entry_width}}

    def parent_call(kind, table, args, present):
        K = table.shape[0]
        out = torch.empty((K, *args[1].shape), dtype=args[1].dtype,
                          device="cuda")
        fn = getattr(parent, f"p3_interp_{kind}_"
                     + ("f32" if args[1].dtype == torch.float32 else "f64"))
        rc = fn(table.data_ptr(), K, *(x.data_ptr() for x in args),
                present.data_ptr() if present is not None else None,
                out.data_ptr(), out[0].numel(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent {kind} kernel: error {rc}")
        return out

    res = {}

    def run(tag, kind, table, args, present):
        kern = LK.interp_ice if kind == "ice" else LK.interp_collect
        plain = LK.interp_ice_plain if kind == "ice" else LK.interp_collect_plain
        pack = LK.pack_ice if kind == "ice" else LK.pack_collect
        canonical = table.contiguous()
        ref = plain(table, *args, present=present)
        bms, _ = cs._bound(cs._nbytes(canonical, args, ref),
                           40 * table.shape[0] * args[1].numel(),
                           args[1].dtype)
        line = {"bound_ms": bms}
        if parent is not None:
            line["parent_equal"] = bool(torch.equal(
                parent_call(kind, canonical, args, present), ref))
            line["parent"] = _timings(
                lambda: parent_call(kind, canonical, args, present), a.reps)
        for name, (_, bitwise) in VARIANTS.items():
            for attr, fn in {**package_layout,
                             **layouts.get(name, {})}.items():
                setattr(LK, attr, fn)
            packed = pack(canonical)  # in this variant's layout
            with LK.LIBRARY.use(sos[name]):
                got = kern(packed, *args, present=present)
                torch.cuda.synchronize()
                if bitwise and not torch.equal(got, ref):
                    raise AssertionError(f"{name} {tag}: differs from plain")
                del got
                line[name] = _timings(
                    lambda: kern(packed, *args, present=present), a.reps)
        for attr, fn in package_layout.items():
            setattr(LK, attr, fn)
        res[tag] = line
        print(tag, json.dumps(line), flush=True)

    tables = load_p3_tables()
    n = 512 * 512 * 64
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        dev = tables.to("cuda", dtype)
        idx, jr, _ = cs._p3_lookup_inputs(n, dtype)
        present = torch.tensor(True, device="cuda")
        for label, cols in cs.ICE_CALLS:
            run(f"phase8 ice {label} K={len(cols)} {name}", "ice",
                dev.ice_cols(cols), idx, present)
        run(f"phase8 collect part2 K=2 {name}", "collect",
            dev.collect_cols((2, 1)), (*idx, *jr), present)
        del idx, jr
        torch.cuda.empty_cache()
        for chain, build in cs._p3_step_chains():
            with LK.LIBRARY.use(sos["package"]):
                lookups = cs._p3_step_lookups(build, name)
            for i, (kind, args, present) in enumerate(lookups):
                kind = kind[len("interp_"):]
                gate = "" if present is None else f" present {bool(present)}"
                run(f"{chain} call {i + 1} {kind} K={args[0].shape[0]} "
                    f"{name}{gate}", kind, args[0], args[1:], present)
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps({"card": _card(), "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
