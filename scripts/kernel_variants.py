"""Time builds of the Kessler and FCT-multiplier kernels with extra nvcc flags.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/kernel_variants.py [--reps N] -- '' -DNO_DIV0 --use_fast_math

Each argument after ``--`` is one build of ``csrc/kessler.cu`` and ``csrc/fct.cu``
with those flags added to the package's own (``''`` is the package's build),
for example ``-DNO_DIV0`` (every division through the IEEE path, without
``exact_div.cuh``'s zero-dividend shortcut) or ``--use_fast_math``
(approximate pow, exp, sqrt and division: not bitwise, a measurement of
what exact rounding costs).  Every build is timed in one process on the
same inputs (CUDA events, median of N calls after a warm call) and checked
against the plain PyTorch versions with ``torch.equal``:

  kessler_step on the Kessler chain's 512x512x64 f32 state after one step
  (the main path's call) and on heavy-rain columns at rainsplit 1 and 3
  (f32) and 3 (f64); fct_mult on the Kessler, P3 and city f32 states.

Then a micro-benchmark: 16 dependent f32 divisions, powf or expf calls per
thread over 16 M values, with zero and with normal operands.  Prints one
``RESULT`` JSON line with the card's name and power limit.  The builds go
to ``chip_smoke_out/kernel_variants/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MICRO = r'''
#include <cuda_runtime.h>
__global__ void micro(int kind, const float* a, const float* b, float* o,
                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = a[i], y = b[i], s = 0.f;
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const float v = kind == 0 ? x / y
                  : kind == 1 ? powf(x, 0.1364f + r * 1e-3f) : expf(x * y);
    s = __fadd_rn(s, v);
    y = __fadd_rn(y, 0.5f);
  }
  o[i] = s;
}
extern "C" int micro_run(int kind, const void* a, const void* b, void* o,
                         int n) {
  micro<<<(n + 255) / 256, 256>>>(kind, (const float*)a, (const float*)b,
                                  (float*)o, n);
  return (int)cudaGetLastError();
}
'''


def _build(src: str, out: str, extra: list[str], name: str) -> ctypes.CDLL:
    from miniweatherml_tpu_torch import cuda_build
    cmd = [cuda_build._nvcc(), *cuda_build.nvcc_flags(name), *extra, "-o",
           out, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    return ctypes.CDLL(out)


def _kessler_cases(cs):
    import numpy as np
    import torch
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    from miniweatherml_tpu_torch.physics.kessler import kessler_rainsplit
    consts = (287.0, 461.0, 1003.0, 1e5)
    state, mods, dycore = build(cs._bench_cfg(512, 512, 64, 1, "float32"),
                                "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    g = state.grid
    rho_d = state["density_dry"]
    zmid = ((torch.arange(g.nz, dtype=rho_d.dtype, device="cuda") + 0.5)
            * g.dz)[None, :, None, None]
    rs = kessler_rainsplit(state["precip_liquid"] / rho_d, rho_d, zmid, dt)
    cases = {f"chain f32 rs{int(rs)}": (
        rho_d, state["temp"], state["water_vapor"], state["cloud_liquid"],
        state["precip_liquid"], rs, dt, g.dz, *consts)}
    # chip_smoke.py phase 4's heavy-rain columns
    rng = np.random.default_rng(7)
    shape, dz = (1, 64, 512, 512), 200.0
    z = ((np.arange(64) + 0.5) * dz)[None, :, None, None]
    for dtype, dts in ((torch.float32, (2.0, 30.0)), (torch.float64, (30.0,))):
        def dev(a):
            return torch.as_tensor(np.array(np.broadcast_to(a, shape)),
                                   dtype=dtype, device="cuda")
        rho = dev(1.2 * np.exp(-z / 8000.0))
        temp = dev((300.0 + 10.0 * z / 20000.0 + rng.uniform(0, 1, shape))
                   * np.exp(-z / 8000.0) ** (287.0 / 1003.0))
        qv = dev(0.016 * np.exp(-z / 3000.0))
        qc = dev(np.where(z < 5000.0, 1e-4, 0.0))
        qr = dev(np.where(z < 3000.0, 5e-4, 0.0) + 5e-3 * rng.random(shape))
        zt = torch.as_tensor(z, dtype=dtype, device="cuda")
        for dt in dts:
            r = kessler_rainsplit(qr, rho, zt, dt)
            name = f"rain {str(dtype)[6:]} rs{int(r)}"
            cases[name] = (rho, temp, qv * rho, qc * rho, qr * rho, r, dt,
                           dz, *consts)
    return cases


def _median_ms(fn, reps):
    import numpy as np
    import torch
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _micro(tmp, reps):
    import torch
    src = os.path.join(tmp, "micro.cu")
    with open(src, "w") as f:
        f.write(_MICRO)
    lib = _build(src, os.path.join(tmp, "libmicro.so"), [], "micro")
    P = ctypes.c_void_p
    lib.micro_run.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int]
    lib.micro_run.restype = ctypes.c_int
    n = 16 * 1024 * 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.rand(n, device="cuda", generator=gen) + 1.0
    o = torch.empty(n, device="cuda")
    operands = {"zero": torch.zeros(n, device="cuda"),
                "U(0.5, 2)": torch.rand(n, device="cuda", generator=gen) * 1.5
                + 0.5}
    out = {}
    for kind, name in enumerate(("f32 division", "powf", "expf")):
        for oname, a in operands.items():
            def run():
                if lib.micro_run(kind, a.data_ptr(), b.data_ptr(),
                                 o.data_ptr(), n):
                    raise RuntimeError("micro-benchmark launch failed")
            ms = _median_ms(run, reps)
            out[f"{name}, {oname}"] = {"ms": ms, "calls_per_s": 16 * n / ms
                                       * 1e3}
            print(f"{name} with {oname} operands: {ms:.4f} ms, "
                  f"{16 * n / ms / 1e6:.1f} G calls/s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("flags", nargs="*", default=[""])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch
    import chip_smoke as cs
    import torch_port_measure as tpm
    from miniweatherml_tpu_torch.ops import fct
    from miniweatherml_tpu_torch.physics import kessler_cuda as kc
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = tpm._card()
    print(card, flush=True)
    tmp = os.path.join(ROOT, "chip_smoke_out", "kernel_variants")
    os.makedirs(tmp, exist_ok=True)
    csrc = os.path.join(ROOT, "miniweatherml_tpu_torch", "csrc")
    libs, errors = {}, []

    def build(i, flags):
        try:
            libs[i] = tuple(_build(os.path.join(csrc, f"{n}.cu"),
                                   os.path.join(tmp, f"lib{n}{i}.so"),
                                   flags.split(), n)
                            for n in ("kessler", "fct"))
        except RuntimeError as e:
            errors.append(str(e))
    threads = [threading.Thread(target=build, args=(i, f))
               for i, f in enumerate(a.flags)]
    for t in threads:
        t.start()
    kcases = _kessler_cases(cs)
    kref = {k: kc.kessler_step_plain(*v) for k, v in kcases.items()}
    fcases = {c: tpm._fct_mult_case(cs, c) for c in ("kessler", "p3", "city")}
    fref = {c: fct.fct_mult_plain(*v) for c, v in fcases.items()}
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    res = {}
    for i, flags in enumerate(a.flags):
        row = {}
        with kc.LIBRARY.use(libs[i][0]), fct.LIBRARY.use(libs[i][1]):
            for name, args in kcases.items():
                same = all(torch.equal(x, y) for x, y in
                           zip(kc.kessler_step(*args), kref[name]))
                row[f"kessler_step {name}"] = {
                    "ms": _median_ms(lambda: kc.kessler_step(*args), a.reps),
                    "equal": same}
            for name, args in fcases.items():
                row[f"fct_mult {name}"] = {
                    "ms": _median_ms(lambda: fct.fct_mult(*args), a.reps),
                    "equal": torch.equal(fct.fct_mult(*args), fref[name])}
        res[flags or "(package build)"] = row
        print(f"[{flags or 'package build'}] " + ", ".join(
            f"{k} {v['ms']:.4f} ms{'' if v['equal'] else ' (differs)'}"
            for k, v in row.items()), flush=True)
    res["micro-benchmark"] = _micro(tmp, a.reps)
    print("RESULT " + json.dumps({"mode": "kernel_variants", "card": card,
                                  "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
