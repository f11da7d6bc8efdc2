"""Measure the PyTorch / CUDA port of one tree on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with the card):

  python scripts/torch_port_measure.py flux    [--root DIR] [--reps N] [--form F]
  python scripts/torch_port_measure.py cells   [--root DIR] [--chains A,B] [--form F]
  python scripts/torch_port_measure.py profile [--root DIR] [--chains A,B] [--form F]
  python scripts/torch_port_measure.py kernels [--root DIR] [--reps N]
  python scripts/torch_port_measure.py min_step [--root DIR] [--reps N]
  python scripts/torch_port_measure.py surrogate [--root DIR] [--reps N]
  python scripts/torch_port_measure.py surrogate_cpu [--reps N]
  python scripts/torch_port_measure.py mesh    [--root DIR] [--reps N]
  python scripts/torch_port_measure.py sed     [--root DIR] [--reps N]
  python scripts/torch_port_measure.py rates   [--root DIR] [--reps N]

``--root`` names the tree whose ``miniweatherml_tpu_torch`` and
``chip_smoke.py`` are imported (default: this checkout), so two trees are
compared by running the script once per tree in one call, in turns.
``--form`` (flux, cells, profile) picks the flux kernel's WENO algebra:
ref (default; the reference algebra, ``Dycore()``), opt (the
reduced-operation algebra with exact weights, ``Dycore(riemann_impl=
"pallas", fast_weights=False)``) or fast (with approximate-reciprocal
weights, ``Dycore(riemann_impl="pallas")``, the JAX package's device form);
a tree from before the opt algebra takes ref only.

  flux     direction_fluxes per direction (CUDA events, median of N calls
           after a warm call) on the Kessler, P3 and city states at their
           cells' widths (chip_smoke.py's _flux_state), f32 and f64.
  cells    run_benchmark's Mcellups and ms/step for the Kessler and P3
           512x512x64 f32 cells (10 steps), the P3 cell with every cell
           seeded (3 steps), the 400x400x60x2 f32 city (10 steps) and the
           512x512x64 f32 online MLP surrogate (10 steps; a tree that has
           it); with the micro module's own device time per step (CUDA
           events around step_modules[1], where chip_smoke.py can record
           them) and its share of the step.
  profile  torch.profiler device time per step over 3 steps after a warm
           step, by kernel family (flux, FCT, microphysics, matmul,
           elementwise glue, copies and reductions), and the device's idle
           share of the profiled span, for the same chains.
  --chains kessler,p3,p3_active,city,surrogate: a subset of the chains;
           ``cells`` also takes b, cell (b) (1024x1024x100, 3 steps, run
           only when named): its ms/step and peak memory, build and warm-up
           step included, as chip_smoke.py phase 6 reports them.
  kernels  fct_mult per call on the Kessler (3 tracers), P3 (9) and city
           (1 x nens 2) f32 states with each chain's own positive flags,
           beside its bytes bound; and on the Kessler chain's 512x512x64
           f32 state after one step, the microphysics kernel alone and
           MicrophysicsKessler.time_step whole (kernel plus rainsplit glue).
           A tree from before the fused Kessler step times its sub-cycle
           kernel on the same fields, prepared as its time_step does.
  min_step kessler_cuda.min_step (the sub-cycle count's reduction) on the
           Kessler chain's 512x512x64 f32 state after one step and on
           chip_smoke.py's heavy-rain 512x512x64 columns, f32 and f64, each
           checked against min_step_plain with torch.equal: three medians
           of N calls each (CUDA events, each call queued behind device
           sleep, as chip_smoke.py times), beside the bound of what the
           data needs (chip_smoke.py's _min_step_need).
  surrogate on the online MLP surrogate cell's 512x512x64 f32 state after
           one step: MicrophysicsKesslerSurrogate.time_step (CUDA events,
           median of N calls) beside the bytes bound of a fused per-cell
           version (5 fields read, 4 written), and the profiler's device
           time of each kernel of one call, by kernel name; then the
           kernel's fixed-width form against its general form on the
           shipped 5-10-4 model on the same fields, and the general form on
           chip_smoke.py's SURROGATE_WIDE models (seeded) on its corners of
           them, f32 and f64, each checked against the plain version with
           torch.equal and timed beside its bound (bytes or operations),
           with the general form's tile and the registers and
           spills of every surrogate entry function (ptxas).
  surrogate_cpu  (no card needed) on the CPU, the online surrogate chain
           at 64x64x32 (bench.py's CPU size) f32 and f64: the surrogate's
           time_step and a whole chain step (host clock, median of N
           calls), with the forward pass as the plain ordered sums and as
           the former stack / torch.matmul form (rebuilt here), each
           checked against the other within f64 1e-12 of scale, f32 1e-6
           of each output's scaling range.

  mesh     the 512x512x64 f32 Kessler chain undecomposed and decomposed
           over a (1, 2, 2) mesh of the one card (parallel/spmd.py), in
           one call: ms/step (host clock over N steps after a warm step,
           ending in a synchronize), Mcellups and peak memory of each, and
           both steps at 64x64x64, where the host sets the step time; the
           decomposed run's launches and barrier meetings per step and
           shard (ShardComm.all_gather calls, counted by wrapping it for
           one step); and each chain's
           device time per step by kernel family over 3 steps (as
           ``profile``: the exchanges' strip copies and the reductions'
           small kernels fall in "cat, reductions, copies" and "glue")
           with the device's idle share.  A tree without parallel/ gives
           the undecomposed figures only.

  sed      the P3 sedimentation of one step as the tree runs it, on what
           one step of the early-storm, mixed-regime and all-active
           512x512x64 P3 chains hands it (chip_smoke.py's _p3_step_chains),
           f32 and f64: this tree's sed_step, the sub-step count and the
           rerun of sed_columns, or a tree from before them its sed_vmax,
           the count and sed_columns; at the step's dt and at a dt that
           makes dt vmax / (0.9 dz_min) = 3.5 (4 sub-steps).  Three medians
           of N calls each (CUDA events, queued behind device sleep).

  rates    P3's per-cell kernels on what one step of the early-storm,
           mixed-regime and all-active 512x512x64 P3 chains hands them
           (chip_smoke.py's _p3_step_chains), f32 and f64: rates_pre and
           rates_post, and where the tree's _p3_step_rates_sed records them
           part1, update and the wrapper's inputs, then part3 and the
           output pass.  Three medians of N calls each (CUDA events,
           queued behind device sleep); a tree from before rates_pre's own
           launch path runs the same call with the flags stored per warp.

Each mode prints one JSON line (prefixed "RESULT ") with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card() -> str:
    import torch
    if not torch.cuda.is_available():
        return "no card (CPU)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


FORMS = ("ref", "opt", "fast")


def _with_form(build, form):
    """``build`` with its dycore replaced by the form's, as bench.py does
    with MWML_BENCH_PALLAS (every chain; the city's dycore is not its first
    module)."""
    if form == "ref":
        return build

    def with_form(cfg, device):
        from miniweatherml_tpu_torch.dycore.euler import Dycore
        state, mods, dycore = build(cfg, device)
        dy = Dycore(ord=dycore.ord, riemann_impl="pallas",
                    fast_weights=form == "fast")
        mods = [dy.time_step if m == dycore.time_step else m for m in mods]
        return state, mods, dy
    return with_form


def mode_flux(cs, reps, form="ref"):
    import torch
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        IDU, IDV, IDW, direction_fluxes)
    kw = cs.ALGEBRA_KW[form] if form != "ref" else {}
    out = {}
    for chain in ("kessler", "p3", "city"):
        for dtype in ("float32", "float64"):
            state, _, dycore = cs._flux_state(chain, dtype)
            prim = cs._prim(state, dycore)
            g, c = state.grid, dycore._consts(state)
            hy = dycore._hy(state)
            for name, axis, n, bc, nid, d, hr, ht in (
                    ("x", -1, g.nx, c.bc_x, IDU, g.dx, hy[0], hy[1]),
                    ("y", -2, g.ny, c.bc_y, IDV, g.dy, hy[0], hy[1]),
                    ("z", -3, g.nz, c.bc_z, IDW, g.dz, hy[2], hy[3])):
                args = (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht,
                        dycore.mats, 0.0, 1.0 / d)
                ms = _median_ms(lambda: direction_fluxes(*args, **kw), reps)
                out[f"{chain} {dtype} {name}"] = ms
                print(f"flux {form} {chain} nvar {prim.shape[0]} {dtype} "
                      f"{name}: {ms:.4f} ms", flush=True)
            del state, prim, hy, dycore
            torch.cuda.empty_cache()
    return out


HBM_BYTES_S = 3.35e12  # H100 SXM data sheet


def _fct_mult_case(cs, chain):
    """fct_mult's arguments at the stage dt on a chain's f32 state."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        IDU, IDV, IDW, direction_fluxes)
    state, _, dycore = cs._flux_state(chain, "float32")
    prim = cs._prim(state, dycore)
    g, c = state.grid, dycore._consts(state)
    hy = dycore._hy(state)
    faces = {}
    for axis, n, bc, nid, d, hr, ht in (
            (-1, g.nx, c.bc_x, IDU, g.dx, hy[0], hy[1]),
            (-2, g.ny, c.bc_y, IDV, g.dy, hy[0], hy[1]),
            (-3, g.nz, c.bc_z, IDW, g.dz, hy[2], hy[3])):
        faces[axis] = direction_fluxes(prim, axis, n, bc, nid, c.C0,
                                       c.gamma, hr, ht, dycore.mats, 0.0,
                                       1.0 / d)[1]
    flags = tuple(t.positive for t in state.meta.tracers)
    return (state.tracer_stack().contiguous(), flags, faces[-1], faces[-2],
            faces[-3], dycore.compute_time_step(state), g.dx, g.dy, g.dz)


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def mode_kernels(cs, reps):
    import torch
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    from miniweatherml_tpu_torch.ops.fct import fct_mult
    from miniweatherml_tpu_torch.physics import kessler_cuda as KC
    from miniweatherml_tpu_torch.physics.kessler import kessler_rainsplit
    out = {}
    for chain in ("kessler", "p3", "city"):
        args = _fct_mult_case(cs, chain)
        ms = _median_ms(lambda: fct_mult(*args), reps)
        tr = args[0]
        bound = 1e3 * _bytes(*args[:1], *args[2:5], tr) / HBM_BYTES_S
        out[f"fct_mult {chain}"] = {"ms": ms, "bound_ms": bound,
                                    "share": bound / ms,
                                    "shape": list(tr.shape)}
        print(f"fct_mult {chain} {tuple(tr.shape)}: {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound / ms:.1%})", flush=True)
        del args, tr
        torch.cuda.empty_cache()

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
    fields = [state[k] for k in ("density_dry", "temp", "water_vapor",
                                 "cloud_liquid", "precip_liquid")]
    R_d, R_v, cp, p0 = 287.0, 461.0, 1003.0, 1e5
    if hasattr(KC, "kessler_step"):
        kernel = "kessler_step"
        ms = _median_ms(lambda: KC.kessler_step(*fields, rs, dt, g.dz, R_d,
                                                R_v, cp, p0), reps)
    else:  # the sub-cycle kernel of a tree before the fused step
        kernel = "kessler_subcycle"
        rd, temp, rv, rc, rr = fields
        exner = ((R_d * rd * temp + R_v * rv * temp) / p0) ** (R_d / cp)
        sub = (temp / exner, rv / rd, rc / rd, rr / rd, rd, exner)
        ms = _median_ms(lambda: KC.kessler_subcycle(*sub, rs, dt, g.dz, R_d,
                                                    cp, p0), reps)
    step_ms = _median_ms(lambda: mods[1](state, dt), reps)
    cells = rho_d.numel()
    bound = 1e3 * (9 * cells + cells // g.nz) * 4 / HBM_BYTES_S
    out["kessler"] = {"kernel": kernel, "rainsplit": int(rs),
                      "kernel_ms": ms, "time_step_ms": step_ms,
                      "bound_ms": bound, "share": bound / ms}
    print(f"kessler 512x512x64 f32 rainsplit {int(rs)}: {kernel} {ms:.4f} "
          f"ms, MicrophysicsKessler.time_step {step_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({bound / ms:.1%} for the kernel)", flush=True)
    return out


def mode_min_step(cs, reps):
    import numpy as np
    import torch
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    from miniweatherml_tpu_torch.physics import kessler_cuda as kc
    state, mods, dycore = build(cs._bench_cfg(512, 512, 64, 1, "float32"),
                                "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    chain = (state["precip_liquid"], state["density_dry"], dt, state.grid.dz)
    del state, mods, dycore
    rng = np.random.default_rng(7)
    out = {}
    for dtype in (torch.float32, torch.float64):
        rd, _, _, _, qr, _, dz, cdt = cs._rain_columns(dtype, rng)
        cases = (("chain state", (chain[0].to(dtype), chain[1].to(dtype),
                                  chain[2], chain[3])),
                 ("heavy-rain columns", (qr * rd, rd, cdt, dz)))
        del rd, qr
        for case, args in cases:
            got = kc.min_step(*args)
            if not torch.equal(got, kc.min_step_plain(*args)):
                raise AssertionError(f"min_step {case} {dtype} differs")
            ms = [cs._time_ms(lambda: kc.min_step(*args), reps)
                  for _ in range(3)]
            bound, by = cs._bound(*cs._min_step_need(args[0], got), dtype)
            key = f"{case} {str(dtype)[6:]}"
            out[key] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                        "count": int(torch.ceil(args[2] / got))}
            print(f"min_step {key}: {', '.join(f'{t:.4f}' for t in ms)} ms, "
                  f"bound {bound:.4f} ms ({by}), count "
                  f"{out[key]['count']}", flush=True)
        del cases, args, got
    return out


def mode_sed(cs, reps):
    import torch
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as sed

    def count(dt, v, dz):
        return torch.clamp(torch.ceil(dt * v / (0.9 * dz.min())), min=1.0)
    out = {}
    for chain, build in cs._p3_step_chains():
        for dtype in ("float32", "float64"):
            seen = cs._p3_step_rates_sed(build, dtype)
            if "sed_step" in seen:   # one pass, the count, the rerun
                a, k = seen["sed_step"]
                fields, (rho, temp, dz, dt, dtab) = a[:8], a[8:13]
                pnc = k["do_predict_nc"]

                def run(dt_):
                    v, one = sed.sed_step(*fields, rho, temp, dz, dt_, dtab,
                                          do_predict_nc=pnc)
                    return sed.sed_columns(*fields, rho, temp, dz, dt_,
                                           count(dt_, v, dz), dtab,
                                           do_predict_nc=pnc, rerun=one)
                vmax = sed.sed_step(*a, **k)[0]
            else:                    # the former pair
                va, vk = seen["sed_vmax"]
                c, ck = seen["sed_columns"]
                fields, (rho, temp, dz, dt, _, dtab) = c[:8], c[8:14]
                pnc = ck["do_predict_nc"]

                def run(dt_):
                    v = sed.sed_vmax(*va, **vk)
                    return sed.sed_columns(*fields, rho, temp, dz, dt_,
                                           count(dt_, v, dz), dtab,
                                           do_predict_nc=pnc)
                vmax = sed.sed_vmax(*va, **vk)
            del seen
            cases = [("step", dt)]
            if float(vmax) > 0.0:  # else every dt gives 1 sub-step
                cases.append(("4 sub-steps",
                              3.5 * 0.9 * float(dz.min()) / float(vmax)))
            for label, dt_ in cases:
                key = f"{chain} {dtype} {label}"
                n = int(count(dt_, vmax, dz))
                ms = [cs._time_ms(lambda: run(dt_), reps) for _ in range(3)]
                out[key] = {"ms": ms, "nsub": n, "dt": dt_}
                print(f"sed {key}: {n} sub-step(s), "
                      f"{', '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
            del fields, rho, temp, dz, dtab
            torch.cuda.empty_cache()
    return out


def mode_rates(cs, reps):
    import torch
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw
    phases = ("part1", "rates_pre", "rates_post", "update", "wrapper")
    out = {}
    for chain, build in cs._p3_step_chains():
        for dtype in ("float32", "float64"):
            seen = cs._p3_step_rates_sed(build, dtype)
            calls = {}
            for ph in phases:
                if ph in seen:
                    pnc, arrays, dt = seen[ph][0]
                    calls[ph] = (lambda ph=ph, pnc=pnc, arrays=arrays, dt=dt:
                                 cw._launch(ph, pnc, arrays, dt))
            for name in ("p3_part3", "p3_wrapper_out"):
                args, _ = seen[name]
                calls[name] = (lambda fn=getattr(cw, name), args=args:
                               fn(*args))
            del seen
            for name, call in calls.items():
                key = f"{chain} {dtype} {name}"
                ms = [cs._time_ms(call, reps) for _ in range(3)]
                out[key] = ms
                print(f"rates {key}: {', '.join(f'{t:.4f}' for t in ms)} ms",
                      flush=True)
            del calls
            torch.cuda.empty_cache()
    return out


def _chains(cs, chains=()):
    from miniweatherml_tpu_torch.experiments import (simple_city,
                                                     supercell_example,
                                                     supercell_p3)
    if "b" in chains:
        # cell (b), as chip_smoke.py phase 6 runs it: the reference's
        # 1024x1024x100 community benchmark, 3 steps (only when named)
        dt = 0.6 * 200.0 / 430.0
        return (("b", cs._supercell_cfg(1024, 1024, 100, 819200.0, 819200.0,
                                        20000.0, 3 * dt * (1.0 - 1e-9),
                                        "float32"),
                 supercell_example.build),) + _chains(cs)
    return (("kessler", cs._bench_cfg(512, 512, 64, 10, "float32"),
             supercell_example.build),
            ("p3", cs._bench_cfg(512, 512, 64, 10, "float32"),
             supercell_p3.build),
            ("p3_active", cs._bench_cfg(512, 512, 64, 3, "float32"),
             cs._p3_active_build),
            ("city", cs._city_cfg("city", 400, 400, 60, 2, "float32",
                                  steps=10), simple_city.build_chain)) + (
        _surrogate_chain(cs) if hasattr(cs, "_surrogate_cfg") else ())


def _surrogate_chain(cs):
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    return (("surrogate",
             cs._surrogate_cfg(cs._bench_cfg(512, 512, 64, 10, "float32")),
             inference_surrogate.build),)


def mode_cells(cs, chains, form="ref"):
    import numpy as np
    import torch
    from miniweatherml_tpu_torch.experiments.community_benchmark import (
        run_benchmark)
    out = {}
    for chain, cfg, build in _chains(cs, chains):
        if chains and chain not in chains:
            continue
        times = []
        build = _with_form(build, form)
        if hasattr(cs, "_timed_micro_build"):
            build = cs._timed_micro_build(build, times)
        torch.cuda.reset_peak_memory_stats()
        state, res = run_benchmark(cfg, "cuda", quiet=True, build=build)
        torch.cuda.synchronize()
        ms_step = 1e3 * res["elapsed_s"] / res["steps"]
        micro = [a.elapsed_time(b) for a, b in times[1:]]
        out[chain] = {"mcellups": res["mcellups"],
                      "ms_per_step": ms_step,
                      "steps": res["steps"],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "micro_ms_per_step": (float(np.mean(micro)) if micro
                                            else None),
                      "micro_share": (float(np.mean(micro)) / ms_step
                                      if micro else None)}
        print(f"cell {chain} ({form}): {out[chain]}", flush=True)
        del state
        torch.cuda.empty_cache()
    return out


def _family(name: str) -> str:
    n = name.lower()
    if "fluxes" in n:
        return "flux"
    if "fct_mult" in n:
        return "fct_mult"
    if "fct" in n:
        return "fct_scale_div"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    if any(k in n for k in ("kessler", "cellwise", "ice_kernel",
                            "collect_kernel", "rain_kernel", "sed_vmax",
                            "sed_step", "sed_columns", "surrogate")):
        return "microphysics"
    if "elementwise" in n or "vectorized" in n:
        return "glue"
    return "cat, reductions, copies"


def _chain_step(mods):
    def step(state, dt):
        for m in mods:
            state = m(state, dt)
        return state
    return step


def _profile_families(step, state, dt, steps=3):
    """torch.profiler device time per step over ``steps`` calls of ``step``
    (after the caller's warm step) by kernel family, the busy time per step
    and the device's idle share of the profiled span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = step(state, dt)
        torch.cuda.synchronize()
    spans = []
    fam: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0 = ev.time_range.start
        t1 = ev.time_range.end
        spans.append((t0, t1))
        f = fam.setdefault(_family(ev.name), [0.0, 0])
        f[0] += (t1 - t0) / 1e3
        f[1] += 1
    spans.sort()
    busy, end = 0.0, None
    for t0, t1 in spans:
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    total = spans[-1][1] - spans[0][0] if spans else 0.0
    kern = sum(v[0] for v in fam.values())
    return {
        "per_step_ms": {k: v[0] / steps for k, v in fam.items()},
        "launches_per_step": {k: v[1] / steps for k, v in fam.items()},
        "share_of_kernel_time": {k: v[0] / kern for k, v in fam.items()},
        "busy_ms_per_step": busy / 1e3 / steps,
        "idle_share": 1.0 - busy / total if total else None}


def mode_profile(cs, chains, form="ref"):
    import torch
    out = {}
    for chain, cfg, build in _chains(cs):
        if chains and chain not in chains:
            continue
        state, mods, dycore = _with_form(build, form)(cfg, "cuda")
        dt = dycore.compute_time_step(state)
        for m in mods:
            state = m(state, dt)
        out[chain] = _profile_families(_chain_step(mods), state, dt)
        print(f"profile {chain} ({form}): {json.dumps(out[chain])}",
              flush=True)
        del state, mods, dycore
        torch.cuda.empty_cache()
    return out


def mode_surrogate(cs, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    state, mods, dycore = inference_surrogate.build(
        cs._surrogate_cfg(cs._bench_cfg(512, 512, 64, 1, "float32")), "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    ms = _median_ms(lambda: mods[1](state, dt), reps)
    bound = 1e3 * 9 * _bytes(state["temp"]) / HBM_BYTES_S
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mods[1](state, dt)
        torch.cuda.synchronize()
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name[:90], [0.0, 0])
            k[0] += (ev.time_range.end - ev.time_range.start) / 1e3
            k[1] += 1
    out = {"time_step_ms": ms, "fused_bound_ms": bound,
           "kernels": {k: {"ms": v[0], "launches": v[1]}
                       for k, v in sorted(kernels.items(),
                                          key=lambda kv: -kv[1][0])}}
    print(f"surrogate time_step 512x512x64 f32 online: {ms:.4f} ms; a fused "
          f"per-cell kernel's bound {bound:.4f} ms", flush=True)
    for k, v in out["kernels"].items():
        print(f"  {v['ms']:8.4f} ms  {v['launches']:3d}  {k}", flush=True)
    names = ("temp", "density_dry", "water_vapor", "cloud_liquid",
             "precip_liquid")
    out["forms"] = _surrogate_forms(cs, [state[n] for n in names],
                                    mods[1].__self__, reps)
    return out


def _surrogate_forms(cs, fields, micro, reps):
    """The kernel's two forms on ``fields`` with the shipped model, then
    the general form on chip_smoke.py's wide models on corners of them."""
    from types import SimpleNamespace
    import torch
    from miniweatherml_tpu_torch.ml.mlp import init_mlp
    from miniweatherml_tpu_torch.physics import kessler_surrogate_cuda as sc
    # _cast_for reads a state's device and dtype only
    cast = micro._cast_for(SimpleNamespace(
        device=fields[0].device,
        meta=SimpleNamespace(tdtype=fields[0].dtype)))
    params, widths = cast[4]
    res = {}

    def one(key, fs, ps, ws, form):
        got = sc._launch(form, *fs, ps, ws)
        ref = sc.surrogate_forward_plain(*fs, ps, ws)
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        nbytes = _bytes(*fs, ps, *got)
        del got, ref
        t = _median_ms(lambda: sc._launch(form, *fs, ps, ws), reps)
        macs = sum(a * b for a, b in zip(ws[:-1], ws[1:]))
        ops = (15 + 2 * macs + 2 * sum(ws[1:]) + 12) * fs[0].numel()
        bound, by = cs._bound(nbytes, ops, fs[0].dtype)
        rec = {"ms": t, "bound_ms": bound, "bound_by": by,
               "share": bound / t, "bit_for_bit": equal}
        if form == "general":
            rec["tile"] = sc._general_tile(ws, fs[0].dtype)
        res[key] = rec
        print(f"surrogate {key}: {t:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / t:.1%}, bit for bit {equal}"
              + (f", tile {rec['tile']}" if "tile" in rec else ""),
              flush=True)
        if not equal:
            raise AssertionError(f"surrogate {key} differs")

    for dtype in (torch.float32, torch.float64):
        fs = [f.to(dtype) for f in fields]
        for form in ("fixed", "general"):
            one(f"{form} {str(dtype)[6:]} shipped 512x512x64", fs,
                params.to(dtype), widths, form)
        del fs
    gen = torch.Generator(fields[0].device).manual_seed(11)
    for name, sizes, scale, (nz, ny, nx) in cs.SURROGATE_WIDE:
        model = init_mlp(sizes, gen, scale, torch.float64)
        for dtype in (torch.float32, torch.float64):
            ps, ws = sc.pack_mlp([(W.to(dtype), b.to(dtype))
                                  for W, b in model.weights],
                                 *(t.to(dtype) for t in cast[2:4]))
            one(f"general {str(dtype)[6:]} {name} {nx}x{ny}x{nz}",
                [f[:, :nz, :ny, :nx].to(dtype).contiguous() for f in fields],
                ps, ws, "general")
    ptxas = [(cs._entry_label("surrogate", m), regs, st, ld)
             for m, regs, st, ld, _, _ in cs._ptxas_report("surrogate")]
    for label, regs, st, ld in ptxas:
        print(f"surrogate ptxas: {label}: {regs} registers, {st} B spill "
              f"stores, {ld} B spill loads", flush=True)
    res["ptxas"] = ptxas
    return res


def mode_surrogate_cpu(cs, reps):
    """The online surrogate chain on the CPU with the forward pass as the
    plain ordered sums and as the former torch.matmul form."""
    import torch
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    from miniweatherml_tpu_torch.physics.kessler_surrogate import \
        MicrophysicsKesslerSurrogate as MKS

    def former(self, state):
        net, scl_in, scl_out = self._params(state)
        x = torch.stack([state[n] for n in ("temp", "density_dry",
                                            "water_vapor", "cloud_liquid",
                                            "precip_liquid")], dim=-1)
        x = (x - scl_in[:, 0]) / (scl_in[:, 1] - scl_in[:, 0])
        y = net(x)
        y = y * (scl_out[:, 1] - scl_out[:, 0]) + scl_out[:, 0]
        t, rv, rc, rr = y.unbind(-1)
        return (t, torch.clamp_min(rv, 0.0), torch.clamp_min(rc, 0.0),
                torch.clamp_min(rr, 0.0))

    def host_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[len(times) // 2]

    out = {"threads": torch.get_num_threads()}
    plain = MKS._nn_forward
    for dtype in ("float32", "float64"):
        cfg = cs._surrogate_cfg(cs._bench_cfg(64, 64, 32, 1, dtype))
        state, mods, dycore = inference_surrogate.build(cfg, "cpu")
        dt = dycore.compute_time_step(state)
        micro = mods[1].__self__
        a = plain(micro, state)
        b = former(micro, state)
        # f64 within 1e-12 of each output's scale, f32 1e-6 of its
        # scaling range (tests/test_torch_surrogate.py's bounds)
        rng = micro._params(state)[2].diff(dim=1).flatten()
        tol = 1e-12 if dtype == "float64" else 1e-6
        worst = max(float((x - y).abs().max()) / (
            max(float(y.abs().max()), 1e-300) if dtype == "float64"
            else float(rng[i])) for i, (x, y) in enumerate(zip(a, b)))
        if not worst <= tol:
            raise AssertionError(f"ordered sums vs matmul {dtype}: {worst}")

        def chain():
            s = state
            for m in mods:
                s = m(s, dt)
        try:
            for form, fn in (("ordered sums", plain), ("matmul", former)):
                MKS._nn_forward = fn
                r = {"time_step_ms": host_ms(lambda: mods[1](state, dt)),
                     "step_ms": host_ms(chain)}
                out[f"{dtype} {form}"] = r
                print(f"surrogate CPU 64x64x32 {dtype}, forward as {form}: "
                      f"time_step {r['time_step_ms']:.3f} ms, chain step "
                      f"{r['step_ms']:.3f} ms ({out['threads']} threads)",
                      flush=True)
        finally:
            MKS._nn_forward = plain
        out[f"{dtype} worst rel diff"] = worst
    return out


def _mesh_step_timed(step, state, dt, reps):
    """(state, seconds per step over ``reps`` steps after a warm one)."""
    import torch
    step(state, dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = step(state, dt)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / reps


def _meetings_per_step(step, sharded, dt):
    """Barrier meetings a shard makes in one step (every collective is
    one ``ShardComm.all_gather``)."""
    import threading

    from miniweatherml_tpu_torch.parallel.collectives import ShardComm
    plain, lock, calls = ShardComm.all_gather, threading.Lock(), [0]

    def counted(self, value):
        with lock:
            calls[0] += 1
        return plain(self, value)
    ShardComm.all_gather = counted
    try:
        step(sharded, dt)
    finally:
        ShardComm.all_gather = plain
    return calls[0] / sharded.mesh.size


def _mesh_host_ms(cs, reps):
    """ms per step of the Kessler chain at 64x64x64 f32, where the card's
    work is small and the step time is the host's: undecomposed, and (a
    tree with parallel/) on the 1x2x2 mesh."""
    import importlib.util
    from miniweatherml_tpu_torch.experiments import supercell_example
    cfg = cs._bench_cfg(64, 64, 64, reps, "float32")
    state, mods, dycore = supercell_example.build(cfg, "cuda")
    dt = dycore.compute_time_step(state)

    out = {"undecomposed": 1e3 * _mesh_step_timed(_chain_step(mods), state,
                                                  dt, reps)[1]}
    if importlib.util.find_spec("miniweatherml_tpu_torch.parallel") is not None:
        from miniweatherml_tpu_torch.parallel.mesh import (make_mesh,
                                                           shard_state)
        from miniweatherml_tpu_torch.parallel.spmd import make_spmd_step
        mesh = make_mesh(["cuda:0"] * 4, ens=1, y=2, x=2)
        step = make_spmd_step(state, mesh, dycore, micro=mods[1].__self__,
                              nudger=mods[3].__self__)
        out["decomposed"] = 1e3 * _mesh_step_timed(
            step, shard_state(state, mesh), dt, reps)[1]
        step.close()
    return out


def mode_mesh(cs, reps):
    import importlib.util

    import torch
    from miniweatherml_tpu_torch.experiments import supercell_example
    cfg = cs._bench_cfg(512, 512, 64, reps, "float32")
    state, mods, dycore = supercell_example.build(cfg, "cuda")
    dt = dycore.compute_time_step(state)
    g = state.grid
    cells = g.nx * g.ny * g.nz * g.nens

    torch.cuda.reset_peak_memory_stats()
    _, und = _mesh_step_timed(_chain_step(mods), state, dt, reps)
    out = {"undecomposed": {"ms_per_step": 1e3 * und,
                            "mcellups": cells / und / 1e6,
                            "peak_gib": torch.cuda.max_memory_allocated()
                            / 2**30}}
    print(f"mesh undecomposed: {out['undecomposed']}", flush=True)
    out["host_bound_64x64x64_ms_per_step"] = _mesh_host_ms(cs, reps)
    print(f"mesh host-bound steps: {out['host_bound_64x64x64_ms_per_step']}",
          flush=True)
    if importlib.util.find_spec("miniweatherml_tpu_torch.parallel") is None:
        out["decomposed"] = None
        return out
    from miniweatherml_tpu_torch.parallel.mesh import make_mesh, shard_state
    from miniweatherml_tpu_torch.parallel.spmd import make_spmd_step
    mesh = make_mesh(["cuda:0"] * 4, ens=1, y=2, x=2)
    step = make_spmd_step(state, mesh, dycore, micro=mods[1].__self__,
                          nudger=mods[3].__self__)
    sharded = shard_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    counts = cs._spmd_counts()
    before = cs._totals(counts)
    torch.cuda.reset_peak_memory_stats()
    sharded, dec = _mesh_step_timed(step, sharded, dt, reps)
    launches = {k: n / ((reps + 1) * mesh.size)
                for k, n in cs._since(counts, before).items()}
    out["decomposed"] = {"mesh": mesh.shape, "ms_per_step": 1e3 * dec,
                         "meetings_per_step_and_shard":
                         _meetings_per_step(step, sharded, dt),
                         "mcellups": cells / dec / 1e6,
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2**30,
                         "launches_per_step_and_shard": launches,
                         "ratio_to_undecomposed": dec / und}
    print(f"mesh decomposed: {out['decomposed']}", flush=True)

    out["profile"] = {"decomposed": _profile_families(step, sharded, dt)}
    step.close()
    del sharded
    torch.cuda.empty_cache()
    state, mods, dycore = supercell_example.build(cfg, "cuda")
    chain = _chain_step(mods)
    state = chain(state, dt)
    out["profile"]["undecomposed"] = _profile_families(chain, state, dt)
    print(f"mesh profile: {json.dumps(out['profile'])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("flux", "cells", "profile", "kernels",
                                     "min_step", "surrogate", "surrogate_cpu",
                                     "mesh", "sed", "rates"))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--chains", default="",
                    help="comma-separated subset of the chains")
    ap.add_argument("--form", choices=FORMS, default="ref",
                    help="the flux kernel's WENO algebra (flux, cells, "
                         "profile)")
    a = ap.parse_args()
    import torch
    if a.mode != "surrogate_cpu" and not torch.cuda.is_available():
        print("torch_port_measure: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import miniweatherml_tpu_torch
    if not miniweatherml_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {miniweatherml_tpu_torch.__file__}, "
                           f"not the tree at {root}")
    chains = [c for c in a.chains.split(",") if c]
    t0 = time.perf_counter()
    res = {"flux": lambda: mode_flux(cs, a.reps, a.form),
           "cells": lambda: mode_cells(cs, chains, a.form),
           "profile": lambda: mode_profile(cs, chains, a.form),
           "kernels": lambda: mode_kernels(cs, a.reps),
           "min_step": lambda: mode_min_step(cs, a.reps),
           "surrogate": lambda: mode_surrogate(cs, a.reps),
           "surrogate_cpu": lambda: mode_surrogate_cpu(cs, a.reps),
           "mesh": lambda: mode_mesh(cs, a.reps),
           "sed": lambda: mode_sed(cs, a.reps),
           "rates": lambda: mode_rates(cs, a.reps)}[a.mode]()
    print("RESULT " + json.dumps({
        "mode": a.mode, "root": a.root, "form": a.form, "card": _card(),
        "seconds": time.perf_counter() - t0, "result": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
