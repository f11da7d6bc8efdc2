"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

Usage (from the root of a checkout):  python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device: name, power limit, torch and CUDA versions;
  2. build: the ten CUDA libraries from csrc/ with nvcc (sm_90a), one
     nvcc each, and the P3 native twin with g++, all started together; the
     registers, spills and shared memory of every kernel (from the ptxas
     reports: the flux kernel's ord-5
     instantiations in each algebra -- reference, opt and opt with the
     approximate reciprocals (direction_fluxes_opt.cu), and reference with
     the approximate reciprocals (direction_fluxes_ref_fast.cu) --,
     the y/z kernel's accumulating and stage-update forms
     beside its bare form, every entry function of the others), and the
     Kessler kernel's dynamic shared memory per block at the chains' nz;
  3. the direction-flux kernel against its plain PyTorch version, x/y/z in
     f32 and f64, on each chain's state at its cell's width: the 512x512x64
     supercell with Kessler (3 tracers) plus a small wall/open case, the P3
     state (9 tracers, 14 variables) with mixed-regime hydrometeors, and the
     400x400x60x2 city with a cross-flow (1 tracer, 6 variables, periodic x
     and y, wall z); equal bit for bit (torch.equal), with kernel and plain
     times, the bound (bytes and operations from the shapes against the
     card's published rates) and the share of it; then the forms one
     right-hand side runs after x -- z accumulating into x's divergence,
     y accumulating with the SSPRK3 stage update (with b1: stages 2-3) --
     on every chain (the city's with its immersed blend), and on the
     Kessler state the stage-1 form (no b1), the form without gravity, a
     small box with a Coriolis parameter and a 2-D slab with z last; each
     bit for bit, the acc buffer written in place, timed beside its bound;
     then the bare x / y / z and the path's z accumulating and y stage
     update forms again in the JAX package's device algebra (opt=True, the
     reduced-operation WENO algebra; csrc/direction_fluxes_opt.cu), bit for
     bit in f32 and f64, and in f32 with fast_weights (the approximate
     reciprocal) against the plain (exact) version by the fast bar (every
     value within 1e-5 of its output's scale but those that a one-ulp
     change of the plain version's reciprocals moves as far, and no more
     of those than twice one such change's count; FAST_TOL), with the count
     of values that round apart and the largest difference in ulps, and on
     the Kessler x and y calls the bar's readings on planted faults; then
     the same in the reference algebra with the approximate reciprocals
     (f32, opt off: Dycore(riemann_impl="pallas", opt_algebra=False)) by
     the same bar, and on the Kessler x and y calls with a cutoff of 0.1
     and opt on (Dycore(riemann_impl="pallas", cutoff=0.1)), with planted
     faults; each timed beside its bound,
     whose operations count
     the opt algebra's limiter (_limiter_ops_opt); the Kessler chain's
     small open / wall box in both;
  14. (run inside 3, on the tracer faces each state gave) the FCT kernels
     against their plain versions: the multiplier (bit for bit, timed with
     the chain's own positive flags beside its bound: 3 tracers Kessler, 9
     P3, 1 x nens 2 city), and the scaled divergence along x, z and y,
     first / accumulating / with the stage update with and without the
     second base, a mixed positive mask, f32 and f64;
  4. the fused Kessler step (prep, sub-cycles, post) against its plain
     version, bit for bit: on the Kessler chain's own 512x512x64 f32 state
     after one step (its rainsplit printed; the kernel and the whole
     MicrophysicsKessler.time_step timed) and on heavy-rain columns at
     rainsplit 3, f32 and f64;
  34. (run after 4) the dycore's state transforms (csrc/dycore_state.cu:
     the de-densitization and the conversions coupler -> dynamics and
     dynamics -> coupler) at 1024x1024x100 f32 with the Kessler chain's 3
     tracers (8 fields) and the P3 chain's 9 (14 fields), each bit for bit
     against its plain version, one launch a call, timed beside the plain
     version and its bytes bound; every chain run below counts their 5
     launches a step, and the 1 of Dycore.init in the chain's build;
  5. the Kessler slice: community_benchmark.run_benchmark on the 512x512x64
     f32 ord-5 supercell, with its kernels' launch counts, the PyTorch
     (glue) launches of one more step (torch.profiler), a clean
     validate(), Mcellups and peak memory; plus the 50x1x20 f64 maxw
     trajectory against the JAX package's golden values and a 16x8x10 f64
     slice against the port's own CPU run;
  6. the reference's 1024x1024x100 community benchmark for 3 steps;
  7. the canonical 2-D supercell experiment with its heartbeat and NetCDF
     (written to chip_smoke_out/);
  8. the three P3 lookup kernels against their plain versions at 512x512x64
     cells, at every column count K of the P3 path, on index sets from
     seeded physical inputs that reach the tables' clip ranges, then the
     ice and collection kernels on the index sets that one step of the
     early-storm, the mixed-regime and the all-active P3 chain hands them,
     each timed beside its bound with its registers and shared memory per
     block;
  9. the P3 per-cell kernel's three phases against their plain versions on
     the inputs one P3 step hands them, on the seeded mixed-regime
     512x512x64 state, f32 and f64;
  31. (run after 9) the P3 scheme's per-cell phases and sedimentation:
     first rates_pre's presence flags against its plain version's on 963
     cells in which no cell, or one at the first, middle or last cell,
     holds ice, rain or both, as made and one element into their storage
     (not 16-byte aligned), f32 and f64; then every phase of the per-cell
     kernel a P3 step launches (part1, rates_pre, rates_post, update,
     wrapper), and sed_step (the speeds once, their maximum, one sub-step)
     with the rerun of sed_columns, against their plain versions on what
     one step of the early-storm, mixed-regime and all-active 512x512x64
     P3 chains hands them, f32 and f64: rates_pre's index sets by their
     lookup positions (index + fraction) with the count of indices that
     differ, its presence flags equal; each phase timed beside its bound,
     the operations counted from its body's SASS (_cell_ops; rates_post's
     bytes and operations those its data needs, each gated group of rates
     counted in the cells whose gate holds, _rates_post_work); on each
     state the wrapper Newton's trips per cell (histogram, and the mean of
     a warp's slowest cell) and, for each rates_post gate, the share of
     warps in which some cell passes it and in which its cells disagree;
     the two kernels' registers, spills and occupancy; the fall
     speed (also against the oracle
     _p3_sed_vmax) with the sub-step count made of it and dt vmax / (0.9
     dz_min) beside it, the one sub-step's outputs, and sed_step + count
     + rerun against sed_columns' plain version from the inputs at the
     step's count with do_predict_nc both ways and at a dt that makes that
     ratio 3.5 (4 sub-steps); each timed beside its bound (operations
     counted from the SASS of each species branch, _sed_ops) and beside
     sed_columns alone from the inputs, with the launches per P3 step and
     the two kernels' launch configuration and registers;
  32. (run inside 31, then on its own) the microphysics tails: P3's
     freezing + part3 (``p3_part3``, with and without its diagnostics,
     within the bound, with the cells that hold ice and that freeze) and
     its output pass (``p3_wrapper_out``, bit for bit) on what each of
     phase 31's steps hands them, f32 and f64; then the Kessler sub-cycle
     step (``min_step``) on the Kessler chain's 512x512x64 state after one
     step and on phase 4's heavy-rain columns (count 2 or more, printed
     beside the largest dt v / (0.8 dz_lev)), and the surrogate's forward pass
     (``surrogate_forward``) in both kernel forms (fixed-width and general)
     on cell (f)'s state after one step, then the general form on wider
     and deeper models (5-17-4, 5-64-64-4, 18 layers, 5-256-256-4 with
     over 227 KiB of parameters) at 128x128x32 cells of that state and
     5-8000-4, its activations in global scratch, at 32x32x16; f32 and f64
     (the state cast), bit for bit; each timed beside its bound, with the four
     kernels' registers and spills from phase 2;
  10. the P3 slice: run_benchmark(build=supercell_p3.build) at 512x512x64
     f32, 10 steps from the supercell init, with every P3-path kernel's
     launch count, a clean validate(), Mcellups and peak memory, and the
     host synchronizations of one step (torch.cuda sync debug mode) of the
     P3, all-active P3, Kessler and online surrogate chains, which must
     all be 0;
  11. the same for 3 steps with every cell seeded (bench.py's all-active
     P3 case), so every presence gate fires;
  12. a 16x8x10 f64 P3 slice with seeded hydrometeor layers and part3
     diagnostics (through part3's diagnostics kernel), card against the
     port's CPU run, 3 steps;
  13. the 2-D supercell_p3 experiment with p3_diagnostics, heartbeat and
     NetCDF (chip_smoke_out/);
  15. the city slice: run_benchmark(build=simple_city.build_chain) at
     inputs/input_city.yaml's 400x400x60 grid with nens 2, f32, 10 steps,
     with the dycore kernels' launch counts (9 flux, 3 multiplier and 9
     scaled-divergence launches per step, checked in every cell) beside the
     PyTorch (glue) launches of one more step, a clean validate(),
     Mcellups, peak memory, and the time averages written to
     chip_smoke_out/;
  16. small f64 building and city slices (one step), card against the
     port's CPU run at 1e-9 of each field's scale;
  17. restart: 2 steps, checkpoint, 2 more against 4 straight, bit for bit;
  18. the surrogate slice: run_benchmark(build=inference_surrogate.build) at
     512x512x64 f32, 10 steps, the MLP deployed online with the shipped
     example model (.npz) and no Kessler comparison (bench.py's
     MWML_BENCH_MICRO=surrogate case), with the dycore kernels' launch
     counts beside the glue launches of one more step, no Kessler launch
     and every surrogate launch in the fixed-width form, a clean
     validate(), Mcellups, peak
     memory, and the surrogate's own time per step (CUDA events around its
     time_step) and its share of the step;
  19. the same width in compare mode (the Kessler result kept, the mean NN -
     Kessler diffs stored) for 3 steps: one Kessler launch per step, the
     diffs finite;
  20. 16x8x10 f64 surrogate chains, card against the port's CPU run: online
     (and comparing) for 1 step, and in compare mode for 3 steps; the
     online chain's 3-step difference printed beside the CPU run's own
     spread under a 1e-15 perturbation;
  21. the surrogate workflow inside chip_smoke_out/ (where the harvest
     writes its dataset and metadata) on inputs/surrogate_example.yaml's
     2-D grid: gather_statistics and generate_micro_data for a few steps,
     train_mlp on the card for 3 epochs, one online step with the trained
     model, and the inference_surrogate experiment with the .npz weights;
  22. the flux kernel's halo-strip form against its plain version on the
     512x512x64 Kessler state split 2x2 (shard (0, 0), local 256x256x64):
     x and y, ends inside the domain and a wall and an open global
     boundary, and y with the stage update (the mesh path's last
     direction), f32 and f64, bit for bit, timed beside its bound; then the
     same in the opt algebra (bit for bit) and with fast_weights in both
     algebras (f32, by the fast bar);
  23. fct_scale_div with the neighbours' edge multipliers against its plain
     version on that shard's tracer faces, every form, f32 and f64, bit for
     bit, timed beside its bytes bound;
  24. the decomposed Kessler slice: make_spmd_step on a (1, 2, 2) mesh of
     the one card at 512x512x64 f32 -- one dycore step equal bit for bit to
     the undecomposed step, one chain step within 1e-5 of scale of the
     undecomposed chain, the host synchronizations of a step (0 expected),
     then 10 steps with the launch counts per step and shard, ms/step,
     Mcellups and peak memory beside the undecomposed chain's in the same
     call; then the 1024x1024x100 community benchmark on that mesh for 3
     steps;
  25. 16x8x10x2 f64 Kessler (3 steps) and P3 (seeded layers, 2 steps)
     chains on a (2, 2, 2) mesh of the card, against the port's CPU run of
     the same mesh and the card's undecomposed run; ShardedStateWriter on a
     2x4 mesh and stitch_sharded in chip_smoke_out/, bit for bit against
     the gathered state's file;
  26. the P3 native twin (csrc/p3_native.cpp, built with g++ in phase 2
     beside the CUDA libraries): its build seconds and whether the lookup
     tables were installed, and the twin against the port's p3_scheme on
     the card in f64 at rtol 1e-9 plus 1e-12 of each field's scale, on
     seeded mixed columns and on the columns one step of a 64x64x64 P3
     chain (seeded layers) hands the micro;
  27. the 128x128x64 f32 supercell_p3 chain with p3_backend native (3 steps
     after the warm-up step, run_benchmark, launch counters: the dycore's
     and the wrapper-inputs kernel), its step split by utils.profiling
     timers (over the timed steps) into the twin's host time, the copies to
     the host and back and the rest on the card, beside the torch-backend chain at the same grid
     in the same call; host syncs per native step; a 16x8x10 f64 native
     slice (seeded layers), card against CPU, 2 steps at 1e-7 of scale;
  28. tracer groups: the flux kernel at 12 tracers (two launches per call)
     along x, y, z, in the halo-strip form and in the accumulating (z) and
     stage-update (y) forms, in the reference algebra, the opt one and
     (f32) with fast_weights in both, each launch counted in its form;
     fct_mult
     and fct_scale_div
     at 12 tracers on its faces (one launch), f32 and f64, and both FCT
     kernels at 70 tracers (two launches), bit for bit against the plain
     versions;
  29. the bench entry: python -m miniweatherml_tpu_torch.bench in a
     subprocess for the default 512x512x64 f32 Kessler run (the JAX
     device form: MWML_BENCH_PALLAS defaults to 1 on the card, so opt with
     fast weights), the same with MWML_BENCH_PALLAS=0 (the reference
     algebra), MICRO=p3, MICRO=p3 with P3_ACTIVE=1 and STEPS=3, CASE=city
     and MICRO=surrogate, one at a time; each last line parsed (bench.py's
     keys plus ms_per_step and peak_mem_gib, value > 0, the metric naming
     the form) and printed;
  33. (run after 5) the main path in the flux kernel's JAX device form:
     run_benchmark on the 512x512x64 f32 Kessler supercell with the YAML's
     riemann_impl "pallas" (opt with fast weights), the same with
     fast_weights false, Dycore() (the reference algebra), and
     riemann_impl "pallas" with opt_algebra=False and with a cutoff of 0.1
     (the reference algebra with fast weights), in the order
     A B C D E E D C B A: each with every flux launch counted in its form,
     a clean
     validate(), Mcellups, ms/step and peak memory, and the largest
     differences between their states after 10 steps (printed); then a
     16x8x10 f64 riemann_impl "pallas" slice (exact weights in f64), card
     against the port's CPU run, 3 steps, at 1e-7 of each field's scale;
  30. the dry run: dryrun_multichip(8) on cuda:0 repeated 8 times (an
     (ens 2, 2, 2) mesh of the one card), f64, 20 Kessler and 20 P3 steps
     and one surrogate step, each within 2e-5 of each field's scale of the
     undecomposed run; each chain's largest difference and wall time, and
     the launch counts of the run.

Tolerance of a kernel against its plain version: max|kernel - plain| over
max|plain| of each output below 1e-12 in f64 and 1e-5 in f32 (the JAX
suite's own f32 bound between its paths, tests/test_pallas.py:260,311);
the direction-flux kernel (in the reference and opt algebras; with
fast_weights, whose plain version is exact, 1e-5 of scale on every value
but the few that a one-ulp change of the plain version's reciprocals moves
as far, see FAST_TOL), fct_mult,
the three P3 lookups, the Kessler
sub-cycle step, the P3 output pass and the surrogate's forward pass must
also equal their plain versions bit for bit; the Kessler step prints
whether it does, and the count and size in ulps of any value that rounds
apart; the P3 rates, sedimentation and part3 kernels print whether they do
(their pow, exp, lgamma and log10 need not round as PyTorch's).
A slice on the card against the port's CPU run: 1e-7 of each field's scale
(1e-9 for the one-step building and city slices, phase 16).  The
surrogate's forward pass is one kernel (csrc/surrogate.cu) and the training
path keeps torch.matmul (TF32 off).

The last lines of output are {"native": {...}} (the twin is host C++, not a
TPU kernel, so it has no row in the kernels line), the card's name and power
limit, {"kernels": [...]} and {"ok": true, "device": {...}}.  Needs torch.cuda; exits non-zero without it.
"""

from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from miniweatherml_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")  # git-ignored


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error over max |reference|) of b against a."""
    err = (a.double() - b.double()).abs().max().item()
    return err, err / max(a.double().abs().max().item(), 1e-300)


# device cycles (~1 ms) that a timed call is queued behind, so that its
# events time the card's work and not the host's launch
QUEUE_CYCLES = 2_000_000


def _time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after a warm call;
    each call is queued behind ``QUEUE_CYCLES`` of device sleep."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# The card's published rates (H100 SXM data sheet, 700 W): HBM bytes/s and
# non-tensor-core FLOP/s per type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def _dtype_name(t) -> str:
    return str(t).replace("torch.", "")


def _nbytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (nested tuples, lists and dicts):
    each input read once, each output written once."""
    tot = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            tot += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            tot += _nbytes(*o)
        elif isinstance(o, dict):
            tot += _nbytes(*o.values())
    return tot


def _bound(nbytes, ops, dtype) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the type's peak."""
    t_b = 1e3 * nbytes / HBM_BYTES_S
    t_o = 1e3 * ops / PEAK_FLOPS[_dtype_name(dtype)]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _limiter_ops(ord_: int) -> int:
    """Floating-point operations of one variable's WENO edges in one cell,
    counted from the limiter's shape (ops/weno_fused.py, csrc weno_edges):
    3 per smoothness term (two multiplies, one add), 2K per normalisation
    (K - 1 adds, a division, K multiplies), 3K for the weights (multiply,
    add, division), and 2 per edge coefficient plus 2 per candidate for
    each of the two edges."""
    from miniweatherml_tpu_torch.ops.weno_fused import substencils
    sup = substencils(ord_)
    K = len(sup)
    tv = sum(w * (w + 1) // 2 for _, w in sup)
    return 3 * tv + 2 * K + 3 * K + 2 * K + 2 * sum(2 * w + 2 for _, w in sup)


def _limiter_ops_opt(ord_: int) -> int:
    """Floating-point operations of one variable's WENO edges in one cell in
    the reduced-operation algebra (pallas_recon.py::_weno_edges_block_opt,
    csrc weno_edges_opt), a reciprocal counted as one: ord 5's Jiang-Shu
    indicators (8 shared differences and 4 for f0, f2, then 5 per
    candidate), else per form 2 per tap (multiply, add; the first tap no
    add, the square one) and an add per further form; the high-order
    indicator on pair sums and differences (2 per pair, 2H + 2 per even
    form, 2H + 1 per odd form, an add per further form); the total (K - 1
    adds), eps T^2 + tiny (3), 4 per weight (square, add, reciprocal,
    multiply), their sum (K - 1) and its reciprocal; then per edge and
    candidate kept the blend coefficient (3 with gamma, else 1), the
    w-tap edge form (2w - 1), its product and an add per further
    candidate."""
    from miniweatherml_tpu_torch.ops.weno_fused import (opt_dropped,
                                                        substencils)
    sup = substencils(ord_)
    K, H = len(sup), ord_ // 2
    if ord_ == 5:
        low = 12 + 3 * 5
    else:
        low = 0
        for k, (_, w) in enumerate(sup[:-1]):
            taps = [w - sum(opt_dropped(ord_, k, m, q) for q in range(w))
                    for m in range(w - 1)]
            low += sum(2 * t for t in taps) + len(taps) - 1
    high = 2 * H + H * (2 * H + 2) + (H - 1) + H * (2 * H + 1)
    weights = (K - 1) + 3 + 4 * K + (K - 1) + 1
    gamma = ord_ <= 5
    kept = sup[:-1] if gamma else sup
    edges = 2 * (sum((3 if gamma else 1) + (2 * w - 1) + 1 for _, w in kept)
                 + len(kept) - 1)
    return low + high + weights + edges


# the flux call's limiter keywords of each algebra (ops/direction_fluxes.py
# limiter_algebra): reference, reduced-operation, approximate reciprocals in
# the reduced-operation and in the reference algebra (opt off: the
# Dycore(riemann_impl="pallas", opt_algebra=False) form; a cutoff with opt
# on reaches it too, FAST_CUTOFF)
ALGEBRA_KW = {"ref": {}, "opt": {"opt": True},
              "fast": {"opt": True, "fast_weights": True},
              "ref_fast": {"fast_weights": True}}
# the algebras with approximate reciprocals, held by the fast bar
FAST_ALGEBRAS = ("fast", "ref_fast")
# the cutoff of the Dycore(riemann_impl="pallas", cutoff=0.1) form
FAST_CUTOFF = 0.1


def _flux_work(prim, axis, ord_, algebra="ref") -> tuple[int, int]:
    """(bytes, operations) one direction_fluxes call needs: it reads the
    nvar variables and the two background profiles once and writes the 5
    state divergences and the ntr tracer faces (n + 1 per line); it forms
    WENO edges of n + 2 cells per line for every variable (in the
    ``algebra``'s operation count), solves n + 1 faces (~25 operations,
    pow counted as one, plus 4 per tracer) and takes 5 differences and
    scalings per cell."""
    nvar = prim.shape[0]
    ntr = nvar - 5
    cells = prim[0].numel()
    n = prim.shape[axis]
    lines = cells // n
    nlev = prim.shape[2] + (1 if axis == -3 else 0)
    item = prim.element_size()
    nbytes = item * (nvar * cells + 5 * cells + ntr * lines * (n + 1)
                     + 2 * prim.shape[1] * nlev)
    lim = (_limiter_ops(ord_) if algebra in ("ref", "ref_fast")
           else _limiter_ops_opt(ord_))
    ops = (nvar * lim * lines * (n + 2)
           + (25 + 4 * ntr) * lines * (n + 1) + 10 * cells)
    return nbytes, ops


def _epilogue_work(args, rk, algebra="ref") -> tuple[int, int]:
    """(bytes, operations) of a direction_fluxes call in the accumulating
    form (``rk`` None) or with the stage update: the bare call's work
    (``_flux_work``, strips included), plus the accumulator read (its write
    takes the divergence's place) and 5 adds per cell, plus, for the stage,
    b0 [, b1], the cell density profile and the immersed proportion read
    once and per cell 3 (gravity), 4 (Coriolis), 21 (immersed blend) and 3
    or 5 per variable (the combination) operations."""
    prim, axis, ord_ = args[0], args[1], args[9].ord
    nbytes, ops = _flux_work(prim, axis, ord_, algebra)
    if len(args) > 12 and args[12] is not None:
        nbytes += _nbytes(args[12][:2])
    cells = prim[0].numel()
    nbytes += 5 * cells * prim.element_size()
    ops += 5 * cells
    if rk is not None:
        nbytes += _nbytes(rk.b0, rk.b1, rk.hy_r, rk.immersed)
        ops += cells * (5 * (3 if rk.b1 is None else 5)
                        + (3 if rk.grav is not None else 0)
                        + (4 if rk.fcor != 0.0 else 0)
                        + (21 if rk.immersed is not None else 0))
    return nbytes, ops


# The fast form's bar.  Its plain version is exact, and no bound of scale
# holds all of an approximate reciprocal's outputs to it: moving the plain
# version's own reciprocals by one ulp moves a few flux outputs by up to
# ~7e-3 of their scale on the Kessler state (the upwind choice ruL + ruR > 0
# flips at faces where the sum is near zero, and the divergence differences
# fluxes of ~1e5), and makes an output that is exactly 0 nonzero.  So the
# one-ulp model only marks those outputs: every output of the fast kernel
# that no one-ulp model run moves by more than FAST_TOL of its scale must
# lie within FAST_TOL of it, and the outputs beyond FAST_TOL may number at
# most FAST_COUNT_FACTOR times as many as the most that one model run moves
# that far.  _planted_faults shows the bar failing wrong kernels.
FAST_TOL = 1e-5
FAST_COUNT_FACTOR = 2


# the card's approximate reciprocal as an elementwise kernel, the
# instruction the fast flux kernels issue (csrc/direction_fluxes.cuh
# rcp_approx), for the fast bar's model run of it
RCP_SRC = r"""
#include <cuda_runtime.h>
__global__ void rcp_kernel(const float* x, float* y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x[i]));
    y[i] = r;
  }
}
extern "C" int rcp_approx_f32(const float* x, float* y, long long n,
                              void* stream) {
  if (n > 0)
    rcp_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return cudaGetLastError();
}
"""
_rcp_lib = []


def _rcp_library():
    """The RCP_SRC library, built with nvcc into chip_smoke_out/ (once per
    process)."""
    import ctypes
    if not _rcp_lib:
        from miniweatherml_tpu_torch import cuda_build
        work = os.path.join(OUT_DIR, "rcp")
        os.makedirs(work, exist_ok=True)
        src, so = os.path.join(work, "rcp.cu"), os.path.join(work, "rcp.so")
        with open(src, "w") as f:
            f.write(RCP_SRC)
        subprocess.run([cuda_build._nvcc(), *cuda_build.nvcc_flags("rcp"),
                        "-o", so, src], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        P = ctypes.c_void_p
        lib.rcp_approx_f32.argtypes = [P, P, ctypes.c_longlong, P]
        lib.rcp_approx_f32.restype = ctypes.c_int
        _rcp_lib.append(lib)
    return _rcp_lib[0]


def _card_recip(v):
    """1 / v by the card's approximate reciprocal (f32 on the card; any
    other tensor exactly, as the fast kernels do: ops/weno_fused.py's
    _recip, which a model run replaces by this)."""
    if not (v.is_cuda and v.dtype == torch.float32):
        return torch.div(v.new_full((), 1.0), v)
    x = v.contiguous()
    r = torch.empty_like(x)
    rc = _rcp_library().rcp_approx_f32(
        x.data_ptr(), r.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rcp_approx_f32 failed: {rc}")
    return r


def _recip_models():
    """The model runs of the fast kernels' reciprocals, by name: each
    replaces every reciprocal of the plain limiters that take them
    (ops/weno_fused.py::_recip: reconstruct_edges_opt and
    reconstruct_edges_recip) by one ulp off -- toward zero, away from zero,
    or up, down or not at random (two seeds) -- and, on the card, by the
    card's own approximate reciprocal (_card_recip).  A cutoff turns a
    weight near it on or off, so which outputs an approximate reciprocal
    moves far depends on the exact reciprocals it gives; only the card's
    own run of them marks those of the kernel."""
    from miniweatherml_tpu_torch.ops import weno_fused
    exact = weno_fused._recip

    def toward(to):
        def model(v):
            r = exact(v)
            return torch.nextafter(r, torch.full_like(r, to))
        return model

    def at_random(seed):
        gens = {}

        def model(v):
            r = exact(v)
            gen = gens.setdefault(r.device, torch.Generator(
                device=r.device).manual_seed(seed))
            step = torch.randint(-1, 2, r.shape, generator=gen,
                                 device=r.device)
            up = torch.nextafter(r, torch.full_like(r, math.inf))
            down = torch.nextafter(r, torch.zeros_like(r))
            return torch.where(step > 0, up,
                               torch.where(step < 0, down, r))
        return model
    models = {"toward zero": toward(0.0), "away from zero": toward(math.inf),
              "random 16": at_random(16), "random 17": at_random(17)}
    if torch.cuda.is_available():
        models["the card's rcp.approx"] = _card_recip
    return models


def _with_recip(recip, fn, terms=None):
    """fn() with the plain limiters' reciprocal replaced by ``recip`` (and
    their term tables by ``terms``, when given: {name in
    ops/weno_fused.py: replacement})."""
    from miniweatherml_tpu_torch.ops import weno_fused
    terms = terms or {}
    saved = {k: getattr(weno_fused, k) for k in ("_recip", *terms)}
    weno_fused._recip = recip
    for k, v in terms.items():
        setattr(weno_fused, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(weno_fused, k, v)


def _beyond(ref, out):
    """Per output, the mask of the values of ``out`` more than FAST_TOL of
    the output's scale (max |ref|) from ``ref``."""
    return [(a.double() - b.double()).abs()
            > FAST_TOL * a.double().abs().max().item()
            for a, b in zip(ref, out)]


def _one_ulp_model(plain, ref):
    """The fast bar's model of ``plain()`` (whose result is ``ref``), per
    output: (mask of the values that some one-ulp model run moves beyond
    FAST_TOL of scale, the most values one run moves that far, the largest
    difference of any run)."""
    masks = counts = spread = None
    for recip in _recip_models().values():
        out = _with_recip(recip, plain)
        far = _beyond(ref, out)
        diff = [(a.double() - b.double()).abs().max().item()
                for a, b in zip(ref, out)]
        del out
        if masks is None:
            masks, counts, spread = far, [0] * len(ref), diff
        else:
            masks = [m | f for m, f in zip(masks, far)]
            spread = [max(x, y) for x, y in zip(spread, diff)]
        counts = [max(c, int(f.sum())) for c, f in zip(counts, far)]
        del far
    return masks, counts, spread


def _fast_verdict(ref, got, model):
    """(passes, per output (values beyond FAST_TOL of scale, those of them
    that no one-ulp model run moves that far)) of the fast kernel's
    outputs ``got`` against the plain version's ``ref`` and its model."""
    masks, counts, _ = model
    per = []
    for far, mask in zip(_beyond(ref, got), masks):
        per.append((int(far.sum()), int((far & ~mask).sum())))
    ok = all(out == 0 and n <= FAST_COUNT_FACTOR * c
             for (n, out), c in zip(per, counts))
    return ok, per


def _verdict_text(per, model) -> str:
    return "; ".join(
        f"{n} beyond {FAST_TOL:g} of scale, {out} of them unmarked (the "
        f"model marks {int(m.sum())}, one run at most {c}, moves it up to "
        f"{sp:.3e})"
        for (n, out), m, c, sp in zip(per, model[0], model[1], model[2]))


def _fault_models():
    """Planted faults of the fast kernels, by name, as (reciprocal, terms)
    replacements for the plain limiters' (_with_recip): every reciprocal
    2^-12 or 2^-18 off (relative), and the first optimal weight idl_0 off
    by 1e-3 in both algebras' tables (the opt algebra's _opt_terms, the
    reference one's _sparse_terms)."""
    from miniweatherml_tpu_torch.ops import weno_fused
    exact = weno_fused._recip
    opt_terms, ref_terms = weno_fused._opt_terms, weno_fused._sparse_terms

    def idl_off(terms):
        def off(ord_):
            *rest, idl = terms(ord_)
            return (*rest, (idl[0] + 1e-3,) + tuple(idl[1:]))
        return off
    return {"reciprocals 2^-12 off": (
                lambda v: exact(v) * (1.0 + 2.0 ** -12), None),
            "reciprocals 2^-18 off": (
                lambda v: exact(v) * (1.0 + 2.0 ** -18), None),
            "idl_0 off by 1e-3": (exact, {
                "_opt_terms": idl_off(opt_terms),
                "_sparse_terms": idl_off(ref_terms)})}


def _planted_faults(tag, plain, ref, model):
    """The fast bar on wrong kernels, stood in for by the plain version
    with each of _fault_models' faults on the same inputs: it must fail
    the reciprocals 2^-12 off; the other readings are printed."""
    caught = {}
    for name, (recip, terms) in _fault_models().items():
        out = _with_recip(recip, plain, terms)
        ok, per = _fast_verdict(ref, out, model)
        del out
        caught[name] = not ok
        print(f"[3] fast bar, planted fault on {tag} ({name}): "
              f"{'FAILS (caught)' if not ok else 'passes (not caught)'}; "
              f"{_verdict_text(per, model)}", flush=True)
    if not caught["reciprocals 2^-12 off"]:
        raise AssertionError(f"the fast bar passes reciprocals 2^-12 off "
                             f"on {tag}")


def _agreement(ref, got, algebra, plain=None, faults=None):
    """(max abs err, rel, bitwise equal, passes, text) of a flux call's
    outputs against its plain version's.  The reference and opt algebras
    pass bit for bit; the fast forms pass the fast bar (FAST_TOL) against
    the model of ``plain`` (the plain call, run again) and equal ``plain``
    run on the card's approximate reciprocal (_card_recip) bit for bit,
    and the text gives the values that round apart, the largest
    difference in ulps, and per output the bar's counts.  With ``faults``
    (a tag) the
    bar is also run on planted faults (_planted_faults)."""
    errs = [_rel(a, b) for a, b in zip(ref, got)]
    same = all(torch.equal(a, b) for a, b in zip(ref, got))
    ok, text = same, ""
    if algebra in FAST_ALGEBRAS:
        model = _one_ulp_model(plain, ref)
        ok, per = _fast_verdict(ref, got, model)
        n, u = max(_ulps(a, b) for a, b in zip(ref, got))
        twin = _with_recip(_card_recip, plain)
        bit = all(torch.equal(a, b) for a, b in zip(twin, got))
        del twin
        ok = ok and bit
        text = (f", {n} values apart, largest {u:.0f} ulps; per output "
                + ", ".join(f"{e[0]:.3e}" for e in errs) + "; bit for bit "
                f"with the plain version on the card's approximate "
                f"reciprocal: {bit}; fast bar "
                + ("passes" if ok else "FAILS") + ": "
                + _verdict_text(per, model))
        if faults is not None:
            _planted_faults(faults, plain, ref, model)
        del model
    return max(e[0] for e in errs), max(e[1] for e in errs), same, ok, text


def _flux_form(phase, tag, args, acc, rk, dtype, tol, timed=True,
               algebra="ref", kw=None):
    """The accumulating (``rk`` None) or stage-update form of one
    direction_fluxes call against its plain version on copies of ``acc``:
    both outputs bit for bit (the fast algebra by the fast bar),
    the result written into the kernel's copy in place; timed beside its
    bound when ``timed`` (kernel and plain in turn on one buffer, which
    each call overwrites).  Returns (max abs err, ms, plain ms, bound ms,
    bound_by), the last four None when not timed.  ``kw``: the limiter
    keywords, by default ALGEBRA_KW's of the algebra."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        direction_fluxes, direction_fluxes_plain)
    kw = ALGEBRA_KW[algebra] if kw is None else kw
    a_ref, a_got = acc.clone(), acc.clone()
    ref = direction_fluxes_plain(*args, acc=a_ref, rk=rk, **kw)
    got = direction_fluxes(*args, acc=a_got, rk=rk, **kw)
    torch.cuda.synchronize()
    err, rel, same, ok, ulps = _agreement(
        ref, got, algebra,
        lambda: direction_fluxes_plain(*args, acc=acc.clone(), rk=rk, **kw))
    in_place = got[0] is a_got
    del ref, got, a_ref
    line = (f"[{phase}] direction_fluxes {tag} {dtype}: bitwise "
            f"{'equal' if same and in_place else 'DIFFERENT'}, max abs err "
            f"{err:.3e}, rel {rel:.3e}{ulps}")
    ms = pms = bms = by = None
    if timed:
        ms = _time_ms(lambda: direction_fluxes(*args, acc=a_got, rk=rk,
                                               **kw))
        pms = _time_ms(lambda: direction_fluxes_plain(*args, acc=a_got,
                                                      rk=rk, **kw), reps=3)
        nbytes, ops = _epilogue_work(args, rk, algebra)
        bms, by = _bound(nbytes, ops, dtype)
        line += (f"; kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                 f"{bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
                 f"{ops / 1e9:.2f} GFLOP), {bms / ms:.1%} of the bound  "
                 f"[{_card()}]")
    print(line, flush=True)
    if not (in_place and ok and (algebra in FAST_ALGEBRAS or rel <= tol)):
        raise AssertionError(f"direction_fluxes {tag} {dtype} {algebra}: "
                             f"equal {same}, in place {in_place}, rel "
                             f"{rel:.3e}")
    return err, ms, pms, bms, by


def _flux_bare(phase, tag, args, dtype, tol, algebra, timed=True,
               faults=False, kw=None):
    """One direction_fluxes call of ``algebra`` against its plain version
    (the same keywords): bit for bit (and within ``tol`` of each output's
    scale), the fast form within the fast bar, its ulps printed, and with
    ``faults`` the bar's readings on planted faults; timed beside its bound
    when ``timed``.  Returns (outputs, max abs err, ms, plain ms, bound ms,
    bound_by), the times None when not timed.  ``kw``: the limiter
    keywords, by default ALGEBRA_KW's of the algebra."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        direction_fluxes, direction_fluxes_plain)
    kw = ALGEBRA_KW[algebra] if kw is None else kw
    ref = direction_fluxes_plain(*args, **kw)
    got = direction_fluxes(*args, **kw)
    torch.cuda.synchronize()
    err, rel, same, ok, ulps = _agreement(
        ref, got, algebra, lambda: direction_fluxes_plain(*args, **kw),
        f"{tag} {dtype}" if faults else None)
    del ref
    line = (f"[{phase}] direction_fluxes {algebra} {tag} {dtype}: bitwise "
            f"{'equal' if same else 'DIFFERENT'}, max abs err {err:.3e}, "
            f"rel {rel:.3e}{ulps}")
    ms = pms = bms = by = None
    if timed:
        ms = _time_ms(lambda: direction_fluxes(*args, **kw))
        pms = _time_ms(lambda: direction_fluxes_plain(*args, **kw), reps=3)
        nbytes, ops = _flux_work(args[0], args[1], args[9].ord, algebra)
        if len(args) > 12 and args[12] is not None:
            nbytes += _nbytes(args[12][:2])
        bms, by = _bound(nbytes, ops, dtype)
        line += (f"; kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                 f"{bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
                 f"{ops / 1e9:.2f} GFLOP), {bms / ms:.1%} of the bound  "
                 f"[{_card()}]")
    print(line, flush=True)
    if not (ok and (algebra in FAST_ALGEBRAS or rel <= tol)):
        raise AssertionError(f"direction_fluxes {algebra} {tag} {dtype}: "
                             f"equal {same}, rel {rel:.3e}{ulps}")
    return got, err, ms, pms, bms, by


def _stage_bases(state, dycore):
    """The stage update's bases on the card: b0 the state, b1 it with
    seeded relative noise of 1e-3 (a previous stage)."""
    s, _ = dycore.convert_coupler_to_dynamics(state)
    gen = torch.Generator(device=s.device).manual_seed(17)
    noise = torch.randn(s.shape, generator=gen, device=s.device,
                        dtype=s.dtype)
    return s.contiguous(), (s * (1.0 + 1e-3 * noise)).contiguous()


def _stage(state, dycore, b0, b1, dt, grav=True, fcor=None, sim2d=None,
           crop=None):
    """The chain's StageUpdate with stage 2's coefficients (stage 1's when
    ``b1`` is None); ``crop`` cuts the cell tensors to a box."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import StageUpdate
    c = dycore._consts(state)
    cut = crop or (lambda t: t)
    imm = state["immersed_proportion"]
    return StageUpdate(
        1.0 if b1 is None else 0.75, 0.0 if b1 is None else 0.25,
        dt if b1 is None else 0.25 * dt, cut(b0).contiguous(),
        None if b1 is None else cut(b1).contiguous(),
        state["hy_dens_cells"],
        c.grav if (grav and c.enable_gravity) else None,
        c.fcor if fcor is None else fcor,
        cut(imm[None])[0].contiguous() if c.use_immersed else None, dt,
        state.grid.sim2d if sim2d is None else sim2d)


def _ptxas_report(name: str, path: str | None = None):
    """(kernel, registers, spill store bytes, spill load bytes, stack bytes,
    shared bytes) of each entry function in _build/<name>.ptxas.txt (or in
    the ptxas report at ``path``)."""
    import re
    path = path or os.path.join(ROOT, "miniweatherml_tpu_torch", "_build",
                                f"{name}.ptxas.txt")
    rows, cur, frame = [], None, (0, 0, 0)
    with open(path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                frame = tuple(int(x) for x in m.groups())
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if m and cur:
                sm = re.search(r"(\d+) bytes smem", ln)
                rows.append((cur, int(m.group(1)), frame[1], frame[2],
                             frame[0], int(sm.group(1)) if sm else 0))
                cur, frame = None, (0, 0, 0)
    return rows


def _kernel_name(mangled: str) -> str:
    """The function name of a mangled entry function, with its first
    template argument when that is float or double."""
    import re
    i = re.match(r"_ZN?", mangled).end()
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name = mangled[j:j + int(mangled[i:j])]
        i = j + int(mangled[i:j])
    t = {"If": "<float>", "Id": "<double>"}.get(mangled[i:i + 2], "")
    return name + t


# the y/z kernel's epilogue forms and the limiter algebras
# (csrc/direction_fluxes.cuh EPI_*, ALG_*)
FLUX_EPILOGUES = {"0": "bare", "1": "accumulating", "2": "stage update"}
FLUX_ALGEBRAS = {"0": "ref", "1": "opt", "2": "fast", "3": "ref_fast"}


def _flux_instance(mangled: str):
    """(kind, ord, type, tracer bound, form, algebra) of a direction_fluxes
    entry function, or None; the form is "whole axis" or "strips",
    followed for the y/z kernel by its epilogue ("bare", "accumulating" or
    "stage update"); the algebra "ref", "opt", "fast" or "ref_fast"."""
    import re
    m = re.search(r"(fluxes_x|fluxes_tiled)ILi(\d+)E([fd])Li(\d+)ELb([01])E"
                  r"(?:Li(\d)E)?Li(\d)E", mangled)
    if not m:
        return None
    kind = "x" if m.group(1) == "fluxes_x" else "y/z"
    dtype = "float32" if m.group(3) == "f" else "float64"
    form = "strips" if m.group(5) == "1" else "whole axis"
    if m.group(6) is not None:
        form += ", " + FLUX_EPILOGUES[m.group(6)]
    return (kind, int(m.group(2)), dtype, int(m.group(4)), form,
            FLUX_ALGEBRAS[m.group(7)])


def _supercell_cfg(nx, ny, nz, xlen, ylen, zlen, sim_time, dtype,
                   out_freq=-1.0, out_prefix="chip_smoke", nens=1, **keys):
    """The supercell configuration; ``keys`` are further YAML keys (the
    dycore's riemann_impl and fast_weights)."""
    from miniweatherml_tpu_torch.config import config_from_dict
    return config_from_dict(dict(
        sim_time=sim_time, nens=nens, nx_glob=nx, ny_glob=ny, nz=nz, xlen=xlen,
        ylen=ylen, zlen=zlen, init_data="supercell", out_prefix=out_prefix,
        dt_phys=0.0, out_freq=out_freq, dtype=dtype, **keys))


def _bench_cfg(nx, ny, nz, steps, dtype, **keys):
    """bench.py's grid (400 m x 400 m x 200 m cells) for ``steps`` steps."""
    dt = 0.6 * 200.0 / 430.0
    return _supercell_cfg(nx, ny, nz, 400.0 * nx, 400.0 * ny, 200.0 * nz,
                          steps * dt * (1.0 - 1e-9), dtype, **keys)


def _prim(state, dycore):
    """The de-densitized variables the dycore hands each direction."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import IDR, IDT, IDU
    s, tr = dycore.convert_coupler_to_dynamics(state)
    full_r = s[IDR] + state["hy_dens_cells"][:, :, None, None]
    return torch.cat([s[IDR:IDU], s[IDU:IDT] / full_r, s[IDT:IDT + 1],
                      tr / full_r]).contiguous()


def phase_device():
    name = torch.cuda.get_device_name(0)
    print(f"[1] device: {name}; nvidia-smi: {_card()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return name


LIBRARIES = ("direction_fluxes", "direction_fluxes_opt",
             "direction_fluxes_ref_fast", "kessler", "p3_lookup",
             "p3_cellwise", "fct", "p3_sed", "surrogate", "dycore_state")
# the flux kernel's libraries: the reference algebra, the
# reduced-operation one with exact and approximate reciprocals, and the
# reference one with approximate reciprocals
FLUX_LIBRARIES = {"direction_fluxes": ("ref",),
                  "direction_fluxes_opt": ("opt", "fast"),
                  "direction_fluxes_ref_fast": ("ref_fast",)}


def _entry_label(lib: str, mangled: str) -> str:
    """A readable name of an entry function: the P3 per-cell phase or the
    sedimentation kernel with its template arguments, else its name."""
    import re
    m = re.search(r"(Part1|Update|WrapperOut|Wrapper|RatesPre|RatesPost|Part3)"
                  r"(?:ILb([01])E(?:Lb([01])E)?E)?E([fd])E", mangled)
    if lib == "p3_cellwise" and m:
        flag = "tables" if m.group(1) == "Part3" else "predict_nc"
        pnc = "" if m.group(2) is None else f" {flag}={m.group(2)}"
        diag = "" if m.group(3) is None else f" diagnostics={m.group(3)}"
        kernel = "cell_kernel" if "cell_kernel" in mangled else "cellwise"
        return (f"{kernel} {m.group(1)}{pnc}{diag} "
                f"<{'float' if m.group(4) == 'f' else 'double'}>")
    m = re.search(r"surrogate_(fixed|general)I([fd])(?:Li(\d+)|Lb([01]))E",
                  mangled)
    if lib == "surrogate" and m:
        t = "float" if m.group(2) == "f" else "double"
        if m.group(1) == "fixed":
            return f"surrogate_fixed <{t}> 5-{m.group(3)}-4"
        where = "global scratch" if m.group(4) == "1" else "shared memory"
        return f"surrogate_general <{t}> activations in {where}"
    m = re.search(r"kessler_min_step_kernelI([fd])E", mangled)
    if lib == "kessler" and m:
        return (f"kessler_min_step_kernel "
                f"<{'float' if m.group(1) == 'f' else 'double'}>")
    m = re.search(r"(sed_step_kernel|sed_columns_kernel)I([fd])Lb([01])E"
                  r"(?:Lb([01])E)?", mangled)
    if lib == "p3_sed" and m:
        tier = "tables" if m.group(3) == "1" else "approx"
        pnc = "" if m.group(4) is None else f" predict_nc={m.group(4)}"
        return (f"{m.group(1)} <{'float' if m.group(2) == 'f' else 'double'}>"
                f" {tier}{pnc}")
    return _kernel_name(mangled)


def _build_seconds(source):
    """Host seconds of this process's build of ``source`` (its span
    ``build.<source>``, recorded under a profiler session); 0.0 when it was
    not built under one (cached)."""
    span = profiling.read()["spans"].get(f"build.{source}")
    return 0.0 if span is None else span["host_ms"] / 1e3


def phase_build():
    from miniweatherml_tpu_torch import cuda_build, native
    t0 = time.perf_counter()
    # a profiler session, so that the builds' spans record their times
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), \
            ThreadPoolExecutor(len(LIBRARIES) + 4) as pool:
        # the P3 native twin (g++) and the SASS probes of the sedimentation
        # and the per-cell phases build beside the CUDA libraries
        twin = pool.submit(native.load_p3_library)
        probes = [pool.submit(_sed_ops), pool.submit(_cell_ops)]
        rcp = pool.submit(_rcp_library)
        list(pool.map(cuda_build.load_library, LIBRARIES))
        twin.result()
        for probe in probes:
            probe.result()
        rcp.result()
    for name in LIBRARIES:
        print(f"[2] built {name}: nvcc {_build_seconds(name):.2f} s",
              flush=True)
    print(f"[2] built the P3 native twin: g++ "
          f"{_build_seconds('p3_native'):.2f} s; "
          f"{profiling.counter('cuda_build.builds')} builds", flush=True)
    print(f"[2] all builds: {time.perf_counter() - t0:.2f} s", flush=True)
    # registers, spills and shared memory of the flux kernel's
    # instantiations in each algebra; the paths run ord 5 with tracer
    # bounds 3 (Kessler), 9 (P3) and 1 (city)
    for lib, algebras in FLUX_LIBRARIES.items():
        worst, count = None, {}
        for mangled, regs, st, ld, stack, smem in _ptxas_report(lib):
            inst = _flux_instance(mangled)
            if inst is None or inst[5] not in algebras:
                raise AssertionError(f"{lib}: unexpected entry function "
                                     f"{mangled}")
            kind, ord_, dtype, ntrb, form, alg = inst
            count[alg] = count.get(alg, 0) + 1
            if ord_ == 5:
                print(f"[2] direction_fluxes {alg} {kind} ord 5 {dtype} "
                      f"tracers <= {ntrb} {form}: {regs} registers, {st} B "
                      f"spill stores, {ld} B spill loads, {stack} B stack, "
                      f"{smem} B shared", flush=True)
            if worst is None or (st, regs) > (worst[1], worst[0]):
                worst = (regs, st, ld, inst)
        print(f"[2] {lib} ({count} entry functions), most spilled of all "
              f"orders: {worst[0]} registers, {worst[1]} B spill stores, "
              f"{worst[2]} B spill loads ({worst[3]})", flush=True)
    for lib in (lib for lib in LIBRARIES if lib not in FLUX_LIBRARIES):
        for mangled, regs, st, ld, stack, smem in _ptxas_report(lib):
            print(f"[2] {lib} {_entry_label(lib, mangled)}: {regs} registers, "
                  f"{st} B spill stores, {ld} B spill loads, {stack} B "
                  f"stack, {smem} B static shared", flush=True)
    from miniweatherml_tpu_torch.physics.kessler_cuda import kessler_staging
    for nz in (64, 100):
        levels, smem = kessler_staging(nz, torch.float32)
        print(f"[2] kessler nz {nz} float32: {levels} levels staged at once, "
              f"{smem} B dynamic shared memory per block", flush=True)


def _p3_mixed_build(cfg, device):
    """The supercell_p3 chain on the seeded mixed-regime state."""
    from miniweatherml_tpu_torch.experiments import supercell_p3
    state, mods, dycore = supercell_p3.build(cfg, device)
    return supercell_p3.seed_mixed_regimes(state), mods, dycore


def _flux_state(chain, dtype):
    """(state, modules, dycore) of a chain at its cell's width on the card:
    the 512x512x64 supercell (Kessler or mixed-regime P3), or
    inputs/input_city.yaml's 400x400x60 grid with nens 2 and the cross-flow."""
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    if chain == "city":
        return _crossflow_build(_city_cfg("city", 400, 400, 60, 2, dtype,
                                          steps=1), "cuda")
    if chain == "p3":
        build = _p3_mixed_build
    return build(_bench_cfg(512, 512, 64, 1, dtype), "cuda")


def phase_direction_fluxes(fct_recs, chain="kessler"):
    """The flux kernel on the chain's state at its cell's width, bare and in
    the accumulating and stage-update forms of the path's z and y, then the
    FCT kernels on the tracer faces it gave; the Kessler chain also runs the
    other stage forms (stage 1, no gravity, a Coriolis box, a 2-D slab)
    and the small wall/open box.  Then the same bare and path forms (and
    on the Kessler chain the small box) in the reduced-operation algebra,
    exact in f32 and f64 (bit for bit) and with the approximate
    reciprocals in f32, and in the reference algebra with the approximate
    reciprocals in f32 (opt off; both by the fast bar, their ulps
    printed); on the Kessler chain also x and y with a cutoff of
    FAST_CUTOFF and opt on, which takes the reference algebra with the
    approximate reciprocals too, with the bar's planted faults.  Returns a
    record per algebra (ALGEBRA_KW), whose times are one right-hand side's:
    x bare, z accumulating, y with the stage update."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        IDU, IDV, IDW, direction_fluxes, direction_fluxes_plain)
    from miniweatherml_tpu_torch.ops.stencil import BC_OPEN, BC_WALL

    recs = {a: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0} for a in ALGEBRA_KW}
    rec = recs["ref"]
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        state, _, dycore = _flux_state(chain, dtype)
        prim = _prim(state, dycore)
        g, c = state.grid, dycore._consts(state)
        hy = dycore._hy(state)
        dirs = (("x", -1, g.nx, c.bc_x, IDU, g.dx, hy[0], hy[1]),
                ("y", -2, g.ny, c.bc_y, IDV, g.dy, hy[0], hy[1]),
                ("z", -3, g.nz, c.bc_z, IDW, g.dz, hy[2], hy[3]))
        faces, bare_ms = {}, {}
        for name, axis, n, bc, nid, d, hr, ht in dirs:
            args = (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht,
                    dycore.mats, 0.0, 1.0 / d)
            ref = direction_fluxes_plain(*args)
            got = direction_fluxes(*args)
            torch.cuda.synchronize()
            errs = [_rel(a, b) for a, b in zip(ref, got)]
            rel = max(e[1] for e in errs)
            same = all(torch.equal(a, b) for a, b in zip(ref, got))
            faces[axis] = got[1]
            if axis == -1:
                xdiv = got[0]
            del ref, got
            ms = _time_ms(lambda: direction_fluxes(*args))
            pms = _time_ms(lambda: direction_fluxes_plain(*args), reps=3)
            nbytes, ops = _flux_work(prim, axis, dycore.mats.ord)
            bms, by = _bound(nbytes, ops, dtype)
            kernel = "fluxes_x" if axis == -1 else "fluxes_tiled"
            print(f"[3] direction_fluxes {chain} nvar {prim.shape[0]} "
                  f"{dtype} {name} (axis {axis}, bc {bc}, {kernel}): bitwise "
                  f"{'equal' if same else 'DIFFERENT'}, max abs err "
                  f"{max(e[0] for e in errs):.3e}, rel {rel:.3e}; kernel "
                  f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
                  f"({by}: {nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP), "
                  f"{bms / ms:.1%} of the bound  [{_card()}]", flush=True)
            if not (same and rel <= tol):
                raise AssertionError(f"direction_fluxes {chain} {dtype} "
                                     f"axis {axis}: not bitwise equal "
                                     f"(rel err {rel:.3e})")
            bare_ms[axis] = (ms, pms, bms)
            if dtype == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         max(e[0] for e in errs))
                rec["ms"] += ms
                rec["plain_ms"] += pms
                rec["bound_ms"] += bms
                rec["bound_by"] = by
        # the forms one right-hand side runs after x: z accumulating into
        # x's divergence, y with the stage update (stages 2-3, with b1)
        b0, b1 = _stage_bases(state, dycore)
        dt = dycore.compute_time_step(state)
        fargs = {name: (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht,
                        dycore.mats, 0.0, 1.0 / d)
                 for name, axis, n, bc, nid, d, hr, ht in dirs}
        path = [("z accumulating", fargs["z"], None),
                ("y stage update, b1", fargs["y"],
                 _stage(state, dycore, b0, b1, dt))]
        if chain == "kessler":
            path += [("y stage update, stage 1 (no b1)", fargs["y"],
                      _stage(state, dycore, b0, None, dt)),
                     ("y stage update, b1, no gravity", fargs["y"],
                      _stage(state, dycore, b0, b1, dt, grav=False))]
        for i, (tag, fa, rk) in enumerate(path):
            err, ms, pms, bms, by = _flux_form(
                "3", f"{chain} nvar {prim.shape[0]} {tag}", fa, xdiv, rk,
                dtype, tol)
            if dtype == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if i < 2:  # the path's forms in place of the bare y and z
                    rec["ms"] += ms - bare_ms[fa[1]][0]
                    rec["plain_ms"] += pms - bare_ms[fa[1]][1]
                    rec["bound_ms"] += bms - bare_ms[fa[1]][2]
        # the reduced-operation algebra: exact in f32 and f64, with the
        # approximate reciprocals in f32 (f64 runs exact), and the
        # reference algebra with the approximate reciprocals (f32)
        for algebra in (("opt", "fast", "ref_fast") if dtype == "float32"
                        else ("opt",)):
            arec, abare = recs[algebra], {}
            for name, axis, *_ in dirs:
                got, err, ms, pms, bms, by = _flux_bare(
                    "3", f"{chain} nvar {prim.shape[0]} {name}",
                    fargs[name], dtype, tol, algebra,
                    faults=chain == "kessler" and name in ("x", "y"))
                if axis == -1:
                    adiv = got[0]
                del got
                abare[axis] = (ms, pms, bms)
                if dtype == "float32":
                    arec["max_abs_err"] = max(arec["max_abs_err"], err)
                    arec["ms"] += ms
                    arec["plain_ms"] += pms
                    arec["bound_ms"] += bms
                    arec["bound_by"] = by
            for tag, fa, rk in path[:2]:
                err, ms, pms, bms, by = _flux_form(
                    "3", f"{chain} nvar {prim.shape[0]} {tag} ({algebra})",
                    fa, adiv, rk, dtype, tol, algebra=algebra)
                if dtype == "float32":  # in place of the bare y and z
                    arec["max_abs_err"] = max(arec["max_abs_err"], err)
                    arec["ms"] += ms - abare[fa[1]][0]
                    arec["plain_ms"] += pms - abare[fa[1]][1]
                    arec["bound_ms"] += bms - abare[fa[1]][2]
            del adiv
        if chain == "kessler" and dtype == "float32":
            # Dycore(riemann_impl="pallas", cutoff=FAST_CUTOFF): opt asked
            # for, the reference algebra run, with the approximate
            # reciprocals
            for name in ("x", "y"):
                cargs = fargs[name][:10] + (FAST_CUTOFF, fargs[name][11])
                got, err = _flux_bare(
                    "3", f"{chain} nvar {prim.shape[0]} {name} cutoff "
                    f"{FAST_CUTOFF}", cargs, dtype, tol, "ref_fast",
                    timed=False, faults=True, kw=ALGEBRA_KW["fast"])[:2]
                recs["ref_fast"]["max_abs_err"] = max(
                    recs["ref_fast"]["max_abs_err"], err)
                del got
        phase_fct(chain, dtype, tol, state, dycore, faces, fct_recs)
        del faces, fargs, path
        if chain != "kessler":
            del state, prim, hy, dycore, b0, b1, xdiv
            torch.cuda.empty_cache()
            continue
        # a small box with a Coriolis parameter, and a 2-D slab (ny = 1)
        # whose last direction is z
        box = (slice(None), slice(None), slice(0, 12), slice(0, 10),
               slice(0, 14))
        small = prim[box].contiguous()
        sacc = xdiv[box].contiguous()
        for axis, nid in ((-2, IDV), (-3, IDW)):
            nl = small.shape[2] + (1 if axis == -3 else 0)
            hr = hy[2 if axis == -3 else 0][:, :nl].contiguous()
            ht = hy[3 if axis == -3 else 1][:, :nl].contiguous()
            args = (small, axis, small.shape[axis], BC_WALL, nid, c.C0,
                    c.gamma, hr, ht, dycore.mats, 0.0, 1.0 / 400.0)
            rk = _stage(state, dycore, b0, b1, dt, fcor=1.0e-4,
                        crop=lambda t: t[box])
            rk = rk._replace(hy_r=rk.hy_r[:, :12].contiguous())
            _flux_form("3", f"small box 12x10x14 axis {axis} stage update, "
                       "b1, Coriolis 1e-4", args, sacc, rk, dtype, tol,
                       timed=False)
        slab = (slice(None), slice(None), slice(None), slice(0, 1))
        args = (prim[slab].contiguous(), -3, g.nz, c.bc_z, IDW, c.C0,
                c.gamma, hy[2], hy[3], dycore.mats, 0.0, 1.0 / g.dz)
        _flux_form("3", f"2-D slab {g.nx}x1x{g.nz} z stage update (the last "
                   "direction), b1, v = 0", args, xdiv[slab].contiguous(),
                   _stage(state, dycore, b0, b1, dt, sim2d=True,
                          crop=lambda t: t[slab]),
                   dtype, tol, timed=False)
        del b0, b1, xdiv
        # the boundary conditions the supercell does not use: a small
        # open/wall box in every direction
        small = prim[:, :, :12, :10, :14].contiguous()
        for axis, nid in ((-1, IDU), (-2, IDV), (-3, IDW)):
            nl = small.shape[2] + (1 if axis == -3 else 0)
            hr = hy[2 if axis == -3 else 0][:, :nl].contiguous()
            ht = hy[3 if axis == -3 else 1][:, :nl].contiguous()
            for bc in (BC_OPEN, BC_WALL):
                args = (small, axis, small.shape[axis], bc, nid, c.C0,
                        c.gamma, hr, ht, dycore.mats, 0.0, 1.0 / 400.0)
                ref = direction_fluxes_plain(*args)
                got = direction_fluxes(*args)
                rel = max(_rel(a, b)[1] for a, b in zip(ref, got))
                same = all(torch.equal(a, b) for a, b in zip(ref, got))
                print(f"[3] direction_fluxes {dtype} small axis {axis} bc "
                      f"{bc}: bitwise {'equal' if same else 'DIFFERENT'}, "
                      f"rel {rel:.3e}", flush=True)
                if not (same and rel <= tol):
                    raise AssertionError(f"direction_fluxes small {dtype} "
                                         f"axis {axis} bc {bc}: {rel:.3e}")
                for algebra in ("opt", "fast", "ref_fast")[
                        :3 if dtype == "float32" else 1]:
                    _flux_bare("3", f"small axis {axis} bc {bc}", args,
                               dtype, tol, algebra, timed=False)
        del state, prim, hy, dycore
        torch.cuda.empty_cache()
    return recs


FCT_FORMS = ("first", "accumulate", "rk_tr1", "rk_no_tr1")
# The forms one right-hand side of the 3-D path runs: x first, z
# accumulating, y accumulating with the stage update (stages 2 and 3).
FCT_PATH = {-1: "first", -3: "accumulate", -2: "rk_tr1"}


def phase_fct(chain, dtype, tol, state, dycore, faces, recs):
    """The FCT kernels against their plain versions on the tracer faces the
    flux kernel gave for the chain's state, with a mixed positive mask: the
    multiplier at the stage's dt and at 100 dt (so that many cells are
    limited), then the scaled divergence along x, z and y in every form.
    Times are per call; the path's forms add up to one right-hand side."""
    from miniweatherml_tpu_torch.ops import fct

    g = state.grid
    tr = state.tracer_stack().contiguous()
    ntr = tr.shape[0]
    positive = tuple(i % 3 != 1 for i in range(ntr))
    dt = dycore.compute_time_step(state)
    f32 = dtype == "float32"
    # the chain's own flags at the stage's dt (timed: the main path's
    # call), then the mixed mask at dt and at 100 dt
    own = tuple(t.positive for t in state.meta.tracers)
    for flags, scale in ((own, 1.0), (positive, 1.0), (positive, 100.0)):
        args = (tr, flags, faces[-1], faces[-2], faces[-3], scale * dt,
                g.dx, g.dy, g.dz)
        ref = fct.fct_mult_plain(*args)
        mult = fct.fct_mult(*args)
        torch.cuda.synchronize()
        err, rel = _rel(ref, mult)
        same = torch.equal(ref, mult)
        limited = (mult < 1.0).double().mean().item()
        del ref
        line = (f"[14] fct_mult {chain} ntr {ntr} nens {g.nens} {dtype} "
                f"flags {''.join('1' if f else '0' for f in flags)} dt "
                f"x{scale:g}: bitwise {'equal' if same else 'DIFFERENT'}, "
                f"max abs err {err:.3e}, rel {rel:.3e}, {limited:.2e} of "
                "values limited")
        if flags is own and scale == 1.0:
            ms = _time_ms(lambda: fct.fct_mult(*args))
            pms = _time_ms(lambda: fct.fct_mult_plain(*args), reps=3)
            # ~20 operations per tracer value (csrc/fct.cu fct_mult)
            bms, by = _bound(_nbytes(args, mult), 20 * tr.numel(), dtype)
            line += (f"; kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                     f"{bms:.3f} ms ({by}), {bms / ms:.1%} of the bound  "
                     f"[{_card()}]")
            if f32 and chain == "kessler":
                recs["fct_mult"].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                        bound_by=by)
        print(line, flush=True)
        if not (same and rel <= tol):
            raise AssertionError(f"fct_mult {chain} {dtype}: not bitwise "
                                 f"equal (rel {rel:.3e})")
        if f32:
            r = recs["fct_mult"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
    t_prev = fct.fct_scale_div_plain(faces[-1], mult, None, -1, g.nx,
                                     1.0 / g.dx)
    tr1 = tr.flip(-1).contiguous()
    for axis, n, d in ((-1, g.nx, g.dx), (-3, g.nz, g.dz), (-2, g.ny, g.dy)):
        for form in FCT_FORMS:
            rk = None
            if form.startswith("rk"):
                rk = (0.75, 0.25, 0.25 * dt, tr,
                      tr1 if form == "rk_tr1" else None, positive)

            def call(fn, prev=None if form == "first" else t_prev):
                p = None if prev is None else prev.clone()
                return fn(faces[axis], mult, p, axis, n, 1.0 / d, rk=rk)
            ref = call(fct.fct_scale_div_plain)
            got = call(fct.fct_scale_div)
            torch.cuda.synchronize()
            err, rel = _rel(ref, got)
            del ref, got
            line = (f"[14] fct_scale_div {chain} ntr {ntr} {dtype} axis "
                    f"{axis} {form}: max abs err {err:.3e}, rel {rel:.3e} "
                    f"(tol {tol:g})")
            if FCT_PATH[axis] == form:
                buf = None if form == "first" else t_prev.clone()
                ms = _time_ms(lambda: fct.fct_scale_div(
                    faces[axis], mult, buf, axis, n, 1.0 / d, rk=rk))
                pms = _time_ms(lambda: fct.fct_scale_div_plain(
                    faces[axis], mult, buf, axis, n, 1.0 / d, rk=rk), reps=3)
                line += f"; kernel {ms:.3f} ms, plain {pms:.3f} ms"
                # ~15 operations per tracer value (csrc/fct.cu); the
                # output is the running buffer, read and written
                out_b = _nbytes(tr)
                bms, by = _bound(
                    _nbytes(faces[axis], mult, rk) + out_b
                    + (0 if buf is None else out_b), 15 * tr.numel(), dtype)
                line += (f", bound {bms:.3f} ms ({by}), {bms / ms:.1%} of "
                         "the bound")
                if f32 and chain == "p3":
                    r = recs["fct_scale_div"]
                    r["ms"] += ms
                    r["plain_ms"] += pms
                    r["bound_ms"] = r.get("bound_ms", 0.0) + bms
                    r["bound_by"] = by
            print(line, flush=True)
            if not rel <= tol:
                raise AssertionError(f"fct_scale_div {chain} {dtype} axis "
                                     f"{axis} {form}: rel {rel:.3e}")
            if f32:
                r = recs["fct_scale_div"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
    del tr, tr1, mult, t_prev


def _ulps(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """(values that differ, their largest difference in units of the last
    place of a)."""
    diff = a != b
    n = int(diff.sum())
    if n == 0:
        return 0, 0.0
    a, b = a[diff], b[diff]
    ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a).abs()
    return n, float(((a - b).abs() / ulp).max())


def _kessler_check(tag, args, tol):
    """The fused step against its plain version on ``args``: every output
    equal bit for bit, or (reported with its count and size in ulps) within
    ``tol`` of its scale.  Returns (max abs err, plain result)."""
    from miniweatherml_tpu_torch.physics.kessler_cuda import (
        kessler_step, kessler_step_plain)
    ref = kessler_step_plain(*args)
    got = kessler_step(*args)
    torch.cuda.synchronize()
    names = ("rho_v", "rho_c", "rho_r", "temp", "precl")
    errs = [_rel(a, b) for a, b in zip(ref, got)]
    rel = max(e[1] for e in errs)
    diffs = {n: _ulps(a, b) for n, a, b in zip(names, ref, got)
             if not torch.equal(a, b)}
    print(f"[4] kessler {tag}: "
          + ("bitwise equal" if not diffs else
             "DIFFERENT in " + ", ".join(f"{n} ({c} values, at most "
                                          f"{u:.0f} ulp)"
                                          for n, (c, u) in diffs.items()))
          + f", max abs err {max(e[0] for e in errs):.3e}, rel {rel:.3e} "
          f"(tol {tol:g})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"kessler {tag}: rel err {rel:.3e} > {tol:g}")
    return max(e[0] for e in errs)


def _kessler_work(args, nsub):
    """(bytes, operations) of one fused step: the five coupler fields read
    once, the four fields and precl written once; ~80 operations per cell
    and sub-step plus ~25 for the prep (two pow, five divisions, a sqrt)
    and the post (csrc/kessler.cu; pow, exp and sqrt counted as one)."""
    cells = args[0].numel()
    item = args[0].element_size()
    return item * (9 * cells + cells // args[0].shape[1]), (
        (80 * nsub + 25) * cells)


def _rain_columns(dtype, rng):
    """Heavy-rain 512x512x64 columns (dz 200 m, dt 30 s) that sub-cycle:
    (rho, temp, qv, qc, qr, zmid, dz, dt), the fields on the card in
    ``dtype``, qr up to 5.5e-3 with ``rng``'s draws."""
    nens, nz, ny, nx = 1, 64, 512, 512
    dz, dt = 200.0, 30.0
    zc = ((np.arange(nz) + 0.5) * dz)[None, :, None, None]

    def dev(a):
        a = np.array(np.broadcast_to(a, (nens, nz, ny, nx)))
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    rho = dev(1.2 * np.exp(-zc / 8000.0))
    temp = dev((300.0 + 10.0 * zc / 20000.0
                + rng.uniform(0.0, 1.0, (nens, nz, ny, nx)))
               * np.exp(-zc / 8000.0) ** (287.0 / 1003.0))
    qv = dev(0.016 * np.exp(-zc / 3000.0))
    qc = dev(np.where(zc < 5000.0, 1e-4, 0.0))
    qr = dev(np.where(zc < 3000.0, 5e-4, 0.0)
             + 5e-3 * rng.random((nens, nz, ny, nx)))
    zt = torch.as_tensor(zc, dtype=dtype, device="cuda")
    return rho, temp, qv, qc, qr, zt, dz, dt


def phase_kessler():
    """The fused Kessler step on the Kessler chain's own 512x512x64 f32
    state after one step (the main path's call: the kernel, and the whole
    MicrophysicsKessler.time_step with its rainsplit), then on heavy-rain
    columns at rainsplit 3, f32 and f64."""
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    from miniweatherml_tpu_torch.physics.kessler import kessler_rainsplit
    from miniweatherml_tpu_torch.physics.kessler_cuda import (
        kessler_step, kessler_step_plain)

    R = (287.0, 461.0, 1003.0, 1e5)
    rec = {"max_abs_err": 0.0}
    state, mods, dycore = build(_bench_cfg(512, 512, 64, 1, "float32"),
                                "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    g = state.grid
    rho_d = state["density_dry"]
    zmid = ((torch.arange(g.nz, dtype=rho_d.dtype, device="cuda") + 0.5)
            * g.dz)[None, :, None, None]
    rs = kessler_rainsplit(state["precip_liquid"] / rho_d, rho_d, zmid, dt)
    args = (rho_d, state["temp"], state["water_vapor"],
            state["cloud_liquid"], state["precip_liquid"], rs, dt, g.dz, *R)
    nsub = int(rs)
    rec["max_abs_err"] = _kessler_check(
        f"chain state 512x512x64 float32 rainsplit {nsub}", args, 1e-5)
    ms = _time_ms(lambda: kessler_step(*args), reps=10)
    pms = _time_ms(lambda: kessler_step_plain(*args), reps=3)
    step_ms = _time_ms(lambda: mods[1](state, dt), reps=10)
    nbytes, ops = _kessler_work(args, nsub)
    bms, by = _bound(nbytes, ops, torch.float32)
    rec.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
    print(f"[4] kessler main path (rainsplit {nsub}): kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms, bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f}"
          f" GB, {ops / 1e9:.2f} GFLOP), {bms / ms:.1%} of the bound; "
          f"MicrophysicsKessler.time_step {step_ms:.3f} ms  [{_card()}]",
          flush=True)
    del state, mods, dycore, args, rho_d
    torch.cuda.empty_cache()

    rng = np.random.default_rng(7)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        rho, temp, qv, qc, qr, zt, dz, dt = _rain_columns(dtype, rng)
        rs = kessler_rainsplit(qr, rho, zt, dt)
        args = (rho, temp, qv * rho, qc * rho, qr * rho, rs, dt, dz, *R)
        nsub = int(rs)
        if nsub < 2:
            raise AssertionError("kessler check did not sub-cycle")
        err = _kessler_check(f"columns {dtype} rainsplit {nsub}", args, tol)
        ms = _time_ms(lambda: kessler_step(*args))
        pms = _time_ms(lambda: kessler_step_plain(*args), reps=3)
        bms, by = _bound(*_kessler_work(args, nsub), dtype)
        print(f"[4] kessler columns {dtype} rainsplit {nsub}: kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms ({by}), "
              f"{bms / ms:.1%} of the bound", flush=True)
        if dtype == torch.float32:
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del args, rho, temp, qv, qc, qr
    return rec


# the dycore's state transforms at the benchmark's grid, with the tracer
# registries of the Kessler chain (3 tracers: 8 fields) and the P3 chain
# (9 tracers, 4 adding mass: 14 fields): (adds_mass, vapor index)
STATE_REGISTRIES = {
    "8 fields (Kessler)": ((True, True, True), 0),
    "14 fields (P3)": ((True, False, True, False, True, False, False, False,
                        True), 8),
}


def phase_dycore_state():
    """The dycore's state transforms (ops/dycore_state.py) at 1024x1024x100
    f32 with 8 and 14 fields: each kernel bit for bit against its plain
    version on the same inputs, one launch a call, timed beside the plain
    version and its bytes bound (every field it reads once, every field it
    writes once; the conversion to the coupler reads only the tracers that
    add mass and vapor).  Returns the kernels line's entry: one step's five
    calls (three de-densitizations and both conversions) at 8 fields."""
    from miniweatherml_tpu_torch.ops import dycore_state as ds

    shape = (1, 100, 1024, 1024)
    gen = torch.Generator(device="cuda").manual_seed(34)

    def rand(lo, hi, size=shape):
        return lo + (hi - lo) * torch.rand(size, generator=gen,
                                           device="cuda")
    gamma = 1003.0 / 716.0
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes"}
    for label, (adds, idwv) in STATE_REGISTRIES.items():
        fields = (rand(1.0, 1.2), rand(-20.0, 20.0), rand(-20.0, 20.0),
                  rand(-10.0, 10.0), rand(220.0, 300.0))
        trs = [rand(0.0, 1e-2) if i == idwv else
               rand(0.0, 1e-3) * (rand(0.0, 1.0) < 0.5)
               for i in range(len(adds))]
        hyc = rand(1.0, 1.2, shape[:2])
        hyt = 300.0 * hyc
        th = dict(idWV=idwv, adds_mass=list(adds), R_d=287.0, R_v=461.0,
                  gamma=gamma, C0=(287.0 * 1e5 ** (-287.0 / 1003.0)) ** gamma)
        s, tr = ds.coupler_to_dynamics(*fields, trs, hyc, hyt, **th)
        read = [t for i, t in enumerate(tr) if adds[i] or i == idwv]
        calls = (
            ("coupler -> dynamics",
             lambda: ds.coupler_to_dynamics(*fields, trs, hyc, hyt, **th),
             lambda: ds.coupler_to_dynamics_plain(*fields, trs, hyc, hyt,
                                                  **th),
             (fields, trs, hyc, hyt)),
            ("de-densitization", lambda: (ds.dedensitize(s, tr, hyc),),
             lambda: (ds.dedensitize_plain(s, tr, hyc),), (s, tr, hyc)),
            ("dynamics -> coupler",
             lambda: ds.dynamics_to_coupler(s, tr, hyc, hyt, **th),
             lambda: ds.dynamics_to_coupler_plain(s, tr, hyc, hyt, **th),
             (s, read, hyc, hyt)))
        for name, kern, plain, inputs in calls:
            n0 = profiling.counter("dycore_state.launches")
            got = kern()
            launches = profiling.counter("dycore_state.launches") - n0
            want = plain()
            torch.cuda.synchronize()
            diffs = [_ulps(w, g) for w, g in zip(want, got)]
            if launches != 1 or any(n for n, _ in diffs):
                raise AssertionError(f"[34] {name}, {label}: {launches} "
                                     f"launches, (values apart, ulps) per "
                                     f"output {diffs}")
            nbytes = _nbytes(inputs, got)
            del got, want
            ms = _time_ms(kern, reps=10)
            pms = _time_ms(plain, reps=3)
            bms = 1e3 * nbytes / HBM_BYTES_S
            print(f"[34] {name}, {label}: bit for bit; kernel {ms:.3f} ms, "
                  f"plain {pms:.3f} ms, bound {bms:.3f} ms (bytes: "
                  f"{nbytes / 1e9:.3f} GB), {bms / ms:.1%} of the bound  "
                  f"[{_card()}]", flush=True)
            if label.startswith("8"):
                k = 3 if name == "de-densitization" else 1
                rec["ms"] += k * ms
                rec["plain_ms"] += k * pms
                rec["bound_ms"] += k * bms
        del fields, trs, s, tr, read, calls
        torch.cuda.empty_cache()
    print(f"[34] one step's five calls at 8 fields: kernels {rec['ms']:.3f} "
          f"ms, plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} "
          f"ms", flush=True)
    return rec


def _launch_counters(*kernels):
    """{kernel: the registry name of its launch counter}."""
    return {k: f"{k}.launches" for k in kernels}


def _counters(chain):
    """The launch counters of the kernels on a chain's path."""
    dycore = {**_launch_counters("direction_fluxes", "fct_mult",
                                 "fct_scale_div", "dycore_state"),
              "fluxes_tiled": "direction_fluxes.tiled_launches"}
    if chain == "city":
        return dycore
    kessler = _launch_counters("min_step", "kessler_step")
    if chain == "kessler":
        return {**dycore, **kessler}
    if chain == "surrogate":
        return {**dycore, **kessler, **_launch_counters("surrogate_forward")}
    if chain == "p3_native":  # the column step runs in the C++ twin
        return {**dycore, **_launch_counters("p3_wrapper", "p3_wrapper_out")}
    return {**dycore, **_launch_counters(
        "interp_ice", "interp_collect", "interp_rain", "p3_part1",
        "p3_update", "p3_wrapper", "p3_rates_pre", "p3_rates_post",
        "sed_step", "sed_columns", "p3_part3", "p3_wrapper_out")}


def _totals(counters):
    """{key: the registry total of its counter} of ``counters``."""
    return {k: profiling.counter(name) for k, name in counters.items()}


def _since(counters, before):
    """{key: its counter's count since ``before`` (``_totals``)}."""
    return {k: n - before[k] for k, n in _totals(counters).items()}


def _check_state(tag, state):
    problems = state.validate()
    maxw = float(state["wvel"].abs().max())
    if problems or not math.isfinite(maxw):
        raise AssertionError(f"{tag}: validate() {problems}, maxw {maxw}")
    g = state.grid
    if tuple(state["temp"].shape) != g.field_shape:
        raise AssertionError(f"{tag}: temp shape {tuple(state['temp'].shape)}")
    return maxw


# launches per step of the dycore's kernels at one CFL cycle, in every cell:
# every y and z call of the 9 flux calls runs the tiled kernel
DYCORE_PER_STEP = {"direction_fluxes": 9, "fluxes_tiled": 6, "fct_mult": 3,
                   "fct_scale_div": 9, "dycore_state": 5}
# launches a chain's build makes before its first step: Dycore.init turns
# its initial state into the coupler's fields
BUILD_LAUNCHES = {"dycore_state": 1}


# the port's own kernels, by a part of their names
OWN_KERNELS = ("fluxes", "fct", "kessler", "cellwise", "ice_kernel",
               "collect_kernel", "rain_kernel", "sed_step", "sed_columns",
               "surrogate", "dyn_prim", "dyn_from_coupler", "dyn_to_coupler")


def _glue_per_step(mods, state, dt):
    """torch.profiler over one more step of the chain: the launches and
    device ms of PyTorch's elementwise kernels (the glue: names holding
    "elementwise" or "vectorized", as scripts/torch_port_measure.py
    profile counts them) and of its other kernels (cat, reductions, copies,
    matmuls); the port's own kernels are not counted."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for m in mods:
            state = m(state, dt)
        torch.cuda.synchronize()
    glue, other = [0, 0.0], [0, 0.0]
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = ev.name.lower()
        if any(k in n for k in OWN_KERNELS):
            continue
        b = glue if ("elementwise" in n or "vectorized" in n) else other
        b[0] += 1
        b[1] += (ev.time_range.end - ev.time_range.start) / 1e3
    return glue, other


def _run_cell(tag, cfg, card, chain="kessler", build=None, finish=None,
              per_step=None, glue=False):
    """run_benchmark on the chain's path with its launch counters read
    just before and just after; ``finish(state)`` runs on the final
    state.  Every step (and the discarded warm-up step) launches each kernel
    of ``per_step`` (default: the dycore's) that many times, besides the
    build's ``BUILD_LAUNCHES``; every other
    kernel of the path at least once in the run.  ``glue``: then one more
    step under the profiler counts PyTorch's own launches (the glue)
    beside the kernels' per step."""
    from miniweatherml_tpu_torch.experiments.community_benchmark import (
        run_benchmark)
    from miniweatherml_tpu_torch.experiments.supercell_example import (
        build as default_build)
    counters = _counters(chain)
    chain_of = {}

    def keep(cfg_, device):
        out = (build or default_build)(cfg_, device)
        chain_of.update(mods=out[1], dycore=out[2])
        return out
    torch.cuda.reset_peak_memory_stats()
    before = _totals(counters)
    state, res = run_benchmark(cfg, "cuda", quiet=True, build=keep)
    launches = _since(counters, before)
    peak = torch.cuda.max_memory_allocated()
    maxw = _check_state(tag, state)
    per_step = per_step or DYCORE_PER_STEP
    if any(n < 1 for k, n in launches.items() if per_step.get(k, 1) > 0):
        raise AssertionError(f"{tag}: a kernel of the path never launched: "
                             f"{launches}")
    if any(launches[k] != v * (res["steps"] + 1) + BUILD_LAUNCHES.get(k, 0)
           for k, v in per_step.items()):
        raise AssertionError(f"{tag}: launches {launches} for "
                             f"{res['steps']} + 1 steps, expected {per_step} "
                             f"per step and {BUILD_LAUNCHES} in the build")
    if glue:
        (gn, gms), (on, oms) = _glue_per_step(
            chain_of["mods"], state, chain_of["dycore"].compute_time_step(
                state))
        per = {k: v // (res["steps"] + 1) for k, v in launches.items()}
        print(f"[{tag}] one more step (torch.profiler): PyTorch glue "
              f"{gn} elementwise launches, {gms:.3f} ms device; {on} other "
              f"PyTorch launches (cat, reductions, copies, matmuls), "
              f"{oms:.3f} ms; beside the kernels' {per} per step  [{card}]",
              flush=True)
    if finish is not None:
        finish(state)
    g = cfg.grid
    ens = f"x{g.nens}" if g.nens > 1 else ""
    print(f"[{tag}] {g.nx}x{g.ny}x{g.nz}{ens} {cfg.dtype}: {res['steps']} "
          f"steps in "
          f"{res['elapsed_s']:.3f} s = {res['mcellups']:.3f} Mcellups, "
          f"{1e3 * res['elapsed_s'] / max(res['steps'], 1):.1f} ms/step; peak "
          f"memory {peak / 2**30:.2f} GiB; maxw {maxw:.6e}; launches "
          f"{launches}; validate() clean  [{card}]", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches, res, peak


# The dycore forms of phase 33's Kessler slice, by the YAML keys that ask
# for them: the JAX package's device form (the reduced-operation algebra
# with approximate-reciprocal weights), the same with exact weights, and
# Dycore() (the reference algebra); then by the Dycore keywords that no
# YAML key reaches: riemann_impl "pallas" with opt_algebra=False and with a
# cutoff, both the reference algebra with approximate-reciprocal weights;
# with the flux launches each form counts (the counters
# direction_fluxes.opt_launches, .fast_launches and .ref_fast_launches).
OPT_SLICE_FORMS = (("opt + fast weights", {"riemann_impl": "pallas"}, "fast"),
                   ("opt, exact weights", {"riemann_impl": "pallas",
                                           "fast_weights": False}, "opt"),
                   ("reference (Dycore())", {}, "ref"),
                   ("opt_algebra=False + fast weights",
                    {"dycore": {"riemann_impl": "pallas",
                                "opt_algebra": False}}, "ref_fast"),
                   (f"cutoff {FAST_CUTOFF} + fast weights",
                    {"dycore": {"riemann_impl": "pallas",
                                "cutoff": FAST_CUTOFF}}, "ref_fast"))


FLUX_FORM_COUNTERS = {a: f"direction_fluxes.{a}_launches"
                      for a in ("opt", "fast", "ref_fast")}


def _dycore_build(dycore_kw):
    """supercell_example.build with its dycore replaced by
    Dycore(ord, **dycore_kw) (a stateless step: the first dycore's init
    serves it)."""
    from miniweatherml_tpu_torch.dycore.euler import Dycore
    from miniweatherml_tpu_torch.experiments.supercell_example import build

    def with_dycore(cfg, device):
        state, mods, dycore = build(cfg, device)
        dy = Dycore(ord=dycore.ord, **dycore_kw)
        mods = [dy.time_step if m == dycore.time_step else m for m in mods]
        return state, mods, dy
    return with_dycore


def phase_opt_slice(card):
    """The main path of the flux kernel's JAX device form:
    community_benchmark.run_benchmark on the 512x512x64 f32 Kessler
    supercell with the YAML's riemann_impl "pallas" (the reduced-operation
    algebra with approximate-reciprocal weights), the same with exact
    weights, Dycore(), and riemann_impl "pallas" with opt_algebra=False and
    with a cutoff (the reference algebra with approximate-reciprocal
    weights), in the order A B C D E E D C B A: each with its launch
    counts (every flux launch in its form), a clean validate(), Mcellups,
    ms/step and peak memory, and the largest differences between the forms'
    states after the 10 steps (printed, not bounded: the algebras round
    apart and the flow amplifies it); then a 16x8x10 f64 riemann_impl
    "pallas" slice (f64 runs exact weights), card against the port's CPU
    run, 3 steps, at 1e-7 of each field's scale.  Returns the launches per
    algebra of the first run of each form."""
    from miniweatherml_tpu_torch.experiments.community_benchmark import (
        run_benchmark)
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    counters = _counters("kessler")
    finals, launches_of, ms_of = {}, {}, {}
    order = OPT_SLICE_FORMS + OPT_SLICE_FORMS[::-1]
    for run, (label, keys, algebra) in enumerate(order):
        keys = dict(keys)
        dycore_kw = keys.pop("dycore", None)
        cfg = _bench_cfg(512, 512, 64, 10, "float32", **keys)
        torch.cuda.reset_peak_memory_stats()
        before = _totals(counters)
        form0 = _totals(FLUX_FORM_COUNTERS)
        state, res = run_benchmark(
            cfg, "cuda", quiet=True,
            **({} if dycore_kw is None else {"build": _dycore_build(
                dycore_kw)}))
        launches = _since(counters, before)
        forms = _since(FLUX_FORM_COUNTERS, form0)
        peak = torch.cuda.max_memory_allocated()
        maxw = _check_state(f"[33] {label}", state)
        steps = res["steps"] + 1  # and the discarded warm-up step
        want = {a: (9 * steps if a == algebra else 0) for a in forms}
        if (forms != want or launches["direction_fluxes"] != 9 * steps
                or any(n < 1 for n in launches.values())):
            raise AssertionError(f"[33] {label}: launches {launches}, by "
                                 f"form {forms}, expected {want}")
        ms = 1e3 * res["elapsed_s"] / res["steps"]
        ms_of.setdefault(label, []).append(ms)
        print(f"[33] 512x512x64 float32 {label}: {res['steps']} steps in "
              f"{res['elapsed_s']:.3f} s = {res['mcellups']:.3f} Mcellups, "
              f"{ms:.2f} ms/step; peak memory {peak / 2**30:.2f} GiB; maxw "
              f"{maxw:.6e}; launches {launches}, by form {forms}; "
              f"validate() clean  [{card}]", flush=True)
        if label not in finals:  # on the host: no later run's peak holds it
            finals[label] = {k: state[k].cpu() for k in (
                "density_dry", "uvel", "vvel", "wvel", "temp",
                "water_vapor", "cloud_liquid", "precip_liquid")}
            launches_of.setdefault(algebra, {**launches, **forms})
        del state
        torch.cuda.empty_cache()
    ref = finals["reference (Dycore())"]
    for label, fields in finals.items():
        if fields is ref:
            continue
        worst = max(((_rel(ref[k], fields[k])[1], k) for k in ref))
        print(f"[33] {label} against the reference after 10 steps: largest "
              f"difference {worst[0]:.3e} of {worst[1]}'s scale; ms/step "
              f"{', '.join(f'{m:.2f}' for m in ms_of[label])} against the "
              f"reference's "
              f"{', '.join(f'{m:.2f}' for m in ms_of['reference (Dycore())'])}"
              f"  [{card}]", flush=True)
    a, b = finals["opt + fast weights"], finals["opt, exact weights"]
    worst = max(((_rel(b[k], a[k])[1], k) for k in a))
    print(f"[33] approximate against exact weights after 10 steps: largest "
          f"difference {worst[0]:.3e} of {worst[1]}'s scale", flush=True)
    del finals, ref, a, b

    cfg = _supercell_cfg(16, 8, 10, 40000.0, 40000.0, 10000.0, 100.0,
                         "float64", riemann_impl="pallas")
    outs = []
    for device in ("cpu", "cuda"):
        state, mods, dycore = build(cfg, device)
        dt = dycore.compute_time_step(state)
        f0 = _totals(FLUX_FORM_COUNTERS)
        for _ in range(3):
            for m in mods:
                state = m(state, dt)
        f1 = _totals(FLUX_FORM_COUNTERS)
        outs.append(state)
    worst = max(_rel(outs[0][k], outs[1][k].cpu())[1] for k in outs[0].fields)
    print(f"[33] 16x8x10 f64 riemann_impl pallas 3-step slice, card vs CPU: "
          f"worst error over field scale {worst:.3e} (tol 1e-7); card "
          f"launches by form {{'opt': {f1['opt'] - f0['opt']}, 'fast': "
          f"{f1['fast'] - f0['fast']}}}", flush=True)
    if not worst <= 1e-7 or f1["opt"] - f0["opt"] != 27 or f1["fast"] != f0[
            "fast"]:
        raise AssertionError(f"[33] f64 pallas slice: {worst:.3e}, "
                             f"launches {f0} -> {f1}")
    return launches_of


def _golden_maxw():
    """_GOLDEN_MAXW of tests/test_golden.py, read without importing it."""
    with open(os.path.join(ROOT, "tests", "test_golden.py")) as f:
        src = f.read()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "_GOLDEN_MAXW" for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError("_GOLDEN_MAXW not found in tests/test_golden.py")


def phase_references():
    """Small inputs against references: the golden maxw trajectory, and the
    card's slice against the port's CPU run (plain versions)."""
    from miniweatherml_tpu_torch.experiments.supercell_example import build

    cfg = _supercell_cfg(50, 1, 20, 100000.0, 100000.0, 20000.0, 100.0,
                         "float64")
    state, mods, dycore = build(cfg, "cuda")
    dt = dycore.compute_time_step(state)
    worst = 0.0
    for i, expect in enumerate(_golden_maxw()):
        for m in mods:
            state = m(state, dt)
        got = float(state["wvel"].abs().max())
        worst = max(worst, abs(got - expect) / expect)
    print(f"[5] golden 20-step maxw 50x1x20 f64: worst rel err {worst:.3e} "
          "(tol 1e-6)", flush=True)
    if not worst <= 1e-6:
        raise AssertionError(f"golden maxw rel err {worst:.3e}")

    cfg = _supercell_cfg(16, 8, 10, 40000.0, 40000.0, 10000.0, 100.0,
                         "float64")
    outs = []
    for device in ("cpu", "cuda"):
        state, mods, dycore = build(cfg, device)
        dt = dycore.compute_time_step(state)
        for _ in range(3):
            for m in mods:
                state = m(state, dt)
        outs.append(state)
    worst = max(_rel(outs[0][k], outs[1][k].cpu())[1] for k in outs[0].fields)
    print(f"[5] 16x8x10 f64 3-step slice, card vs CPU: worst error over "
          f"field scale {worst:.3e} (tol 1e-7)", flush=True)
    if not worst <= 1e-7:
        raise AssertionError(f"card vs CPU slice: {worst:.3e}")


def phase_heartbeat():
    from miniweatherml_tpu_torch.experiments.supercell_example import run
    os.makedirs(OUT_DIR, exist_ok=True)
    prefix = os.path.join(OUT_DIR, "chip_smoke_supercell_short")
    # inputs/supercell_short.yaml, with the output under chip_smoke_out/
    cfg = _supercell_cfg(100, 1, 40, 100000.0, 100000.0, 20000.0, 50.0,
                         "float32", out_freq=25.0, out_prefix=prefix)
    state = run(cfg, "cuda")
    maxw = _check_state("7", state)
    if not os.path.getsize(prefix + ".nc") > 0:
        raise AssertionError("no NetCDF output")
    print(f"[7] supercell_short 100x1x40 f32: maxw {maxw:.6e}, wrote "
          f"{prefix}.nc", flush=True)


# -- P3 -----------------------------------------------------------------------

# (label, 1-based ice columns) of every ice lookup on the P3 path
# (physics/p3.py: part2 rates, sedimentation, part3, part3 with diagnostics)
ICE_CALLS = (("part2", (7, 8, 4, 2, 3, 5, 10)), ("sed", (2, 1, 7, 8)),
             ("part3", (7, 8)), ("part3_diag", (7, 8, 2, 6, 9, 11, 12)))
RAIN_CALLS = (("revap", ("revap",)), ("sed", ("vm", "vn")))


def _p3_lookup_inputs(n, dtype, seed=13):
    """Index sets for n cells from the index finders, on seeded physical
    inputs that reach past the tables (every clip range is hit)."""
    from miniweatherml_tpu_torch.physics import p3_tables as PT
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    qi = 10.0 ** rng.uniform(-15, -1, n)
    idx = PT.ice_table_indices(t(qi), t(10.0 ** rng.uniform(-3, 10, n)),
                               t(qi * rng.uniform(0.0, 1.2, n)),
                               t(rng.uniform(0.0, 1000.0, n)))
    jr = PT.rain_collection_index(t(10.0 ** rng.uniform(-15, -1, n)),
                                  t(10.0 ** rng.uniform(-3, 8, n)))
    rs = PT.rain_size_index(t(10.0 ** rng.uniform(-7, -1, n)))
    return idx, jr, rs


def _lookup_resources(name, K, dtype):
    """(registers, shared memory per block in bytes) of the kernel that a
    lookup of K columns launches (ptxas report; the ice kernel's staged
    table)."""
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    t = "f" if dtype == torch.float32 else "d"
    w = LK.vec_width(K, dtype)
    smem = 0
    if name == "interp_ice":
        smem = LK.launch_config("ice", K, dtype, 1)[2]
        pat = f"ice_kernelI{t}Li{w}EE"
    elif name == "interp_collect":
        smem = LK.launch_config("collect", K, dtype, 1)[2]
        pat = f"collect_kernelI{t}Li{w}E"
    else:
        pat = f"rain_kernelI{t}E"
    regs = [r for m, r, *_ in _ptxas_report("p3_lookup") if pat in m]
    if len(regs) != 1:
        raise AssertionError(f"no single entry function {pat} in p3_lookup")
    return regs[0], smem


def _lookup_check(name, label, kern, plain, args, present, dtype, n):
    """One lookup call against its plain version, bit for bit (else the
    count and size in ulps of the values that differ, and a failure), then
    timed beside its bound; returns (max abs err, ms, plain ms, bound ms,
    bound_by)."""
    ref = plain(*args, present=present)
    got = kern(*args, present=present)
    torch.cuda.synchronize()
    err = _rel(ref, got)[0]
    diff, ulps = _ulps(ref, got)
    nbytes = _nbytes(args, got)
    del ref, got
    ms = _time_ms(lambda: kern(*args, present=present))
    pms = _time_ms(lambda: plain(*args, present=present), reps=3)
    K = args[0].shape[0]
    # ~40 operations per cell and column (index clamps, weights, the
    # multilinear blend; csrc/p3_lookup.cu)
    bms, by = _bound(nbytes, 40 * K * n, dtype)
    regs, smem = _lookup_resources(name, K, dtype)
    print(f"[8] {name} {label} K={K} {_dtype_name(dtype)}: "
          + ("bit for bit" if diff == 0 else
             f"DIFFERENT in {diff} values, at most {ulps:.0f} ulp")
          + f"; kernel {ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
          f"({by}), {bms / ms:.1%} of the bound; {regs} registers, {smem} B "
          f"shared per block", flush=True)
    if diff:
        raise AssertionError(f"{name} {label} {dtype}: {diff} values differ "
                             f"from the plain version")
    return err, ms, pms, bms, by


def _p3_step_lookups(build, dtype):
    """The ice and collection lookup calls that one step of a 512x512x64
    P3 chain makes (``build``: supercell_p3.build, the early storm, or
    _p3_active_build, every cell seeded): [(name, args, present)] in call
    order."""
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    state, mods, dycore = build(_bench_cfg(512, 512, 64, 1, dtype), "cuda")
    real = {"interp_ice": LK.interp_ice, "interp_collect": LK.interp_collect}
    seen = []

    def spy(name, nargs):
        def call(*args, present=None):
            if len(args) > nargs:  # present passed by position
                args, present = args[:nargs], args[nargs]
            seen.append((name, args, present))
            return real[name](*args, present=present)
        return call
    LK.interp_ice = spy("interp_ice", 7)
    LK.interp_collect = spy("interp_collect", 9)
    try:
        dt = dycore.compute_time_step(state)
        for m in mods:
            state = m(state, dt)
    finally:
        LK.interp_ice, LK.interp_collect = (real["interp_ice"],
                                            real["interp_collect"])
    return seen


def _p3_step_chains():
    """(label, build) of the P3 chains whose lookup index sets phase 8
    checks and times: the main cell's early storm, the mixed-regime seeds
    of phase 9 and every cell seeded."""
    from miniweatherml_tpu_torch.experiments import supercell_p3
    return (("early-storm", supercell_p3.build),
            ("mixed", _p3_mixed_build), ("all-active", _p3_active_build))


def phase_p3_lookups():
    """Each lookup kernel at every K of the path, 512x512x64 cells, on the
    seeded index sets, then the ice and collection kernels on the index
    sets one step of each of _p3_step_chains hands them."""
    from miniweatherml_tpu_torch.physics import p3_lookup_cuda as LK
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    tables = load_p3_tables()
    n = 512 * 512 * 64
    recs = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
            for k in ("interp_ice", "interp_collect", "interp_rain")}
    for dtype in (torch.float32, torch.float64):
        dev = tables.to("cuda", dtype)
        idx, jr, rs = _p3_lookup_inputs(n, dtype)
        present = torch.tensor(True, device="cuda")
        calls = [("interp_ice", label, LK.interp_ice, LK.interp_ice_plain,
                  (dev.ice_cols(cols), *idx)) for label, cols in ICE_CALLS]
        calls.append(("interp_collect", "part2", LK.interp_collect,
                      LK.interp_collect_plain,
                      (dev.collect_cols((2, 1)), *idx, *jr)))
        calls += [("interp_rain", label, LK.interp_rain, LK.interp_rain_plain,
                   (dev.rain_rows(rows), *rs)) for label, rows in RAIN_CALLS]
        for name, label, kern, plain, args in calls:
            err, ms, pms, bms, by = _lookup_check(name, label, kern, plain,
                                                  args, present, dtype, n)
            if dtype == torch.float32:
                r = recs[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if r["ms"] == 0.0:  # the first call site of the family
                    r.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        off = LK.interp_ice(dev.ice_cols((2,)), *idx,
                            present=torch.tensor(False, device="cuda"))
        if off.any():
            raise AssertionError("interp_ice wrote values with present=False")
        del idx, jr, rs, calls
        torch.cuda.empty_cache()
    plain = {"interp_ice": LK.interp_ice_plain,
             "interp_collect": LK.interp_collect_plain}
    kern = {"interp_ice": LK.interp_ice, "interp_collect": LK.interp_collect}
    for chain, build in _p3_step_chains():
        for dtype in ("float32", "float64"):
            seen = _p3_step_lookups(build, dtype)
            names = [name for name, *_ in seen]
            if "interp_ice" not in names or "interp_collect" not in names:
                raise AssertionError(f"{chain} P3 step made lookups {names}")
            for i, (name, args, present) in enumerate(seen):
                gate = "" if present is None else f", present {bool(present)}"
                _lookup_check(name, f"{chain} call {i + 1}{gate}", kern[name],
                              plain[name], args, present, args[2].dtype,
                              args[2].numel())
            del seen
            torch.cuda.empty_cache()
    return recs


def phase_p3_cellwise():
    """The three phases of the per-cell kernel against their plain versions
    on the inputs one P3 step hands them (captured at the shared launcher),
    mixed-regime 512x512x64 state."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw

    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    cell_phases = ("part1", "update", "wrapper")
    launch = cw._launch
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        state, mods, dycore = _p3_mixed_build(
            _bench_cfg(512, 512, 64, 1, dtype), "cuda")
        seen = {}

        def spy(phase, predict_nc, arrays, dt=0.0, table=None):
            if phase in cell_phases:  # the others are phase 31's and 32's
                seen[phase] = (predict_nc, arrays, dt)
            return launch(phase, predict_nc, arrays, dt, table)
        cw._launch = spy
        try:
            mods[1](state, dycore.compute_time_step(state))
        finally:
            cw._launch = launch
        del state, mods, dycore
        if set(seen) != set(cell_phases):
            raise AssertionError(f"P3 step launched phases {sorted(seen)}")
        for phase, (pnc, arrays, dt) in sorted(seen.items()):
            ref = cw.plain_phase(phase, pnc, arrays, dt)
            got = launch(phase, pnc, arrays, dt)
            torch.cuda.synchronize()
            errs = [_rel(a, b) for a, b in zip(ref, got)]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            nbytes = _nbytes(arrays, got)
            cells = got[0].numel()
            del ref, got
            ms = _time_ms(lambda: launch(phase, pnc, arrays, dt))
            pms = _time_ms(lambda: cw.plain_phase(phase, pnc, arrays, dt),
                           reps=3)
            bms, by = _bound(nbytes, _phase_ops(phase, pnc, dtype) * cells,
                             dtype)
            print(f"[9] p3_cellwise {phase} ({len(arrays)} in) {dtype}: max "
                  f"abs err {err:.3e}, rel {rel:.3e} (tol {tol:g}); kernel "
                  f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
                  f"({by}), {bms / ms:.1%} of the bound", flush=True)
            if not rel <= tol:
                raise AssertionError(f"p3 {phase} {dtype}: rel {rel:.3e}")
            if dtype == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["ms"] += ms
                rec["plain_ms"] += pms
                rec["bound_ms"] += bms
                rec["bound_by"] = by
        del seen
        torch.cuda.empty_cache()
    return rec


# the per-cell phases a P3 step launches through p3_cellwise_cuda._launch,
# in the step's order (part3 and the output pass go through their own
# wrappers, _tails_check)
STEP_PHASES = ("part1", "rates_pre", "rates_post", "update", "wrapper")
# indices and fractions of rates_pre's outputs: (index, fraction) pairs
RATES_PRE_PAIRS = ((2, 3), (4, 5), (6, 7), (8, 9), (10, 11))
# rates_pre's flags case: fields of 963 cells (not a multiple of 128 or 4)
# in which no cell, or exactly one, holds ice, rain or both, at these cells
RATES_PRE_FLAG_CELLS = 963
RATES_PRE_FLAG_CASES = (("none", None),) + tuple(
    (kind, at) for kind in ("ice", "rain", "ice and rain")
    for at in (0, RATES_PRE_FLAG_CELLS // 2, RATES_PRE_FLAG_CELLS - 1))


def _rates_pre_flag_fields(kind, at, dtype, device, n=RATES_PRE_FLAG_CELLS,
                           seed=18):
    """rates_pre's ten inputs (qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in,
    qr_in, nr_in) on ``n`` cells, made with numpy from ``seed``: qi and qr
    below QSMALL everywhere except, by ``kind`` ("none", "ice", "rain",
    "ice and rain"), 1e-4 at cell ``at``; the in-cloud values spread over
    their ranges in every cell (a tenth of them 0), so that the index
    finders see every branch."""
    from miniweatherml_tpu_torch.physics.p3 import QSMALL
    rng = np.random.default_rng(seed)

    def logu(lo, hi):
        v = 10.0 ** rng.uniform(lo, hi, n)
        v[rng.uniform(size=n) < 0.1] = 0.0
        return v
    qi = rng.uniform(0.0, 0.99, n) * QSMALL
    qr = rng.uniform(0.0, 0.99, n) * QSMALL
    if "ice" in kind:
        qi[at] = 1e-4
    if "rain" in kind:
        qr[at] = 1e-4
    qi_in = logu(-9, -3)
    qm_in = qi_in * rng.uniform(0.0, 1.2, n)
    bm_in = qm_in / rng.uniform(20.0, 1000.0, n)
    fields = (qi, qr, logu(-12, -5), logu(-14, -7), qi_in, qm_in, bm_in,
              logu(1, 7), logu(-9, -3), logu(0, 6))
    return [torch.as_tensor(f).to(device=device, dtype=dtype)
            for f in fields]


# rates_post's regimes of _rates_post_fields: which of q{c,r,i} a cell
# holds (at least QSMALL) and its temperature range (K)
RP_REGIMES = {"quiet": ("", 262.0, 300.0),
              "cold mixed": ("cri", 235.0, 255.0),
              "warm rain": ("r", 280.0, 300.0),
              "melting": ("ci", 274.0, 285.0),
              "cold ice": ("i", 240.0, 270.0)}
# the branch cases of the card tests: rates_post's fields of 963 cells (not
# a multiple of the block or of a warp), all quiet, or with one cell of a
# regime that passes gates at the first, the middle or the last cell
RATES_POST_CELLS = 963
RATES_POST_CASES = (("quiet", None),) + tuple(
    (kind, at) for kind in ("cold mixed", "warm rain")
    for at in (0, RATES_POST_CELLS // 2, RATES_POST_CELLS - 1))


def _rates_post_fields(regimes, dtype, device, seed=19):
    """rates_post's 30 inputs on one cell per entry of ``regimes`` (names of
    RP_REGIMES), made with numpy from ``seed``: the hydrometeors a regime
    holds at 1e-6 to 3e-4 (in-cloud values alike; the others below QSMALL,
    in-cloud 0), its temperatures, ice-supersaturated in the cold regimes
    (so that Cooper nucleation fires below -15 C) and subsaturated in the
    others (so that rain evaporates); numbers, shapes and lookup values
    spread over plausible ranges in every cell."""
    from miniweatherml_tpu_torch.physics import p3 as P
    rng = np.random.default_rng(seed)
    n = len(regimes)

    def logu(lo, hi):
        return 10.0 ** rng.uniform(lo, hi, n)
    held = np.array([RP_REGIMES[r][0] for r in regimes])
    temp = np.array([rng.uniform(*RP_REGIMES[r][1:]) for r in regimes])
    pres = rng.uniform(5.0e4, 1.0e5, n)
    rho = pres / (287.0 * temp)
    qsi = P.p3_qv_sat_ice(torch.as_tensor(temp),
                          torch.as_tensor(pres)).numpy()
    cold = temp < 258.0
    qv = qsi * np.where(cold, rng.uniform(1.06, 1.3, n),
                        rng.uniform(0.3, 0.9, n))
    q, q_in = {}, {}
    for s in "cri":
        has = np.char.find(held, s) >= 0
        q_in[s] = np.where(has, logu(-6.0, -3.5), 0.0)
        q[s] = np.where(has, q_in[s], rng.uniform(0.0, 0.9, n) * P.QSMALL)
    qm_in = q_in["i"] * rng.uniform(0.0, 1.0, n)
    fields = (q["c"], logu(7, 9), q["r"], q["i"], logu(3, 6), qv, temp, pres,
              rho, q_in["c"], q_in["r"], q_in["i"], qm_in,
              qm_in / rng.uniform(100.0, 900.0, n), logu(7, 9), logu(2, 5),
              logu(3, 6), rng.uniform(2.0, 15.0, n),
              qv * rng.uniform(0.98, 1.02, n),
              temp + rng.uniform(-0.5, 0.5, n), rng.uniform(1.0, 3.0, n),
              rng.uniform(0.1, 1.0, n), logu(-6, -4), rng.uniform(0.2, 2.0, n),
              logu(-12, -9), logu(-6, -4), logu(-5, -3), logu(-8, -5),
              logu(-8, -5), rng.uniform(0.5, 2.0, n))
    return [torch.as_tensor(f).to(device=device, dtype=dtype)
            for f in fields]


def _rates_post_case(kind, at, dtype, device, n=RATES_POST_CELLS):
    """_rates_post_fields of ``n`` quiet cells but cell ``at``, of regime
    ``kind`` (RATES_POST_CASES)."""
    regimes = ["quiet"] * n
    if at is not None:
        regimes[at] = kind
    return _rates_post_fields(regimes, dtype, device)


def _p3_step_rates_sed(build, dtype):
    """What one step of a 512x512x64 P3 chain hands the per-cell phases of
    STEP_PHASES, the two sedimentation wrappers, part3 and the output pass:
    {name: (args, keywords)}, and under "launches" the sedimentation
    wrappers' launches in the step."""
    sed_counters = _launch_counters("sed_step", "sed_columns")
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as sed
    state, mods, dycore = build(_bench_cfg(512, 512, 64, 1, dtype), "cuda")
    seen = {}
    launch, step, columns = cw._launch, sed.sed_step, sed.sed_columns
    part3, wrapper_out = cw.p3_part3, cw.p3_wrapper_out

    def spy_launch(phase, predict_nc, arrays, dt=0.0, table=None):
        if phase in STEP_PHASES:
            seen[phase] = ((predict_nc, arrays, dt), {})
        return launch(phase, predict_nc, arrays, dt, table)

    def spy(name, real):
        def call(*args, **kw):
            seen[name] = (args, kw)
            return real(*args, **kw)
        return call
    cw._launch = spy_launch
    spies = {"sed_step": spy("sed_step", step),
             "sed_columns": spy("sed_columns", columns)}
    sed.sed_step, sed.sed_columns = spies["sed_step"], spies["sed_columns"]
    cw.p3_part3, cw.p3_wrapper_out = (spy("p3_part3", part3),
                                      spy("p3_wrapper_out", wrapper_out))
    before = _totals(sed_counters)
    try:
        mods[1](state, dycore.compute_time_step(state))
    finally:
        cw._launch, sed.sed_step, sed.sed_columns = launch, step, columns
        cw.p3_part3, cw.p3_wrapper_out = part3, wrapper_out
    if set(seen) != set(STEP_PHASES) | set(SED_CALLS) | {"p3_part3",
                                                           "p3_wrapper_out"}:
        raise AssertionError(f"P3 step made calls {sorted(seen)}")
    seen["launches"] = _since(sed_counters, before)
    return seen


def _bits(x):
    """The bit patterns of a float32 or float64 tensor."""
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _newton_trips(args):
    """Trips of the wrapper kernel's saturation Newton in each cell (int64)
    on the wrapper's 13 inputs, by the plain version's arithmetic
    (p3.compute_adjusted_state): 0 where the kernel skips it (a cell that
    neither condenses nor evaporates, or an evaporating cell whose boundary
    root holds), else the first trip that leaves x with the bits it had, or
    n_newton + 1 where none does."""
    from miniweatherml_tpu_torch.ops.exact_div import exact_div
    from miniweatherml_tpu_torch.physics import p3 as P
    rho_d, temp, rho_c, _, rho_r, _, rho_i, _, _, _, rho_v = args[:11]
    rho = rho_d + rho_c + rho_r + rho_i + rho_v
    svp = P.saturation_vapor_pressure(temp)
    pv = rho_v * P.R_V * temp
    condensing = pv > svp
    evaporating = (pv < svp) & (rho_c > 0.0)
    lv = P.latent_heat_condensation(temp)
    n_newton = 10 if temp.dtype == torch.float64 else 7
    lo = torch.where(condensing, 0.0, -rho_c)
    hi = torch.where(condensing, rho_v, 0.0)
    rho_t = rho_d + rho_v + rho_c
    cp0 = (rho_d * P.CP_D + rho_v * P.CP_V + rho_c * P.CP_L) / rho_t
    dcp = exact_div(P.CP_L - P.CP_V, rho_t)
    cp_lo = cp0 - rho_c * dcp
    t_lo = temp - rho_c * lv / (rho * cp_lo)
    f_lo = ((rho_v + rho_c) * P.R_V * t_lo
            - P.saturation_vapor_pressure(t_lo))
    run = (condensing | evaporating) & ~(evaporating & (f_lo <= 0.0))
    dtdx0 = lv / (rho * cp0)
    fp0 = (-P.R_V * temp + rho_v * P.R_V * dtdx0
           - P._magnus_dsvp_dT(svp, temp) * dtdx0)
    x1 = -(pv - svp) / P._min(fp0, -1e-30)
    x = torch.where((fp0 < 0.0) & (x1 >= lo) & (x1 <= hi), x1,
                    0.5 * (lo + hi))
    trips = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    done = ~run
    for _trip in range(n_newton + 1):
        rv = rho_v - x
        cp = cp0 + x * dcp
        dtdx_lin = lv / (rho * cp)
        t_loc = temp + x * dtdx_lin
        svp_loc = P.saturation_vapor_pressure(t_loc)
        f = rv * P.R_V * t_loc - svp_loc
        pos = f > 0.0
        lo = torch.where(pos, x, lo)
        hi = torch.where(pos, hi, x)
        dtdx = dtdx_lin * (1.0 - x * dcp / cp)
        fp = (-P.R_V * t_loc + rv * P.R_V * dtdx
              - P._magnus_dsvp_dT(svp_loc, t_loc) * dtdx)
        xn = x - f / fp
        nxt = torch.where((xn >= lo) & (xn <= hi), xn, 0.5 * (lo + hi))
        trips += (~done).long()
        done = done | (_bits(nxt) == _bits(x))
        x = nxt
    return trips


def _warp_split(mask):
    """(share of 32-cell warps in which some cell sets ``mask``, share in
    which its cells disagree) over the cells in their launch order."""
    m = mask.reshape(-1)
    pad = (-m.numel()) % 32
    w = torch.cat([m, m.new_zeros(pad)]).reshape(-1, 32).sum(1)
    return (float((w > 0).float().mean()),
            float(((w > 0) & (w < 32)).float().mean()))


def _rates_post_gates(arrays):
    """{group: cells whose gate holds} of RatesPost's gated groups
    (RP_GROUPS) on its 30 inputs, by the plain version's arithmetic; and
    the cells of its ice-rain collection ("ice and rain") and of that
    collection's mass rate ("ice and rain at or below 0 C")."""
    from miniweatherml_tpu_torch.physics import p3 as P
    qc, _, qr, qi, _, qv, temp, pres, rho, qc_in, qr_in, qi_in = arrays[:12]
    ni_in, tab7, tab8, tab4 = arrays[16], arrays[20], arrays[21], arrays[22]
    tc = temp - P.TMELT
    has_qc, has_qr, has_qi = qc >= P.QSMALL, qr >= P.QSMALL, qi >= P.QSMALL
    sup_i = qv / P._max(P.p3_qv_sat_ice(temp, pres), P.QSMALL) - 1.0
    evap = (qc_in + qi_in < 1.0e-6) & has_qr
    ni_t = P._max(ni_in, P.NSMALL)
    ni_t = torch.maximum(torch.minimum(ni_t, tab7 * ni_t), tab8 * ni_t)
    rim = torch.where(has_qi & has_qc & (tc < 0.0),
                      (P._RHO_600MB * (1.0 / rho)) ** 0.54 * tab4 * qc_in
                      * 0.5 * rho * ni_t, 0.0)
    return {"autoconversion": qc_in >= 1.0e-8,
            "accretion": has_qc & has_qr, "rain_size": has_qr,
            "nucleation": (tc < -15.0) & (sup_i >= 0.05),
            "bigg_cloud": has_qc & (tc <= -4.0),
            "bigg_rain": has_qr & (tc <= -4.0),
            "transport": has_qi | evap,
            "qsl": (has_qi & (tc < 0.0)) | evap, "ice": has_qi,
            "rime": has_qi & has_qc & (rim >= P.QSMALL),
            "evaporation": evap, "ice and rain": has_qi & has_qr,
            "ice and rain at or below 0 C": has_qi & has_qr & (tc <= 0.0)}


# RatesPost's inputs that a gated group reads (every other input is read
# in every cell): input position -> the groups whose cells read it
# (csrc/p3_cellwise.cu rp::In)
RP_LOADS = {14: ("autoconversion", "bigg_cloud", "rime"),  # nc_in
            15: ("rain_size",), 4: ("nucleation",), 1: ("bigg_cloud",),
            17: ("bigg_cloud", "rime"),  # mu_cd
            **{k: ("ice",) for k in (12, 13, 20, 21, 22, 24, 25, 26)},
            23: ("rime",), 28: ("ice and rain",),
            27: ("ice and rain at or below 0 C",),
            **{k: ("evaporation",) for k in (18, 19, 29)}}


def _rates_post_work(arrays, dtype):
    """(bytes, operations) that RatesPost's data needs on these inputs: its
    25 outputs written, each input read in the cells whose groups read it
    (RP_LOADS), the rest in every cell; the operations of each gated group
    (its probe's SASS) in the cells whose gate holds and the saturation's
    in every cell (the few comparisons and products of the gates, ni_rate
    and the deposition are not counted)."""
    gates = _rates_post_gates(arrays)
    n = arrays[0].numel()
    item = arrays[0].element_size()
    cells = 25 * n
    for k in range(30):
        if k in RP_LOADS:
            need = torch.zeros_like(gates["ice"])
            for g in RP_LOADS[k]:
                need = need | gates[g]
            cells += int(need.sum())
        else:
            cells += n
    ops = _cell_ops()[_dtype_name(dtype)]
    work = ops["rp_saturation"] * n + sum(
        ops[f"rp_{g}"] * int(gates[g].sum()) for g in RP_GROUPS)
    return cells * item, work


def _own_path_registers():
    """[31] registers, spills and the occupancy they allow (warps per SM of
    64, blocks of 128 threads, registers allocated in eights) of the
    wrapper's and rates_post's launch path, from phase 2's ptxas report."""
    import re
    for mangled, regs, st, ld, stack, _ in _ptxas_report("p3_cellwise"):
        m = re.search(r"cell_kernelI.*?(Wrapper|RatesPost)E([fd])E", mangled)
        if not m:
            continue
        warps = 4 * min(16, 65536 // (128 * (-(-regs // 8) * 8)))
        print(f"[31] cell_kernel<{m.group(1)}, "
              f"{'float' if m.group(2) == 'f' else 'double'}>: {regs} "
              f"registers, {st} B spill stores, {ld} B spill loads, {stack} "
              f"B stack; occupancy {warps} of 64 warps per SM", flush=True)


def _own_path_report(tag, seen):
    """[31] what the wrapper's and rates_post's branches meet on this
    state: the Newton's trips per cell (histogram), their mean per cell and
    the mean per warp of its slowest cell; and for each RatesPost group the
    share of warps in which some cell passes its gate and in which the
    cells disagree."""
    trips = _newton_trips(seen["wrapper"][0][1]).reshape(-1)
    hist = torch.bincount(trips).tolist()
    pad = (-trips.numel()) % 32
    warp = torch.cat([trips, trips.new_zeros(pad)]).reshape(-1, 32)
    print(f"[31] {tag} wrapper Newton trips per cell {dict(enumerate(hist))}"
          f"; mean {float(trips.double().mean()):.3f} a cell, "
          f"{float(warp.max(1).values.double().mean()):.3f} a warp's "
          f"slowest cell", flush=True)
    gates = _rates_post_gates(seen["rates_post"][0][1])
    split = {g: _warp_split(m) for g, m in gates.items()}
    print(f"[31] {tag} rates_post warps (some cell passes the gate / cells "
          f"disagree): " + ", ".join(f"{g} {a:.1%} / {d:.1%}"
                                     for g, (a, d) in split.items()),
          flush=True)


def _worst(pairs):
    """(max abs err, max rel err over each reference's scale) of
    [(reference, got)]."""
    errs = [_rel(a, b) for a, b in pairs]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _rates_pre_agreement(tag, ref, got):
    """rates_pre's outputs against its plain version's: the pairs to hold
    to the tolerance (the two fields, and the lookup positions index +
    fraction its index sets give), how many indices differ, and its
    presence flags, which must be equal."""
    pairs = [(ref[0], got[0]), (ref[1], got[1])] + [
        (ref[i].double() + ref[f].double(),
         got[i].double() + got[f].double()) for i, f in RATES_PRE_PAIRS]
    moved = sum(int((ref[i] != got[i]).sum()) for i, _ in RATES_PRE_PAIRS)
    if not torch.equal(ref[-1], got[-1]):
        raise AssertionError(f"{tag} rates_pre: flags {got[-1].tolist()} "
                             f"against {ref[-1].tolist()}")
    return pairs, moved


def _cell_check(tag, phase, args, dtype, tol):
    """One per-cell phase against its plain version on what the step
    handed it (rates_pre: its fields, the lookup positions its index sets
    give, how many indices differ, and its presence flags), timed beside
    its bound, the operations from the SASS (_cell_ops; rates_post's
    bytes and operations those its data needs, _rates_post_work, with its
    bound on every byte beside it).  Returns (max abs err, ms, plain ms,
    bound ms, bound_by)."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw
    pnc, arrays, dt = args
    ref = cw.plain_phase(phase, pnc, arrays, dt)
    got = cw._launch(phase, pnc, arrays, dt)
    torch.cuda.synchronize()
    note = ""
    if phase == "rates_pre":
        pairs, moved = _rates_pre_agreement(tag, ref, got)
        note = (f"; {moved} of {5 * got[2].numel()} indices differ (their "
                f"positions index + fraction agree within the bound); "
                f"presence flags {got[-1].tolist()}, equal True")
    else:
        pairs = list(zip(ref, got))
    err, rel = _worst(pairs)
    bit = all(torch.equal(a, b) for a, b in zip(ref, got))
    if phase == "rates_post":  # its gated loads and groups: the data's need
        nbytes, ops = _rates_post_work(arrays, dtype)
        full = 1e3 * _nbytes(arrays, got) / HBM_BYTES_S
        note += f"; its bound on every byte {full:.3f} ms"
    else:
        nbytes = _nbytes(arrays, got)
        ops = _phase_ops(phase, pnc, dtype) * arrays[0].numel()
    del ref, got
    ms = _time_ms(lambda: cw._launch(phase, pnc, arrays, dt))
    pms = _time_ms(lambda: cw.plain_phase(phase, pnc, arrays, dt), reps=3)
    bms, by = _bound(nbytes, ops, dtype)
    print(f"[31] {tag} {phase} ({len(arrays)} in): max abs err {err:.3e}, "
          f"rel {rel:.3e} (tol {tol:g}), bit for bit {bit}{note}; kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP), {bms / ms:.1%} "
          f"of the bound  [{_card()}]", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{tag} {phase}: rel {rel:.3e}")
    return err, ms, pms, bms, by


def _rates_pre_flags_check(dtype, tol):
    """[31] rates_pre's kernel against its plain version on
    RATES_PRE_FLAG_CASES (963 cells, no cell or one with ice, rain or both
    at the first, the middle or the last cell), on the fields as made and
    on views one element into their storage (contiguous, not 16-byte
    aligned): flags equal in every case, fields and lookup positions
    within ``tol``.  Returns the largest abs error."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw
    worst, seen = 0.0, []
    for kind, at in RATES_PRE_FLAG_CASES:
        fields = _rates_pre_flag_fields(kind, at, dtype, "cuda")
        shifted = []
        for f in fields:
            buf = torch.empty(f.numel() + 1, dtype=dtype, device="cuda")
            buf[1:] = f
            shifted.append(buf[1:])
        for layout, args in (("aligned", fields), ("offset 1", shifted)):
            ref = cw.rates_pre_plain(*args)
            got = cw._launch("rates_pre", False, args)
            torch.cuda.synchronize()
            tag = f"flags case {kind} at {at} {layout} {_dtype_name(dtype)}"
            pairs, moved = _rates_pre_agreement(tag, ref, got)
            err, rel = _worst(pairs)
            if not rel <= tol:
                raise AssertionError(f"{tag}: rel {rel:.3e}")
            worst = max(worst, err)
            seen.append(f"{kind} at {at} {layout}: {got[-1].tolist()} "
                        f"({moved} indices differ)")
    print(f"[31] rates_pre flags, {RATES_PRE_FLAG_CELLS} cells "
          f"{_dtype_name(dtype)}, each equal to the plain version's: "
          f"{'; '.join(seen)}; max abs err {worst:.3e} (tol {tol:g})",
          flush=True)
    return worst


def _count(dt, vmax, dz):
    """The sub-step count p3_scheme makes of vmax on a single card, a 0-d
    tensor (no host read)."""
    return torch.clamp(torch.ceil(dt * vmax / (0.9 * dz.min())), min=1.0)


def _nsub(dt, vmax, dz):
    """(the sub-step count p3_scheme makes of vmax, dt vmax / (0.9 dz_min))
    for a single card, as 0-d tensor and float."""
    return _count(dt, vmax, dz), float(dt * vmax / (0.9 * dz.min()))


# the sedimentation wrappers a P3 step calls
SED_CALLS = ("sed_step", "sed_columns")
# the species branches of the sedimentation's level body (csrc/p3_sed.cu):
# probe kernels, each calling one branch (or the whole body) on values it
# loads, so that its SASS holds that branch's instructions alone
SED_PROBE = r"""
#include "p3_sed.cu"
namespace {
template <typename T>
__device__ SedTables<T> probe_tables(const T* x) {
  SedTables<T> tb{};
  tb.ice = x; tb.rain = x; tb.bs = 64; tb.es = 4; tb.rsize = 300;
  return tb;
}
}
template <typename T> __global__ void probe_rain(const T* x, T* o) {
  T nr = x[1], vq, vn;
  rain_speeds<T, true>(x[0], nr, x[2], x[3], probe_tables(x), vq, vn);
  o[0] = vq; o[1] = vn; o[2] = nr;
}
template <typename T> __global__ void probe_ice(const T* x, T* o) {
  T ni = x[1], qm = x[2], bm = x[3], vq, vn;
  ice_speeds<T, true>(x[0], ni, qm, bm, x[4], probe_tables(x), vq, vn);
  o[0] = vq; o[1] = vn; o[2] = ni; o[3] = qm; o[4] = bm;
}
template <typename T> __global__ void probe_cloud(const T* x, T* o) {
  T nc = x[1];
  o[0] = cloud_speed(x[0], nc, x[2], x[3]);
  o[1] = nc;
}
template <typename T> __global__ void probe_update(const T* x, T* o) {
  T q[8], v[8], fa[8], r[8];
  for (int w = 0; w < 8; ++w) {
    q[w] = x[w]; v[w] = x[8 + w]; fa[w] = x[16 + w];
  }
  level_update<T, false>(q, v, x[24], x[25], x[26] > T(0), x[27], fa, r);
  for (int w = 0; w < 8; ++w) o[w] = r[w] + fa[w];
}
template __global__ void probe_rain<float>(const float*, float*);
template __global__ void probe_ice<float>(const float*, float*);
template __global__ void probe_cloud<float>(const float*, float*);
template __global__ void probe_update<float>(const float*, float*);
template __global__ void probe_rain<double>(const double*, double*);
template __global__ void probe_ice<double>(const double*, double*);
template __global__ void probe_cloud<double>(const double*, double*);
template __global__ void probe_update<double>(const double*, double*);
"""
# floating-point opcodes of the SASS (a fused multiply-add counts as two
# operations, every other instruction as one; MUFU is the special-function
# unit's approximation step inside exp, log, pow and the divisions)
SASS_FP = {"FADD": 1, "FMUL": 1, "FFMA": 2, "FMNMX": 1, "FSETP": 1,
           "FSEL": 1, "FCHK": 1, "FRND": 1, "MUFU": 1, "DADD": 1, "DMUL": 1,
           "DFMA": 2, "DMNMX": 1, "DSETP": 1, "F2F": 1, "F2I": 1, "I2F": 1,
           "FSWZADD": 1}
# the per-cell phases of csrc/p3_cellwise.cu as probe kernels, each calling
# one phase's body (RatesPre's and the main path's forms of the others) on
# values it loads, so that its SASS holds that body's instructions alone
CELL_PROBE = r"""
#include "p3_cellwise.cu"
namespace {
template <class P, typename T>
__device__ void probe_phase(const T* x, T* o, int* io, bool* f) {
  T in[P::NIN], out[P::NOUT];
  int iout[P::NIOUT > 0 ? P::NIOUT : 1];
  bool fl[P::NFLAG > 0 ? P::NFLAG : 1];
  for (int k = 0; k < P::NIN; ++k) in[k] = x[k];
  P::template run<T>(in, out, iout, fl, (double)x[P::NIN], x + 64);
  for (int k = 0; k < P::NOUT; ++k) o[k] = out[k];
  for (int k = 0; k < P::NIOUT; ++k) io[k] = iout[k];
  for (int k = 0; k < P::NFLAG; ++k) f[k] = fl[k];
}
using Part1Pnc = Part1<true>;
using UpdatePnc = Update<true>;
}
#define PROBE(NAME, PHASE)                                                   \
  template <typename T>                                                      \
  __global__ void probe_##NAME(const T* x, T* o, int* io, bool* f) {         \
    probe_phase<PHASE, T>(x, o, io, f);                                      \
  }                                                                          \
  template __global__ void probe_##NAME<float>(const float*, float*, int*,   \
                                               bool*);                       \
  template __global__ void probe_##NAME<double>(const double*, double*,      \
                                                int*, bool*);
PROBE(part1, Part1<false>)
PROBE(part1_pnc, Part1Pnc)
PROBE(update, Update<false>)
PROBE(update_pnc, UpdatePnc)
PROBE(wrapper, Wrapper)
PROBE(rates_pre, RatesPre)
PROBE(rates_post, RatesPost)
PROBE(part3, Part3Tables)
PROBE(part3_diag, Part3TablesDiag)
PROBE(wrapper_out, WrapperOut)
namespace {
// RatesPost's shared values, loaded (its gates as values above 0)
template <typename T>
__device__ rp::Cell<T> probe_cell(const T* x) {
  rp::Cell<T> c;
  c.dt = x[30]; c.qc = x[0]; c.qr = x[2]; c.qi = x[3]; c.qv = x[5];
  c.temp = x[6]; c.pres = x[7]; c.rho = x[8]; c.inv_rho = x[31];
  c.tc = x[32]; c.qc_in = x[9]; c.qr_in = x[10]; c.qi_in = x[11];
  c.has_qc = x[33] > T(0); c.has_qr = x[34] > T(0); c.has_qi = x[35] > T(0);
  c.qv_si = x[36]; c.abi = x[37]; c.ni_rate = x[38]; c.epsi = x[39];
  c.nr1 = x[40]; c.lamr = x[41]; c.mu_v = x[42]; c.dv_diff = x[43];
  c.cbrt_sc = x[44]; c.qsl = x[45]; c.rhofaci = x[46]; c.rim0 = x[47];
  return c;
}
template <typename T>
__device__ void probe_keep(const rp::Cell<T>& c, T a, T b, T* o) {
  o[25] = a; o[26] = b; o[27] = c.nr1; o[28] = c.lamr; o[29] = c.mu_v;
  o[30] = c.dv_diff; o[31] = c.cbrt_sc; o[32] = c.epsi; o[33] = c.rhofaci;
  o[34] = c.rim0; o[35] = c.qv_si; o[36] = c.abi;
}
}
// one group of RatesPost's gated rates alone (RP_GROUPS)
#define PROBE_RP(NAME, CALL)                                                 \
  template <typename T>                                                      \
  __global__ void probe_rp_##NAME(const T* x, T* o, int*, bool*) {           \
    rp::Cell<T> c = probe_cell(x);                                           \
    const ArrayIO<T> io{x, o};                                               \
    T a = T(0), b = T(0);                                                    \
    CALL;                                                                    \
    probe_keep(c, a, b, o);                                                  \
  }                                                                          \
  template __global__ void probe_rp_##NAME<float>(const float*, float*,      \
                                                  int*, bool*);              \
  template __global__ void probe_rp_##NAME<double>(const double*, double*,   \
                                                   int*, bool*);
PROBE_RP(saturation, a = rp::saturation(c))
PROBE_RP(autoconversion, a = rp::autoconversion<T>(io, c))
PROBE_RP(accretion, a = rp::accretion(c))
PROBE_RP(rain_size, a = rp::rain_size<T>(io, c))
PROBE_RP(nucleation, rp::nucleation<T>(io, c, a, b))
PROBE_RP(bigg_cloud, rp::bigg_cloud<T>(io, c, a, b))
PROBE_RP(bigg_rain, rp::bigg_rain(c, a, b))
PROBE_RP(transport, rp::transport(c))
PROBE_RP(qsl, a = qv_sat_liq(c.temp, c.pres))
PROBE_RP(ice, rp::ice_rates<T>(io, c))
PROBE_RP(rime, a = rp::rime_density<T>(io, c))
PROBE_RP(evaporation, a = rp::rain_evaporation<T>(io, c))
"""
# RatesPost's gated groups of rates (csrc/p3_cellwise.cu, namespace rp), in
# the order of _rates_post_gates; each has a probe (probe_rp_<name>), as
# has the saturation every cell computes
RP_GROUPS = ("autoconversion", "accretion", "rain_size", "nucleation",
             "bigg_cloud", "bigg_rain", "transport", "qsl", "ice", "rime",
             "evaporation")
CELL_PROBES = ("part1", "part1_pnc", "update", "update_pnc", "wrapper",
               "rates_pre", "rates_post", "part3", "part3_diag",
               "wrapper_out", "rp_saturation") + tuple(
                   f"rp_{g}" for g in RP_GROUPS)
_sass_ops_cache = {}


def _sass_ops(lib, probe, names):
    """{"float32" / "float64": {name: operations}} of the probe kernels
    ``probe_<name><T>`` of ``probe`` (a source that includes
    csrc/<lib>.cu), counted from their SASS: built with that file's own
    nvcc flags as a cubin in chip_smoke_out/ and read with cuobjdump.  A
    static count: every path through the math functions' range splits
    (and, in part3, the ice lookup a cell without ice skips) counts, so a
    count is an upper estimate of one call.  Cached per process."""
    import re
    if lib in _sass_ops_cache:
        return _sass_ops_cache[lib]
    from miniweatherml_tpu_torch import cuda_build
    nvcc = cuda_build._nvcc()
    csrc = os.path.join(ROOT, "miniweatherml_tpu_torch", "csrc")
    work = os.path.join(OUT_DIR, f"{lib}_probe")
    os.makedirs(work, exist_ok=True)
    src, cubin = (os.path.join(work, "probe.cu"),
                  os.path.join(work, "probe.cubin"))
    with open(src, "w") as f:
        f.write(probe)
    flags = [f for f in cuda_build.nvcc_flags(lib)
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                          "--split-compile=0")]
    subprocess.run([nvcc, *flags, "-cubin", "-I", csrc, "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)"
                      r"(?:\.[\w.]+)?\s", ln)
        if cur and m and m.group(1) in SASS_FP:
            counts[cur] += SASS_FP[m.group(1)]
    out = {}
    for t, dtype in (("f", "float32"), ("d", "float64")):
        per = {}
        for name in names:
            hits = [n for k, n in counts.items()
                    if re.search(rf"\d+probe_{name}I{t}E", k)]
            if len(hits) != 1:
                raise AssertionError(f"no single probe_{name} <{dtype}> in "
                                     f"the SASS: {sorted(counts)}")
            per[name] = hits[0]
        out[dtype] = per
    _sass_ops_cache[lib] = out
    print(f"[2] {lib} operations per cell from the SASS (FMA as 2): {out}",
          flush=True)
    return out


def _sed_ops():
    """The sedimentation's level body by species branch (SED_PROBE):
    "rain", "ice" and "cloud" (one call of each species' speeds) and
    "update" (the eight fluxes and updates of a level); a cell without
    the species counts 0 for its branch."""
    return _sass_ops("p3_sed", SED_PROBE, ("rain", "ice", "cloud", "update"))


def _cell_ops():
    """The per-cell phases' bodies (CELL_PROBE), by phase."""
    return _sass_ops("p3_cellwise", CELL_PROBE, CELL_PROBES)


def _phase_ops(phase, predict_nc, dtype):
    """Operations per cell of one launch of a per-cell phase (``_launch``'s
    phase name and flag), from the SASS."""
    name = phase + ("_pnc" if phase in ("part1", "update") and predict_nc
                     else "")
    return _cell_ops()[_dtype_name(dtype)][name]


def _sed_work(fields, rho, dtype, nsub=1):
    """(bytes, operations) of the sedimentation at ``nsub`` sub-steps on
    these inputs: 11 fields read and 8 written per sub-step plus the two
    surface fields; per cell and sub-step the level body's operations,
    each species' branch only where it is present (at one sub-step the
    inputs' presence; the speeds' gates, QSMALL)."""
    from miniweatherml_tpu_torch.physics.p3 import QSMALL
    ops = _sed_ops()[_dtype_name(dtype)]
    qc, qr, qi = fields[0], fields[2], fields[4]
    cells = qc.numel()
    item = qc.element_size()
    nbytes = nsub * (19 * cells * item) + 2 * item * cells // rho.shape[1]
    work = (cells * ops["update"] + int((qr >= QSMALL).sum()) * ops["rain"]
            + int((qi >= QSMALL).sum()) * ops["ice"]
            + int((qc >= QSMALL).sum()) * ops["cloud"])
    return nbytes, nsub * work


def _sed_registers(kernel, dtype):
    """(registers, spill store bytes) of the table-tier, prescribed-nc
    ``kernel`` ("sed_step_kernel" or "sed_columns_kernel") from the ptxas
    report."""
    t = "f" if dtype == torch.float32 else "d"
    rows = [(r, st) for m, r, st, *_ in _ptxas_report("p3_sed")
            if f"{kernel}I{t}Lb1ELb0E" in m]
    if len(rows) != 1:
        raise AssertionError(f"no single {kernel} <{t}> tables in p3_sed")
    return rows[0]


def _sed_check(tag, seen, dtype, tol):
    """sed_step and the rerun of sed_columns against their plain versions
    on what the step handed them: the speed (against the oracle
    _p3_sed_vmax too) and the count made of it, the one sub-step's outputs,
    and the rerun at the step's count with do_predict_nc both ways, and at
    a dt that makes dt vmax / (0.9 dz_min) = 3.5 (4 sub-steps) against
    sed_columns' plain version from the inputs; each pass timed beside its
    bound, with sed_columns alone from the inputs (the former pair's
    second kernel) beside it.  Returns the record of the sedimentation at
    the step's count, (ms, plain ms, bound ms, bound_by), and the largest
    abs error of the checks."""
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as sed
    sa, sk = seen["sed_step"]
    ca, ck = seen["sed_columns"]
    fields, (rho, temp, dz, dt, dtab) = sa[:8], sa[8:13]
    nsub_t = ca[12]
    pnc = sk["do_predict_nc"]
    if seen["launches"] != {"sed_step": 1, "sed_columns": 1}:
        raise AssertionError(f"{tag}: sedimentation launches per P3 step "
                             f"{seen['launches']}")
    ref_v, ref_one = sed.step_plain(*sa, pnc, 1)
    oracle = sed.vmax_plain(*fields, rho, temp, dtab)
    got_v, got_one = sed.sed_step(*sa, **sk)
    torch.cuda.synchronize()
    n_ref, r_ref = _nsub(dt, ref_v, dz)
    n_got, r_got = _nsub(dt, got_v, dz)
    err_v, rel_v = _rel(ref_v, got_v)
    err_1, rel_1 = _worst(zip(ref_one, got_one))
    bit_1 = all(torch.equal(a, b) for a, b in zip(ref_one, got_one))
    print(f"[31] {tag} sed_step: vmax {float(got_v):.9e} m/s, plain "
          f"{float(ref_v):.9e} (oracle {float(oracle):.9e}), rel err "
          f"{rel_v:.3e}; nsub {int(n_got)} (plain {int(n_ref)}, the step's "
          f"{int(nsub_t)}) at dt vmax / (0.9 dz_min) = {r_got:.9f} (plain "
          f"{r_ref:.9f}); one sub-step do_predict_nc {pnc}: max abs err "
          f"{err_1:.3e}, rel {rel_1:.3e} (tol {tol:g}), bit for bit "
          f"{bit_1}; launches per P3 step {seen['launches']}", flush=True)
    if (not rel_v <= tol or not rel_1 <= tol or int(n_got) != int(n_ref)
            or not torch.equal(n_got, nsub_t)
            or not torch.equal(ref_v, oracle)):
        raise AssertionError(f"{tag} sed_step: rel {rel_v:.3e} / "
                             f"{rel_1:.3e}, nsub {int(n_got)} / {int(n_ref)}"
                             f" / {int(nsub_t)}")
    del ref_one, got_one
    cases = [("step", dt, pnc), ("step", dt, not pnc)]
    if float(got_v) > 0.0:
        dt3 = 3.5 * 0.9 * float(dz.min()) / float(got_v)
        cases.append((f"dt {dt3:.3f} s (ratio "
                      f"{_nsub(dt3, got_v, dz)[1]:.9f})", dt3, False))
    else:
        print(f"[31] {tag}: no hydrometeor falls (vmax 0), so every dt "
              "gives 1 sub-step", flush=True)

    def passes(dt_, pnc_):
        """sed_step, the count and the rerun, as p3_scheme runs them."""
        v, one = sed.sed_step(*fields, rho, temp, dz, dt_, dtab,
                              do_predict_nc=pnc_)
        n = _count(dt_, v, dz)
        return sed.sed_columns(*fields, rho, temp, dz, dt_, n, dtab,
                               do_predict_nc=pnc_, rerun=one), n

    def plain(dt_, pnc_):
        v, one = sed.step_plain(*fields, rho, temp, dz, dt_, dtab, pnc_, 1)
        n = _count(dt_, v, dz)
        return sed.columns_plain(*fields, rho, temp, dz, dt_, n, dtab, pnc_,
                                 1, one)

    err_c, recs = max(err_v, err_1), {}
    for label, dt_, pnc_ in cases:
        got, n = passes(dt_, pnc_)
        ref = sed.columns_plain(*fields, rho, temp, dz, dt_, n, dtab, pnc_,
                                1)
        torch.cuda.synchronize()
        err, rel = _worst(zip(ref, got))
        bit = all(torch.equal(a, b) for a, b in zip(ref, got))
        err_c = max(err_c, err)
        del ref, got
        ns = int(n)
        nbytes, ops = _sed_work(fields, rho, dtype, ns)
        bms, by = _bound(nbytes, ops, dtype)
        ms = _time_ms(lambda: passes(dt_, pnc_))
        ms_step = _time_ms(lambda: sed.sed_step(
            *fields, rho, temp, dz, dt_, dtab, do_predict_nc=pnc_))
        ms_cols = _time_ms(lambda: sed.sed_columns(
            *fields, rho, temp, dz, dt_, n, dtab, do_predict_nc=pnc_))
        pms = _time_ms(lambda: plain(dt_, pnc_), reps=3)
        print(f"[31] {tag} sedimentation {label}, {ns} sub-step(s), "
              f"do_predict_nc {pnc_}: against sed_columns' plain version "
              f"from the inputs max abs err {err:.3e}, rel {rel:.3e} (tol "
              f"{tol:g}), bit for bit {bit}; sed_step + count + rerun "
              f"{ms:.3f} ms (sed_step alone {ms_step:.3f} ms), sed_columns "
              f"alone from the inputs {ms_cols:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
              f"{ops / 1e9:.2f} GFLOP), {bms / ms:.1%} of the bound  "
              f"[{_card()}]", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{tag} sedimentation {label}: rel "
                                 f"{rel:.3e}")
        if label == "step" and pnc_ == pnc:
            recs = (ms, pms, bms, by)
    return recs, err_c


def phase_p3_rates_sed():
    """rates_pre's presence flags on RATES_PRE_FLAG_CASES; then every
    per-cell phase of a P3 step (STEP_PHASES; part3 and the output pass in
    _tails_check) and the sedimentation (sed_step, the count and the rerun
    of sed_columns) against their plain versions on what one step of each
    of _p3_step_chains hands them at 512x512x64, f32 and f64, each timed
    beside its bound; the records of the kernels line from the early-storm
    f32 step (the main cell)."""
    from miniweatherml_tpu_torch.physics import p3_sed_cuda as sed
    for kernel in ("step", "columns"):
        for dtype in (torch.float32, torch.float64):
            b, t, sm = sed.launch_config(kernel, True, False, dtype,
                                         512 * 512 * 64, 64)
            regs, spill = _sed_registers(f"sed_{kernel}_kernel", dtype)
            print(f"[31] sed_{kernel} {_dtype_name(dtype)} launch: {b} "
                  f"blocks of {t} threads, {sm} B shared per block (the "
                  f"staged ice columns and rain rows); {regs} registers, "
                  f"{spill} B spill stores", flush=True)
    _own_path_registers()
    recs = {"p3_rates": {"max_abs_err": 0.0},
            "p3_sedimentation": {"max_abs_err": 0.0},
            "p3_part3": {"max_abs_err": 0.0},
            "p3_wrapper_out": {"max_abs_err": 0.0}}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        err = _rates_pre_flags_check(dtype, tol)
        if dtype == torch.float32:
            recs["p3_rates"]["max_abs_err"] = err
    for chain, build in _p3_step_chains():
        for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
            tag = f"{chain} {dtype}"
            seen = _p3_step_rates_sed(build, dtype)
            main = chain == "early-storm" and dtype == "float32"
            _own_path_report(tag, seen)
            checks = {ph: _cell_check(tag, ph, seen[ph][0],
                                      seen[ph][0][1][0].dtype, tol)
                      for ph in STEP_PHASES}
            rates = [checks["rates_pre"], checks["rates_post"]]
            sed_rec, sed_err = _sed_check(tag, seen,
                                          seen["sed_step"][0][0].dtype, tol)
            if dtype == "float32":
                r = recs["p3_rates"]
                r["max_abs_err"] = max(r["max_abs_err"],
                                       *(x[0] for x in rates))
                s = recs["p3_sedimentation"]
                s["max_abs_err"] = max(s["max_abs_err"], sed_err)
            if main:
                recs["p3_rates"].update(
                    ms=sum(x[1] for x in rates),
                    plain_ms=sum(x[2] for x in rates),
                    bound_ms=sum(x[3] for x in rates), bound_by=rates[1][4])
                recs["p3_sedimentation"].update(
                    ms=sed_rec[0], plain_ms=sed_rec[1], bound_ms=sed_rec[2],
                    bound_by=sed_rec[3])
            for name, (err, ms, pms, bms, by) in _tails_check(
                    tag, seen, seen["sed_step"][0][0].dtype, tol).items():
                r = recs[name]
                if dtype == "float32":
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                if main:
                    r.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
            del seen
            torch.cuda.empty_cache()
    return recs


# operations per rain cell of kessler_min_step, read from its source (pow
# counted as one): the sub-cycle step's speed and step; part3's and the
# output pass's come from the SASS (_cell_ops)
TAIL_OPS = {"min_step": 20}
# _tails_check's kernels as phases of csrc/p3_cellwise.cu (the table tier)
TAIL_PHASES = {"p3_part3": "part3", "p3_part3 diagnostics": "part3_diag",
               "p3_wrapper_out": "wrapper_out"}


def _tails_check(tag, seen, dtype, tol):
    """[32] part3 (without and with its diagnostics) and the output pass
    against their plain versions on what the P3 step handed them: part3
    within ``tol`` of each output's scale (its pow and log10 need not round
    as PyTorch's; whether it is bit for bit is printed), the output pass
    bit for bit; each timed beside its bound.  Returns {name: (max abs
    err, ms, plain ms, bound ms, bound_by)} for part3 (its error the larger
    of both forms', its times those of the form the main path runs) and
    the output pass."""
    from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as cw
    from miniweatherml_tpu_torch.physics.p3 import QSMALL, T_HOMOGFRZ
    a3, _ = seen["p3_part3"]
    aw, _ = seen["p3_wrapper_out"]
    ice = int((a3[4] >= QSMALL).sum())
    frz = int((((a3[0] >= QSMALL) | (a3[2] >= QSMALL))
               & (a3[10] < T_HOMOGFRZ)).sum())
    table = () if a3[14] is None else (cw.ice_table(a3[14], a3[0]),)
    table_d = () if a3[14] is None else (
        cw.ice_table(a3[14], a3[0], cw.PART3_DIAG_COLS),)

    def flat(fn):
        def run(*a):
            prog, diag = fn(*a, diagnostics=True)
            return (*prog, *diag.values())
        return run
    recs = {}
    for name, kern, plain, args, extra in (
            ("p3_part3", cw.p3_part3, cw.part3_plain, a3, table),
            ("p3_part3 diagnostics", flat(cw.p3_part3),
             flat(cw.part3_plain), a3, table_d),
            ("p3_wrapper_out", cw.p3_wrapper_out, cw.wrapper_out_plain, aw,
             ())):
        ref = plain(*args)
        got = kern(*args)
        torch.cuda.synchronize()
        err, rel = _worst(zip(ref, got))
        differ = sum(int((a != b).sum()) for a, b in zip(ref, got))
        nbytes = _nbytes([a for a in args if torch.is_tensor(a)], extra, got)
        cells = got[0].numel()
        del ref, got
        ms = _time_ms(lambda: kern(*args))
        pms = _time_ms(lambda: plain(*args), reps=3)
        bms, by = _bound(nbytes, _phase_ops(TAIL_PHASES[name], False, dtype)
                         * cells, dtype)
        note = (f"; {ice} cells with ice, {frz} freezing"
                if name.startswith("p3_part3") else "")
        print(f"[32] {tag} {name} ({len(args)} in{note}): max abs err "
              f"{err:.3e}, rel {rel:.3e} (tol {tol:g}), bit for bit "
              f"{differ == 0} ({differ} values differ); kernel {ms:.3f} ms, "
              f"plain {pms:.3f} ms, bound {bms:.3f} ms ({by}: "
              f"{nbytes / 1e9:.3f} GB), {bms / ms:.1%} of the bound",
              flush=True)
        if not rel <= tol or (name == "p3_wrapper_out" and differ):
            raise AssertionError(f"{tag} {name}: rel {rel:.3e}, {differ} "
                                 "values differ")
        if name == "p3_part3 diagnostics":
            recs["p3_part3"] = (max(err, recs["p3_part3"][0]),
                                *recs["p3_part3"][1:])
        else:
            recs[name] = (err, ms, pms, bms, by)
    return recs


def _tail_registers():
    """[32] the registers, spills and stack of the four kernels' entry
    functions (phase 2's ptxas reports)."""
    for lib, keys in (("kessler", ("min_step",)),
                      ("p3_cellwise", ("Part3", "WrapperOut")),
                      ("surrogate", ("surrogate",))):
        for mangled, regs, st, ld, stack, smem in _ptxas_report(lib):
            if any(k in mangled for k in keys):
                print(f"[32] {lib} {_entry_label(lib, mangled)}: {regs} "
                      f"registers, {st} B spill stores, {ld} B spill loads, "
                      f"{stack} B stack", flush=True)


def phase_micro_tails():
    """[32] the Kessler sub-cycle step on the Kessler chain's 512x512x64
    state after one step (little rain, so it barely limits the step) and on
    phase 4's heavy-rain 512x512x64 columns (which must give a count of 2
    or more); the surrogate's forward pass in both kernel forms on cell
    (f)'s state after one step (the shipped 5-10-4 model, online), and the
    general form on SURROGATE_WIDE's models on corners of that state; each
    against its plain version in f32 and in f64 (the state cast), bit for
    bit, timed beside its bound.  (Part3 and the P3 output
    pass run inside phase 31.)  Returns the records of the kernels line."""
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    from miniweatherml_tpu_torch.experiments.supercell_example import build
    from miniweatherml_tpu_torch.ml.mlp import init_mlp
    from miniweatherml_tpu_torch.physics import kessler_cuda as kc
    from miniweatherml_tpu_torch.physics import kessler_surrogate_cuda as sc
    _tail_registers()
    recs = {}
    state, mods, dycore = build(_bench_cfg(512, 512, 64, 1, "float32"),
                                "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    dz = state.grid.dz
    fields = (state["precip_liquid"], state["density_dry"])
    del state, mods, dycore
    rng = np.random.default_rng(7)
    err = 0.0
    for case in ("chain state", "heavy-rain columns"):
        for dtype in (torch.float32, torch.float64):
            if case == "chain state":
                rr, rd = (f.to(dtype) for f in fields)
                cdt, cdz = dt, dz
            else:
                rd, _, _, _, qr, _, cdz, cdt = _rain_columns(dtype, rng)
                rr = qr * rd
                del qr
            ref = kc.min_step_plain(rr, rd, cdt, cdz)
            got = kc.min_step(rr, rd, cdt, cdz)
            bit = torch.equal(ref, got)
            err = max(err, float((got - ref).abs()))
            count = int(torch.ceil(cdt / got))
            main = case == "chain state" and dtype == torch.float32
            ms = _time_ms(lambda: kc.min_step(rr, rd, cdt, cdz), reps=10)
            pms = _time_ms(lambda: kc.min_step_plain(rr, rd, cdt, cdz),
                           reps=3)
            bms, by = _bound(*_min_step_need(rr, got), dtype)
            # dt / step is the largest dt v / (0.8 dz_lev) over the cells
            # (1 where no cell limits the step)
            print(f"[32] kessler min_step {case} 512x512x64 "
                  f"{_dtype_name(dtype)}: {float(got):.9e} s (plain "
                  f"{float(ref):.9e}), bit for bit {bit}, count {count} at "
                  f"dt {cdt:.6f} s, max dt v / (0.8 dz_lev) "
                  f"{float(cdt / got):.6f} (plain {float(cdt / ref):.6f}); "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                  f"{bms:.3f} ms ({by}), {bms / ms:.1%} of the bound",
                  flush=True)
            if not bit:
                raise AssertionError(f"min_step {case} {dtype}: "
                                     f"{float(got)!r} against {float(ref)!r}")
            if case == "heavy-rain columns" and count < 2:
                raise AssertionError(f"min_step {case} {dtype}: count "
                                     f"{count}, the columns did not limit "
                                     "the step")
            if main:
                recs["min_step"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                        bound_by=by)
            del rr, rd, ref, got
    recs["min_step"]["max_abs_err"] = err
    del fields

    cfg = _surrogate_cfg(_bench_cfg(512, 512, 64, 1, "float32"))
    state, mods, dycore = inference_surrogate.build(cfg, "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    micro = mods[1].__self__
    params, widths = micro._cast_for(state)[4]
    scl = micro._cast_for(state)[2:4]
    names = ("temp", "density_dry", "water_vapor", "cloud_liquid",
             "precip_liquid")
    fields = [state[n] for n in names]
    del state, mods, dycore
    err = 0.0
    for dtype in (torch.float32, torch.float64):
        fs = [f.to(dtype) for f in fields]
        ps = params.to(dtype)
        for form in ("fixed", "general"):
            e, ms, pms, bms, by = _surrogate_check(
                f"cell (f) state 512x512x64, model {widths}", fs, ps, widths,
                form, dtype, plain_reps=3 if form == "fixed" else 0)
            err = max(err, e)
            if dtype == torch.float32 and form == "fixed":
                recs["surrogate_forward"] = dict(
                    ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        del fs, ps
    # the general form on wider and deeper models (seeded weights, the
    # shipped scaling tables) on a corner of the same state
    gen = torch.Generator("cuda").manual_seed(11)
    for name, sizes, scale, (nz, ny, nx) in SURROGATE_WIDE:
        model = init_mlp(sizes, gen, scale, torch.float64)
        for dtype in (torch.float32, torch.float64):
            ps, ws = sc.pack_mlp([(W.to(dtype), b.to(dtype))
                                  for W, b in model.weights],
                                 *(t.to(dtype) for t in scl))
            fs = [f[:, :nz, :ny, :nx].to(dtype).contiguous() for f in fields]
            err = max(err, _surrogate_check(
                f"{name} {nx}x{ny}x{nz} ({ps.numel() * ps.element_size()} B "
                "of parameters)", fs, ps, ws, "general", dtype,
                plain_reps=1)[0])
            del fs, ps
    del fields
    recs["surrogate_forward"]["max_abs_err"] = err
    torch.cuda.empty_cache()
    return recs


def _min_step_need(rho_r, step) -> tuple[int, int]:
    """(bytes, operations) that kessler_min_step needs on this data: rho_r
    below the top level; rho_d, and its column's bottom density, only where
    a cell there holds rain; the step written; TAIL_OPS' count for each
    rain cell (a dry cell needs one compare)."""
    rain = rho_r[:, :-1] != 0
    rho_d = rain.clone()
    rho_d[:, 0] |= rain.any(dim=1)
    nbytes = (rho_r.element_size() * (rain.numel() + int(rho_d.sum()))
              + step.element_size())
    return nbytes, TAIL_OPS["min_step"] * int(rain.sum())


# (name, widths, scale of the seeded weights, (nz, ny, nx) cells) of phase
# 32's wide models: a hidden layer over the fixed form's, two 64-wide
# layers, 18 layers, two 256-wide layers (over 227 KiB of parameters, a
# block's shared memory) and one too wide for its activations to stay in
# shared memory, on fewer cells (the plain version keeps a field per unit)
SURROGATE_WIDE = (("5-17-4", (5, 17, 4), 0.5, (32, 128, 128)),
                  ("5-64-64-4", (5, 64, 64, 4), 0.2, (32, 128, 128)),
                  ("18 layers", (5,) + (8,) * 17 + (4,), 0.5, (32, 128, 128)),
                  ("5-256-256-4", (5, 256, 256, 4), 0.1, (32, 128, 128)),
                  ("5-8000-4", (5, 8000, 4), 0.02, (16, 32, 32)))


def _surrogate_check(tag, fs, ps, widths, form, dtype, plain_reps):
    """[32] one surrogate kernel form against the plain version, bit for
    bit, timed beside its bound (and the plain version, with plain_reps >
    0).  Returns (max abs err, ms, plain ms or None, bound ms, bound_by)."""
    from miniweatherml_tpu_torch.physics import kessler_surrogate_cuda as sc
    ref = sc.surrogate_forward_plain(*fs, ps, widths)
    got = sc._launch(form, *fs, ps, widths)
    torch.cuda.synchronize()
    err, rel = _worst(zip(ref, got))
    differ = sum(int((a != b).sum()) for a, b in zip(ref, got))
    nbytes = _nbytes(fs, ps, got)
    del ref, got
    ms = _time_ms(lambda: sc._launch(form, *fs, ps, widths),
                  reps=10)
    pms = (_time_ms(lambda: sc.surrogate_forward_plain(*fs, ps, widths),
                    reps=plain_reps) if plain_reps else None)
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    # normalise (3 a field), a multiply and an add per weight, the biases
    # and activations, denormalise and clamp
    ops = (15 + 2 * macs + 2 * sum(widths[1:]) + 12) * fs[0].numel()
    bms, by = _bound(nbytes, ops, dtype)
    tile = ""
    if form == "general":
        m, smem, gact = sc._general_tile(widths, dtype)
        tile = (f", tile {m} cells, {smem} B shared"
                + (", activations in global scratch" if gact else ""))
    plain = "" if pms is None else f", plain {pms:.3f} ms"
    print(f"[32] surrogate_forward {form} form, {tag} {_dtype_name(dtype)}"
          f"{tile}: max abs err {err:.3e}, rel {rel:.3e}, bit for bit "
          f"{differ == 0} ({differ} values differ); kernel {ms:.3f} ms"
          f"{plain}, bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
          f"{ops / 1e9:.2f} GFLOP), {bms / ms:.1%} of the bound", flush=True)
    if differ:
        raise AssertionError(f"surrogate_forward {form} {tag} {dtype}: "
                             f"{differ} values differ from the plain version")
    return err, ms, pms, bms, by


def _p3_active_build(cfg, device):
    """The supercell_p3 chain with bench.py's all-cells-active seeds."""
    from miniweatherml_tpu_torch.experiments import supercell_p3
    state, mods, dycore = supercell_p3.build(cfg, device)
    return supercell_p3.seed_all_active(state), mods, dycore


def _host_syncs(build, cfg):
    """Synchronizing operations in one step after a warm step, as counted by
    torch.cuda's sync debug mode."""
    state, mods, dycore = build(cfg, "cuda")
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for m in mods:
                state = m(state, dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def phase_p3_references():
    """16x8x10 f64 P3 slice with seeded layers and part3 diagnostics: card
    against CPU; the card's run launches the diagnostics form of part3."""
    from miniweatherml_tpu_torch.experiments import supercell_p3

    cfg = _supercell_cfg(16, 8, 10, 40000.0, 40000.0, 16000.0, 100.0,
                         "float64")
    cfg.extras["p3_diagnostics"] = True
    outs = []
    for device in ("cpu", "cuda"):
        state, mods, dycore = supercell_p3.build(cfg, device)
        state = supercell_p3.seed_layers(state)
        dt = dycore.compute_time_step(state)
        n0 = profiling.counter("p3_part3.launches")
        for _ in range(3):
            for m in mods:
                state = m(state, dt)
        outs.append(state)
    part3 = profiling.counter("p3_part3.launches") - n0
    if part3 != 3:
        raise AssertionError(f"P3 slice with diagnostics: {part3} part3 "
                             "launches on the card in 3 steps")
    if float(outs[1]["ice"].max()) <= 0.0:
        raise AssertionError("P3 reference slice holds no ice")
    worst = max(_rel(outs[0][k], outs[1][k].cpu())[1] for k in outs[0].fields)
    print(f"[12] 16x8x10 f64 3-step P3 slice, card vs CPU: worst error over "
          f"field scale {worst:.3e} (tol 1e-7)", flush=True)
    if not worst <= 1e-7:
        raise AssertionError(f"P3 card vs CPU slice: {worst:.3e}")


def phase_p3_heartbeat():
    from miniweatherml_tpu_torch.experiments import supercell_p3
    from miniweatherml_tpu_torch.physics.p3 import MicrophysicsP3
    from scipy.io import netcdf_file

    os.makedirs(OUT_DIR, exist_ok=True)
    prefix = os.path.join(OUT_DIR, "chip_smoke_supercell_p3")
    cfg = _supercell_cfg(100, 1, 40, 100000.0, 100000.0, 20000.0, 50.0,
                         "float32", out_freq=25.0, out_prefix=prefix)
    cfg.extras["p3_diagnostics"] = True
    state = supercell_p3.run(cfg, "cuda")
    maxw = _check_state("13", state)
    with netcdf_file(prefix + ".nc", "r", mmap=False) as nc:
        missing = [k for k in MicrophysicsP3.DIAG_FIELDS
                   if k not in nc.variables]
        nt = nc.variables["t"].shape[0]
    if missing or nt != 3:
        raise AssertionError(f"P3 NetCDF: missing {missing}, {nt} records")
    dbz = state["equiv_reflectivity"]
    print(f"[13] supercell_p3 100x1x40 f32 with diagnostics: maxw "
          f"{maxw:.6e}, dBZ in [{float(dbz.min()):.2f}, "
          f"{float(dbz.max()):.2f}], wrote {prefix}.nc", flush=True)


# -- city / building ------------------------------------------------------------

def _city_cfg(case, nx, ny, nz, nens, dtype, steps=None, dt_phys=0.0):
    """inputs/input_city.yaml (or input_building.yaml) on an nx x ny x nz
    grid; ``steps`` CFL steps, or ``steps`` steps of ``dt_phys``."""
    from miniweatherml_tpu_torch.config import config_from_dict
    zlen = 300.0 if case == "city" else 500.0
    dt = dt_phys or 0.6 * min(2000.0 / nx, 2000.0 / ny, zlen / nz) / 430.0
    return config_from_dict(dict(
        sim_time=steps * dt * (1.0 if dt_phys else 1.0 - 1e-9), nens=nens,
        nx_glob=nx, ny_glob=ny, nz=nz, xlen=2000.0, ylen=2000.0, zlen=zlen,
        init_data=case, out_prefix=os.path.join(OUT_DIR, "chip_smoke_city"),
        dt_phys=dt_phys, out_freq=-1.0, enable_gravity=False, dtype=dtype))


def _crossflow_build(cfg, device):
    """The city / building chain with a uniform v = 2, w = 0.5 m/s: from v =
    w = 0 the Riemann solver's upwind choice beside the buildings is decided
    by round-off (tests/test_torch_dycore.py::crossflow), so card and CPU
    are compared off that tie."""
    from miniweatherml_tpu_torch.experiments import simple_city
    state, mods, dycore = simple_city.build_chain(cfg, device)
    return state.replace_fields(vvel=torch.full_like(state["vvel"], 2.0),
                                wvel=torch.full_like(state["wvel"], 0.5)
                                ), mods, dycore


def phase_city_references():
    """Small f64 building and city slices of the simple_city chain with a
    cross-flow, card against the port's CPU run, one step each, at 1e-9 of
    each field's scale.  Only one step is bounded: beside a building the
    flow varies by ~1e-7 of its speed, where the WENO smoothness indicators
    (quadratic forms of the raw values, ops/weno_fused.py) are a few
    rounding quanta of u^2, so a one-ulp input difference changes the
    stencil weights by whole factors.  The CPU alone, with every field
    perturbed by 1e-15, differs by ~1e-9 of wvel's scale after one step
    and ~1e-7 after two."""
    for case, shape in (("building", (48, 16, 16, 1)),
                        ("city", (64, 64, 12, 2))):
        cfg = _city_cfg(case, *shape, "float64", steps=1)
        outs = []
        for device in ("cpu", "cuda"):
            state, mods, dycore = _crossflow_build(cfg, device)
            dt = dycore.compute_time_step(state)
            for m in mods:
                state = m(state, dt)
            outs.append(state)
        if not float(outs[1]["immersed_proportion"].max()) == 1.0:
            raise AssertionError(f"{case} slice has no immersed cells")
        worst = max(_rel(outs[0][k], outs[1][k].cpu())[1]
                    for k in outs[0].fields)
        print(f"[16] {'x'.join(map(str, shape))} f64 1-step {case} slice, "
              f"card vs CPU: worst error over field scale {worst:.3e} "
              "(tol 1e-9)", flush=True)
        if not worst <= 1e-9:
            raise AssertionError(f"{case} card vs CPU slice: {worst:.3e}")


def phase_restart():
    """2 steps, a checkpoint, a restart from it on the card and 2 more steps
    against 4 straight steps: every field equal, bit for bit."""
    from miniweatherml_tpu_torch.experiments import simple_city
    from miniweatherml_tpu_torch.experiments.driver import run_main_loop
    from miniweatherml_tpu_torch.io.checkpoint import load_checkpoint

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_restart.npz")
    dt = 2.0 ** -6
    cfg4 = _city_cfg("city", 64, 64, 12, 2, "float32", steps=4, dt_phys=dt)
    cfg2 = _city_cfg("city", 64, 64, 12, 2, "float32", steps=2, dt_phys=dt)
    state, mods, dycore = simple_city.build_chain(cfg4, "cuda")
    straight = run_main_loop(state.clone(), cfg4, mods, dycore, quiet=True)
    run_main_loop(state, cfg2, mods, dycore, quiet=True,
                  checkpoint_freq=2 * dt, checkpoint_path=path)
    restored, etime = load_checkpoint(path, "cuda")
    resumed = run_main_loop(restored, cfg4, mods, dycore, quiet=True,
                            etime0=etime)
    differ = [k for k in straight.fields
              if not torch.equal(straight[k], resumed[k])]
    print(f"[17] restart 64x64x12x2 f32 city chain: 2 steps + checkpoint at "
          f"etime {etime:g} + 2 steps against 4 straight: "
          f"{len(straight.fields) - len(differ)} of {len(straight.fields)} "
          "fields equal", flush=True)
    if differ or etime != 2 * dt or resumed.device.type != "cuda":
        raise AssertionError(f"restart differs in {differ} (etime {etime})")


# -- the Kessler MLP surrogate ----------------------------------------------

EXAMPLES = os.path.join(ROOT, "inputs", "examples")


def _surrogate_cfg(cfg, online=True, compare=False):
    """``cfg`` with inference_surrogate's YAML keys: the shipped example
    model as .npz (the same arrays as its Keras HDF5, which needs h5py)."""
    cfg.extras.update(
        nn_weights=os.path.join(EXAMPLES,
                                "supercell_kessler_example_weights.npz"),
        nn_input_scaling=os.path.join(EXAMPLES,
                                      "supercell_kessler_input_scaling.txt"),
        nn_output_scaling=os.path.join(
            EXAMPLES, "supercell_kessler_output_scaling.txt"),
        surrogate_online=online, surrogate_compare=compare)
    return cfg


def _timed_micro_build(build, times):
    """``build`` with CUDA events recorded around the micro module's
    time_step (step_modules[1]); each step appends its (start, end)."""
    def timed_build(cfg, device):
        state, mods, dycore = build(cfg, device)
        micro = mods[1]

        def timed(s, dt):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = micro(s, dt)
            e1.record()
            times.append((e0, e1))
            return out
        return state, [mods[0], timed, *mods[2:]], dycore
    return timed_build


def phase_surrogate_slice(card):
    """The online surrogate at bench.py's 512x512x64 f32 grid, 10 steps,
    with the surrogate's own time per step; then compare mode, 3 steps.
    Returns the online run's launches (the main path of the surrogate)."""
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    from miniweatherml_tpu_torch.physics import kessler_surrogate_cuda as sc

    times = []
    cfg = _surrogate_cfg(_bench_cfg(512, 512, 64, 10, "float32"))
    # the kernel form of each launch (surrogate_forward calls sc._launch)
    forms, launch = [], sc._launch

    def record(form, *args):
        forms.append(form)
        return launch(form, *args)
    sc._launch = record
    try:
        launches, res, _ = _run_cell(
            "18", cfg, card, chain="surrogate",
            build=_timed_micro_build(inference_surrogate.build, times),
            per_step={**DYCORE_PER_STEP, "kessler_step": 0, "min_step": 0,
                      "surrogate_forward": 1}, glue=True)
    finally:
        sc._launch = launch
    torch.cuda.synchronize()
    # the shipped 5-10-4 model runs the fixed-width form
    if not forms or set(forms) != {"fixed"}:
        raise AssertionError(f"[18] surrogate launches in the forms "
                             f"{sorted(set(forms))}, not the fixed-width "
                             "form alone")
    # after the warm-up step, without the profiled step
    ms = [a.elapsed_time(b) for a, b in times[1:1 + res["steps"]]]
    step_ms = 1e3 * res["elapsed_s"] / res["steps"]
    print(f"[18] surrogate time_step (online, no comparison): "
          f"{np.mean(ms):.3f} ms per step (median {np.median(ms):.3f}, min "
          f"{min(ms):.3f}; CUDA events over {len(ms)} steps), "
          f"{np.mean(ms) / step_ms:.2%} of the {step_ms:.2f} ms step  "
          f"[{card}]", flush=True)

    def finish(state):
        d = state["surrogate_diffs"].tolist()
        if not (all(math.isfinite(v) for v in d) and any(d)):
            raise AssertionError(f"surrogate diffs {d}")
        print(f"[19] mean diff NN - Kessler [temp, rho_v, rho_c, rho_r] of "
              f"the last step: [{d[0]: .6e}, {d[1]: .6e}, {d[2]: .6e}, "
              f"{d[3]: .6e}]", flush=True)
    cfg = _surrogate_cfg(_bench_cfg(512, 512, 64, 3, "float32"),
                         online=False, compare=True)
    _run_cell("19", cfg, card, chain="surrogate",
              build=inference_surrogate.build, finish=finish,
              per_step={**DYCORE_PER_STEP, "kessler_step": 1, "min_step": 1,
                        "surrogate_forward": 1})
    return launches


def _surrogate_slice(cfg, device, steps, perturb=0.0):
    """The inference_surrogate chain on ``device`` after ``steps`` steps;
    with ``perturb``, every 3-D field starts scaled by 1 + perturb * (u -
    1/2), u uniform from a seeded generator."""
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    state, mods, dycore = inference_surrogate.build(cfg, device)
    if perturb:
        gen = torch.Generator(device).manual_seed(0)
        state = state.replace_fields(**{
            k: v * (1.0 + perturb * (torch.rand(
                v.shape, generator=gen, dtype=v.dtype, device=device) - 0.5))
            for k, v in state.fields.items() if v.dim() == 4})
    dt = dycore.compute_time_step(state)
    for _ in range(steps):
        for m in mods:
            state = m(state, dt)
    return state


def phase_surrogate_references():
    """16x8x10 f64 surrogate chains, card against the port's CPU run: online
    (and comparing) for 1 step, and in compare mode (Kessler's result kept,
    the NN run and the diffs stored every step) for 3 steps.  The online
    chain is bounded at one step: with the NN's fields fed back, the CPU
    run alone with every field perturbed by 1e-15 moves by ~1e-6 of cloud
    water's scale within two steps (printed here beside the card's
    3-step difference)."""
    worst = {}
    for label, online, steps in (("online", True, 1), ("compare", False, 3),
                                 ("online", True, 3)):
        cfg = _surrogate_cfg(_supercell_cfg(16, 8, 10, 40000.0, 40000.0,
                                            10000.0, 100.0, "float64"),
                             online=online, compare=True)
        outs = [_surrogate_slice(cfg, d, steps) for d in ("cpu", "cuda")]
        errs = {k: _rel(outs[0][k], outs[1][k].cpu())[1]
                for k in outs[0].fields}
        name = max(errs, key=errs.get)
        worst[(label, steps)] = errs[name]
        line = (f"[20] 16x8x10 f64 {steps}-step {label} surrogate slice, "
                f"card vs CPU: worst error over field scale {errs[name]:.3e}"
                f" ({name})")
        if steps == 3 and online:
            cpu = _surrogate_slice(cfg, "cpu", steps, perturb=1e-15)
            spread = max(_rel(outs[0][k], cpu[k])[1] for k in outs[0].fields)
            _check_state("20", outs[1])
            print(line + f"; the CPU run against itself with every field "
                  f"perturbed by 1e-15: {spread:.3e} (not bounded)",
                  flush=True)
            continue
        print(line + f" (tol 1e-7); diffs "
              f"{outs[1]['surrogate_diffs'].tolist()}", flush=True)
        if not errs[name] <= 1e-7:
            raise AssertionError(f"surrogate {label} card vs CPU slice: "
                                 f"{errs[name]:.3e} in {name}")


def phase_surrogate_workflow():
    """Harvest -> train -> deploy on the card, inside chip_smoke_out/: the
    harvest writes its dataset and metadata sidecar into the working
    directory, so the repo's own copies are never touched."""
    from miniweatherml_tpu_torch.config import load_config
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    from miniweatherml_tpu_torch.experiments.gather_statistics import (
        run_gather_statistics)
    from miniweatherml_tpu_torch.experiments.generate_micro_data import (
        run_generate_micro_data)
    from miniweatherml_tpu_torch.ml.surrogate_data import (DataGenerator,
                                                           load_dataset)
    from miniweatherml_tpu_torch.ml.train import train_mlp
    from miniweatherml_tpu_torch.physics.kessler_surrogate import (
        MicrophysicsKesslerSurrogate)

    os.makedirs(OUT_DIR, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(OUT_DIR)
    try:
        # inputs/surrogate_example.yaml's 250x1x50 grid for 6 s (~10 steps)
        cfg = load_config(os.path.join(ROOT, "inputs",
                                       "surrogate_example.yaml"))
        cfg.extras.pop("keras_weights_h5")
        cfg = _surrogate_cfg(cfg, online=False, compare=True)
        cfg.sim_time = 6.0
        cfg.out_prefix = os.path.join(OUT_DIR, "chip_smoke_surrogate")
        _, gatherer = run_gather_statistics(cfg, "cuda", quiet=True)
        gen = DataGenerator(fname=os.path.join(
            OUT_DIR, "chip_smoke_surrogate_data.nc"), samples_per_step=400.0)
        _, gen = run_generate_micro_data(cfg, "cuda", quiet=True,
                                         generator=gen)
        inputs, outputs, meta = load_dataset(gen.fname)
        if not (len(inputs) == gen.num_samples > 100
                and os.path.exists("supercell_kessler_metadata.txt")):
            raise AssertionError(f"harvest: {len(inputs)} rows, "
                                 f"{gen.num_samples} taken")
        t0 = time.perf_counter()
        model, scl_in, scl_out, hist = train_mlp(
            inputs, outputs, device="cuda", epochs=3, batch=256,
            verbose=False)
        train_s = time.perf_counter() - t0
        model.validate()
        micro = MicrophysicsKesslerSurrogate(model, scl_in, scl_out,
                                             online=True, compare=True)
        state, mods, dycore = inference_surrogate.build(cfg, "cuda",
                                                        micro=micro)
        dt = dycore.compute_time_step(state)
        for m in mods:
            state = m(state, dt)
        _check_state("21", state)
        d = state["surrogate_diffs"].tolist()
        if not (all(math.isfinite(v) for v in d)
                and next(model.parameters()).device.type == "cuda"):
            raise AssertionError(f"deployed model: diffs {d}")
        print(f"[21] workflow on 250x1x50: active ratio "
              f"{gatherer.ratio_active:.6e}; {gen.num_samples} samples to "
              f"{gen.fname}; train_mlp 3 epochs on the card in {train_s:.2f}"
              f" s, loss {hist[0]['loss']:.6e} -> {hist[-1]['loss']:.6e}, "
              f"val {hist[-1]['val_loss']:.6e}; one online step with the "
              f"trained model: validate() clean, diffs "
              f"[{', '.join(f'{v:.3e}' for v in d)}]", flush=True)
        state = inference_surrogate.run(_surrogate_cfg(cfg, compare=True),
                                        "cuda", quiet=True)
        _check_state("21", state)
        print(f"[21] inference_surrogate with the .npz weights, online, "
              f"{cfg.sim_time:g} s: validate() clean, last diffs "
              f"{state['surrogate_diffs'].tolist()}", flush=True)
    finally:
        os.chdir(cwd)


# -- the domain decomposition (parallel/) -------------------------------------

HP5 = 3  # halo strip width at ord 5


def _shard_case(prim, axis, bc, nid, i, ns=2):
    """Shard i (of ns along ``axis``) of ``prim``: its block and its halo
    strips, cut from the global padding (the ring neighbours' cells inside
    the domain, the boundary fill beyond it), with each end's face mode."""
    from miniweatherml_tpu_torch.ops.stencil import BC_WALL, pad_bc
    pad = pad_bc(prim, axis, HP5, bc, zero_var=nid if bc == BC_WALL else None)
    nl = prim.shape[axis] // ns
    block = prim.narrow(axis, i * nl, nl).contiguous()
    lo = pad.narrow(axis, i * nl, HP5).contiguous()
    hi = pad.narrow(axis, (i + 1) * nl + HP5, HP5).contiguous()
    return block, (lo, hi, bc if i == 0 else 0, bc if i == ns - 1 else 0)


def phase_strip_fluxes():
    """The flux kernel's halo-strip form against its plain version on the
    512x512x64 Kessler state split 2x2 (a local 256x256x64 block, shard
    (0, 0)): x and y, periodic (both ends inside the domain), and a wall
    and an open global boundary at one end, y also with the stage update
    (the mesh path's last direction); f32 and f64, bit for bit.  The
    periodic f32 calls (the main path's forms: x bare, y with the stage
    update) are timed beside their bound.  Then the same cases in the
    reduced-operation algebra: exact in f32 and f64, bit for bit, and with
    the approximate reciprocals in f32, and in the reference algebra with
    the approximate reciprocals in f32, both by the fast bar.
    Returns the JSON record and, per dtype, the local state's pieces that
    phase 23 needs."""
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        IDU, IDV, direction_fluxes, direction_fluxes_plain)
    from miniweatherml_tpu_torch.ops.stencil import BC_OPEN, BC_WALL
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    pieces = {}
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        state, _, dycore = _flux_state("kessler", dtype)
        prim = _prim(state, dycore)
        g, c = state.grid, dycore._consts(state)
        hy = dycore._hy(state)
        b0, b1 = _stage_bases(state, dycore)
        dt = dycore.compute_time_step(state)
        # shard (0, 0) of the 2x2 split: its y rows, then x or y strips
        rows = prim.narrow(-2, 0, g.ny // 2)
        cols = prim.narrow(-1, 0, g.nx // 2)
        for name, axis, nid, d, src in (("x", -1, IDU, g.dx, rows),
                                        ("y", -2, IDV, g.dy, cols)):
            for bc, i in ((c.bc_x if axis == -1 else c.bc_y, 0),
                          (BC_WALL, 0), (BC_OPEN, 1)):
                block, strips = _shard_case(src.contiguous(), axis, bc, nid,
                                            i)
                nl = block.shape[axis]
                args = (block, axis, nl, bc, nid, c.C0, c.gamma, hy[0],
                        hy[1], dycore.mats, 0.0, 1.0 / d, strips)
                ref = direction_fluxes_plain(*args)
                got = direction_fluxes(*args)
                torch.cuda.synchronize()
                errs = [_rel(a, b) for a, b in zip(ref, got)]
                rel = max(e[1] for e in errs)
                same = all(torch.equal(a, b) for a, b in zip(ref, got))
                line = (f"[22] direction_fluxes strips {dtype} {name} "
                        f"local {tuple(block.shape[2:])} bc {bc} ends "
                        f"{strips[2:]}: bitwise "
                        f"{'equal' if same else 'DIFFERENT'}, rel {rel:.3e}")
                if bc == 0:
                    pieces.setdefault(dtype, {})[axis] = got[1]
                    ms = _time_ms(lambda: direction_fluxes(*args))
                    pms = _time_ms(lambda: direction_fluxes_plain(*args),
                                   reps=3)
                    nbytes, ops = _flux_work(block, axis, dycore.mats.ord)
                    nbytes += _nbytes(strips[:2])
                    bms, by = _bound(nbytes, ops, dtype)
                    line += (f"; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                             f"bound {bms:.3f} ms ({by}), {bms / ms:.1%} of "
                             f"the bound  [{_card()}]")
                    if dtype == "float32":
                        rec["ms"] += ms
                        rec["plain_ms"] += pms
                        rec["bound_ms"] += bms
                        rec["bound_by"] = by
                print(line, flush=True)
                if not (same and rel <= tol):
                    raise AssertionError(f"strip-form flux {dtype} {name} "
                                         f"bc {bc}: not bitwise ({rel:.3e})")
                if dtype == "float32":
                    rec["max_abs_err"] = max(rec["max_abs_err"],
                                             max(e[0] for e in errs))
                if axis == -2:
                    # the mesh path's last direction: y with the stage
                    # update, into the shard's own cells of b0 / b1
                    nl2 = block.shape[-2]

                    def cut(t):
                        return t.narrow(-1, 0, g.nx // 2).narrow(
                            -2, i * nl2, nl2)
                    rk = _stage(state, dycore, b0, b1, dt, crop=cut)
                    err, sms, spms, sbms, _ = _flux_form(
                        "22", f"strips local {tuple(block.shape[2:])} bc {bc}"
                        f" ends {strips[2:]} y stage update, b1", args,
                        got[0], rk, dtype, tol, timed=bc == 0)
                    if dtype == "float32":
                        rec["max_abs_err"] = max(rec["max_abs_err"], err)
                        if bc == 0:  # in place of the bare y strip call
                            rec["ms"] += sms - ms
                            rec["plain_ms"] += spms - pms
                            rec["bound_ms"] += sbms - bms
                del ref, got
        for algebra in (("opt", "fast", "ref_fast") if dtype == "float32"
                        else ("opt",)):
            for name, axis, nid, d, src in (("x", -1, IDU, g.dx, rows),
                                            ("y", -2, IDV, g.dy, cols)):
                for bc, i in ((c.bc_x if axis == -1 else c.bc_y, 0),
                              (BC_WALL, 0), (BC_OPEN, 1)):
                    block, strips = _shard_case(src.contiguous(), axis, bc,
                                                nid, i)
                    nl = block.shape[axis]
                    args = (block, axis, nl, bc, nid, c.C0, c.gamma, hy[0],
                            hy[1], dycore.mats, 0.0, 1.0 / d, strips)
                    tag = (f"strips {name} local {tuple(block.shape[2:])} "
                           f"bc {bc} ends {strips[2:]}")
                    got = _flux_bare("22", tag, args, dtype, tol, algebra,
                                     timed=bc == 0)[0]
                    if axis == -2:
                        nl2 = block.shape[-2]
                        rk = _stage(state, dycore, b0, b1, dt,
                                    crop=lambda t: t.narrow(
                                        -1, 0, g.nx // 2).narrow(
                                            -2, i * nl2, nl2))
                        _flux_form("22", f"{tag} y stage update, b1 "
                                   f"({algebra})", args, got[0], rk, dtype,
                                   tol, timed=bc == 0, algebra=algebra)
                    del got
        del b0, b1
        # the shard's own z faces, tracers and stage bases for phase 23
        block = prim.narrow(-2, 0, g.ny // 2).narrow(-1, 0, g.nx // 2)
        block = block.contiguous()
        pieces[dtype][-3] = direction_fluxes(
            block, -3, g.nz, c.bc_z, 3, c.C0, c.gamma, hy[2], hy[3],
            dycore.mats, 0.0, 1.0 / g.dz)[1]
        tr = state.tracer_stack().narrow(-2, 0, g.ny // 2).narrow(
            -1, 0, g.nx // 2).contiguous()
        pieces[dtype].update(tr=tr, grid=g, dt=dycore.compute_time_step(state),
                             positive=tuple(t.positive
                                            for t in state.meta.tracers))
        del state, prim, hy, dycore, rows, cols
        torch.cuda.empty_cache()
    return rec, pieces


def phase_fct_edges(pieces):
    """fct_scale_div with the neighbours' edge multipliers against its
    plain version on shard (0, 0)'s tracer faces from phase 22: x first,
    z accumulating, y with the stage update (the path's forms), and x / y
    in every form, f32 and f64, bit for bit; the path's x and y calls timed
    beside their bytes bound."""
    from miniweatherml_tpu_torch.ops import fct
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for dtype, p in pieces.items():
        g, tr, dt, own = p["grid"], p["tr"], p["dt"], p["positive"]
        mult = fct.fct_mult(tr, own, p[-1], p[-2], p[-3], dt, g.dx, g.dy,
                            g.dz)
        t_prev = fct.fct_scale_div(p[-3], mult, None, -3, g.nz, 1.0 / g.dz)
        tr1 = tr.flip(-1).contiguous()
        for axis, d in ((-1, g.dx), (-2, g.dy)):
            n = mult.shape[axis]
            # the neighbours' boundary cells: any plane of multipliers of
            # the shard's shape, here its own far ends
            edges = (mult.narrow(axis, n - 1, 1).contiguous(),
                     mult.narrow(axis, 0, 1).flip(0).contiguous())
            for form in FCT_FORMS:
                rk = None
                if form.startswith("rk"):
                    rk = (0.75, 0.25, 0.25 * dt, tr,
                          tr1 if form == "rk_tr1" else None, own)

                def call(fn, prev=None if form == "first" else t_prev):
                    q = None if prev is None else prev.clone()
                    return fn(p[axis], mult, q, axis, n, 1.0 / d, rk=rk,
                              edges=edges)
                ref = call(fct.fct_scale_div_plain)
                got = call(fct.fct_scale_div)
                torch.cuda.synchronize()
                err, rel = _rel(ref, got)
                same = torch.equal(ref, got)
                del ref, got
                line = (f"[23] fct_scale_div edges {dtype} axis {axis} "
                        f"{form}: bitwise {'equal' if same else 'DIFFERENT'},"
                        f" max abs err {err:.3e}")
                if FCT_PATH[axis] == form:
                    buf = None if form == "first" else t_prev.clone()
                    ms = _time_ms(lambda: fct.fct_scale_div(
                        p[axis], mult, buf, axis, n, 1.0 / d, rk=rk,
                        edges=edges))
                    pms = _time_ms(lambda: fct.fct_scale_div_plain(
                        p[axis], mult, buf, axis, n, 1.0 / d, rk=rk,
                        edges=edges), reps=3)
                    out_b = _nbytes(tr)
                    bms, by = _bound(_nbytes(p[axis], mult, rk, edges) + out_b
                                     + (0 if buf is None else out_b),
                                     15 * tr.numel(), dtype)
                    line += (f"; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                             f"bound {bms:.3f} ms ({by}), {bms / ms:.1%} of "
                             f"the bound  [{_card()}]")
                    if dtype == "float32":
                        rec["ms"] += ms
                        rec["plain_ms"] += pms
                        rec["bound_ms"] += bms
                        rec["bound_by"] = by
                print(line, flush=True)
                if not same:
                    raise AssertionError(f"fct_scale_div edges {dtype} axis "
                                         f"{axis} {form}: {rel:.3e}")
                if dtype == "float32":
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del mult, t_prev, tr1
    return rec


def _spmd_chain(build, cfg, mesh, device="cuda", seed=None):
    """(global state, step modules, dycore, make_spmd_step's step) of a
    chain of ``build`` (supercell_example / supercell_p3 order: dycore,
    micro, sponge, nudger)."""
    from miniweatherml_tpu_torch.parallel.spmd import make_spmd_step
    state, mods, dycore = build(cfg, device)
    if seed is not None:
        state = seed(state)
    step = make_spmd_step(state, mesh, dycore, micro=mods[1].__self__,
                          nudger=mods[3].__self__)
    return state, mods, dycore, step


# launches per step and shard of the decomposed Kessler chain (one CFL
# cycle): the dycore's, its y and z calls (the tiled kernel) and the strip
# forms (x and y of each stage) among them, and the Kessler kernel
SPMD_PER_STEP = {"direction_fluxes": 9, "fluxes_tiled": 6, "strips": 6,
                 "fct_mult": 3, "fct_scale_div": 9, "edges": 6,
                 "kessler_step": 1, "min_step": 1, "dycore_state": 5}


def _spmd_counts():
    return {**_counters("kessler"),
            "strips": "direction_fluxes.strip_launches",
            "edges": "fct_scale_div.edge_launches"}


def _timed_steps(step, state, dt, steps):
    """(state, seconds) of ``steps`` calls of ``step`` after a warm call on
    a copy, host clock around work that ends in a synchronize."""
    warm = step(state, dt)
    del warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, dt)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def _chain_step(mods):
    def step(state, dt):
        for m in mods:
            state = m(state, dt)
        return state
    return step


def phase_spmd_kessler(card):
    """The decomposed Kessler slice: make_spmd_step on a (1, 2, 2) mesh of
    the one card at 512x512x64 f32, against the undecomposed chain in the
    same call.  Returns the launches of the strip and edge forms in the
    main path's run."""
    from miniweatherml_tpu_torch.experiments import supercell_example
    from miniweatherml_tpu_torch.parallel.mesh import (gather_state,
                                                       make_mesh, shard_state)
    from miniweatherml_tpu_torch.parallel.spmd import make_spmd_step
    mesh = make_mesh(["cuda:0"] * 4, ens=1, y=2, x=2)
    cfg = _bench_cfg(512, 512, 64, 10, "float32")
    state, mods, dycore, step = _spmd_chain(supercell_example.build, cfg, mesh)
    dt = dycore.compute_time_step(state)
    cells = state.grid.nx * state.grid.ny * state.grid.nz
    # one dycore step: the strip and edge forms against the whole axis
    dyn = make_spmd_step(state, mesh, dycore, sponge_time_scale=None)
    ref = dycore.time_step(state, dt)
    got = gather_state(dyn(shard_state(state, mesh), dt), "cuda")
    dyn.close()
    differ = [k for k in ref.fields if not torch.equal(ref[k], got[k])]
    print(f"[24] one dycore step 512x512x64 f32 on a 2x2 mesh of one card "
          f"against the undecomposed step: {len(ref.fields) - len(differ)} "
          f"of {len(ref.fields)} fields equal bit for bit", flush=True)
    if differ:
        raise AssertionError(f"decomposed dycore step differs in {differ}")
    del ref, got
    # one chain step within f32 1e-5 of scale
    ref = _chain_step(mods)(state, dt)
    sharded = shard_state(state, mesh)
    got = gather_state(step(sharded, dt), "cuda")
    worst = max(_rel(ref[k], got[k])[1] for k in ref.fields)
    print(f"[24] one chain step (dycore, Kessler, sponge, nudging) against "
          f"the undecomposed chain: worst error over field scale "
          f"{worst:.3e} (tol 1e-5)", flush=True)
    if not worst <= 1e-5:
        raise AssertionError(f"decomposed chain step: {worst:.3e}")
    del ref, got
    # host synchronizations of one decomposed step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sharded = step(sharded, dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    # the main path: counts read, 10 steps, counts read
    counts = _spmd_counts()
    steps = 10
    sharded = shard_state(state, mesh)
    torch.cuda.reset_peak_memory_stats()
    step(sharded, dt)  # warm
    torch.cuda.synchronize()
    before = _totals(counts)
    t0 = time.perf_counter()
    for _ in range(steps):
        sharded = step(sharded, dt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _since(counts, before)
    peak = torch.cuda.max_memory_allocated()
    problems = sharded.validate()
    maxw = max(float(s["wvel"].abs().max()) for s in sharded.shards)
    per_shard = {k: v / (steps * mesh.size) for k, v in launches.items()}
    print(f"[24] decomposed Kessler 512x512x64 f32, 1x2x2 mesh on one card: "
          f"{steps} steps, {1e3 * elapsed / steps:.2f} ms/step, "
          f"{cells * steps / elapsed / 1e6:.2f} Mcellups, peak memory "
          f"{peak / 2**30:.2f} GiB, maxw {maxw:.6e}, validate() "
          f"{problems or 'clean'}; launches {launches} ({per_shard} per step "
          f"and shard); host syncs in one step: {syncs}  [{card}]",
          flush=True)
    if (problems or not math.isfinite(maxw) or syncs
            or per_shard != {k: float(v) for k, v in SPMD_PER_STEP.items()}):
        raise AssertionError(f"decomposed Kessler: validate {problems}, "
                             f"maxw {maxw}, syncs {syncs}, launches "
                             f"{per_shard}")
    step.close()
    del sharded
    # the undecomposed chain, same call, same timing
    torch.cuda.reset_peak_memory_stats()
    _, und_s = _timed_steps(_chain_step(mods), state, dt, steps)
    und_peak = torch.cuda.max_memory_allocated()
    print(f"[24] undecomposed Kessler 512x512x64 f32, same call: "
          f"{1e3 * und_s / steps:.2f} ms/step, "
          f"{cells * steps / und_s / 1e6:.2f} Mcellups, peak memory "
          f"{und_peak / 2**30:.2f} GiB; the 2x2 mesh takes "
          f"{elapsed / und_s:.3f}x the undecomposed step  [{card}]",
          flush=True)
    del state, mods, dycore
    torch.cuda.empty_cache()
    # the reference's 1024x1024x100 community benchmark on the same mesh
    dt6 = 0.6 * 200.0 / 430.0
    cfg = _supercell_cfg(1024, 1024, 100, 819200.0, 819200.0, 20000.0,
                         3 * dt6, "float32")
    state, mods, dycore, step = _spmd_chain(supercell_example.build, cfg,
                                            mesh)
    sharded = shard_state(state, mesh)
    del state, mods
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sharded, s6 = _timed_steps(step, sharded, dycore.compute_time_step(
        sharded.shards[0]), 3)
    peak6 = torch.cuda.max_memory_allocated()
    problems = sharded.validate()
    step.close()
    print(f"[24] decomposed 1024x1024x100 f32 community benchmark, 1x2x2 "
          f"mesh on one card: 3 steps, {1e3 * s6 / 3:.1f} ms/step, "
          f"{1024 * 1024 * 100 * 3 / s6 / 1e6:.2f} Mcellups, peak memory "
          f"{peak6 / 2**30:.2f} GiB, validate() {problems or 'clean'}  "
          f"[{card}]", flush=True)
    if problems:
        raise AssertionError(f"decomposed 1024^2x100: {problems}")
    del sharded, dycore
    torch.cuda.empty_cache()
    return launches


def phase_spmd_references():
    """16x8x10 f64 slices on a (2, 2, 2) mesh of the one card: the Kessler
    chain (3 steps) and the P3 chain (seeded layers, 2 steps), against the
    port's CPU run of the same decomposed chain at 1e-7 of each field's
    scale and against the card's undecomposed run (one step at 1e-12 of
    scale: the sponge and nudging means are summed shard by shard; past it
    the microphysics' thresholds amplify those last bits, tests/
    test_torch_spmd.py, so the rest at 1e-7); then ShardedStateWriter and
    stitch_sharded in chip_smoke_out/ against the gathered state's file."""
    from miniweatherml_tpu_torch.experiments import (supercell_example,
                                                     supercell_p3)
    from miniweatherml_tpu_torch.io.netcdf import (ShardedStateWriter,
                                                   StateWriter)
    from miniweatherml_tpu_torch.io.stitch import stitch_sharded
    from miniweatherml_tpu_torch.parallel.mesh import (gather_state,
                                                       make_mesh, shard_state)
    from scipy.io import netcdf_file
    for name, build, seed, zlen, steps in (
            ("Kessler", supercell_example.build, None, 10000.0, 3),
            ("P3", supercell_p3.build, supercell_p3.seed_layers, 16000.0, 2)):
        cfg = _supercell_cfg(16, 8, 10, 40000.0, 40000.0, zlen, 100.0,
                             "float64", nens=2)
        runs = {}
        for device in ("cpu", "cuda"):
            mesh = make_mesh([device] * 8, ens=2)
            state, mods, dycore, step = _spmd_chain(build, cfg, mesh, device,
                                                    seed)
            dt = dycore.compute_time_step(state)
            sharded, ref = shard_state(state, mesh), state
            for k in range(steps):
                sharded = step(sharded, dt)
                ref = _chain_step(mods)(ref, dt)
                if k == 0 and device == "cuda":
                    got = gather_state(sharded, "cuda")
                    one = max(_rel(ref[f], got[f])[1] for f in ref.fields)
            step.close()
            runs[device] = (gather_state(sharded, "cpu"), ref)
        card, und = runs["cuda"][0], runs["cuda"][1]
        vs_cpu = max(_rel(runs["cpu"][0][k], card[k])[1] for k in card.fields)
        vs_und = max(_rel(und[k].cpu(), card[k])[1] for k in card.fields)
        print(f"[25] 16x8x10x2 f64 {name} chain on a 2x2x2 mesh of the card: "
              f"{steps} steps against the port's CPU run of the same mesh "
              f"{vs_cpu:.3e} of field scale (tol 1e-7); against the card's "
              f"undecomposed run {one:.3e} after one step (tol 1e-12), "
              f"{vs_und:.3e} after {steps} (tol 1e-7)", flush=True)
        if not (vs_cpu <= 1e-7 and one <= 1e-12 and vs_und <= 1e-7):
            raise AssertionError(f"{name} decomposed slice: {vs_cpu:.3e}, "
                                 f"{one:.3e}, {vs_und:.3e}")
    # per-shard output and the stitch, on the last (P3) card run's mesh
    os.makedirs(OUT_DIR, exist_ok=True)
    prefix = os.path.join(OUT_DIR, "chip_smoke_sharded")
    mesh = make_mesh(["cuda:0"] * 8, ens=1, y=2, x=4)
    cfg = _supercell_cfg(32, 16, 8, 32000.0, 16000.0, 8000.0, 1.0, "float64")
    state = supercell_example.build(cfg, "cuda")[0]
    sharded = shard_state(state, mesh)
    sw = ShardedStateWriter(prefix, sharded)
    gw = StateWriter(prefix + "_gathered", gather_state(sharded, "cuda"))
    for t in (0.0, 10.0):
        sw.write(sharded, t)
        gw.write(gather_state(sharded, "cuda"), t)
    sw.close()
    gw.close()
    out = stitch_sharded(prefix)
    with netcdf_file(out, "r", mmap=False) as a, \
            netcdf_file(prefix + "_gathered.nc", "r", mmap=False) as b:
        differ = [k for k in b.variables
                  if not np.array_equal(a.variables[k][:], b.variables[k][:])]
        same_names = set(a.variables) == set(b.variables)
    same = not differ and same_names
    print(f"[25] ShardedStateWriter on a 2x4 mesh of the card: 8 files, "
          f"stitched to {out}: {'equal' if same else 'DIFFERENT'} to the "
          "gathered state's file, bit for bit", flush=True)
    if differ or not same_names:
        raise AssertionError(f"stitched file differs in {differ}")


# -- the P3 native twin and tracer groups -------------------------------------

SCHEME_OUT = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv", "theta",
              "precip_liq", "precip_ice")


def _mixed_columns(nz=24, ncol=8, seed=1):
    """tests/test_p3_native.py::_mixed_column's recipe (numpy, re-made
    here), as float64 tensors (1, nz, 1, ncol) on the card, and a
    qv_prev / t_prev history."""
    rng = np.random.default_rng(seed)
    z = (np.arange(nz) + 0.5) * 450.0
    temp = 300.0 - 7.5e-3 * z
    pres = 1.0e5 * (temp / 300.0) ** 6.0
    rho_d = pres / (287.042 * temp)
    shape = (1, nz, 1, ncol)

    def tile(v):
        return np.broadcast_to(v.reshape(1, nz, 1, 1), shape).copy()

    def rand(hi):
        return rng.uniform(0, hi, shape)
    exner = tile((pres / 1e5) ** (287.042 / 1004.64))
    d = dict(qc=rand(2e-3), nc=tile(100e6 / rho_d), qr=rand(1e-3),
             nr=rand(1e5), qi=rand(1e-3), ni=rand(1e5), qm=rand(2e-4),
             bm=rand(1e-6), qv=rand(0.015), theta=tile(temp) / exner,
             exner=exner, pres=tile(pres), rho_d=tile(rho_d),
             dz=np.full(shape, 450.0))
    d = {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}
    t = d["theta"] * d["exner"]
    return d, (0.95 * d["qv"], t - 0.2)


def _twin_check(tag, inputs, dt, tables, hist):
    """The twin against the port's p3_scheme on the card (f64): rtol 1e-9,
    atol 1e-12 of each field's scale (tests/test_p3_native.py:75-83)."""
    from miniweatherml_tpu_torch.physics import p3 as PP
    want = PP.p3_scheme(**inputs, dt=dt, z_axis=1, tables=tables,
                        qv_prev=hist[0], t_prev=hist[1])
    names = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv", "theta",
             "exner", "pres", "rho_d", "dz")
    got = PP._p3_scheme_native(*(inputs[k] for k in names), dt,
                               qv_prev=hist[0], t_prev=hist[1])
    worst, where = 0.0, ""
    for name, a, b in zip(SCHEME_OUT, want, got):
        if b.device.type != "cuda" or b.dtype != a.dtype:
            raise AssertionError(f"[26] {tag} {name}: {b.device} {b.dtype}")
        scale = max(a.abs().max().item(), 1e-6)
        # the share of the allowance used, <= 1 passes
        used = ((a - b).abs() / (1e-9 * a.abs() + 1e-12 * scale)).max().item()
        if used > worst:
            worst, where = used, name
    print(f"[26] twin vs p3_scheme on the card, {tag} "
          f"({want[0].numel()} cells, f64): worst {worst:.3e} of the "
          f"allowance rtol 1e-9 + 1e-12 of scale ({where or '-'})",
          flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"[26] twin vs p3_scheme {tag}: {where} at "
                             f"{worst:.3e} of the allowance")


def phase_native_twin():
    """The P3 native twin (g++ build time, tables installed) against the
    port's p3_scheme on the card: seeded mixed columns, then the column set
    one step of the P3 chain hands the micro (64x64x64 f64, seeded layers),
    both with a qv_prev / t_prev history."""
    from miniweatherml_tpu_torch import native
    from miniweatherml_tpu_torch.experiments import supercell_p3
    from miniweatherml_tpu_torch.physics import p3 as PP
    from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables

    lib = native.load_p3_library()
    has = bool(lib.p3_has_tables())
    print(f"[26] P3 native twin: g++ {_build_seconds('p3_native'):.2f} s "
          f"({' '.join(native.GXX_FLAGS)}); lookup tables installed: {has}",
          flush=True)
    tables = load_p3_tables() if has else None
    cols, hist = _mixed_columns()
    _twin_check("mixed columns", cols, 15.0, tables, hist)
    state, mods, dycore = supercell_p3.build(
        _bench_cfg(64, 64, 64, 1, "float64"), "cuda")
    state = supercell_p3.seed_layers(state)
    dt = dycore.compute_time_step(state)
    for m in mods:
        state = m(state, dt)
    (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, dz, qv_prev,
     t_prev) = PP.p3_wrapper_inputs(state)
    inputs = dict(qc=qc, nc=nc, qr=qr, nr=nr, qi=qi, ni=ni, qm=qm, bm=bm,
                  qv=qv, theta=theta, exner=exner, pres=pres,
                  rho_d=state["density_dry"], dz=dz)
    _twin_check("a P3 chain step's columns (64x64x64, seeded layers)",
                inputs, dt, tables, (qv_prev, t_prev))
    del state, mods, dycore, inputs
    torch.cuda.empty_cache()


def _native_cfg(cfg):
    cfg.extras["p3_backend"] = "native"
    return cfg


def _native_build(cfg, device):
    from miniweatherml_tpu_torch.experiments import supercell_p3
    return supercell_p3.build(_native_cfg(cfg), device)


def phase_native_chain(card):
    """The 128x128x64 f32 supercell_p3 chain with p3_backend native (3
    steps after the warm-up step, run_benchmark, launch counters), its step
    split with utils.profiling timers, beside the torch-backend chain in
    the same call; host syncs per step; then a 16x8x10 f64 native slice,
    card against CPU, 2 steps.  Returns the JSON ``native`` record."""
    from miniweatherml_tpu_torch import native
    from miniweatherml_tpu_torch.experiments import supercell_p3
    from miniweatherml_tpu_torch.physics import p3 as PP
    from miniweatherml_tpu_torch.utils import profiling

    orig = (PP._columns_to_host, native.column_step, PP._columns_to_device)
    calls_seen = [0]

    def to_host(fields):
        profiling.sync()  # what was queued before is the rest of the step
        calls_seen[0] += 1
        if calls_seen[0] == 2:
            # the first timed step: the split covers the window step_ms does
            profiling.reset_timers()
        with profiling.timer("to host"):
            return orig[0](fields)

    def twin(*args, **kw):
        with profiling.timer("twin"):
            return orig[1](*args, **kw)

    def to_device(*args):
        with profiling.timer("to device"):  # synchronizes the card on exit
            return orig[2](*args)
    profiling.reset_timers()
    PP._columns_to_host, native.column_step, PP._columns_to_device = (
        to_host, twin, to_device)
    try:
        _, res, _ = _run_cell(
            "27 native", _native_cfg(_bench_cfg(128, 128, 64, 3, "float32")), card,
            chain="p3_native", build=_native_build,
            per_step={**DYCORE_PER_STEP, "p3_wrapper": 1})
    finally:
        PP._columns_to_host, native.column_step, PP._columns_to_device = orig
    totals = profiling.timer_totals()
    calls = totals["twin"][1]
    if (calls != res["steps"] or calls_seen[0] != calls + 1
            or totals["to host"][1] != calls
            or totals["to device"][1] != calls):
        raise AssertionError(f"[27] native timers {totals} for "
                             f"{res['steps']} timed steps")
    host_ms = 1e3 * totals["twin"][0] / calls
    down_ms = 1e3 * totals["to host"][0] / calls
    up_ms = 1e3 * totals["to device"][0] / calls
    step_ms = 1e3 * res["elapsed_s"] / res["steps"]
    print(profiling.timer_report(), flush=True)
    print(f"[27] native step split (mean of the {calls} timed steps, "
          f"the window of the ms/step): twin on the host {host_ms:.1f} ms, to host (f64 cast, "
          f"column permute, one copy) {down_ms:.1f} ms, to the card {up_ms:.1f}"
          f" ms, the rest on the card ~{step_ms - host_ms - down_ms - up_ms:.1f}"
          f" ms of the timed {step_ms:.1f} ms/step; twin "
          f"{host_ms / step_ms:.1%} of the step  [{card}]", flush=True)
    _run_cell("27 torch", _bench_cfg(128, 128, 64, 3, "float32"), card,
              chain="p3", build=supercell_p3.build)
    small = _native_cfg(_bench_cfg(128, 128, 64, 2, "float32"))
    print(f"[27] host synchronizations in one step at 128x128x64: native P3 "
          f"chain {_host_syncs(supercell_p3.build, small)}", flush=True)
    cfg = _native_cfg(_supercell_cfg(16, 8, 10, 40000.0, 40000.0, 16000.0,
                                     100.0, "float64"))
    outs = []
    for device in ("cpu", "cuda"):
        state, mods, dycore = supercell_p3.build(cfg, device)
        state = supercell_p3.seed_layers(state)
        dt = dycore.compute_time_step(state)
        for _ in range(2):
            for m in mods:
                state = m(state, dt)
        outs.append(state)
    _check_state("27", outs[1])
    if float(outs[1]["ice"].max()) <= 0.0:
        raise AssertionError("native P3 slice holds no ice")
    worst = max(_rel(outs[0][k], outs[1][k].cpu())[1] for k in outs[0].fields)
    print(f"[27] 16x8x10 f64 2-step native P3 slice, card vs CPU: worst "
          f"error over field scale {worst:.3e} (tol 1e-7)", flush=True)
    if not worst <= 1e-7:
        raise AssertionError(f"native P3 card vs CPU slice: {worst:.3e}")
    return {"build_s": _build_seconds("p3_native"),
            "host_ms_per_step": host_ms,
            "copy_ms_per_step": down_ms + up_ms, "cells": 128 * 128 * 64}


def phase_tracer_groups():
    """The wrappers above one launch's tracer count: the flux kernel at 12
    tracers (17 variables) on a 64x64x32 P3 state plus three more tracers,
    x / y / z, z accumulating, y with the stage update and the halo-strip
    form, in the reference algebra and the reduced-operation one (exact,
    and with the approximate reciprocals in f32, by the fast bar), and in
    the reference algebra with the approximate reciprocals (f32, by the
    fast bar), then
    fct_mult and fct_scale_div at
    12 tracers on the faces it gave, f32 and f64, and both FCT kernels at
    70 tracers (f32, small grid); bit for bit against the plain versions,
    with the launches per call."""
    from miniweatherml_tpu_torch.ops import fct
    from miniweatherml_tpu_torch.ops.direction_fluxes import (
        IDU, IDV, IDW, direction_fluxes, direction_fluxes_plain)

    def check(tag, wrapper, expect, kern, plain, algebra="ref"):
        """kern() launches through ``wrapper``, ``expect`` times (and as
        many times in its algebra's count); plain() is its plain version
        on the same inputs: bit for bit, the fast algebra by the fast
        bar."""
        name = wrapper.__name__
        counter = f"{name}.launches" if algebra == "ref" else (
            f"{name}.{algebra}_launches")
        n0, a0 = (profiling.counter(f"{name}.launches"),
                  profiling.counter(counter))
        got = kern()
        launches = profiling.counter(f"{name}.launches") - n0
        in_form = profiling.counter(counter) - a0
        ref = plain()
        torch.cuda.synchronize()
        tup = isinstance(got, tuple)
        _, rel, same, ok, text = _agreement(
            ref if tup else (ref,), got if tup else (got,), algebra,
            plain if tup else lambda: (plain(),))
        print(f"[28] {tag}: {launches} launches, bitwise "
              f"{'equal' if same else 'DIFFERENT'}, rel {rel:.3e}{text}",
              flush=True)
        if not ok or launches != expect or in_form != expect:
            raise AssertionError(f"[28] {tag}: {launches} launches, "
                                 f"{in_form} in its form (expected "
                                 f"{expect}), bitwise equal {same}")
        return got

    def scale_div(fn, F, mult, prev, axis, n, dxi, rk):
        return fn(F, mult, None if prev is None else prev.clone(), axis, n,
                  dxi, rk=rk)

    for dtype in ("float32", "float64"):
        state, _, dycore = _p3_mixed_build(_bench_cfg(64, 64, 32, 1, dtype),
                                           "cuda")
        prim = _prim(state, dycore)
        prim = torch.cat([prim, 0.5 * prim[5:8]]).contiguous()
        ntr = prim.shape[0] - 5
        g, c = state.grid, dycore._consts(state)
        hy = dycore._hy(state)
        faces = {}
        for name, axis, n, bc, nid, d, hr, ht in (
                ("x", -1, g.nx, c.bc_x, IDU, g.dx, hy[0], hy[1]),
                ("y", -2, g.ny, c.bc_y, IDV, g.dy, hy[0], hy[1]),
                ("z", -3, g.nz, c.bc_z, IDW, g.dz, hy[2], hy[3])):
            args = (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht,
                    dycore.mats, 0.0, 1.0 / d)
            faces[axis] = check(
                f"direction_fluxes {ntr} tracers {dtype} {name}",
                direction_fluxes, 2, lambda: direction_fluxes(*args),
                lambda: direction_fluxes_plain(*args))[1]
        # the accumulating (z) and stage-update (y) forms: the epilogue
        # rides the first group's launch only
        b0, b1 = _stage_bases(state, dycore)
        xdiv = direction_fluxes_plain(prim, -1, g.nx, c.bc_x, IDU, c.C0,
                                      c.gamma, hy[0], hy[1], dycore.mats,
                                      0.0, 1.0 / g.dx)[0]
        rk = _stage(state, dycore, b0, b1, dycore.compute_time_step(state))
        for name, axis, n, bc, nid, d, hr, ht, form in (
                ("z accumulating", -3, g.nz, c.bc_z, IDW, g.dz, hy[2], hy[3],
                 None),
                ("y stage update", -2, g.ny, c.bc_y, IDV, g.dy, hy[0], hy[1],
                 rk)):
            args = (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht,
                    dycore.mats, 0.0, 1.0 / d)
            check(f"direction_fluxes {ntr} tracers {dtype} {name}",
                  direction_fluxes, 2,
                  lambda: direction_fluxes(*args, acc=xdiv.clone(), rk=form),
                  lambda: direction_fluxes_plain(*args, acc=xdiv.clone(),
                                                 rk=form))
        del b0, b1, xdiv, rk
        block, strips = _shard_case(prim.narrow(-2, 0, g.ny // 2)
                                    .contiguous(), -1, c.bc_x, IDU, 0)
        args = (block, -1, block.shape[-1], c.bc_x, IDU, c.C0, c.gamma,
                hy[0], hy[1], dycore.mats, 0.0, 1.0 / g.dx, strips)
        check(f"direction_fluxes strips {ntr} tracers {dtype} x",
              direction_fluxes, 2, lambda: direction_fluxes(*args),
              lambda: direction_fluxes_plain(*args))
        # the reduced-operation algebra's groups: every direction, the
        # epilogue forms and the strips
        sargs = args
        b0, b1 = _stage_bases(state, dycore)
        rk = _stage(state, dycore, b0, b1, dycore.compute_time_step(state))
        for algebra in (("opt", "fast", "ref_fast") if dtype == "float32"
                        else ("opt",)):
            kw = ALGEBRA_KW[algebra]
            xdiv = direction_fluxes_plain(prim, -1, g.nx, c.bc_x, IDU, c.C0,
                                          c.gamma, hy[0], hy[1], dycore.mats,
                                          0.0, 1.0 / g.dx, **kw)[0]
            for name, axis, n, bc, nid, d, hr, ht, epi in (
                    ("x", -1, g.nx, c.bc_x, IDU, g.dx, hy[0], hy[1], None),
                    ("y", -2, g.ny, c.bc_y, IDV, g.dy, hy[0], hy[1], None),
                    ("z", -3, g.nz, c.bc_z, IDW, g.dz, hy[2], hy[3], None),
                    ("z accumulating", -3, g.nz, c.bc_z, IDW, g.dz, hy[2],
                     hy[3], "acc"),
                    ("y stage update", -2, g.ny, c.bc_y, IDV, g.dy, hy[0],
                     hy[1], rk)):
                args = (prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht,
                        dycore.mats, 0.0, 1.0 / d)
                ekw = {} if epi is None else {
                    "rk": None if epi == "acc" else epi}
                check(f"direction_fluxes {algebra} {ntr} tracers {dtype} "
                      f"{name}", direction_fluxes, 2,
                      lambda: direction_fluxes(
                          *args, **kw, **ekw,
                          **({"acc": xdiv.clone()} if ekw else {})),
                      lambda: direction_fluxes_plain(
                          *args, **kw, **ekw,
                          **({"acc": xdiv.clone()} if ekw else {})),
                      algebra)
            check(f"direction_fluxes {algebra} strips {ntr} tracers {dtype} "
                  "x", direction_fluxes, 2,
                  lambda: direction_fluxes(*sargs, **kw),
                  lambda: direction_fluxes_plain(*sargs, **kw), algebra)
            del xdiv
        del b0, b1, rk, sargs
        tr = torch.cat([state.tracer_stack(),
                        0.5 * state.tracer_stack()[:3]]).contiguous()
        flags = tuple(i % 3 != 1 for i in range(ntr))
        dt = dycore.compute_time_step(state)
        margs = (tr, flags, faces[-1], faces[-2], faces[-3], 100 * dt, g.dx,
                 g.dy, g.dz)
        mult = check(f"fct_mult {ntr} tracers {dtype}", fct.fct_mult, 1,
                     lambda: fct.fct_mult(*margs),
                     lambda: fct.fct_mult_plain(*margs))
        # one right-hand side: x first, z accumulating, y with the update
        prev = None
        for axis, n, d, rk in (
                (-1, g.nx, g.dx, None), (-3, g.nz, g.dz, None),
                (-2, g.ny, g.dy, (0.75, 0.25, 0.25 * dt, tr,
                                  tr.flip(-1).contiguous(), flags))):
            sargs = (faces[axis], mult, prev, axis, n, 1.0 / d, rk)
            prev = check(f"fct_scale_div {ntr} tracers {dtype} axis {axis}",
                         fct.fct_scale_div, 1,
                         lambda: scale_div(fct.fct_scale_div, *sargs),
                         lambda: scale_div(fct.fct_scale_div_plain, *sargs))
        del state, dycore, prim, faces, tr, mult, prev, block, strips
        torch.cuda.empty_cache()
    rng = np.random.default_rng(70)

    def rand(*shape, lo=None):
        a = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, 1e-2, shape))
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")
    tr = rand(70, 1, 16, 16, 16, lo=-1e-4)
    flags = tuple(i % 3 != 1 for i in range(70))
    margs = (tr, flags, rand(70, 1, 16, 16, 17), rand(70, 1, 16, 17, 16),
             rand(70, 1, 17, 16, 16), 0.9, 5.0, 4.0, 2.5)
    mult = check("fct_mult 70 tracers float32", fct.fct_mult, 2,
                 lambda: fct.fct_mult(*margs),
                 lambda: fct.fct_mult_plain(*margs))
    sargs = (margs[3], mult, rand(*tr.shape), -2, 16, 0.2,
             (0.75, 0.25, 0.1, tr, tr.flip(-1).contiguous(), flags))
    check("fct_scale_div 70 tracers float32 axis -2 with the stage update",
          fct.fct_scale_div, 2,
          lambda: scale_div(fct.fct_scale_div, *sargs),
          lambda: scale_div(fct.fct_scale_div_plain, *sargs))



# -- the bench entry and the dry run ----------------------------------------

# (label, MWML_BENCH_* switches) of each bench run: the default Kessler
# cell and each chain switch of bench.py
BENCH_RUNS = (("kessler", {}),
              ("kessler, reference algebra", {"MWML_BENCH_PALLAS": "0"}),
              ("p3", {"MWML_BENCH_MICRO": "p3"}),
              ("p3 all active", {"MWML_BENCH_MICRO": "p3",
                                 "MWML_BENCH_P3_ACTIVE": "1",
                                 "MWML_BENCH_STEPS": "3"}),
              ("city", {"MWML_BENCH_CASE": "city"}),
              ("surrogate", {"MWML_BENCH_MICRO": "surrogate"}))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step",
              "peak_mem_gib"}


def phase_bench(card):
    """python -m miniweatherml_tpu_torch.bench in a subprocess per run of
    BENCH_RUNS, one at a time; each last line parsed, with its keys, a
    positive value and vs_baseline = value / 10.  Each subprocess builds
    the chain that phases 5, 10, 11, 15 and 18 count the launches of."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("MWML_BENCH_")}
    out = {}
    for label, switches in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "miniweatherml_tpu_torch.bench"],
            cwd=ROOT, env={**base, **switches}, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[29] bench {label} {switches}: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        res = json.loads(line)
        # the card's default is the JAX device form, opt + fast weights
        form = ("" if switches.get("MWML_BENCH_PALLAS") == "0"
                else ", opt WENO, fast weights")
        if (set(res) != BENCH_KEYS or res["unit"] != "Mcellups"
                or not res["value"] > 0
                or res["vs_baseline"] != res["value"] / 10.0
                or ("opt WENO" in res["metric"]) != bool(form)
                or form not in res["metric"]):
            raise AssertionError(f"[29] bench {label}: bad line {line}")
        print(f"[29] bench {label} ({wall:.1f} s): {line}  [{card}]",
              flush=True)
        out[label] = res
    return out


def _dryrun_counts():
    return {**_spmd_counts(), **_counters("p3"),
            **_launch_counters("surrogate_forward")}


def phase_dryrun(card):
    """dryrun_multichip(8) on cuda:0 repeated 8 times (an (ens 2, 2, 2)
    mesh of the one card), f64, 20 steps: each chain's largest difference
    from its undecomposed run (bound 2e-5 of a field's scale, checked by
    dryrun_multichip) and wall seconds, with the launch counts of the run
    (every kernel of the Kessler and P3 paths, the halo-strip flux form and
    the FCT edges at least once)."""
    from miniweatherml_tpu_torch import dryrun
    counts = _dryrun_counts()
    before = _totals(counts)
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(8)
    wall = time.perf_counter() - t0
    launches = _since(counts, before)
    if any(n < 1 for n in launches.values()):
        raise AssertionError(f"[30] a kernel of the dry run never launched: "
                             f"{launches}")
    for chain in ("kessler", "p3", "surrogate"):
        r = res[chain]
        print(f"[30] dry run {chain}, mesh {res['mesh']}, {r['steps']} f64 "
              f"steps: largest difference {r['max_rel_err']:.3e} of "
              f"{r['field']}'s scale (bound {dryrun.INVARIANCE_RTOL:.0e}); "
              f"{r['seconds']:.2f} s decomposed, "
              f"{r['seconds_undecomposed']:.2f} s undecomposed  [{card}]",
              flush=True)
    print(f"[30] dry run {wall:.1f} s in all; launches {launches}",
          flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    card = _card()
    phase_build()
    k_fct = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
             for k in ("fct_mult", "fct_scale_div")}
    # no single PyTorch call computes any of these kernels' functions
    r_kessler = phase_direction_fluxes(k_fct)
    r_p3 = phase_direction_fluxes(k_fct, "p3")
    r_city = phase_direction_fluxes(k_fct, "city")
    # the JSON line's times: one right-hand side, of the reference algebra
    # at 14 variables, 9 tracers (P3), of the others at the main path's 8
    # variables (Kessler); the largest error of every chain
    k_a, k_opt, k_fast, k_rfast = (r_p3["ref"], r_kessler["opt"],
                                   r_kessler["fast"], r_kessler["ref_fast"])
    for alg, k in (("ref", k_a), ("opt", k_opt), ("fast", k_fast),
                   ("ref_fast", k_rfast)):
        k["max_abs_err"] = max(r[alg]["max_abs_err"]
                               for r in (r_kessler, r_p3, r_city))
    del r_kessler, r_p3, r_city
    k_b = phase_kessler()
    k_ds = phase_dycore_state()
    l_kessler = _run_cell("5", _bench_cfg(512, 512, 64, 10, "float32"),
                          card, glue=True)[0]
    l_opt = phase_opt_slice(card)
    phase_references()
    # inputs/community_benchmark_1024.yaml (819.2 x 819.2 x 20 km), 3 steps
    dt = 0.6 * 200.0 / 430.0
    _run_cell("6", _supercell_cfg(1024, 1024, 100, 819200.0, 819200.0,
                                  20000.0, 3 * dt * (1.0 - 1e-9), "float32"),
              card)
    phase_heartbeat()

    from miniweatherml_tpu_torch.experiments import supercell_example
    from miniweatherml_tpu_torch.experiments import supercell_p3
    k_lk = phase_p3_lookups()
    k_cw = phase_p3_cellwise()
    k_rs = phase_p3_rates_sed()
    k_tails = phase_micro_tails()
    l_p3 = _run_cell("10", _bench_cfg(512, 512, 64, 10, "float32"), card,
                     chain="p3", build=supercell_p3.build)[0]
    _run_cell("11", _bench_cfg(512, 512, 64, 3, "float32"), card,
              chain="p3", build=_p3_active_build)
    small = _bench_cfg(128, 128, 64, 2, "float32")
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    syncs = {"P3 chain": _host_syncs(supercell_p3.build, small),
             "all-active P3": _host_syncs(_p3_active_build, small),
             "Kessler chain": _host_syncs(supercell_example.build, small),
             "online surrogate": _host_syncs(
                 inference_surrogate.build,
                 _surrogate_cfg(_bench_cfg(128, 128, 64, 2, "float32")))}
    print(f"[10] host synchronizations in one step at 128x128x64: {syncs}",
          flush=True)
    if any(syncs.values()):
        raise AssertionError(f"a chain step synchronized with the host: "
                             f"{syncs}")
    phase_p3_references()
    phase_p3_heartbeat()

    from miniweatherml_tpu_torch.experiments import simple_city
    from miniweatherml_tpu_torch.physics.time_averager import TimeAverager
    avg_path = os.path.join(OUT_DIR, "chip_smoke_city_time_averaged.nc")

    def finalize(state):
        TimeAverager().finalize(state, avg_path)
        print(f"[15] wrote {avg_path}", flush=True)
    # inputs/input_city.yaml's grid and ensemble, 10 steps
    l_city = _run_cell("15", _city_cfg("city", 400, 400, 60, 2, "float32",
                                       steps=10), card, chain="city",
                       build=simple_city.build_chain, finish=finalize,
                       glue=True)[0]
    phase_city_references()
    phase_restart()

    l_sur = phase_surrogate_slice(card)
    phase_surrogate_references()
    phase_surrogate_workflow()

    k_strips, pieces = phase_strip_fluxes()
    k_edges = phase_fct_edges(pieces)
    del pieces
    torch.cuda.empty_cache()
    l_spmd = phase_spmd_kessler(card)
    phase_spmd_references()

    phase_native_twin()
    native_rec = phase_native_chain(card)
    phase_tracer_groups()
    torch.cuda.empty_cache()
    phase_bench(card)
    phase_dryrun(card)

    kernels = [
        # one right-hand side of the P3 path: x, z accumulating, y with the
        # stage update (the sub kernel's acc and rk forms)
        {"name": "direction_fluxes (x; y/z bare, accumulating, stage "
                 "update)", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/direction_fluxes.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:536, "
                     "miniweatherml_tpu/ops/pallas_recon.py:941",
         "launches": l_p3["direction_fluxes"], **k_a},
        # the same kernel in the Pallas kernels' default algebra (opt=True,
        # pallas_recon.py:127-247), exact and with fast_weights: one
        # right-hand side of the Kessler path, launches from phase 33
        {"name": "direction_fluxes opt (x; y/z bare, accumulating, stage "
                 "update; exact weights)", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/direction_fluxes_opt.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:536, "
                     "miniweatherml_tpu/ops/pallas_recon.py:941 (opt=True)",
         "launches": l_opt["opt"]["opt"], **k_opt},
        {"name": "direction_fluxes opt + fast weights (x; y/z bare, "
                 "accumulating, stage update)", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/direction_fluxes_opt.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:536, "
                     "miniweatherml_tpu/ops/pallas_recon.py:941 (opt=True, "
                     "fast_weights=True)",
         "launches": l_opt["fast"]["fast"], **k_fast},
        # the Pallas kernels' reference-ordered algebra with fast_weights
        # (a cutoff, or opt_algebra=False): launches from phase 33's
        # opt_algebra=False run
        {"name": "direction_fluxes ref + fast weights (x; y/z bare, "
                 "accumulating, stage update)", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/direction_fluxes_ref_fast.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:536, "
                     "miniweatherml_tpu/ops/pallas_recon.py:941 "
                     "(_weno_edges_block with fast_weights=True, :58-124)",
         "launches": l_opt["ref_fast"]["ref_fast"], **k_rfast},
        {"name": "kessler_step", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/kessler.cu",
         "replaces": "miniweatherml_tpu/physics/kessler_pallas.py:128",
         "launches": l_kessler["kessler_step"], **k_b},
        {"name": "p3_interp_ice", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_lookup.cu",
         "replaces": "miniweatherml_tpu/physics/p3_pallas_lookup.py:155, "
                     "miniweatherml_tpu/physics/p3_pallas_lookup.py:292",
         "launches": l_p3["interp_ice"], **k_lk["interp_ice"]},
        {"name": "p3_interp_collect", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_lookup.cu",
         "replaces": "miniweatherml_tpu/physics/p3_pallas_lookup.py:155, "
                     "miniweatherml_tpu/physics/p3_pallas_lookup.py:292",
         "launches": l_p3["interp_collect"], **k_lk["interp_collect"]},
        {"name": "p3_interp_rain", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_lookup.cu",
         "replaces": "miniweatherml_tpu/physics/p3_pallas_lookup.py:155, "
                     "miniweatherml_tpu/physics/p3_pallas_lookup.py:486",
         "launches": l_p3["interp_rain"], **k_lk["interp_rain"]},
        {"name": "p3_cellwise", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_cellwise.cu",
         "replaces": "miniweatherml_tpu/ops/elementwise.py:101",
         "launches": (l_p3["p3_part1"] + l_p3["p3_update"]
                      + l_p3["p3_wrapper"]), **k_cw},
        # the P3 scheme's process rates and sedimentation, which XLA runs on
        # the TPU (no Pallas kernels there)
        {"name": "p3_rates", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_cellwise.cu",
         "replaces": "miniweatherml_tpu/physics/p3.py:853-1225 (an XLA "
                     "fusion, not a Pallas kernel)",
         "launches": l_p3["p3_rates_pre"] + l_p3["p3_rates_post"],
         **k_rs["p3_rates"]},
        {"name": "p3_sedimentation (sed_step + sed_columns rerun)",
         "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_sed.cu",
         "replaces": "miniweatherml_tpu/physics/p3.py:1268-1388 "
                     "(lax.while_loop, not a Pallas kernel)",
         "launches": l_p3["sed_step"] + l_p3["sed_columns"],
         **k_rs["p3_sedimentation"]},
        {"name": "fct_scale_div", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/fct.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:1084, "
                     "miniweatherml_tpu/ops/pallas_recon.py:1151",
         "launches": l_city["fct_scale_div"], **k_fct["fct_scale_div"]},
        {"name": "fct_mult", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/fct.cu",
         "replaces": "miniweatherml_tpu/dycore/euler.py:880-889 (an XLA "
                     "fusion, not a Pallas kernel)",
         "launches": l_city["fct_mult"], **k_fct["fct_mult"]},
        {"name": "direction_fluxes_strips (x; y with the stage update)",
         "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/direction_fluxes.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:536, "
                     "miniweatherml_tpu/ops/pallas_recon.py:941 (the "
                     "halo-strip form, miniweatherml_tpu/dycore/"
                     "euler.py:645-655)",
         "launches": l_spmd["strips"], **k_strips},
        {"name": "fct_scale_div_edges", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/fct.cu",
         "replaces": "miniweatherml_tpu/ops/pallas_recon.py:1084, "
                     "miniweatherml_tpu/ops/pallas_recon.py:1151 (with the "
                     "edge multipliers of miniweatherml_tpu/dycore/"
                     "euler.py:943-957)",
         "launches": l_spmd["edges"], **k_edges},
        # the microphysics tails that the JAX package leaves to XLA fusion
        {"name": "kessler_min_step", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/kessler.cu",
         "replaces": "miniweatherml_tpu/physics/kessler.py:134-150 (an XLA "
                     "fusion, not a Pallas kernel)",
         "launches": l_kessler["min_step"], **k_tails["min_step"]},
        {"name": "p3_part3", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_cellwise.cu",
         "replaces": "miniweatherml_tpu/physics/p3.py:1392-1485 (an XLA "
                     "fusion, not a Pallas kernel)",
         "launches": l_p3["p3_part3"], **k_rs["p3_part3"]},
        {"name": "p3_wrapper_out", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/p3_cellwise.cu",
         "replaces": "miniweatherml_tpu/physics/p3.py:1726-1741 (an XLA "
                     "fusion, not a Pallas kernel)",
         "launches": l_p3["p3_wrapper_out"], **k_rs["p3_wrapper_out"]},
        # the dycore's state transforms, which the JAX package leaves to
        # XLA: one step's five calls
        {"name": "dycore_state (de-densitization x 3, both conversions)",
         "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/dycore_state.cu",
         "replaces": "miniweatherml_tpu/dycore/euler.py:322-356, 1009-1017 "
                     "(XLA fusions, not Pallas kernels)",
         "launches": l_kessler["dycore_state"], **k_ds},
        {"name": "surrogate_forward", "route": "cuda",
         "source": "miniweatherml_tpu_torch/csrc/surrogate.cu",
         "replaces": "miniweatherml_tpu/physics/kessler_surrogate.py:60-76 "
                     "(an XLA fusion, not a Pallas kernel)",
         "launches": l_sur["surrogate_forward"],
         **k_tails["surrogate_forward"]},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        # no single PyTorch call computes any of these kernels' functions
        k["library_ms"] = None
        missing = [key for key in keys if key not in k]
        if missing:
            raise AssertionError(f"{k['name']}: no {missing} measured")
    # the twin is host C++, not a TPU kernel: a line of its own
    print(json.dumps({"native": native_rec}))
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
