"""Entry points: one supercell step, and the multi-device dry run.

Counterpart of the root ``__graft_entry__.py``.

``entry()`` returns a forward step of the flagship model (the supercell
experiment: WENO Euler dycore + Kessler + sponge + column nudging) with its
example state, at ``__graft_entry__``'s tiny 2-D configuration.

``dryrun_multichip(n)`` builds an ("ens", "y", "x") mesh of n devices
(``parallel/mesh.py``), shards the coupler state over it and runs, through
``parallel/spmd.py::make_spmd_step``, 20 steps of the Kessler chain, 20
steps of the P3 ice chain and one step of the MLP surrogate, each in f64,
and holds every result against the same chain run undecomposed on the
first device: after ``gather_state`` every checked field must lie within
``INVARIANCE_RTOL`` (2e-5, the JAX dry run's ``_INVARIANCE_RTOL``) of its
scale, and ``ShardedState.validate()`` must be clean.  A decomposition
fault anywhere (halo strips, the sponge's and nudger's horizontal means,
the microphysics' sub-cycle counts) fails the run.  The JAX dry run checks
two distribution paths (auto-SPMD and ``shard_map``); the port has one,
``make_spmd_step``.  By default the mesh repeats ``cuda:0`` n times, which
``make_mesh`` allows: every shard then runs on the one card, in turns.

Usage:  python -m miniweatherml_tpu_torch.dryrun [n_devices] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

from .bench import example_surrogate
from .config import config_from_dict
from .core.coupler import Grid, make_coupler_state
from .experiments.driver import add_device_argument, checked_device, setup_state
from .experiments.supercell_example import build
from .parallel.mesh import gather_state, make_mesh, shard_state
from .parallel.spmd import make_spmd_step
from .physics.column_nudging import ColumnNudger
from .physics.kessler import MicrophysicsKessler
from .physics.p3 import MicrophysicsP3
from .physics.sponge import sponge_layer

__all__ = ["entry", "dryrun_multichip", "INVARIANCE_RTOL", "DRYRUN_STEPS"]

DRYRUN_STEPS = 20
# n shards against 1 at f64 after DRYRUN_STEPS steps, as a share of each
# field's scale: the JAX dry run's bound (__graft_entry__.py), ~100x above
# its measured 1.2e-7 / 1.9e-7 and far below an exchange fault (~1e-3+).
INVARIANCE_RTOL = 2e-5

KESSLER_FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp",
                  "water_vapor", "cloud_liquid", "precip_liquid")
P3_FIELDS = ("density_dry", "uvel", "wvel", "temp", "water_vapor",
             "cloud_water", "rain", "ice", "ice_num")
SURROGATE_FIELDS = ("density_dry", "uvel", "wvel", "temp", "water_vapor",
                    "cloud_liquid", "precip_liquid")


def _tiny_config(nx=32, ny=1, nz=16, nens=1, dtype="float32"):
    return config_from_dict(dict(
        sim_time=10.0, nens=nens, nx_glob=nx, ny_glob=ny, nz=nz,
        xlen=100000.0, ylen=100000.0, zlen=20000.0, dtype=dtype,
        init_data="supercell", out_prefix="graft", dt_phys=0.0, out_freq=-1.0,
    ))


def entry(device: str = "cuda"):
    """(step, (state,)): one full supercell physics step of the tiny 2-D
    configuration (32 x 1 x 16, f32) on ``device``."""
    device = checked_device("entry", device)
    state, mods, dycore = build(_tiny_config(), device)
    dt = dycore.compute_time_step(state)

    def step(s):
        for m in mods:
            s = m(s, dt)
        return s

    return step, (state,)


def _largest_error(got, want, names) -> tuple[float, str]:
    """(max |got - want| over max |want|, field) of the worst field."""
    worst = (0.0, names[0])
    for n in names:
        a, b = got[n].double(), want[n].to(got[n].device).double()
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, (float((a - b).abs().max()) / scale, n))
    return worst


def _run_chain(label, state, mesh, step_fn, spmd_kw, dt, steps, names):
    """``steps`` steps of ``step_fn`` undecomposed on the mesh's first
    device, then decomposed; returns the chain's record and raises when the
    two differ by more than ``INVARIANCE_RTOL`` of a field's scale or a
    shard's state is bad."""
    t0 = time.perf_counter()
    ref = state.clone()
    for _ in range(steps):
        ref = step_fn(ref, dt)
    ref_s = time.perf_counter() - t0
    step = make_spmd_step(state, mesh, **spmd_kw)
    try:
        t0 = time.perf_counter()
        sharded = shard_state(state, mesh)
        for _ in range(steps):
            sharded = step(sharded, dt)
        problems = sharded.validate()
        mesh_s = time.perf_counter() - t0
    finally:
        step.close()
    if problems:
        raise AssertionError(f"{label}: the decomposed run has bad values: "
                             f"{problems}")
    err, field = _largest_error(gather_state(sharded, mesh.devices[0]), ref,
                                names)
    if not err <= INVARIANCE_RTOL:
        raise AssertionError(
            f"{label}: field {field} differs between {mesh.size} shards and "
            f"1 after {steps} steps by {err:.3e} of its scale "
            f"(> {INVARIANCE_RTOL:.0e})")
    return {"steps": steps, "max_rel_err": err, "field": field,
            "seconds": mesh_s, "seconds_undecomposed": ref_s}


def dryrun_multichip(n_devices: int, devices=None,
                     steps: int = DRYRUN_STEPS) -> dict:
    """The Kessler (``steps`` steps), P3 (``steps``) and surrogate (one
    step) chains on an n-device mesh against the undecomposed run, all in
    f64.  ``devices`` defaults to ``cuda:0`` repeated ``n_devices`` times.
    The mesh is (ens, y, x) with ens = 2 when n is even and at least 4,
    near-square (y, x) for the rest, as in the JAX dry run.  Returns, per
    chain, the largest difference as a share of its field's scale, that
    field, and the decomposed and undecomposed wall seconds."""
    if devices is None:
        devices = [checked_device("dryrun_multichip", "cuda:0")] * n_devices
    devices = list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"dry run needs {n_devices} devices but was given "
                         f"{len(devices)}")
    ens = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices, ens=ens)
    if mesh.size != n_devices:
        raise ValueError(f"mesh uses {mesh.size} devices, expected "
                         f"{n_devices}")
    ny_m, nx_m = mesh.y, mesh.x
    ny = 8 * ny_m if ny_m > 1 else 8
    dev = mesh.devices[0]
    out = {"mesh": mesh.shape}

    # ---- Kessler chain (dycore -> Kessler -> sponge -> nudging) ----
    config = _tiny_config(nx=16 * nx_m, ny=ny, nz=16, nens=2 * ens,
                          dtype="float64")
    state, _, dycore = build(config, dev)
    dt = dycore.compute_time_step(state)
    micro, nudger = MicrophysicsKessler(), ColumnNudger()

    def kessler(s, dt):
        s = micro.time_step(dycore.time_step(s, dt), dt)
        return nudger.nudge_to_column(sponge_layer(s, dt), dt)

    out["kessler"] = _run_chain(
        "Kessler", state, mesh, kessler,
        dict(dycore=dycore, micro=micro, nudger=nudger), dt, steps,
        KESSLER_FIELDS)
    del state

    # ---- P3 ice chain (dycore -> P3) ----
    g = Grid(nx=16 * nx_m, ny=ny, nz=12, nens=ens, xlen=64000.0,
             ylen=32000.0, zlen=16000.0)
    micro3 = MicrophysicsP3()
    st3 = make_coupler_state(g, dtype="float64", device=dev,
                             options={"init_data": "supercell",
                                      "out_freq": -1.0})
    st3 = dycore.init(micro3.init(st3))
    dt3 = dycore.compute_time_step(st3)
    out["p3"] = _run_chain(
        "P3", st3, mesh,
        lambda s, dt: micro3.time_step(dycore.time_step(s, dt), dt),
        dict(dycore=dycore, micro=micro3, sponge_time_scale=None), dt3,
        steps, P3_FIELDS)
    del st3

    # ---- MLP surrogate (dycore -> surrogate), one step ----
    sur = example_surrogate()
    st5 = dycore.init(sur.init(setup_state(config, dev)))
    out["surrogate"] = _run_chain(
        "surrogate", st5, mesh,
        lambda s, dt: sur.time_step(dycore.time_step(s, dt), dt),
        dict(dycore=dycore, micro=sur, sponge_time_scale=None), dt, 1,
        SURROGATE_FIELDS)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    add_device_argument(ap)
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    device = checked_device("dryrun", args.device)
    step, (state,) = entry(device)
    problems = step(state).validate()
    if problems:
        raise AssertionError(f"entry(): bad values after one step: {problems}")
    print("entry() ok")
    res = dryrun_multichip(args.n_devices, [device] * args.n_devices)
    for chain in ("kessler", "p3", "surrogate"):
        r = res[chain]
        print(f"{chain}: {r['steps']} steps on mesh {res['mesh']}, largest "
              f"difference {r['max_rel_err']:.3e} of {r['field']}'s scale; "
              f"{r['seconds']:.2f} s decomposed, "
              f"{r['seconds_undecomposed']:.2f} s undecomposed")
    print("dryrun_multichip ok")
    return res


if __name__ == "__main__":
    main()
