"""The one generator of the benchmark's inputs: it reads a traffic mix
(``traffic/<name>.json``, parameters only) and makes that mix's inputs on
the device from ``--seed``.  The same tensors go to the program and to the
reference, each of which puts them into its own state (``apply_inputs``).

A mix lists ``inputs``, each one field's input, made in that order from
one generator seeded with ``--seed``.  Every entry names its ``field``,
whether it is added to the field or sets it (``mode``: ``add`` or
``set``), and its ``form``:

* ``uniform``: values drawn uniformly from ``range`` [lo, hi] on the
  levels from ``levels`` [first, last) (fractions of nz; default all),
  times ``scale`` where given, optionally scaled linearly from 1 at the
  first level to 0 at the last (``taper``), and kept only where a second
  draw falls under ``keep_fraction`` (default 1, no second draw) -- the
  random form of the reference's model/modules/perturb_temperature.h:
  26-41, or white-noise hydrometeors over every regime;
* ``layer``: a Gaussian in z, ``peak`` at ``z_m`` with ``width_m``, times
  the profile ``rho0 exp(-z / height_m)`` (``density``) where given,
  times 1 + ``amplitude`` sin(2 pi x / xlen + a) cos(2 pi y / ylen + b)
  (``modulation``), the phases a, b drawn from the seed once per mix, at
  the first layer that asks for them.

``per_density_dry``: the value is a mixing ratio, multiplied by the
state's ``density_dry`` when it is put in.  Every seed gets the same
sizes, levels and magnitudes; only the random values and phases change.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SEED_MASK = (1 << 63) - 1


@dataclass
class Input:
    """One field's input: ``value`` (nens, levels, ny, nx) from level
    ``k0``, added to the field or setting it."""

    field: str
    add: bool
    k0: int
    value: torch.Tensor
    per_density_dry: bool = False


def _levels(entry, nz):
    lo, hi = entry.get("levels", (0.0, 1.0))
    return int(nz * lo), int(nz * hi)


def _uniform(entry, grid, g, dtype, device):
    k0, k1 = _levels(entry, grid.nz)
    shape = (grid.nens, k1 - k0, grid.ny, grid.nx)
    lo, hi = entry["range"]
    v = torch.rand(shape, generator=g, dtype=dtype, device=device) \
        * (hi - lo) + lo
    if "scale" in entry:
        v = v * entry["scale"]
    if entry.get("taper"):
        n = k1 - k0
        k = torch.arange(n, dtype=dtype, device=device)
        v = v * ((n - k) / n)[None, :, None, None]
    keep = entry.get("keep_fraction", 1.0)
    if keep < 1.0:
        v = torch.where(torch.rand(shape, generator=g, dtype=dtype,
                                   device=device) < keep, v, 0.0)
    return k0, v


def _layer(entry, grid, g, dtype, device, phases):
    f64 = dict(dtype=torch.float64, device=device)
    z = (torch.arange(grid.nz, **f64) + 0.5) * grid.dz
    gauss = torch.exp(-((z - entry["z_m"]) / entry["width_m"]) ** 2)
    dens = entry.get("density")
    if dens:
        rho = dens["rho0"] * torch.exp(-z / dens["height_m"])
        prof = entry["peak"] * rho * gauss
    else:
        prof = entry["peak"] * gauss
    horiz = torch.ones((grid.ny, grid.nx), **f64)
    mod = entry.get("modulation")
    if mod:
        if not phases:
            phases.extend((torch.rand(2, generator=g, **f64)
                           * 2.0 * math.pi).tolist())
        x = (torch.arange(grid.nx, **f64) + 0.5) * grid.dx
        y = (torch.arange(grid.ny, **f64) + 0.5) * grid.dy
        horiz = 1.0 + mod["amplitude"] * (
            torch.sin(2.0 * math.pi * x / grid.xlen + phases[0])[None, :]
            * torch.cos(2.0 * math.pi * y / grid.ylen + phases[1])[:, None])
    v = (prof.to(dtype)[:, None, None] * horiz.to(dtype)[None])[None]
    return 0, v.expand(grid.nens, -1, -1, -1).contiguous()


def make_inputs(traffic: dict, grid, seed: int, dtype, device) -> list:
    """The mix's inputs, a list of ``Input`` in the mix's order."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)   # any whole number
    phases: list = []
    out = []
    for entry in traffic["inputs"]:
        if entry["form"] == "uniform":
            k0, v = _uniform(entry, grid, g, dtype, device)
        elif entry["form"] == "layer":
            k0, v = _layer(entry, grid, g, dtype, device, phases)
        else:
            raise ValueError(f"no input form {entry['form']!r}")
        if entry["mode"] not in ("add", "set"):
            raise ValueError(f"no input mode {entry['mode']!r}")
        out.append(Input(entry["field"], entry["mode"] == "add", k0, v,
                         bool(entry.get("per_density_dry"))))
    return out


def input_fields(inputs: list) -> list:
    """The state's fields that ``apply_inputs`` reads."""
    names = {i.field for i in inputs}
    if any(i.per_density_dry for i in inputs):
        names.add("density_dry")
    return sorted(names)


def apply_inputs(fields, inputs: list) -> dict:
    """The field updates that put ``inputs`` into a state whose fields
    ``fields[name]`` gives, in the inputs' order."""
    upd = {}
    for i in inputs:
        v = i.value * fields["density_dry"][:, i.k0:i.k0 + i.value.shape[1]] \
            if i.per_density_dry else i.value
        base = upd.get(i.field, fields[i.field])
        k1 = i.k0 + v.shape[1]
        if i.add:
            v = base[:, i.k0:k1] + v
        if i.k0 == 0 and k1 == base.shape[1]:
            upd[i.field] = v
        else:
            upd[i.field] = torch.cat([base[:, :i.k0], v, base[:, k1:]], dim=1)
    return upd


def input_sums(inputs: list) -> list:
    """Each input's sum in float64: the same seed gives the same inputs."""
    return [(i.field, i.value.double().sum().item()) for i in inputs]
