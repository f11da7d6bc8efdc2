"""Surrogate training-data harvesting: activity statistics + stratified
sample generation.

Port of ``miniweatherml_tpu/ml/surrogate_data.py`` (after the reference's
StatisticsGatherer, experiments/supercell_kessler_surrogate/custom_modules/
gather_micro_statistics.h, and DataGenerator,
custom_modules/generate_micro_surrogate_data.h).

Classification and stratified thresholding run on the device; the selected
cells' stencil rows are gathered there too, and only those rows go to the
host, in one copy per step.  Rows are buffered and written once at
``finalize``, with the reference's NetCDF schema.

The selection draws its uniforms from a ``torch.Generator`` that the
``DataGenerator`` owns; the JAX package draws from a JAX PRNG key, which
torch cannot reproduce, so the two packages harvest different cells.
``select_samples`` takes the uniforms as an argument: given the same
uniforms, both select the same cells.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.coupler import CouplerState

__all__ = ["is_active_mask", "select_samples", "StatisticsGatherer",
           "DataGenerator", "load_dataset"]

_TOL = 1.0e-10  # activity tolerance (gather_micro_statistics.h:62)


def is_active_mask(before: CouplerState, after: CouplerState) -> torch.Tensor:
    """Cells where microphysics changed T / rho_v / rho_c / rho_p by more
    than 1e-10 (gather_micro_statistics.h:61-73).  Shape (nens,nz,ny,nx)."""
    act = torch.zeros(before["temp"].shape, dtype=torch.bool,
                      device=before["temp"].device)
    for name in ("temp", "water_vapor", "cloud_liquid", "precip_liquid"):
        act |= torch.abs(after[name] - before[name]) > _TOL
    return act


class StatisticsGatherer:
    """Accumulates the active-cell ratio; prints every 200 s of sim time
    (gather_micro_statistics.h:54,76-84).  One host read per step."""

    def __init__(self):
        self.numer = 0.0
        self.denom = 0.0
        self.num_out = 0

    def gather(self, before: CouplerState, after: CouplerState,
               dt: float, etime: float) -> None:
        act = is_active_mask(before, after)
        if etime > (self.num_out + 1) * 200.0:
            self.print_ratio()
            self.num_out += 1
        self.numer += float(torch.sum(act))
        self.denom += float(act.numel())

    @property
    def ratio_active(self) -> float:
        return self.numer / max(self.denom, 1.0)

    def print_ratio(self) -> None:
        print(f"*** Ratio Active ***:  {self.ratio_active:10.6e}")

    def finalize(self) -> None:
        self.print_ratio()


def select_samples(active: torch.Tensor, u: torch.Tensor,
                   ratio_active: float = 0.4, samples_per_step: float = 50.0,
                   desired_ratio_active: float = 0.5) -> torch.Tensor:
    """Stratified per-cell Bernoulli selection
    (generate_micro_surrogate_data.h:47-98): with uniforms ``u`` in [0, 1)
    of ``active``'s shape, active cells are taken with probability
    p_a = (r_des*S)/(r_act*N), inactive ones with
    p_i = ((1-r_des)*S)/((1-r_act)*N); the thresholds are in ``u``'s dtype."""
    n = active.numel()
    p_active = desired_ratio_active * samples_per_step / (ratio_active * n)
    p_inactive = (1.0 - desired_ratio_active) * samples_per_step / (
        (1.0 - ratio_active) * n)
    thresh = torch.where(active, u.new_full((), p_active),
                         u.new_full((), p_inactive))
    return u < thresh


class DataGenerator:
    """Harvests (input, output) pairs around the microphysics call into the
    reference's dataset schema: float32 ``inputs`` (nsamples, 5, 2) --
    column 0 = [T, rho_d, rho_v, rho_c, rho_p] at cell k, column 1 =
    [T, rho_v, rho_c, rho_p, 0] at cell min(k+1, nz-1) (the reference packs
    the second stencil cell skipping the rho_d row,
    generate_micro_surrogate_data.h:131-140) -- and ``outputs``
    (nsamples, 4) = [T, rho_v, rho_c, rho_p] after microphysics.

    The selection's uniforms come from a generator on the state's device,
    seeded ``seed + step`` at every step."""

    VARS_IN = ("temp", "density_dry", "water_vapor", "cloud_liquid",
               "precip_liquid")
    VARS_OUT = ("temp", "water_vapor", "cloud_liquid", "precip_liquid")

    def __init__(self, fname: str = "supercell_kessler_data_task_0.nc",
                 ratio_active: float = 0.4, samples_per_step: float = 50.0,
                 seed: int = 0):
        self.fname = fname
        self.ratio_active = ratio_active
        self.samples_per_step = samples_per_step
        self.seed = seed
        self._step = 0
        self._generator: torch.Generator | None = None
        self._inputs: list[np.ndarray] = []
        self._outputs: list[np.ndarray] = []
        self.meta: dict[str, float] = {}

    def init(self, state: CouplerState) -> CouplerState:
        """Write the metadata sidecar into the working directory
        (generate_micro_surrogate_data.h:25-30)."""
        with open("supercell_kessler_metadata.txt", "w") as f:
            f.write("This dataset contains data for training a surrogate "
                    "model to emulate Kessler microphysics.\n\n")
            f.write("vars_in : temperature, dry air density, water vapor "
                    "density, cloud liquid density, precipitation density\n")
            f.write("vars_out: temperature, water vapor density, cloud "
                    "liquid density, precipitation density\n")
        return state

    def _uniforms(self, like: torch.Tensor) -> torch.Tensor:
        if self._generator is None or self._generator.device != like.device:
            self._generator = torch.Generator(like.device)
        self._generator.manual_seed(self.seed + self._step)
        return torch.rand(like.shape, generator=self._generator,
                          dtype=torch.float64, device=like.device)

    def generate_samples_stencil(self, before: CouplerState,
                                 after: CouplerState, dt: float,
                                 etime: float) -> int:
        """Select cells (stratified), gather their stencil rows on the
        device and copy them to the host, buffered for the dataset.
        Returns the number of samples taken."""
        g = before.grid
        if not self.meta:
            self.meta = dict(
                time_step_size=dt,
                only_two_dimensions=0 if g.ny == 1 else 1,
                dx=g.dx, dy=g.dy, dz=g.dz,
                xlen=g.xlen, ylen=g.ylen, zlen=g.zlen,
            )
        active = is_active_mask(before, after)
        mask = select_samples(active, self._uniforms(active),
                              ratio_active=self.ratio_active,
                              samples_per_step=self.samples_per_step)
        self._step += 1

        idx = torch.nonzero(mask)  # (ns, 4) (e, k, j, i), np.argwhere's order
        ns = idx.shape[0]
        if ns == 0:
            return 0
        e, k, j, i = idx.unbind(1)
        kp = torch.clamp(k + 1, max=g.nz - 1)
        col0 = [before[n][e, k, j, i] for n in self.VARS_IN]
        col1 = [before[n][e, kp, j, i] for n in self.VARS_OUT]
        col1.append(torch.zeros_like(col1[0]))  # col 1 skips rho_d
        out = [after[n][e, k, j, i] for n in self.VARS_OUT]
        rows = torch.stack(
            [torch.stack(col0, -1), torch.stack(col1, -1)], -1)  # (ns, 5, 2)
        rows = torch.cat([rows.reshape(ns, 10), torch.stack(out, -1)], 1)
        rows = rows.to(torch.float32).cpu().numpy()
        self._inputs.append(rows[:, :10].reshape(ns, 5, 2))
        self._outputs.append(rows[:, 10:])
        return ns

    @property
    def num_samples(self) -> int:
        return sum(a.shape[0] for a in self._inputs)

    def finalize(self) -> str:
        """Write the buffered samples to ``fname`` as NetCDF with the
        reference's schema (dims nsamples/num_vars_in/sten_size/
        num_vars_out + grid scalars); returns the path."""
        from scipy.io import netcdf_file

        inputs = (np.concatenate(self._inputs) if self._inputs
                  else np.zeros((0, 5, 2), np.float32))
        outputs = (np.concatenate(self._outputs) if self._outputs
                   else np.zeros((0, 4), np.float32))
        nc = netcdf_file(self.fname, "w")
        nc.createDimension("nsamples", None)
        nc.createDimension("num_vars_in", 5)
        nc.createDimension("sten_size", 2)
        nc.createDimension("num_vars_out", 4)
        nc.createDimension("scalar", 1)
        vi = nc.createVariable("inputs", "f",
                               ("nsamples", "num_vars_in", "sten_size"))
        vi[:] = inputs
        vo = nc.createVariable("outputs", "f", ("nsamples", "num_vars_out"))
        vo[:] = outputs
        for name, val in self.meta.items():
            v = nc.createVariable(name, "d", ("scalar",))
            v[:] = float(val)
        nc.close()
        return self.fname


def load_dataset(path: str):
    """Read a generated dataset (.nc or .npz) -> (inputs (N,5,2) float32,
    outputs (N,4) float32, meta dict)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            meta = {k: float(z[k]) for k in z.files
                    if k not in ("inputs", "outputs")}
            return z["inputs"], z["outputs"], meta
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        inputs = np.array(nc.variables["inputs"][:], np.float32)
        outputs = np.array(nc.variables["outputs"][:], np.float32)
        meta = {k: float(np.array(v[:]).ravel()[0])
                for k, v in nc.variables.items()
                if k not in ("inputs", "outputs")}
    return inputs, outputs, meta
