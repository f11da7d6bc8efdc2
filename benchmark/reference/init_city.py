"""The city initial state, derived again from the configuration: the
random downtown of dynamics_euler_stratified_wenofv.h:1421-1547 in the
gravity-off case of experiments/simple_city/inputs/input_city.yaml.

Written from ``miniweatherml_tpu_torch/dycore/init_cases.py``
(``init_city``, ``_uniform_flow_profiles``, ``_uniform_flow_state``) at
commit a5ba73f; it imports nothing of the program.  With gravity off the
background is uniform, rho = 1.15 and theta = 300, and the flow u = 20 m/s
everywhere, buildings included.  The chain has no microphysics: its one
tracer is the water vapor the driver adds by hand (driver.cpp:55-56), and
the gas constants are the dycore's defaults (dynamics...h:1227-1248).

The buildings: 30 m blocks from 20 blocks in from the x and y edges, in
rows of two blocks of three along x and eight of nine along y; a block's
height is a draw of the reference's std::mt19937(17) with
std::normal_distribution(60, 10), taken row-major over the block grid, and
a cell of level k is immersed where k <= ceil(height / dz).  The draws are
read as data from the file the configuration's ``city_heights`` names
(libstdc++'s normal draws cannot be made again with numpy).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .dycore import BC_PERIODIC, BC_WALL, IDU

# (name, positive, adds_mass): the vapor the driver registers by hand
TRACERS = (("water_vapor", True, True),)
R_D, CP_D, R_V, P0, GRAV = 287.0, 1003.0, 461.0, 1.0e5, 9.81
RHO, THETA, U = 1.15, 300.0, 20.0
BLOCK_M, PAD_BLOCKS = 30, 20


def constants(micro=None):
    """The dycore's constants (dynamics...h:1227-1248): its default gas
    constants, periodic x and y, walls in z, gravity off and the immersed
    blend on."""
    c = dict(R_d=R_D, cp_d=CP_D, R_v=R_V, p0=P0, grav=GRAV)
    cv_d = c["cp_d"] - c["R_d"]
    gamma = c["cp_d"] / cv_d
    kappa = c["R_d"] / c["cp_d"]
    c.update(gamma=gamma, C0=(c["R_d"] * c["p0"] ** (-kappa)) ** gamma,
             fcor=2.0 * 7.292115e-5 * math.sin(0.0), bc_x=BC_PERIODIC,
             bc_y=BC_PERIODIC, bc_z=BC_WALL, enable_gravity=False,
             use_immersed_boundaries=True)
    return c


def _ensemble(value, n, grid, dtype, device):
    return torch.full((grid.nens, n), value, dtype=dtype, device=device)


def initial_dynamics(grid, c, ntr, idwv, dtype, device):
    """(hy, s, tr): the uniform backgrounds (nens, nz[+1]), rho' = (rho
    theta)' = 0, rho u = 1.15 x 20 and no vapor."""
    hy = (_ensemble(RHO, grid.nz, grid, dtype, device),
          _ensemble(RHO * THETA, grid.nz, grid, dtype, device),
          _ensemble(RHO, grid.nz + 1, grid, dtype, device),
          _ensemble(RHO * THETA, grid.nz + 1, grid, dtype, device))
    shape = (grid.nens, grid.nz, grid.ny, grid.nx)
    s = torch.zeros((5,) + shape, dtype=dtype, device=device)
    tr = torch.zeros((ntr,) + shape, dtype=dtype, device=device)
    s[IDU] = RHO * U
    return hy, s, tr


def building_heights(grid, cfg, root):
    """(ny, nx) height in m of the building over each column, -1 where
    there is none."""
    cells = max(int(round(BLOCK_M / grid.dx)), 1)
    blocks_x = max((int(grid.xlen) // BLOCK_M - 2 * PAD_BLOCKS) // 3, 0) * 3
    blocks_y = max((int(grid.ylen) // BLOCK_M - 2 * PAD_BLOCKS) // 9, 0) * 9
    out = np.full((grid.ny, grid.nx), -1.0)
    if blocks_x == 0 or blocks_y == 0:
        return out
    draws = np.load(os.path.join(root, cfg["city_heights"]))
    heights = draws[:blocks_y * blocks_x].reshape(blocks_y, blocks_x)
    bi = np.arange(grid.nx) // cells - PAD_BLOCKS
    bj = np.arange(grid.ny) // cells - PAD_BLOCKS
    for j in range(grid.ny):
        if not (0 <= bj[j] < blocks_y and bj[j] % 9 < 8):
            continue
        for i in np.nonzero((bi >= 0) & (bi < blocks_x) & (bi % 3 < 2))[0]:
            out[j, i] = heights[bj[j], bi[i]]
    return out


def immersed_proportion(grid, cfg, root, dtype, device):
    """(nz, ny, nx): 1 in the cells inside a building, else 0."""
    h = building_heights(grid, cfg, root)
    k = np.arange(grid.nz)[:, None, None]
    inside = (h[None] >= 0.0) & (k <= np.ceil(h / grid.dz)[None])
    return torch.as_tensor(inside.astype(np.float64), dtype=dtype,
                           device=device)
