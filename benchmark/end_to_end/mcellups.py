"""Cells times steps completed in the window over its seconds, in
millions: all the work over all the time, ended by a synchronize."""


def read(run):
    g = run.grid
    return g.nx * g.ny * g.nz * g.nens * run.steps / run.elapsed / 1e6
