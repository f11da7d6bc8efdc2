"""Offline stitcher for per-shard NetCDF output.

A copy, in the port, of ``miniweatherml_tpu/io/stitch.py``.

The reference's PNetCDF branch writes ONE collective file from all ranks
(dynamics_euler_stratified_wenofv.h:2019-2191); its ``file_per_process``
branch writes one file per rank instead (dynamics...h:2027-2120).  Here the
``ShardedStateWriter`` is the per-shard path, and this module restores the
single-file capability offline: it reassembles ``{prefix}_task_*.nc`` shard
files into one file bit-for-bit identical to what ``StateWriter`` would
have written from the gathered global state.

Each shard file carries its global index offsets as ``i_beg``/``j_beg``
attributes and global-coordinate x/y variables (io/netcdf.py), so the
placement of every block is explicit -- no mesh metadata is needed at
stitch time.

Usage:  python -m miniweatherml_tpu_torch.io.stitch <prefix> [-o out.nc]
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from scipy.io import netcdf_file as _netcdf_file

__all__ = ["stitch_sharded", "main"]

_COORDS = ("t", "x", "y", "z")


def _shard_paths(prefix: str) -> list[str]:
    paths = glob.glob(f"{prefix}_task_*.nc")
    if not paths:
        raise FileNotFoundError(f"no shard files match {prefix}_task_*.nc")
    # numeric rank order (glob is lexicographic: task_10 before task_2)
    def rank(p):
        m = re.search(r"_task_(\d+)\.nc$", p)
        if m is None:
            raise ValueError(f"not a shard file name: {p}")
        return int(m.group(1))
    return sorted(paths, key=rank)


def stitch_sharded(prefix: str, out_path: str | None = None) -> str:
    """Merge ``{prefix}_task_*.nc`` into one global file at ``out_path``
    (default ``{prefix}.nc``).  Returns the output path.

    Validates that the shards tile the global (y, x) rectangle exactly
    (no gaps, no overlaps) and share identical t and z axes.
    """
    out_path = out_path or prefix + ".nc"

    shards = []
    for path in _shard_paths(prefix):
        # mmap=False: read eagerly so the handle can close before we write
        nc = _netcdf_file(path, "r", mmap=False)
        i_beg = int(getattr(nc, "i_beg", 0))
        j_beg = int(getattr(nc, "j_beg", 0))
        data = {name: var[:].copy() for name, var in nc.variables.items()}
        nc.close()
        shards.append((i_beg, j_beg, data))

    _, _, first = shards[0]
    varnames = [n for n in first if n not in _COORDS]
    t = first["t"]
    z = first["z"]
    nx_glob = max(i + d["x"].size for i, _, d in shards)
    ny_glob = max(j + d["y"].size for _, j, d in shards)

    # Exact-tiling check: every global cell covered exactly once.
    cover = np.zeros((ny_glob, nx_glob), np.int32)
    for i_beg, j_beg, d in shards:
        cover[j_beg:j_beg + d["y"].size, i_beg:i_beg + d["x"].size] += 1
    if not (cover == 1).all():
        bad = "gaps" if (cover == 0).any() else "overlaps"
        raise ValueError(f"shard files do not tile the global grid: {bad}")

    x_glob = np.empty(nx_glob, np.float64)
    y_glob = np.empty(ny_glob, np.float64)
    for i_beg, j_beg, d in shards:
        if d["t"].shape != t.shape or not (d["t"] == t).all():
            raise ValueError("shard files disagree on the time axis")
        if not (d["z"] == z).all():
            raise ValueError("shard files disagree on the z axis")
        x_glob[i_beg:i_beg + d["x"].size] = d["x"]  # already global coords
        y_glob[j_beg:j_beg + d["y"].size] = d["y"]

    out = _netcdf_file(out_path, "w")
    out.createDimension("t", None)
    out.createDimension("x", nx_glob)
    out.createDimension("y", ny_glob)
    out.createDimension("z", z.size)
    for dim, vals in (("x", x_glob), ("y", y_glob), ("z", z)):
        v = out.createVariable(dim, "d", (dim,))
        v[:] = vals
    tvar = out.createVariable("t", "d", ("t",))
    vars_out = {n: out.createVariable(n, "d", ("t", "z", "y", "x"))
                for n in varnames}
    for it in range(t.size):
        tvar[it] = t[it]
        for name in varnames:
            frame = np.empty((z.size, ny_glob, nx_glob), np.float64)
            for i_beg, j_beg, d in shards:
                ny, nx = d["y"].size, d["x"].size
                frame[:, j_beg:j_beg + ny, i_beg:i_beg + nx] = d[name][it]
            vars_out[name][it] = frame
    out.close()
    return out_path


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("prefix", help="shard file prefix ({prefix}_task_N.nc)")
    p.add_argument("-o", "--out", default=None, help="output path")
    a = p.parse_args(argv)
    path = stitch_sharded(a.prefix, a.out)
    print(f"stitched -> {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
