"""The work a step needs, counted from shapes, and the card's peaks.

Frozen from ``chip_smoke.py`` at commit b9c5862 (``HBM_BYTES_S``,
``PEAK_FLOPS``, ``_bound``, ``_limiter_ops_opt``, ``_flux_work``,
``_epilogue_work``, ``_kessler_work`` and the FCT bound of its phase 14),
with ``substencils`` of ``miniweatherml_tpu_torch/ops/weno_fused.py`` at the
same commit.  Frozen: the work a kernel is credited with does not follow
what implements it.  Bytes count each input once and each output once;
the flux kernel's operations are those of the reduced-operation (``opt``)
WENO algebra, the fewest the port has, whichever algebra runs.
"""

from __future__ import annotations

# The card's published rates (H100 SXM data sheet, 700 W): HBM bytes/s and
# non-tensor-core FLOP/s per type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEM = {"float32": 4, "float64": 8}


def bound_s(nbytes: int, ops: int, dtype: str) -> float:
    """The least time of a call: the larger of its bytes over the HBM rate
    and its operations over the type's peak."""
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[dtype])


def substencils(ord_: int) -> list[tuple[int, int]]:
    """(first stencil index, width) of each candidate polynomial."""
    hs = (ord_ - 1) // 2
    if ord_ == 3:
        return [(0, 2), (1, 2), (0, 3)]
    return [(hs - 2, 3), (hs - 1, 3), (hs, 3), (0, ord_)]


def _opt_dropped(ord_: int, k: int, m: int, q: int) -> bool:
    return ord_ >= 7 and k == 1 and m == 0 and q == 1


def limiter_ops_opt(ord_: int) -> int:
    """Operations of one variable's WENO edges in one cell in the
    reduced-operation algebra, a reciprocal counted as one."""
    sup = substencils(ord_)
    K, H = len(sup), ord_ // 2
    if ord_ == 5:
        low = 12 + 3 * 5
    else:
        low = 0
        for k, (_, w) in enumerate(sup[:-1]):
            taps = [w - sum(_opt_dropped(ord_, k, m, q) for q in range(w))
                    for m in range(w - 1)]
            low += sum(2 * t for t in taps) + len(taps) - 1
    high = 2 * H + H * (2 * H + 2) + (H - 1) + H * (2 * H + 1)
    weights = (K - 1) + 3 + 4 * K + (K - 1) + 1
    gamma = ord_ <= 5
    kept = sup[:-1] if gamma else sup
    edges = 2 * (sum((3 if gamma else 1) + (2 * w - 1) + 1 for _, w in kept)
                 + len(kept) - 1)
    return low + high + weights + edges


def flux_work(nvar, shape, axis, ord_, dtype) -> tuple[int, int]:
    """(bytes, operations) of one bare direction_fluxes call on ``nvar``
    variables of ``shape`` = (nens, nz, ny, nx) along ``axis`` (-1 x, -2 y,
    -3 z): the variables and the two background profiles read once, the 5
    state divergences and the tracer faces (n + 1 per line) written once;
    WENO edges of n + 2 cells per line for every variable, n + 1 faces
    solved (~25 operations plus 4 per tracer), 5 differences and scalings
    per cell."""
    ntr = nvar - 5
    nens, nz = shape[0], shape[1]
    cells = nens * nz * shape[2] * shape[3]
    n = shape[axis]
    lines = cells // n
    nlev = nz + (1 if axis == -3 else 0)
    item = ITEM[dtype]
    nbytes = item * (nvar * cells + 5 * cells + ntr * lines * (n + 1)
                     + 2 * nens * nlev)
    ops = (nvar * limiter_ops_opt(ord_) * lines * (n + 2)
           + (25 + 4 * ntr) * lines * (n + 1) + 10 * cells)
    return nbytes, ops


def epilogue_work(nvar, shape, axis, ord_, dtype,
                  stage=None) -> tuple[int, int]:
    """(bytes, operations) of a call that adds its divergence into the
    running one, and with ``stage`` (1, 2 or 3) also makes the SSPRK3
    stage's state: the bare call's work, the accumulator read and 5 adds a
    cell; for the stage b0 [, b1] and the cell density profile read once,
    and per cell 3 or 5 operations a variable, 3 for gravity."""
    nbytes, ops = flux_work(nvar, shape, axis, ord_, dtype)
    cells = shape[0] * shape[1] * shape[2] * shape[3]
    item = ITEM[dtype]
    nbytes += 5 * cells * item
    ops += 5 * cells
    if stage is not None:
        nb = 5 * cells * (1 if stage == 1 else 2) + shape[0] * shape[1]
        nbytes += nb * item
        ops += cells * (5 * (3 if stage == 1 else 5) + 3)
    return nbytes, ops


def flux_step(nvar, shape, ord_, dtype) -> tuple[float, int]:
    """(least seconds, operations) of one step's flux calls: per SSPRK3
    stage x bare, z accumulating and y with the stage update."""
    t, ops = 0.0, 0
    for stage in (1, 2, 3):
        for w in (flux_work(nvar, shape, -1, ord_, dtype),
                  epilogue_work(nvar, shape, -3, ord_, dtype),
                  epilogue_work(nvar, shape, -2, ord_, dtype, stage)):
            t += bound_s(*w, dtype)
            ops += w[1]
    return t, ops


def fct_step(ntr, shape, dtype) -> float:
    """Least seconds of one step's FCT calls: per stage the multiplier
    (the tracers and their three face sets read, the multipliers written;
    ~20 operations a value) and the scaled divergences along x (faces and
    multipliers read, the tracer tendency written), z (also the running
    tendency read) and y (also the stage's tracers b0 [, b1] read, the new
    tracers written); the divergences are counted by their bytes."""
    nens, nz, ny, nx = shape
    cells = nens * nz * ny * nx
    item = ITEM[dtype]
    fx = nens * nz * ny * (nx + 1)
    fy = nens * nz * (ny + 1) * nx
    fz = nens * (nz + 1) * ny * nx
    t = 0.0
    for stage in (1, 2, 3):
        mult = ntr * (cells + fx + fy + fz + cells)
        t += bound_s(mult * item, 20 * ntr * cells, dtype)
        t += bound_s(ntr * (fx + 2 * cells) * item, 0, dtype)
        t += bound_s(ntr * (fz + 3 * cells) * item, 0, dtype)
        t += bound_s(ntr * (fy + (4 if stage == 1 else 5) * cells) * item, 0,
                     dtype)
    return t


def kessler_step_ops(shape, nsub: int = 1) -> int:
    """Operations of one Kessler step: ~80 a cell and sub-step plus ~25
    for the prep and the post (pow, exp and sqrt counted as one); the
    sub-step count is the least a step takes."""
    cells = shape[0] * shape[1] * shape[2] * shape[3]
    return (80 * nsub + 25) * cells
