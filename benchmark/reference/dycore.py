"""Plain PyTorch reference of the dycore step (the supercell and the city).

Frozen from ``tests/oracle_dycore.py`` at commit b9c5862 (the NumPy oracle
written from the reference ``Dynamics_Euler_Stratified_WenoFV``,
model/modules/dynamics_euler_stratified_wenofv.h) and translated to torch
so that it runs at the benchmark's full grid on the card.  Frozen: it does
not follow later edits of that file, and it imports nothing of the program.

What changed from the oracle, and why:

* The WENO limiter is evaluated as small matrix products on stencils laid
  out as rows (every candidate's coefficients in one product, every
  candidate's edge values in another), not cell by cell.  The operation
  order of the weights is the oracle's: TV -> convexify -> idl / (w^2 +
  1e-20) -> convexify (cutoff 0).  Matrix products run with TF32 off.
* Each direction's reconstruction and Riemann solve run over slabs of the
  grid along an axis other than the direction's own, so the temporaries fit
  beside the state; the slabs need no halo.
* The state divergence of a direction is added as soon as its fluxes are
  known; only the tracer fluxes are kept for FCT.
* Gravity where the constants enable it, Coriolis only if nonzero, and
  the immersed blend where the constants carry ``immersed_proportion`` and
  ``use_immersed_boundaries`` (frozen from the oracle's lines 335-342 at
  commit a5ba73f: the state's tendencies blend toward -min(1, dt / tau)
  state / dt with tau = 1000 dt, weighted per cell by the proportion).

Tensor layout: (nvar, nens, nz, ny, nx); state order idR, idU, idV, idW,
idT = rho', rho u, rho v, rho w, (rho theta)'.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IDR, IDU, IDV, IDW, IDT = 0, 1, 2, 3, 4
BC_PERIODIC, BC_OPEN, BC_WALL = 0, 1, 2
CS = 350.0                # frozen acoustic speed (dynamics...h:402)
MAXWAVE = 350.0 + 80.0    # fixed max wave speed (dynamics...h:70-77)
CFL = 0.6
SLAB_VALUES = 1 << 25     # stencil rows per slab (of nvar variables)


def time_step(dx: float, dy: float, dz: float) -> float:
    """The dycore's CFL step (dynamics...h:70-77)."""
    return CFL * min(dx, dy, dz) / MAXWAVE


# ----------------------------------------------------------------------
# WENO machinery, derived with float64 linear algebra (as the oracle)
# ----------------------------------------------------------------------
def _sten_to_coefs(offsets):
    """Cell averages at integer ``offsets`` -> monomial coefficients."""
    n = len(offsets)
    A = np.empty((n, n))
    for r, c in enumerate(offsets):
        for s in range(n):
            A[r, s] = ((c + 0.5) ** (s + 1) - (c - 0.5) ** (s + 1)) / (s + 1)
    return np.linalg.inv(A)


def _tv_quadratic(n):
    """Q with TV(a) = a^T Q a = sum_{m>=1} int (p^(m))^2 dx."""
    Q = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            acc = 0.0
            for m in range(1, n):
                pi = np.polynomial.Polynomial([0.0] * i + [1.0]).deriv(m)
                pj = np.polynomial.Polynomial([0.0] * j + [1.0]).deriv(m)
                prod = (pi * pj).integ()
                acc += prod(0.5) - prod(-0.5)
            Q[i, j] = acc
    return Q


class Weno:
    """WenoLimiter<ord> with cutoff 0 (WenoLimiter.h:52-193): low
    sub-stencils, ideal weights and the edge evaluation of the oracle."""

    def __init__(self, ord_: int, dtype: torch.dtype, device):
        h = (ord_ - 1) // 2
        if ord_ == 3:
            lows = [(-1, 0), (0, 1)]
            idl = [1.0, 1.0, 5.0e2]
        elif ord_ == 5:
            lows = [(-2, -1, 0), (-1, 0, 1), (0, 1, 2)]
            idl = [1.0, 2.0, 1.0, 1.0e3]
        elif ord_ in (7, 9):
            lows = [(-2, -1, 0), (-1, 0, 1), (0, 1, 2)]
            idl = [1.0, 2.0, 1.0, 1.0e5 if ord_ == 7 else 1.0e8]
        else:
            raise ValueError(f"unsupported order {ord_}")
        self.ord = ord_
        m = len(lows[0])
        # every candidate's coefficients from the whole stencil: (ord, m)
        # blocks of the low candidates, then the (ord, ord) high one
        mats = []
        for offs in lows:
            M = np.zeros((ord_, m))
            M[[h + o for o in offs], :] = _sten_to_coefs(offs).T
            mats.append(M)
        mats.append(_sten_to_coefs(tuple(range(-h, h + 1))).T)
        self.widths = [m] * len(lows) + [ord_]
        self.coef = torch.as_tensor(np.concatenate(mats, axis=1), dtype=dtype,
                                    device=device)
        self.tv = [torch.as_tensor(_tv_quadratic(w), dtype=dtype,
                                   device=device) for w in self.widths]
        # every candidate's left and right edge values: (ord, 2K)
        P = [np.array([[(-0.5) ** s for s in range(w)],
                       [(+0.5) ** s for s in range(w)]]) for w in self.widths]
        self.edge = torch.as_tensor(np.concatenate(
            [M @ Pk.T for M, Pk in zip(mats, P)], axis=1), dtype=dtype,
            device=device)
        idl = np.array(idl)
        self.idl = [float(v) for v in idl / idl.sum()]

    def edges(self, sten):
        """(rows, ord) stencils -> (left, right) edge values per row."""
        C = sten @ self.coef
        ws, a = [], 0
        for w, Q in zip(self.widths, self.tv):
            c = C[:, a:a + w]
            ws.append(((c @ Q) * c).sum(-1))
            a += w
        del C

        def convexify(ws):
            tot = sum(ws)
            sel = tot > 1e-20
            return [torch.where(sel, w / torch.where(sel, tot, 1.0), w)
                    for w in ws]

        ws = convexify(ws)
        ws = [i / (w * w + 1e-20) for i, w in zip(self.idl, ws)]
        ws = convexify(ws)
        E = sten @ self.edge
        left = sum(w * E[:, 2 * k] for k, w in enumerate(ws))
        right = sum(w * E[:, 2 * k + 1] for k, w in enumerate(ws))
        return left, right


# ----------------------------------------------------------------------
# one direction: halo fill, reconstruction, edge BCs, Riemann
# ----------------------------------------------------------------------
def _fill_halos(a, bc, hp, zero_var=None):
    """Halo fill on the last axis (dynamics...h:749-827): periodic wrap, or
    edge replication with the wall-normal variable zeroed."""
    n = a.shape[-1]
    if bc == BC_PERIODIC:
        lo, hi = a[..., n - hp:], a[..., :hp]
    else:
        lo = a[..., :1].expand(*a.shape[:-1], hp).clone()
        hi = a[..., n - 1:].expand(*a.shape[:-1], hp).clone()
        if zero_var is not None and bc == BC_WALL:
            lo[zero_var] = 0.0
            hi[zero_var] = 0.0
    return torch.cat([lo, a, hi], dim=-1)


def _limits(weno, prim, bc, normal_id, hy_r, hy_t):
    """Both edge limits at the n + 1 faces of the last axis of ``prim``
    (nvar, ..., n): state limits re-densitized with the backgrounds
    ``hy_r`` / ``hy_t`` (broadcast to the faces) re-added, then the edge
    BCs (dynamics...h:271-388, :1005-1085)."""
    nvar, n = prim.shape[0], prim.shape[-1]
    hp = (weno.ord - 1) // 2 + 1
    padded = _fill_halos(prim, bc, hp,
                         zero_var=normal_id if bc == BC_WALL else None)
    sten = padded.unfold(-1, weno.ord, 1)      # (..., n + 2, ord)
    lead = sten.shape[:-1]
    gl, gr = weno.edges(sten.reshape(-1, weno.ord))
    gl, gr = gl.reshape(lead), gr.reshape(lead)
    # face f: L from cell f-1's right edge, R from cell f's left edge
    L = gr[..., :n + 1].clone()
    R = gl[..., 1:].clone()
    del gl, gr
    rL = L[IDR] + hy_r
    rR = R[IDR] + hy_r
    L[IDR] = rL
    R[IDR] = rR
    L[IDU:IDT] *= rL
    R[IDU:IDT] *= rR
    L[IDT] += hy_t
    R[IDT] += hy_t
    L[5:] *= rL
    R[5:] *= rR
    if bc != BC_PERIODIC:
        L[..., 0] = R[..., 0]
        R[..., n] = L[..., n]
        if bc == BC_WALL:
            for X in (L, R):
                X[normal_id, ..., 0] = 0.0
                X[normal_id, ..., n] = 0.0
    return L, R


def _riemann(L, R, normal_id, C0, gamma):
    """Acoustic + advective upwind fluxes (dynamics...h:395-485)."""
    ruL, ruR = L[normal_id], R[normal_id]
    pL = C0 * L[IDT] ** gamma
    pR = C0 * R[IDT] ** gamma
    w1 = 0.5 * (pR - CS * ruR)
    w2 = 0.5 * (pL + CS * ruL)
    p_upw = w1 + w2
    ru_upw = (w2 - w1) / CS
    q = torch.where((ruL + ruR) > 0, L, R)
    r_upw = q[IDR]
    sf = torch.empty_like(L[:5])
    sf[IDR] = ru_upw
    for v in (IDU, IDV, IDW, IDT):
        sf[v] = ru_upw * q[v] / r_upw
    sf[normal_id] += p_upw
    tf = ru_upw * q[5:] / r_upw
    return sf, tf


def _direction(weno, prim, axis, bc, normal_id, hy_r, hy_t, d, C0, gamma,
               st):
    """Fluxes of one direction (``axis`` -1 x, -2 y, -3 z): the state
    divergence is added into ``st``; returns the tracer fluxes with the
    faces on ``axis``.  The work runs over slabs of another axis."""
    nvar = prim.shape[0]
    n = prim.shape[axis]
    moved = prim.movedim(axis, -1)             # (nvar, nens, a, b, n)
    slab_axis = 2                              # z for x and y, y for z
    extent = moved.shape[slab_axis]
    per = max(1, SLAB_VALUES // max(1, moved[0].numel() // extent * nvar))
    ntr = nvar - 5
    tf_out = prim.new_empty((ntr,) + tuple(moved.shape[1:-1]) + (n + 1,))
    st_moved = st.movedim(axis, -1)
    for a in range(0, extent, per):
        sl = [slice(None)] * 5
        sl[slab_axis] = slice(a, min(extent, a + per))
        sl = tuple(sl)
        blk = moved[sl].contiguous()
        if axis == -3:      # z: backgrounds at the faces, (nens, nz + 1)
            hr = hy_r[:, None, None, :]
            ht = hy_t[:, None, None, :]
        else:               # x, y: backgrounds at the slab's levels
            hr = hy_r[:, sl[2], None, None]
            ht = hy_t[:, sl[2], None, None]
        L, R = _limits(weno, blk, bc, normal_id, hr, ht)
        del blk
        sf, tf = _riemann(L, R, normal_id, C0, gamma)
        del L, R
        st_moved[sl] -= (sf[..., 1:] - sf[..., :-1]) / d
        tf_out[sl] = tf
        del sf, tf
    return tf_out.movedim(-1, axis)


def _fct(tr, positive, TFx, TFy, TFz, dt, dx, dy, dz):
    """Flux-corrected transport (dynamics...h:498-516) and the tracer flux
    divergence.  Face f of an axis takes cell f-1's multiplier where the
    flux is positive and cell f's where it is negative; the outer side of
    faces 0 and n takes 1, on periodic axes too."""
    tt = torch.zeros_like(tr)
    for t in range(tr.shape[0]):
        Fx, Fy, Fz = TFx[t], TFy[t], TFz[t]
        if positive[t]:
            avail = torch.clamp(tr[t], min=0.0) * dx * dy * dz
            fo = (torch.clamp(Fx[..., 1:], min=0.0)
                  - torch.clamp(Fx[..., :-1], max=0.0)) / dx
            fo = fo + (torch.clamp(Fz[:, 1:], min=0.0)
                       - torch.clamp(Fz[:, :-1], max=0.0)) / dz
            fo = fo + (torch.clamp(Fy[:, :, 1:], min=0.0)
                       - torch.clamp(Fy[:, :, :-1], max=0.0)) / dy
            mass_out = fo * dt * dx * dy * dz
            del fo
            need = mass_out > avail
            mult = torch.where(need, avail / torch.where(need, mass_out, 1.0),
                               1.0)
            del need, avail, mass_out

            def scale(F, axis):
                shp = list(mult.shape)
                shp[axis] = 1
                one = mult.new_ones(shp)
                m_left = torch.cat([one, mult], dim=axis)
                m_right = torch.cat([mult, one], dim=axis)
                return F * torch.where(F > 0, m_left,
                                       torch.where(F < 0, m_right, 1.0))
            Fx, Fy, Fz = scale(Fx, -1), scale(Fy, -2), scale(Fz, -3)
        tt[t] = (-(Fx[..., 1:] - Fx[..., :-1]) / dx
                 - (Fz[:, 1:] - Fz[:, :-1]) / dz
                 - (Fy[:, :, 1:] - Fy[:, :, :-1]) / dy)
    return tt


class DycoreReference:
    """The SSPRK3 step of the oracle on a full 3-D grid."""

    def __init__(self, grid, consts, hy, tracer_flags, dtype, device,
                 ord_: int = 5):
        self.g, self.c = grid, consts
        self.hy = hy                    # (hyc, hyt, hye, hyte), (nens, nz[+1])
        self.positive = [p for p, _ in tracer_flags]
        self.adds_mass = [m for _, m in tracer_flags]
        self.weno = Weno(ord_, dtype, device)

    def tendencies(self, s, tr, dt):
        """One compute_tendencies (dynamics...h:204-552): (st, tt)."""
        g, c = self.g, self.c
        hyc, hyt, hye, hyte = self.hy
        full_r = s[IDR] + hyc[:, :, None, None]
        prim = torch.cat([s[IDR:IDU], s[IDU:IDT] / full_r, s[IDT:IDT + 1],
                          tr / full_r])
        st = torch.zeros_like(s)
        args = (c["C0"], c["gamma"], st)
        TFx = _direction(self.weno, prim, -1, c["bc_x"], IDU, hyc, hyt, g.dx,
                         *args)
        TFz = _direction(self.weno, prim, -3, c["bc_z"], IDW, hye, hyte, g.dz,
                         *args)
        TFy = _direction(self.weno, prim, -2, c["bc_y"], IDV, hyc, hyt, g.dy,
                         *args)
        del prim
        tt = _fct(tr, self.positive, TFx, TFy, TFz, dt, g.dx, g.dy, g.dz)
        del TFx, TFy, TFz
        if c.get("enable_gravity", True):
            st[IDW] -= c["grav"] * full_r
        if c["fcor"] != 0.0:
            st[IDU] += c["fcor"] * s[IDV]
            st[IDV] -= c["fcor"] * s[IDU]
        prop = c.get("immersed_proportion")
        if prop is not None and c.get("use_immersed_boundaries", False):
            fac = -min(1.0, dt / (1.0e3 * dt)) / dt
            st = prop * (fac * s) + (1.0 - prop) * st
        return st, tt

    def step(self, s, tr, dt):
        """One SSPRK3 step with the per-stage positive-tracer clamp
        (dynamics...h:117-174)."""
        pos = torch.tensor(self.positive, device=tr.device)[:, None, None,
                                                            None, None]

        def clamp(t):
            return torch.where(pos, torch.clamp(t, min=0.0), t)

        st, tt = self.tendencies(s, tr, dt)
        s1 = s + dt * st
        t1 = clamp(tr + dt * tt)
        st, tt = self.tendencies(s1, t1, dt / 4.0)
        s2 = 0.75 * s + 0.25 * s1 + 0.25 * dt * st
        t2 = clamp(0.75 * tr + 0.25 * t1 + 0.25 * dt * tt)
        del s1, t1
        st, tt = self.tendencies(s2, t2, 2.0 * dt / 3.0)
        s3 = s / 3.0 + 2.0 / 3.0 * s2 + 2.0 / 3.0 * dt * st
        t3 = clamp(tr / 3.0 + 2.0 / 3.0 * t2 + 2.0 / 3.0 * dt * tt)
        return s3, t3

    # conversions (dynamics...h:1891-2015)
    def to_dynamics(self, f, tracer_names, idwv):
        c = self.c
        hyc = self.hy[0][:, :, None, None]
        hyt = self.hy[1][:, :, None, None]
        rho_d, temp = f["density_dry"], f["temp"]
        trs = torch.stack([f[n] for n in tracer_names])
        press = rho_d * c["R_d"] * temp + trs[idwv] * c["R_v"] * temp
        rho = rho_d + sum(trs[t] for t in range(len(tracer_names))
                          if self.adds_mass[t])
        theta = (press / c["C0"]) ** (1.0 / c["gamma"]) / rho
        s = torch.stack([rho - hyc, rho * f["uvel"], rho * f["vvel"],
                         rho * f["wvel"], rho * theta - hyt])
        return s, trs

    def to_coupler(self, s, tr, tracer_names, idwv):
        c = self.c
        hyc = self.hy[0][:, :, None, None]
        hyt = self.hy[1][:, :, None, None]
        rho = s[IDR] + hyc
        theta = (s[IDT] + hyt) / rho
        press = c["C0"] * (rho * theta) ** c["gamma"]
        rho_d = rho - sum(tr[t] for t in range(len(tracer_names))
                          if self.adds_mass[t])
        temp = press / (rho_d * c["R_d"] + tr[idwv] * c["R_v"])
        out = {"density_dry": rho_d, "uvel": s[IDU] / rho,
               "vvel": s[IDV] / rho, "wvel": s[IDW] / rho, "temp": temp}
        for t, n in enumerate(tracer_names):
            out[n] = tr[t]
        return out

    def time_step(self, f, dt_phys, tracer_names, idwv):
        """The dycore's module step on coupler fields: CFL sub-cycles of
        SSPRK3 (dynamics...h:81-181)."""
        g = self.g
        dt_dyn = time_step(g.dx, g.dy, g.dz)
        ncycles = max(1, int(math.ceil(dt_phys / dt_dyn - 1e-12)))
        dt = dt_phys / ncycles
        s, tr = self.to_dynamics(f, tracer_names, idwv)
        for _ in range(ncycles):
            s, tr = self.step(s, tr, dt)
        out = dict(f)
        out.update(self.to_coupler(s, tr, tracer_names, idwv))
        return out
