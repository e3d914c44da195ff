"""A frozen copy of the general Godunov corner-transport-upwind chain
(incflo_torch/ops/godunov_walls.py, itself the jnp chain of incflo's
Godunov with the boundary forms of incflo_godunov_plm.H,
incflo_godunov_ppm.H and incflo_godunov_trans_bc.H), with its x-slab
(mesh) forms taken out.  The reference step advects the walled
Rayleigh-Taylor deck with it.  Kept here so that a later change to the
program's chain cannot move the reference it is held to.

Every transverse correction is a cell-indexed quantity applied to a face
state as lo(face f) -= corr(cell f-1), hi(face f) -= corr(cell f).  All
stages work on arrays tagged with a global-index origin (class F), so
every stencil window is explicit; face arrays use face ids along their
own axis (face f lies between cells f-1 and f).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.deck import BCType
from benchmark.reference.godunov_periodic import (SMALL_VEL, _mc2_parts,
                                                  _mc4, _riemann, _van_leer)
from benchmark.reference.godunov_periodic import _upwind as _upwind_edge

_EXTRAP = (BCType.foextrap, BCType.hoextrap, BCType.reflect_even)


@dataclasses.dataclass(frozen=True)
class F:
    """An array and the global index of its first entry per axis."""
    a: torch.Tensor
    org: Tuple[int, ...]

    def win(self, ranges) -> torch.Tensor:
        out = self.a
        for d, (lo, hi) in enumerate(ranges):
            s, e = lo - self.org[d], hi - self.org[d]
            if not 0 <= s <= e <= self.a.shape[d]:
                raise IndexError(
                    f"window {(lo, hi)} outside field axis {d} "
                    f"(org {self.org[d]}, size {self.a.shape[d]})")
            out = out.narrow(d, s, e - s)
        return out


def _mask(like: torch.Tensor, axis: int, org: int, value: int):
    """True where the global index along `axis` equals `value`
    (broadcastable against `like`)."""
    shape = [1] * like.dim()
    shape[axis] = like.shape[axis]
    idx = torch.arange(like.shape[axis], device=like.device) + org
    return (idx == value).reshape(shape)


def _mc4_extdir(qm2, qm1, q0, qp1, qp2, on_lo, on_hi, near_lo, near_hi):
    """Order-4 slope with the extdir boundary forms
    (amrex_calc_xslope_extdir): at the boundary cell the derivative is
    fitted through the face value held in the ghost cell; the order-2
    slopes feeding the interior form use the 3-point one-sided dc at the
    boundary cell (near_lo / near_hi mark the cells one away)."""
    def mc2(a, b, c, lo_m, hi_m):
        dl = 2.0 * (b - a)
        dr = 2.0 * (c - b)
        dc = 0.5 * (c - a)
        dc = torch.where(lo_m, (c + 3.0 * b - 4.0 * a) / 3.0, dc)
        dc = torch.where(hi_m, (4.0 * c - 3.0 * b - a) / 3.0, dc)
        dlim = torch.where(dl * dr >= 0.0,
                           torch.minimum(dl.abs(), dr.abs()), 0.0)
        return torch.sign(dc) * torch.minimum(dc.abs(), dlim)

    false = torch.zeros_like(on_lo)
    sm = mc2(qm2, qm1, q0, near_lo, false)   # slope at cell i-1
    sp = mc2(q0, qp1, qp2, false, near_hi)   # slope at cell i+1
    dc, dlim = _mc2_parts(qm1, q0, qp1)
    dc = torch.where(on_lo, (qp1 + 3.0 * q0 - 4.0 * qm1) / 3.0, dc)
    dc = torch.where(on_hi, (4.0 * qp1 - 3.0 * q0 - qm1) / 3.0, dc)
    dq = (4.0 / 3.0) * dc - (1.0 / 6.0) * (sp + sm)
    dq = torch.where(on_lo, -16.0 / 15.0 * qm1 + 0.5 * q0
                     + 2.0 / 3.0 * qp1 - 0.1 * qp2, dq)
    dq = torch.where(on_hi, 16.0 / 15.0 * qp1 - 0.5 * q0
                     - 2.0 / 3.0 * qm1 + 0.1 * qm2, dq)
    return torch.sign(dq) * torch.minimum(dq.abs(), dlim)


def _clip(x, a, b):
    return torch.clamp(x, torch.minimum(a, b), torch.maximum(a, b))


def _relimit(smc, spc, c, strict: bool):
    """PPM monotonicity limiter of the edge pair (smc, spc) about c."""
    prod = (spc - c) * (c - smc)
    flat = (prod < 0.0) if strict else (prod <= 0.0)
    big_p = (spc - c).abs() >= 2.0 * (smc - c).abs()
    big_m = (smc - c).abs() >= 2.0 * (spc - c).abs()
    sp_n = torch.where(flat, c, torch.where(big_p, 3.0 * c - 2.0 * smc, spc))
    sm_n = torch.where(flat, c, torch.where(~big_p & big_m,
                                            3.0 * c - 2.0 * spc, smc))
    return sm_n, sp_n


class WindowedGodunov:
    """The chain of incflo_tpu's GodunovScheme._predict / .advect on
    ghost-filled arrays, 2D or 3D, for any mix of periodic and walled
    axes.  use_forces_in_trans adds the half-step force to the traces
    before the transverse stages instead of to the final face states
    (incflo_tpu/ops/godunov.py:320-323)."""

    def __init__(self, grid, use_ppm: bool,
                 use_forces_in_trans: bool = False):
        self.grid = grid
        self.use_ppm = use_ppm
        self.uft = use_forces_in_trans
        self.nd = grid.ndim

    # -- range helpers -------------------------------------------------
    def _cells1(self):
        """cells [-1, n+1) on every axis."""
        return [(-1, n + 1) for n in self.grid.n_cell]

    def _rng(self, spec: Dict[int, Tuple[int, int]], default=(0, 0)):
        """ranges with per-axis overrides; default = interior cells
        extended by (lo, hi)."""
        out = []
        for d, n in enumerate(self.grid.n_cell):
            lo, hi = spec.get(d, default)
            out.append((lo, n + hi))
        return out

    def _shift(self, qf: F, axis, off):
        r = self._cells1()
        r[axis] = (r[axis][0] + off, r[axis][1] + off)
        return qf.win(r)

    # -- traces: per-cell Im/Ip on cells [-1, n+1) ---------------------
    def _traces(self, qf, axis, comp_bc, wlo_c, whi_c, dt, is_velocity,
                comp):
        if self.use_ppm:
            return self._ppm_traces(qf, axis, comp_bc, wlo_c, whi_c, dt)
        return self._plm_traces(qf, axis, comp_bc, wlo_c, whi_c, dt,
                                is_velocity, comp)

    def _plm_traces(self, qf, axis, comp_bc, wlo_c, whi_c, dt, is_velocity,
                    comp):
        g = self.grid
        n = g.n_cell[axis]
        dtdx = dt / g.dx[axis]
        qm2, qm1, q0, qp1, qp2 = (self._shift(qf, axis, o)
                                  for o in (-2, -1, 0, 1, 2))
        bclo, bchi = comp_bc
        walled = not g.periodic[axis]
        extdir_lo = walled and bclo in (BCType.ext_dir, BCType.hoextrap)
        extdir_hi = walled and bchi in (BCType.ext_dir, BCType.hoextrap)
        if extdir_lo or extdir_hi:
            never = _mask(q0, axis, 0, -1)
            on_lo = _mask(q0, axis, -1, 0) if extdir_lo else never
            on_hi = _mask(q0, axis, -1, n - 1) if extdir_hi else never
            nr_lo = _mask(q0, axis, -1, 1) if extdir_lo else never
            nr_hi = _mask(q0, axis, -1, n - 2) if extdir_hi else never
            slp = _mc4_extdir(qm2, qm1, q0, qp1, qp2, on_lo, on_hi,
                              nr_lo, nr_hi)
        else:
            slp = _mc4(qm2, qm1, q0, qp1, qp2)

        Im = q0 + 0.5 * (-1.0 - wlo_c * dtdx) * slp
        Ip = q0 + 0.5 * (1.0 - whi_c * dtdx) * slp

        # ext_dir boundary-face overrides (Godunov_plm_fpu_*:34-51)
        if walled:
            if bclo == BCType.ext_dir:
                Ip = torch.where(_mask(q0, axis, -1, -1), q0, Ip)
                if comp == axis and is_velocity:
                    Im = torch.where(_mask(q0, axis, -1, 0), qm1, Im)
            if bchi == BCType.ext_dir:
                Im = torch.where(_mask(q0, axis, -1, n), q0, Im)
                if comp == axis and is_velocity:
                    Ip = torch.where(_mask(q0, axis, -1, n - 1), qp1, Ip)
        org = (-1,) * self.nd
        return F(Im, org), F(Ip, org)

    def _ppm_traces(self, qf, axis, comp_bc, wlo_c, whi_c, dt):
        g = self.grid
        dtdx = dt / g.dx[axis]
        sm2, sm1, s0, sp1, sp2 = (self._shift(qf, axis, o)
                                  for o in (-2, -1, 0, 1, 2))
        d1 = _van_leer(s0, sp1, sm1)
        d2 = _van_leer(sm1, s0, sm2)
        sedge1 = _clip(0.5 * (s0 + sm1) - (1.0 / 6.0) * (d1 - d2), s0, sm1)
        d1 = _van_leer(sp1, sp2, s0)
        d2 = _van_leer(s0, sp1, sm1)
        sedge2 = _clip(0.5 * (sp1 + s0) - (1.0 / 6.0) * (d1 - d2), s0, sp1)
        sm, sp = _relimit(sedge1, sedge2, s0, strict=True)

        bclo, bchi = comp_bc
        if not g.periodic[axis]:
            if bclo in (BCType.ext_dir, BCType.hoextrap):
                sm, sp = self._ppm_bc(axis, qf, sm, sp, 0)
            if bchi in (BCType.ext_dir, BCType.hoextrap):
                sm, sp = self._ppm_bc(axis, qf, sm, sp, 1)

        s6 = 6.0 * s0 - 3.0 * (sm + sp)
        sig_p = whi_c.abs() * dtdx
        sig_m = wlo_c.abs() * dtdx
        Ip = torch.where(whi_c > SMALL_VEL,
                         sp - 0.5 * sig_p * ((sp - sm)
                                             - (1.0 - 2.0 / 3.0 * sig_p) * s6),
                         s0)
        Im = torch.where(wlo_c < -SMALL_VEL,
                         sm + 0.5 * sig_m * ((sp - sm)
                                             + (1.0 - 2.0 / 3.0 * sig_m) * s6),
                         s0)
        org = (-1,) * self.nd
        return F(Im, org), F(Ip, org)

    def _ppm_bc(self, axis, qf, sm, sp, side):
        """Godunov_ppm_*bc: one-sided edge at the domain face, then the
        limiter again at the cell one away (godunov_ppm.H:31-186)."""
        n = self.grid.n_cell[axis]

        def at(cell):
            r = self._cells1()
            r[axis] = (cell, cell + 1)
            return qf.win(r)

        if side == 0:
            qg, q0, q1, q2 = at(-1), at(0), at(1), at(2)
            sedge = _clip(-0.2 * qg + 0.75 * q0 + 0.5 * q1 - 0.05 * q2,
                          q0, q1)
            m0 = _mask(sm, axis, -1, 0)
            m1 = _mask(sm, axis, -1, 1)
            sm = torch.where(m0, qg, sm)
            sp = torch.where(m0, sedge, sp)
            smc, spc, c = sedge.expand_as(sm), sp, at(1)
        else:
            qg, q0, q1, q2 = at(n), at(n - 1), at(n - 2), at(n - 3)
            sedge = _clip(-0.2 * qg + 0.75 * q0 + 0.5 * q1 - 0.05 * q2,
                          q0, q1)
            m0 = _mask(sm, axis, -1, n - 1)
            m1 = _mask(sm, axis, -1, n - 2)
            sp = torch.where(m0, qg, sp)
            sm = torch.where(m0, sedge, sm)
            smc, spc, c = sm, sedge.expand_as(sm), at(n - 2)
        sm_n, sp_n = _relimit(smc, spc, c, strict=False)
        return torch.where(m1, sm_n, sm), torch.where(m1, sp_n, sp)

    # -- face lo/hi states and their boundary forms --------------------
    def _face_lo_hi(self, d, Im: F, Ip: F, trans_ext: int,
                    force: Optional[F] = None, dt=None):
        """lo(face f) = Ip(cell f-1), hi(face f) = Im(cell f); faces
        0..n_d, transverse cells [-trans_ext, n+trans_ext); with
        use_forces_in_trans plus the half-step force of each cell."""
        r_hi = self._rng({d: (0, 1)}, default=(-trans_ext, trans_ext))
        r_lo = list(r_hi)
        r_lo[d] = (r_hi[d][0] - 1, r_hi[d][1] - 1)
        lo, hi = Ip.win(r_lo), Im.win(r_hi)
        if self.uft and force is not None:
            lo = lo + 0.5 * dt * force.win(r_lo)
            hi = hi + 0.5 * dt * force.win(r_hi)
        return lo, hi

    def _face_org(self, d, trans_ext=1):
        return tuple(0 if a == d else -trans_ext for a in range(self.nd))

    def _face_bc(self, d, lo, hi, qf: F, comp_bc, is_velocity, comp,
                 r_face):
        """Boundary forms of the (lo, hi) states of the faces in r_face
        on the domain faces of axis d: the ext_dir value from the ghost
        cell, the interior state at extrapolated faces, zero at
        reflect_odd.  One function serves the transverse stages and the
        final one (incflo_tpu's _trans_bc, _trans_bc_win and _cc_bc),
        which apply the same forms."""
        g = self.grid
        if g.periodic[d]:
            return lo, hi
        n = g.n_cell[d]
        bclo, bchi = comp_bc
        m_lo = _mask(lo, d, 0, 0)
        m_hi = _mask(lo, d, 0, n)
        if bclo == BCType.ext_dir:
            rg = list(r_face)
            rg[d] = (-1, 0)
            bval = qf.win(rg)
            lo = torch.where(m_lo, bval, lo)
            if comp == d and is_velocity:
                hi = torch.where(m_lo, bval, hi)
        elif bclo in _EXTRAP:
            lo = torch.where(m_lo, hi, lo)
        elif bclo == BCType.reflect_odd:
            lo = torch.where(m_lo, 0.0, lo)
            hi = torch.where(m_lo, 0.0, hi)
        if bchi == BCType.ext_dir:
            rg = list(r_face)
            rg[d] = (n, n + 1)
            bval = qf.win(rg)
            hi = torch.where(m_hi, bval, hi)
            if comp == d and is_velocity:
                lo = torch.where(m_hi, bval, lo)
        elif bchi in _EXTRAP:
            hi = torch.where(m_hi, lo, hi)
        elif bchi == BCType.reflect_odd:
            lo = torch.where(m_hi, 0.0, lo)
            hi = torch.where(m_hi, 0.0, hi)
        return lo, hi

    def _prevent_backflow(self, d, stl, sth, comp_bc):
        g = self.grid
        if g.periodic[d]:
            return stl, sth
        n = g.n_cell[d]
        bclo, bchi = comp_bc
        if bclo in (BCType.foextrap, BCType.hoextrap):
            m = _mask(stl, d, 0, 0)
            v = torch.clamp_max(sth, 0.0)
            sth = torch.where(m, v, sth)
            stl = torch.where(m, v, stl)
        if bchi in (BCType.foextrap, BCType.hoextrap):
            m = _mask(stl, d, 0, n)
            v = torch.clamp_min(stl, 0.0)
            stl = torch.where(m, v, stl)
            sth = torch.where(m, v, sth)
        return stl, sth

    # -- transverse corrections, cell-indexed --------------------------
    def _cell_corr(self, t, inter: F, w: F, qf: Optional[F], dt,
                   cell_ranges, conservative: bool, corner: bool):
        """Correction at the cells of cell_ranges from transverse axis t.
        Convective form: c (w_hi + w_lo)(q_hi - q_lo)/dx_t with c = dt/6
        (corner) or dt/4 (final); conservative form:
        c2 [(q_hi w_hi - q_lo w_lo) - q_cell (w_hi - w_lo)]/dx_t with
        c2 = dt/3 or dt/2 (the divu terms drop: divu == 0)."""
        g = self.grid
        r_lo = list(cell_ranges)
        r_hi = list(cell_ranges)
        r_hi[t] = (cell_ranges[t][0] + 1, cell_ranges[t][1] + 1)
        wlo, whi = w.win(r_lo), w.win(r_hi)
        qlo, qhi = inter.win(r_lo), inter.win(r_hi)
        if conservative:
            coef = dt / (3.0 * g.dx[t]) if corner else 0.5 * dt / g.dx[t]
            qc = qf.win(cell_ranges)
            return coef * ((qhi * whi - qlo * wlo) - qc * (whi - wlo))
        coef = dt / (6.0 * g.dx[t]) if corner else 0.25 * dt / g.dx[t]
        return coef * (whi + wlo) * (qhi - qlo)

    @staticmethod
    def _apply_cell_corr(d, lo, hi, corrF: F, face_ranges):
        """lo(face f) -= corr(cell f-1); hi(face f) -= corr(cell f)."""
        r_lo = list(face_ranges)
        r_lo[d] = (face_ranges[d][0] - 1, face_ranges[d][1] - 1)
        return lo - corrF.win(r_lo), hi - corrF.win(face_ranges)

    def _corner_stage(self, t, o, d, xlo_t, xhi_t, edge_o, w: Dict[int, F],
                      qf, bc_t, is_velocity, comp, dt, conservative):
        """Corner-coupled t-face states for face direction d: start from
        (t-lo, t-hi), subtract the o-derivative correction built from the
        o-edge states, apply the boundary forms on t, upwind with w[t].
        Extents: t faces [0, n+1), d cells [-1, n+1), o cells [0, n)."""
        spec = {t: (0, 1), d: (-1, 1)}
        r_face = self._rng(spec)
        lo = xlo_t.win(r_face)
        hi = xhi_t.win(r_face)
        corr_cells = self._rng({t: (-1, 1), d: (-1, 1)})
        corr = self._cell_corr(o, edge_o, w[o], qf, dt, corr_cells,
                               conservative, corner=True)
        corrF = F(corr, tuple(-1 if a in (t, d) else 0
                              for a in range(self.nd)))
        lo, hi = self._apply_cell_corr(t, lo, hi, corrF, r_face)
        lo, hi = self._face_bc(t, lo, hi, qf, bc_t, is_velocity, comp,
                               r_face)
        orgf = tuple(0 if a == t else (-1 if a == d else 0)
                     for a in range(self.nd))
        return F(_upwind_edge(lo, hi, w[t].win(r_face)), orgf)

    def _final_states(self, d, c_key, xlo, xhi, edge, w, qf, bc_of,
                      is_velocity, comp, force: Optional[F], dt,
                      conservative: bool):
        """(stl, sth) on the faces of direction d after the transverse
        corrections and the half-step force, before the boundary forms."""
        nd = self.nd
        t_axes = [a for a in range(nd) if a != d]
        r_face = self._rng({d: (0, 1)})
        stl = xlo[c_key(d)].win(r_face)
        sth = xhi[c_key(d)].win(r_face)
        for t in t_axes:
            if nd == 2:
                inter = edge[c_key(t)]
            else:
                o = [a for a in t_axes if a != t][0]
                inter = self._corner_stage(
                    t, o, d, xlo[c_key(t)], xhi[c_key(t)], edge[c_key(o)],
                    w, qf, bc_of(t), is_velocity, comp, dt, conservative)
            corr_cells = self._rng({d: (-1, 1)})
            corrF = F(self._cell_corr(t, inter, w[t], qf, dt, corr_cells,
                                      conservative, corner=False),
                      tuple(-1 if a == d else 0 for a in range(nd)))
            stl, sth = self._apply_cell_corr(d, stl, sth, corrF, r_face)
        if not self.uft and force is not None:
            r_lo = list(r_face)
            r_lo[d] = (r_face[d][0] - 1, r_face[d][1] - 1)
            stl = stl + 0.5 * dt * force.win(r_lo)
            sth = sth + 0.5 * dt * force.win(r_face)
        return stl, sth, r_face

    # -- MAC prediction ------------------------------------------------
    def predict(self, vel_g, forces_g, dt, ng: int, bcrecs: np.ndarray,
                gmacphi: Optional[Sequence[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """vel_g grown by ng >= 3, forces_g by 1 (or None).  Returns the
        MAC face velocity of each direction (n+1 along its own axis).
        gmacphi: -(1/rho) grad(mac_phi) on the faces, the
        use_mac_phi_in_godunov warm start: half a step of the gradient
        is taken out of the face states before the Riemann selection and
        put back after it (incflo_tpu/ops/godunov.py:564-577)."""
        nd = self.nd
        org = (-ng,) * nd
        comps = [F(vel_g[..., c], org) for c in range(nd)]
        fcomps = [F(forces_g[..., c], (-1,) * nd) if forces_g is not None
                  else None for c in range(nd)]

        def bc_of(c, ax):
            return (BCType(int(bcrecs[c, ax, 0])),
                    BCType(int(bcrecs[c, ax, 1])))

        # lo/hi states per axis for each component, at the cell velocity
        xlo, xhi = {}, {}
        for ax in range(nd):
            w = self._shift(comps[ax], ax, 0)
            for c in range(nd):
                Im, Ip = self._traces(comps[c], ax, bc_of(c, ax), w, w, dt,
                                      True, c)
                lo, hi = self._face_lo_hi(ax, Im, Ip, 1, fcomps[c], dt)
                r = self._rng({ax: (0, 1)}, default=(-1, 1))
                lo, hi = self._face_bc(ax, lo, hi, comps[c], bc_of(c, ax),
                                       True, c, r)
                orgf = self._face_org(ax)
                xlo[(ax, c)] = F(lo, orgf)
                xhi[(ax, c)] = F(hi, orgf)

        # transverse velocities (Riemann of the own component), then the
        # edge states they upwind
        u_ad = {ax: F(_riemann(xlo[(ax, ax)].a, xhi[(ax, ax)].a),
                      self._face_org(ax)) for ax in range(nd)}
        edge = {k: F(_upwind_edge(xlo[k].a, xhi[k].a, u_ad[k[0]].a),
                     xlo[k].org) for k in xlo}

        out = []
        for d in range(nd):
            stl, sth, r_face = self._final_states(
                d, lambda ax, c=d: (ax, c), xlo, xhi, edge, u_ad, comps[d],
                lambda t, c=d: bc_of(c, t), True, d, fcomps[d], dt, False)
            gphi = None
            if gmacphi is not None:
                gphi = -gmacphi[d]
                stl = stl - 0.5 * dt * gphi
                sth = sth - 0.5 * dt * gphi
            stl, sth = self._face_bc(d, stl, sth, comps[d], bc_of(d, d),
                                     True, d, r_face)
            stl, sth = self._prevent_backflow(d, stl, sth, bc_of(d, d))
            q = _riemann(stl, sth)
            if gphi is not None:
                q = q + 0.5 * dt * gphi
            out.append(q)
        return out

    # -- advective update ----------------------------------------------
    def advect(self, q_g, umac: Sequence[torch.Tensor], forces_g, dt,
               ng: int, bcrecs: np.ndarray, iconserv: Sequence[int],
               is_velocity: bool) -> torch.Tensor:
        """q_g grown by ng >= 3; umac interior face arrays (n+1 along
        their own axis); forces_g grown by 1 (or None).  Returns dq/dt on
        the interior, components last."""
        g = self.grid
        nd = self.nd
        org = (-ng,) * nd
        macF = {ax: self._extend_mac(umac[ax], ax) for ax in range(nd)}
        rates = []
        for c in range(q_g.shape[-1]):
            qf = F(q_g[..., c], org)
            fF = (F(forces_g[..., c], (-1,) * nd)
                  if forces_g is not None else None)
            icons = bool(iconserv[c])

            def bc(ax, c=c):
                return (BCType(int(bcrecs[c, ax, 0])),
                        BCType(int(bcrecs[c, ax, 1])))

            xlo, xhi, edge = {}, {}, {}
            for ax in range(nd):
                # wave speeds at the cell's low/high faces from umac
                r_lo = self._cells1()
                r_hi = list(r_lo)
                r_hi[ax] = (r_lo[ax][0] + 1, r_lo[ax][1] + 1)
                Im, Ip = self._traces(qf, ax, bc(ax), macF[ax].win(r_lo),
                                      macF[ax].win(r_hi), dt, is_velocity, c)
                lo, hi = self._face_lo_hi(ax, Im, Ip, 1, fF, dt)
                r = self._rng({ax: (0, 1)}, default=(-1, 1))
                lo, hi = self._face_bc(ax, lo, hi, qf, bc(ax), is_velocity,
                                       c, r)
                orgf = self._face_org(ax)
                xlo[ax] = F(lo, orgf)
                xhi[ax] = F(hi, orgf)
                edge[ax] = F(_upwind_edge(lo, hi, macF[ax].win(r)), orgf)

            rate = None
            for d in range(nd):
                stl, sth, r_face = self._final_states(
                    d, lambda ax: ax, xlo, xhi, edge, macF, qf, bc,
                    is_velocity, c, fF, dt, icons)
                stl, sth = self._face_bc(d, stl, sth, qf, bc(d),
                                         is_velocity, c, r_face)
                w = macF[d].win(r_face)
                qface = _upwind_edge(stl, sth, w)
                n = g.n_cell[d]
                dxi = 1.0 / g.dx[d]
                flo, fhi = qface.narrow(d, 0, n), qface.narrow(d, 1, n)
                wlo, whi = w.narrow(d, 0, n), w.narrow(d, 1, n)
                if icons:
                    term = dxi * (wlo * flo - whi * fhi)
                else:
                    term = 0.5 * dxi * (wlo + whi) * (flo - fhi)
                rate = term if rate is None else rate + term
            rates.append(rate)
        return torch.stack(rates, dim=-1)

    def _extend_mac(self, m: torch.Tensor, ax: int) -> F:
        """Extend a face array: own axis -> faces [-1, n+2) (wrap on a
        periodic axis with faces n-1 and 1, since faces 0 and n coincide;
        zero otherwise); transverse axes -> one ghost cell (wrap or
        zero)."""
        g = self.grid
        for a in range(self.nd):
            k = m.shape[a]
            if g.periodic[a]:
                if a == ax:
                    n = g.n_cell[ax]
                    lo, hi = m.narrow(a, n - 1, 1), m.narrow(a, 1, 1)
                else:
                    lo, hi = m.narrow(a, k - 1, 1), m.narrow(a, 0, 1)
            else:
                lo = hi = torch.zeros_like(m.narrow(a, 0, 1))
            m = torch.cat([lo, m, hi], dim=a)
        return F(m, (-1,) * self.nd)
