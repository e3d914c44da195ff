"""Centroid-aware MOL face prediction and upwind fluxes at cut cells
(port of incflo_tpu/eb/mol.py; reference
src/convection/incflo_mol_predict_eb.cpp:22-591 and
incflo_mol_fluxes_eb.cpp:28-612): the face-normal velocity and the
advected state extrapolated from the cell fluid centroid to the face
fluid centroid with least-squares slopes over the connected neighbours.

The normal matrix of each cell's least-squares fit is static geometry,
so its pseudo-inverse is precomputed on the host (eb.lsq_minv_g1,
packed symmetric) and a slope costs 3^d - 1 masked shifted reads and a
few multiply-adds.  The centroid-aware states replace the regular
MC-limited states (ops/mol.py) on faces within 2 cells of a non-regular
cell (eb.near_g1); domain-boundary faces keep the regular path's value.
Plain PyTorch on either device, as incflo_tpu runs it in jnp; on a
rank's x slab (eb/ops.slab_arrays) on the slab's ghost-filled windows.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from incflo_torch.eb.ops import EBArrays
from incflo_torch.grid import Grid
from incflo_torch.ops import mol
from incflo_torch.ops.mol import SMALL_VEL
from incflo_torch.ops.stencil import window


def _ext(a: torch.Tensor, ng_a: int, off, nd: int) -> torch.Tensor:
    """a(i+off) for i on the box grown by 1 (a carries ng_a ghosts)."""
    out = a
    for ax in range(nd):
        out = window(out, ax, ng_a - 1 + off[ax], ng_a - 1 - off[ax])
    return out


def lsq_slopes(q_g: torch.Tensor, grid: Grid, ng: int, eb: EBArrays
               ) -> torch.Tensor:
    """Least-squares slope vector of a grown scalar on the grown-by-1 box
    (reference amrex_calc_slopes_eb): minimises
    sum_connected (q(i+off) - q(i) - s . delta)^2 with
    delta = off + ccent(i+off) - ccent(i); exact for linear fields."""
    nd = grid.ndim
    zero = (0,) * nd
    q0 = _ext(q_g, ng, zero, nd)
    c0 = _ext(eb.ccent_g2, 2, zero, nd)
    b = [torch.zeros_like(q0) for _ in range(nd)]
    for m, off in zip(eb.conn_g1, eb.offsets):
        qn = _ext(q_g, ng, off, nd)
        cn = _ext(eb.ccent_g2, 2, off, nd)
        dq = m * (qn - q0)
        for a in range(nd):
            delta = off[a] + cn[..., a] - c0[..., a]
            b[a] = b[a] + delta * dq
    mi = eb.lsq_minv_g1
    if nd == 2:
        sx = mi[..., 0] * b[0] + mi[..., 1] * b[1]
        sy = mi[..., 1] * b[0] + mi[..., 2] * b[1]
        return torch.stack([sx, sy], dim=-1)
    sx = mi[..., 0] * b[0] + mi[..., 1] * b[1] + mi[..., 2] * b[2]
    sy = mi[..., 1] * b[0] + mi[..., 3] * b[1] + mi[..., 4] * b[2]
    sz = mi[..., 2] * b[0] + mi[..., 4] * b[1] + mi[..., 5] * b[2]
    return torch.stack([sx, sy, sz], dim=-1)


def _cell_window(axis: int, which: str, nd: int):
    """Trim a grown-by-1 array to the cells next to faces 0..n along
    `axis` ('pls': cells 0..n, 'mns': cells -1..n-1), interior on the
    other axes."""
    lo = 1 if which == "pls" else 0
    hi = 0 if which == "pls" else 1

    def t(a):
        out = a
        for ax in range(nd):
            out = window(out, ax, lo if ax == axis else 1,
                         hi if ax == axis else 1)
        return out
    return t


def face_states(qc_g: torch.Tensor, slopes: torch.Tensor, axis: int,
                grid: Grid, ng: int, eb: EBArrays):
    """(q_pls, q_mns, qcc_pls, qcc_mns) on the faces 0..n along `axis`:
    the adjacent cells' values extrapolated from the cell fluid centroid
    to the face fluid centroid, and the cell values themselves."""
    nd = grid.ndim
    zero = (0,) * nd
    q0 = _ext(qc_g, ng, zero, nd)
    c0 = _ext(eb.ccent_g2, 2, zero, nd)
    fc = eb.face_cent[axis]

    def extrap(which, fpos_axis):
        t = _cell_window(axis, which, nd)
        q, c, s = t(q0), t(c0), t(slopes)
        val = q
        for a in range(nd):
            fpos = fpos_axis if a == axis else fc[..., a]
            val = val + s[..., a] * (fpos - c[..., a])
        return val, q

    qpls, qcc_pls = extrap("pls", -0.5)
    qmns, qcc_mns = extrap("mns", +0.5)
    return qpls, qmns, qcc_pls, qcc_mns


def _near_face(eb: EBArrays, axis: int, nd: int) -> torch.Tensor:
    tp = _cell_window(axis, "pls", nd)
    tm = _cell_window(axis, "mns", nd)
    return (tp(eb.near_g1) > 0.5) | (tm(eb.near_g1) > 0.5)


def _keep_domain_faces(u: torch.Tensor, u_reg: torch.Tensor, axis: int,
                       grid: Grid) -> torch.Tensor:
    """Domain-boundary faces take the regular path's value (which carries
    the ext_dir and outflow forms): the level's own faces (Grid.edge),
    not the x faces a rank's slab shares with its neighbours."""
    if grid.periodic[axis]:
        return u
    u = u.clone()
    n = u.shape[axis]
    for side, i in ((0, 0), (1, n - 1)):
        if grid.edge(axis, side):
            u.narrow(axis, i, 1).copy_(u_reg.narrow(axis, i, 1))
    return u


def predict_vels_on_faces_eb(vel_g: torch.Tensor, grid: Grid, ng: int,
                             bcrecs: np.ndarray, eb: EBArrays
                             ) -> List[torch.Tensor]:
    """EB form of mol.predict_vels_on_faces (reference
    incflo_mol_predict_eb.cpp): centroid-extrapolated upwind face-normal
    velocities near the EB, the regular MC-limited states elsewhere."""
    nd = grid.ndim
    reg = mol.predict_vels_on_faces(vel_g, grid, ng, bcrecs)
    out = []
    for d in range(nd):
        slp = lsq_slopes(vel_g[..., d], grid, ng, eb)
        qpls, qmns, qp_cc, qm_cc = face_states(vel_g[..., d], slp, d,
                                               grid, ng, eb)
        cc_max = torch.maximum(qp_cc, qm_cc)
        cc_min = torch.minimum(qp_cc, qm_cc)
        upls = torch.clamp(qpls, cc_min, cc_max)
        umns = torch.clamp(qmns, cc_min, cc_max)
        avg = 0.5 * (upls + umns)
        zero = torch.zeros_like(avg)
        sel = torch.where(avg >= SMALL_VEL, umns,
                          torch.where(avg <= -SMALL_VEL, upls, zero))
        u_val = torch.where((umns >= 0.0) | (upls <= 0.0), sel, zero)
        u_val = torch.where(eb.afrac[d] > 0.0, u_val, zero)
        u = torch.where(_near_face(eb, d, nd), u_val, reg[d])
        out.append(_keep_domain_faces(u, reg[d], d, grid))
    return out


def compute_convective_fluxes_eb(q_g: torch.Tensor,
                                 umac: Sequence[torch.Tensor], grid: Grid,
                                 ng: int, bcrecs: np.ndarray, eb: EBArrays
                                 ) -> List[torch.Tensor]:
    """EB form of mol.compute_convective_fluxes (reference
    incflo_mol_fluxes_eb.cpp): the advected state interpolated to the
    face fluid centroid, upwinded by umac; 0.5 (mns + pls) at
    stagnation."""
    nd = grid.ndim
    ncomp = q_g.shape[-1]
    reg = mol.compute_convective_fluxes(q_g, umac, grid, ng, bcrecs)
    slopes = [lsq_slopes(q_g[..., c], grid, ng, eb) for c in range(ncomp)]
    fluxes = []
    for d in range(nd):
        near = _near_face(eb, d, nd)
        um = umac[d]
        comp_fluxes = []
        for c in range(ncomp):
            qpls, qmns, _, _ = face_states(q_g[..., c], slopes[c], d,
                                           grid, ng, eb)
            qs = torch.where(um > SMALL_VEL, qmns,
                             torch.where(um < -SMALL_VEL, qpls,
                                         0.5 * (qmns + qpls)))
            f_eb = torch.where(eb.afrac[d] > 0.0, qs * um, 0.0)
            f = torch.where(near, f_eb, reg[d][..., c])
            comp_fluxes.append(_keep_domain_faces(f, reg[d][..., c], d,
                                                  grid))
        fluxes.append(torch.stack(comp_fluxes, dim=-1))
    return fluxes
