"""Method-of-lines advection: face prediction and upwind fluxes (port of
incflo_tpu/ops/mol.py; reference src/convection/incflo_mol_predict.cpp
and incflo_mol_fluxes.cpp) with AMReX's order-2 MC-limited slopes,
including the one-sided slope next to ext_dir / hoextrap boundaries
(where the boundary value lives on the face).

Conventions:
  * inputs are grown tensors carrying >= 2 ghost layers per axis
    (bcs.grow output); `ng` says how many.
  * face tensors along their normal axis have n+1 entries (periodic axes
    store the wrap face twice, entries 0 and n equal).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from incflo_torch.bcs import BCType, slab_bcrecs
from incflo_torch.grid import Grid
from incflo_torch.ops.stencil import mc_slope, mc_slope_extdir, window

SMALL_VEL = 1.0e-10   # reference MOL.H small_vel


def _slopes_1d(q_g, axis, grid: Grid, ng, bclo, bchi, lo_cells, hi_cells):
    """MC-limited slopes along `axis` for cells -lo_cells .. n+hi_cells-1;
    the other axes keep their extent."""
    n = grid.n_cell[axis]
    lo = ng - lo_cells
    hi_trim = ng - hi_cells
    qm = window(q_g, axis, lo - 1, hi_trim + 1)
    q = window(q_g, axis, lo, hi_trim)
    qp = window(q_g, axis, lo + 1, hi_trim - 1)
    extdir_lo = bclo in (BCType.ext_dir, BCType.hoextrap)
    extdir_hi = bchi in (BCType.ext_dir, BCType.hoextrap)
    if not (extdir_lo or extdir_hi) or grid.periodic[axis]:
        return mc_slope(qm, q, qp)
    # one-sided dc at the first/last interior cell next to an extdir face
    shape = [1] * q.dim()
    shape[axis] = q.shape[axis]
    gidx = (torch.arange(q.shape[axis], device=q.device)
            - lo_cells).reshape(shape)
    on_lo = (gidx == 0) & extdir_lo
    on_hi = (gidx == n - 1) & extdir_hi
    return mc_slope_extdir(qm, q, qp, on_lo, on_hi)


def _face_slab(a, axis, idx):
    return a.narrow(axis, 0 if idx == 0 else a.shape[axis] - 1, 1)


def _set_slab_face(a, axis, idx, val):
    out = a.clone()
    _face_slab(out, axis, idx).copy_(val)
    return out


def _face_states(q_g, d, grid: Grid, ng, bclo, bchi):
    """(q_mns, q_pls, slope-extrapolated minus and plus states) on the
    n+1 faces along d of a component already trimmed to the interior on
    the other axes."""
    slp = _slopes_1d(q_g, d, grid, ng, bclo, bchi, 1, 1)
    q = window(q_g, d, ng - 1, ng - 1)          # cells -1..n
    q_pls = window(q, d, 1, 0)
    q_mns = window(q, d, 0, 1)
    s_pls = window(slp, d, 1, 0)
    s_mns = window(slp, d, 0, 1)
    return q_mns, q_pls, q_mns + 0.5 * s_mns, q_pls - 0.5 * s_pls


def _interior_except(q, d, ndim, ng):
    for ax in range(ndim):
        if ax != d:
            q = window(q, ax, ng, ng)
    return q


def predict_vels_on_faces(vel_g: torch.Tensor, grid: Grid, ng: int,
                          bcrecs: np.ndarray) -> List[torch.Tensor]:
    """Upwind-select face-normal velocities from the grown cell velocity
    (reference incflo_mol_predict.cpp:91-351).  Returns [u_x, u_y(, u_z)],
    n+1 entries along the own axis, n on the others.  On a rank's x slab
    the x boundary forms act at the level's own x faces only
    (bcs.slab_bcrecs)."""
    ndim = grid.ndim
    bcrecs = slab_bcrecs(bcrecs, grid)
    out = []
    for d in range(ndim):
        q_g = _interior_except(vel_g[..., d], d, ndim, ng)
        bclo = BCType(int(bcrecs[d, d, 0]))
        bchi = BCType(int(bcrecs[d, d, 1]))
        q_mns, q_pls, umns, upls = _face_states(q_g, d, grid, ng, bclo, bchi)
        avg = 0.5 * (upls + umns)
        zero = torch.zeros_like(avg)
        sel = torch.where(avg >= SMALL_VEL, umns,
                          torch.where(avg <= -SMALL_VEL, upls, zero))
        u_val = torch.where((umns >= 0.0) | (upls <= 0.0), sel, zero)
        # ext_dir boundary faces take the ghost (boundary) value
        if not grid.periodic[d]:
            if bclo == BCType.ext_dir:
                u_val = _set_slab_face(u_val, d, 0, _face_slab(q_mns, d, 0))
            if bchi == BCType.ext_dir:
                u_val = _set_slab_face(u_val, d, -1,
                                       _face_slab(q_pls, d, -1))
        out.append(u_val)
    return out


def compute_convective_fluxes(q_g: torch.Tensor, umac: Sequence[torch.Tensor],
                              grid: Grid, ng: int, bcrecs: np.ndarray
                              ) -> List[torch.Tensor]:
    """Upwind fluxes f_d = q_face * umac_d of a (..., ncomp) grown state
    (reference incflo_mol_fluxes.cpp:23-227); on a slab as
    predict_vels_on_faces."""
    ndim = grid.ndim
    bcrecs = slab_bcrecs(bcrecs, grid)
    fluxes = []
    for d in range(ndim):
        comp_fluxes = []
        um = umac[d]
        for c in range(q_g.shape[-1]):
            qc = _interior_except(q_g[..., c], d, ndim, ng)
            bclo = BCType(int(bcrecs[c, d, 0]))
            bchi = BCType(int(bcrecs[c, d, 1]))
            q_mns, q_pls, qmns, qpls = _face_states(qc, d, grid, ng, bclo,
                                                    bchi)
            qs = torch.where(um > SMALL_VEL, qmns,
                             torch.where(um < -SMALL_VEL, qpls,
                                         0.5 * (qmns + qpls)))
            # ext_dir domain faces: the upstream state is the boundary value
            if not grid.periodic[d]:
                if bclo == BCType.ext_dir:
                    qs = _set_slab_face(qs, d, 0, _face_slab(q_mns, d, 0))
                if bchi == BCType.ext_dir:
                    qs = _set_slab_face(qs, d, -1, _face_slab(q_pls, d, -1))
            comp_fluxes.append(qs * um)
        fluxes.append(torch.stack(comp_fluxes, dim=-1))
    return fluxes


def convective_rate(fluxes: Sequence[torch.Tensor], grid: Grid
                    ) -> torch.Tensor:
    """dq/dt = sum_d (f_d(i) - f_d(i+1)) / dx_d  (= -div(umac q); reference
    mol::compute_convective_rate, incflo_compute_advection_term.cpp
    :360-381)."""
    out = None
    for d in range(grid.ndim):
        f = fluxes[d]
        t = (window(f, d, 0, 1) - window(f, d, 1, 0)) * (1.0 / grid.dx[d])
        out = t if out is None else out + t
    return out
