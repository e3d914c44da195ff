"""MAC projection: make the face advection velocities divergence-free
(port of incflo_tpu/ops/mac_projection.py; reference
src/convection/incflo_compute_MAC_projected_velocities.cpp:10-133):

    solve   div(beta grad phi) = div(u_mac),  beta = 1/rho on faces,
    then    u_mac -= beta grad phi.

The correction uses the same discrete fluxes as the operator
(multigrid.cell_fluxes), so div(u_mac) after projection equals the
solver residual.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from incflo_torch.bcs import BCKind
from incflo_torch.grid import Grid
from incflo_torch.ops import multigrid as mg
from incflo_torch.ops.stencil import window
from incflo_torch.parallel.mesh import mesh_of


def projection_solver_bc(bc_kind: np.ndarray, grid: Grid):
    """BC map for MAC/nodal projections (reference
    incflo_apply_nodal_projection.cpp:6-36): pressure_* -> Dirichlet,
    walls/mass inflow -> Neumann, periodic -> periodic."""
    lo, hi = [], []
    for ax in range(grid.ndim):
        for side, out in ((0, lo), (1, hi)):
            if grid.periodic[ax]:
                out.append(mg.SolverBC.PERIODIC)
                continue
            k = BCKind(int(bc_kind[ax, side]))
            if k in (BCKind.pressure_inflow, BCKind.pressure_outflow):
                out.append(mg.SolverBC.DIRICHLET)
            else:
                out.append(mg.SolverBC.NEUMANN)
    return lo, hi


def inv_rho_on_faces(rho_g1: torch.Tensor, grid: Grid) -> List[torch.Tensor]:
    """beta = 1/avg(rho) on all faces (n+1 per axis) from density grown
    by 1: average THEN invert (incflo_compute_advection_term.cpp:65-83)."""
    ndim = grid.ndim
    out = []
    for d in range(ndim):
        r = rho_g1
        for ax in range(ndim):
            if ax != d:
                r = window(r, ax, 1, 1)
        avg = 0.5 * (window(r, d, 0, 1) + window(r, d, 1, 0))
        out.append(1.0 / avg)
    return out


def mac_divergence(umac: Sequence[torch.Tensor], grid: Grid) -> torch.Tensor:
    out = None
    for d in range(grid.ndim):
        dxi = 1.0 / grid.dx[d]
        t = (window(umac[d], d, 1, 0) - window(umac[d], d, 0, 1)) * dxi
        out = t if out is None else out + t
    return out


def project_mac_velocities(umac: List[torch.Tensor],
                           beta: List[torch.Tensor], grid: Grid,
                           bc_kind: np.ndarray, phi0=None, rtol=1e-11,
                           atol=1e-14, maxiter=200, prebuilt_solver=None,
                           direct=True, eb=None, bc_override=None,
                           phi_bvals=None):
    """Returns (umac_projected, phi).  With a prebuilt solver (constant
    density) phi comes from it; otherwise a CellSolver is built from
    `beta` and, unless its coefficients are constant and `direct` lets
    it look, iterates from the warm start `phi0` to rtol/atol (on a
    rank's x slab, grid.mesh, by multigrid on the slab: beta then holds
    the slab's nxl + 1 x faces).

    With embedded boundaries (eb, eb/ops.EBArrays) the solve is
    div(ap beta grad phi) = div(ap u) and u -= beta grad phi on the open
    faces (incflo_tpu/ops/mac_projection.py:92-120, the MLEBABecLap
    MacProjector); a face whose area fraction is at most 1e-4 carries no
    velocity.

    bc_override ((axis, side) -> SolverBC) and phi_bvals ((axis, side) ->
    face values): the coarse-fine faces of an AMR patch take Dirichlet
    phi with the parent's interpolated values (incflo_tpu/ops/
    mac_projection.py:74-111); the correction then uses the
    inhomogeneous fluxes."""
    bc_lo, bc_hi = projection_solver_bc(bc_kind, grid)
    for (ax, side), bc in (bc_override or {}).items():
        (bc_lo if side == 0 else bc_hi)[ax] = bc
    # faces with a tiny area fraction carry negligible flux, but their
    # values feed the small-cell velocity fix: keep them at the no-slip
    # limit instead of flux/ap-amplified noise
    ap_small = 1e-4
    if eb is not None:
        umac = [torch.where(eb.afrac[d] > ap_small, umac[d], 0.0)
                for d in range(grid.ndim)]
        beta = [beta[d] * eb.afrac[d] for d in range(grid.ndim)]
    solver = prebuilt_solver if prebuilt_solver is not None else \
        mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=0.0, beta=1.0,
                      acoef=None, bcoef=beta, direct=direct,
                      mesh=mesh_of(grid))
    # L = -div(beta grad phi); solve L phi = -div(ap u)
    if eb is not None:
        rhs = -mac_divergence([eb.afrac[d] * umac[d]
                               for d in range(grid.ndim)], grid)
    else:
        rhs = -mac_divergence(umac, grid)
    if phi_bvals:
        phi = solver.solve_inhom(rhs, phi_bvals, x0=phi0, rtol=rtol,
                                 atol=atol, maxiter=maxiter)
        fluxes = mg.cell_fluxes_inhom(phi, solver.levels[0], phi_bvals)
    else:
        phi = solver.solve(rhs, x0=phi0, rtol=rtol, atol=atol,
                           maxiter=maxiter)
        fluxes = mg.cell_fluxes(phi, solver.levels[0])   # beta grad phi
    if eb is None:
        return [umac[d] - fluxes[d] for d in range(grid.ndim)], phi
    out = []
    for d in range(grid.ndim):
        ap = eb.afrac[d]
        corr = torch.where(ap > ap_small,
                           fluxes[d] / torch.clamp_min(ap, ap_small), 0.0)
        out.append(umac[d] - corr)
    return out, phi
