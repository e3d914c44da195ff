"""Viscous terms: explicit divtau and the implicit tensor velocity solve
(port of the parts of incflo_tpu/ops/diffusion.py that steps without
embedded boundaries run -- explicit, Crank-Nicolson and implicit,
Newtonian or not; reference DiffusionTensorOp, src/diffusion/*.cpp):

  eta_to_faces     : eta grown by 1 -> face averages
  compute_divtau   : div(tau)/rho, tau = eta(grad u + grad u^T) (tensor)
                     or eta grad u (scalar mode)
  compute_laps     : div(mu_s grad s) per tracer
  diffuse_velocity : (rho - dt div(eta (grad + grad^T))) u = rho u*.
                     Where every component has the same solver BCs
                     (periodic boxes, no-slip walls, inflow/outflow):
                     the batched branch (the prebuilt constant-
                     coefficient solver of a Newtonian fluid, or one
                     built from the current rho and eta: variable density
                     or a non-Newtonian viscosity) and the tensor CG on
                     the cross coupling, adaptive or with a fixed number
                     of masked trips (the fused 2D step's form).  Where
                     they differ (a slip wall: Dirichlet for the normal
                     component, Neumann for the tangential ones): one
                     scalar solve per component.
  diffuse_scalar   : (rho - dt div(mu_s grad)) s = rho s* per tracer.

Dirichlet sides: no-slip walls and mass inflow for the velocity (the
inflow profile in velocity_bvals), a slip wall for its normal component,
mass inflow for tracers; Neumann: pressure inflow and outflow.  Explicit
diffusion uses compute_divtau and compute_laps alone and calls no solve.

On an x slab of a mesh (grid.mesh, parallel/mesh.py) the operators pad
x from the neighbouring ranks and the CG's dots and norms are global, so
each loop test decides on the whole level's residual.

The EB forms (ROADMAP A11) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from incflo_torch.bcs import BCKind
from incflo_torch.config import IncfloConfig
from incflo_torch.grid import Grid
from incflo_torch.ops import multigrid as mg
from incflo_torch.ops import spectral
from incflo_torch.ops.stencil import window
from incflo_torch.parallel.mesh import mesh_of


# ---------------------------------------------------------------------
# BC maps
# ---------------------------------------------------------------------

def velocity_solver_bc(cfg: IncfloConfig, comp: int):
    lo, hi = [], []
    for ax in range(cfg.ndim):
        for side, out in ((0, lo), (1, hi)):
            if cfg.grid.periodic[ax]:
                out.append(mg.SolverBC.PERIODIC)
                continue
            k = BCKind(int(cfg.bc_kind[ax, side]))
            if k in (BCKind.mass_inflow, BCKind.no_slip_wall):
                out.append(mg.SolverBC.DIRICHLET)
            elif k == BCKind.slip_wall:
                out.append(mg.SolverBC.DIRICHLET if comp == ax
                           else mg.SolverBC.NEUMANN)
            else:   # pressure in/out
                out.append(mg.SolverBC.NEUMANN)
    return lo, hi


def scalar_solver_bc(cfg: IncfloConfig):
    lo, hi = [], []
    for ax in range(cfg.ndim):
        for side, out in ((0, lo), (1, hi)):
            if cfg.grid.periodic[ax]:
                out.append(mg.SolverBC.PERIODIC)
                continue
            k = BCKind(int(cfg.bc_kind[ax, side]))
            out.append(mg.SolverBC.DIRICHLET if k == BCKind.mass_inflow
                       else mg.SolverBC.NEUMANN)
    return lo, hi


def velocity_bvals(cfg: IncfloConfig, comp: int, dtype,
                   device=None) -> Dict:
    """Dirichlet face values for velocity component `comp`, including the
    probtype inflow profiles (slabs built with the padding the solver's
    ghost fill has when it reaches each face axis)."""
    ev = cfg.velocity_ext_values()
    out = {}
    for ax in range(cfg.ndim):
        if cfg.grid.periodic[ax]:
            continue
        for side in range(2):
            pads = [1 if a < ax else 0 for a in range(cfg.ndim)]
            val = ev.slab(ax, side, comp, pads, dtype, device=device)
            if val.dim() > cfg.ndim:   # drop the component axis
                val = val[..., 0]
            out[(ax, side)] = val
    return out


def tracer_bvals(cfg: IncfloConfig, comp: int, dtype, device=None) -> Dict:
    out = {}
    for ax in range(cfg.ndim):
        if cfg.grid.periodic[ax]:
            continue
        for side in range(2):
            out[(ax, side)] = torch.tensor(
                float(cfg.bc_tracer[ax, side, comp]), dtype=dtype,
                device=device)
    return out


# ---------------------------------------------------------------------
# eta cell -> face averaging (reference average_velocity_eta_to_faces,
# incflo_diffusion.cpp:235-359)
# ---------------------------------------------------------------------

def _face_slab(a, axis, idx):
    n = a.shape[axis]
    return a.narrow(axis, 0 if idx == 0 else n - 1, 1)


def _set_face(a, axis, idx, val):
    out = a.clone()
    n = out.shape[axis]
    out.narrow(axis, 0 if idx == 0 else n - 1, 1).copy_(val)
    return out


def eta_to_faces(eta_g1: torch.Tensor, grid: Grid) -> List[torch.Tensor]:
    """eta grown by 1 -> arithmetic average on all faces; on non-periodic
    domain faces copy the adjacent interior cell value (the reference's
    fixup_eta_on_domain_faces)."""
    nd = grid.ndim
    out = []
    for d in range(nd):
        face_g = 0.5 * (window(eta_g1, d, 0, 1) + window(eta_g1, d, 1, 0))
        t_axes = [a for a in range(nd) if a != d]

        def tint(a):
            for ax in t_axes:
                a = window(a, ax, 1, 1)
            return a

        face = tint(face_g)
        if not grid.periodic[d]:
            cells = tint(window(eta_g1, d, 1, 1))
            face = _set_face(face, d, 0, _face_slab(cells, d, 0))
            face = _set_face(face, d, -1, _face_slab(cells, d, -1))
        out.append(face)
    return out


# ---------------------------------------------------------------------
# explicit applies
# ---------------------------------------------------------------------

def compute_laps(tracer: torch.Tensor, eta_faces_per_comp,
                 cfg: IncfloConfig, grid: Grid) -> torch.Tensor:
    """div(mu_s grad s) per tracer component (inhomogeneous BCs)."""
    bc_lo, bc_hi = scalar_solver_bc(cfg)
    out = []
    for n in range(tracer.shape[-1]):
        lev = mg.CellLevel(grid.dx, tuple(bc_lo), tuple(bc_hi),
                           alpha=0.0, beta=1.0, acoef=None,
                           bcoef=tuple(eta_faces_per_comp[n]),
                           mesh=mesh_of(grid))
        # L = -div(mu grad); laps = -L
        out.append(-mg.cell_apply_inhom(
            tracer[..., n], lev,
            tracer_bvals(cfg, n, tracer.dtype, tracer.device)))
    return torch.stack(out, dim=-1)


def compute_divtau(vel: torch.Tensor, vel_g: torch.Tensor,
                   rho: torch.Tensor, eta_faces, eta_g1: torch.Tensor,
                   cfg: IncfloConfig, grid: Grid, ng: int) -> torch.Tensor:
    """divtau = div(tau) / rho.  The scalar part div(eta grad u_c) uses
    the operator-consistent fluxes with the physical Dirichlet values;
    in tensor mode the transpose term is added from the grown velocity
    (reference DiffusionTensorOp::compute_divtau)."""
    if cfg.use_tensor_correction:
        return _transpose_term(vel_g, eta_g1, grid, ng) / rho[..., None]
    parts = []
    for c in range(grid.ndim):
        bc_lo, bc_hi = velocity_solver_bc(cfg, c)
        lev = mg.CellLevel(grid.dx, tuple(bc_lo), tuple(bc_hi),
                           alpha=0.0, beta=1.0, acoef=None,
                           bcoef=tuple(eta_faces), mesh=mesh_of(grid))
        lap = -mg.cell_apply_inhom(vel[..., c], lev,
                                   velocity_bvals(cfg, c, vel.dtype,
                                                  vel.device))
        parts.append(lap)
    divtau = torch.stack(parts, dim=-1)
    if cfg.use_tensor_solve:
        divtau = divtau + _transpose_term(vel_g, eta_g1, grid, ng)
    return divtau / rho[..., None]


def _transpose_term(vel_g: torch.Tensor, eta_g1: torch.Tensor, grid: Grid,
                    ng: int, cross_only: bool = False) -> torch.Tensor:
    """sum_d d/dx_d [ eta * d u_d / dx_c ] for each component c.  Fluxes
    on d-faces: for c == d the compact face difference, for c != d the
    average of cell-centred central derivatives.  cross_only skips the
    c == d (diagonal-doubling) part."""
    ndim = grid.ndim
    out = [0.0] * ndim
    for d in range(ndim):   # face direction / flux axis
        e = eta_g1
        for ax in range(ndim):
            if ax != d:
                e = window(e, ax, 1, 1)
        eta_f = 0.5 * (window(e, d, 0, 1) + window(e, d, 1, 0))
        for c in range(ndim):   # component receiving the flux divergence
            if c == d:
                if cross_only:
                    continue
                u = vel_g[..., d]
                for ax in range(ndim):
                    if ax != d:
                        u = window(u, ax, ng, ng)
                u = window(u, d, ng - 1, ng - 1)
                dudx = (window(u, d, 1, 0) - window(u, d, 0, 1)) / grid.dx[d]
            else:
                u = vel_g[..., d]
                g = 0.5 * (window(u, c, 2, 0) - window(u, c, 0, 2)) / grid.dx[c]
                for ax in range(ndim):
                    if ax == c:
                        t = (ng - 1) - (1 if ax == d else 0)
                    else:
                        t = ng - (1 if ax == d else 0)
                    g = window(g, ax, t, t)
                dudx = 0.5 * (window(g, d, 0, 1) + window(g, d, 1, 0))
            flux = eta_f * dudx
            div = (window(flux, d, 1, 0) - window(flux, d, 0, 1)) / grid.dx[d]
            out[c] = out[c] + div
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------
# implicit solves
# ---------------------------------------------------------------------

def _dot(a, b, mesh=None):
    d = torch.sum(a * b)
    return d if mesh is None else mesh.all_reduce_sum(d)


def _tensor_pcg(x0, rhs, bvals, solver, dt_diff, eta_g1, grid, ng,
                grow_fn, grow_hom_fn, tol, maxiter, with_res=False,
                fixed_trips=None):
    """CG on the full coupled tensor Helmholtz operator

        A(u) = aniso_helmholtz(u) - dt * cross_transpose(u)

    preconditioned by the EXACT inverse of the anisotropic part where it
    has a fast-diagonalization symbol (constant coefficients), else by
    the anisotropic solver's V-cycle.  Residuals use the inhomogeneous ghost
    fill (grow_fn), Krylov directions the homogeneous one (grow_hom_fn),
    which keeps A linear.  Adaptive loop of incflo_tpu/ops/diffusion.py
    :670-704: stop when the best residual is under tol, after maxiter,
    or after 5 non-improving iterations.  Each loop test reads one bool
    back to the host.

    fixed_trips = k runs instead exactly k masked trips of the same
    iteration and reads nothing back (the kernel-mode form of
    incflo_tpu/ops/diffusion.py:627-667): a trip changes the state only
    while the best residual is above tol and fewer than 5 trips in a row
    failed to improve it, so a converged solve stops changing."""
    lev0 = solver.levels[0]
    ndim = grid.ndim
    mesh = mesh_of(grid)

    def _cross(ug):
        return _transpose_term(ug, eta_g1, grid, ng, cross_only=True)

    def A_lin(p):
        return mg.cell_apply(p, lev0) - dt_diff * _cross(grow_hom_fn(p))

    def residual(u):
        return (rhs + dt_diff * _cross(grow_fn(u))
                - mg.cell_apply_inhom(u, lev0, bvals))

    sym = solver.symbol
    direct = (sym is not None and sym.fwd is not None
              and tuple(rhs.shape[:ndim]) == sym.cells
              and (rhs.dim() > ndim or not sym.batched))

    def prec(r):
        if direct:
            return spectral.solve(sym, r, lev0.alpha, lev0.beta, False)
        return solver._vcycle(torch.zeros_like(r), r)[0]

    def dot(a, b):
        return _dot(a, b, mesh)

    def norm(r):
        return mg._maxnorm(r, mesh)

    r0 = residual(x0)
    res0 = norm(r0)
    if fixed_trips is not None:
        xb, rb = _fixed_trip_cg(x0, r0, res0, tol, A_lin, prec, fixed_trips)
        return (xb, rb) if with_res else xb
    if not mg.host_bool(res0 > tol):
        return (x0, res0) if with_res else x0
    x, r = x0, r0
    p = prec(r0)
    rz = dot(r0, p)
    xb, rb = x0, res0
    bad = torch.zeros((), dtype=torch.int32, device=x0.device)
    it = 0
    while it < maxiter and mg.host_bool((rb > tol) & (bad < 5)):
        Ap = A_lin(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        new_res = norm(r)
        improved = new_res < 0.999 * rb
        xb = torch.where(improved, x, xb)
        rb = torch.minimum(rb, new_res)
        bad = torch.where(improved, 0, bad + 1)
        it += 1
    mg.COUNTS["tensor_cg_iters"] += it
    return (xb, rb) if with_res else xb


def _fixed_trip_cg(x0, r0, res0, tol, A_lin, prec, trips):
    """(best iterate, best residual) of `trips` masked CG trips."""
    x, r, p = x0, r0, prec(r0)
    rz = _dot(r0, p)
    xb, rb = x0, res0
    bad = torch.zeros((), dtype=torch.int32, device=x0.device)
    for _ in range(trips):
        live = (rb > tol) & (bad < 5)
        Ap = A_lin(p)
        denom = _dot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        xn = x + alpha * p
        rn = r - alpha * Ap
        z = prec(rn)
        rzn = _dot(rn, z)
        beta = rzn / torch.where(rz == 0, 1.0, rz)
        pn = z + beta * p
        new_res = mg._maxnorm(rn)
        improved = new_res < 0.999 * rb
        xb = torch.where(live & improved, xn, xb)
        x = torch.where(live, xn, x)
        r = torch.where(live, rn, r)
        p = torch.where(live, pn, p)
        rz = torch.where(live, rzn, rz)
        rb = torch.where(live, torch.minimum(rb, new_res), rb)
        bad = torch.where(live, torch.where(improved, 0, bad + 1), bad)
    return xb, rb


def diffuse_velocity(vel: torch.Tensor, rho: torch.Tensor, eta_faces,
                     dt_diff, cfg: IncfloConfig, grid: Grid,
                     eta_g1=None, grow_fn=None, ng=None, grow_hom_fn=None,
                     prebuilt_solver=None, return_tensor_res=False,
                     direct=True, fixed_trips=None):
    """(rho - dt div(eta (grad + grad^T))) u = rho u*  (reference
    DiffusionTensorOp::diffuse_velocity).  Where every component has the
    same solver BCs the components are one batched solve; the diagonal
    part of the transpose term (the 2*eta doubling of each component's
    own-axis flux) is folded into an anisotropic coefficient, and the
    remaining cross coupling is converged by the tensor CG, whose
    Krylov directions take the homogeneous ghost fill grow_hom_fn.
    Without a prebuilt solver one is built from rho and eta_faces
    (`direct` as for mg.CellSolver) and iterates from the warm start
    `vel` after 4 fine-level sweeps: at CFL-limited dt the operator is
    diagonally dominant and those often reach the tolerance alone.
    fixed_trips as for _tensor_pcg.

    Where the components' BCs differ (slip walls) each component is a
    scalar solve of (rho - dt div(eta grad)) with its own BCs, and no
    tensor CG runs, as in incflo_tpu/ops/diffusion.py:844-866;
    return_tensor_res then gives (0, inf), which says that no CG ran,
    not that one converged."""
    dtype = vel.dtype
    acoef = rho
    bcs_all = [velocity_solver_bc(cfg, c) for c in range(grid.ndim)]
    if not all(b == bcs_all[0] for b in bcs_all):
        comps = []
        for c in range(grid.ndim):
            bc_lo, bc_hi = bcs_all[c]
            solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=1.0,
                                   beta=dt_diff, acoef=acoef,
                                   bcoef=tuple(eta_faces), direct=direct)
            comps.append(solver.solve_inhom(
                acoef * vel[..., c],
                velocity_bvals(cfg, c, dtype, vel.device), x0=vel[..., c],
                rtol=cfg.tensor_mg_rtol, atol=cfg.tensor_mg_atol,
                maxiter=cfg.tensor_mg_maxiter, presmooth=4))
        out = torch.stack(comps, dim=-1)
        if return_tensor_res:
            z = torch.zeros((), dtype=dtype, device=vel.device)
            return out, z, torch.full((), float("inf"), dtype=dtype,
                                      device=vel.device)
        return out
    tensor = (cfg.use_tensor_solve and grow_fn is not None
              and eta_g1 is not None)
    if prebuilt_solver is not None:
        solver = prebuilt_solver.with_beta(dt_diff)
    else:
        eta_b = []
        for d in range(grid.ndim):
            scale_np = np.ones((grid.ndim,), np.float64)
            if tensor:
                scale_np[d] = 2.0
            eta_b.append(eta_faces[d][..., None]
                         * torch.as_tensor(scale_np, dtype=dtype,
                                           device=vel.device))
        bc_lo, bc_hi = bcs_all[0]
        solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=1.0,
                               beta=dt_diff, acoef=acoef[..., None],
                               bcoef=tuple(eta_b), direct=direct)
    bvals = {}
    for ax in range(cfg.ndim):
        if grid.periodic[ax]:
            continue
        for side in range(2):
            vals = [velocity_bvals(cfg, c, dtype, vel.device)[(ax, side)]
                    for c in range(grid.ndim)]
            vals = torch.broadcast_tensors(*vals)
            bvals[(ax, side)] = torch.stack(vals, dim=-1)
    rhs = acoef[..., None] * vel
    out = solver.solve_inhom(rhs, bvals, x0=vel, rtol=cfg.tensor_mg_rtol,
                             atol=cfg.tensor_mg_atol,
                             maxiter=cfg.tensor_mg_maxiter, presmooth=4)
    if tensor:
        cg_tol = torch.clamp_min(
            cfg.tensor_mg_rtol * mg._maxnorm(rhs, mesh_of(grid)),
            cfg.tensor_mg_atol)
        out = _tensor_pcg(out, rhs, bvals, solver, dt_diff, eta_g1, grid,
                          ng, grow_fn, grow_hom_fn, tol=cg_tol,
                          maxiter=cfg.tensor_mg_maxiter,
                          with_res=return_tensor_res,
                          fixed_trips=fixed_trips)
        if return_tensor_res:
            out, cg_res = out
            return out, cg_res, cg_tol
    if return_tensor_res:
        z = torch.zeros((), dtype=dtype, device=vel.device)
        return out, z, torch.full((), float("inf"), dtype=dtype,
                                  device=vel.device)
    return out


def diffuse_scalar(tracer: torch.Tensor, rho: torch.Tensor,
                   eta_faces_per_comp, dt_diff, cfg: IncfloConfig,
                   grid: Grid) -> torch.Tensor:
    """(rho - dt div(mu_s grad)) s = rho s* per tracer, from the warm
    start s* after 4 fine-level sweeps.  The solver is built from the
    step's rho and never looks for a direct solve (as incflo_tpu's,
    built inside a trace)."""
    bc_lo, bc_hi = scalar_solver_bc(cfg)
    comps = []
    for n in range(tracer.shape[-1]):
        solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=1.0,
                               beta=dt_diff, acoef=rho,
                               bcoef=tuple(eta_faces_per_comp[n]),
                               direct=False)
        comps.append(solver.solve_inhom(
            rho * tracer[..., n],
            tracer_bvals(cfg, n, tracer.dtype, tracer.device),
            x0=tracer[..., n], rtol=cfg.diff_mg_rtol, atol=cfg.diff_mg_atol,
            maxiter=cfg.diff_mg_maxiter, presmooth=4))
    return torch.stack(comps, dim=-1)
