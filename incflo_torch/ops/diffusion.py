"""Viscous terms: explicit divtau and the implicit tensor velocity solve
(port of incflo_tpu/ops/diffusion.py -- explicit, Crank-Nicolson and
implicit, Newtonian or not, with or without embedded boundaries;
reference DiffusionTensorOp, src/diffusion/*.cpp):

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
x from the neighbouring ranks, and with the level's boundary pads and
face fixups at its own x faces (the end ranks of a level whose x ends in
walls, inflow or outflow), and the CG's dots and norms are global, so
each loop test decides on the whole level's residual.

Embedded boundaries (eb, an eb/ops.EBArrays; incflo_tpu/ops/diffusion.py
:109-430): face coefficients weighted by the area fractions and
interpolated to the face fluid centroids, the no-slip EB wall as the
coefficient ebc of the velocity operator (L += beta*ebc*u, eta A/(V d)
with d the centroid-to-wall distance), rows weighted by vfrac, and with
eb_wall_order = 2 one deferred-correction re-solve that upgrades the wall
flux, the cut-face gradients and the cut-cell state to second order.
Scalars see the EB as a no-flux wall.  incflo_tpu's opt-in switches of
this code (INCFLO_EB_JC, INCFLO_EB_CENTROID_STATE) keep their defaults
here: the wall-probe correction off, the centroid-state correction on.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from incflo_torch.bcs import BCKind
from incflo_torch.config import IncfloConfig
from incflo_torch.grid import Grid
from incflo_torch.ops import multigrid as mg
from incflo_torch.ops import spectral
from incflo_torch.ops.stencil import inner, window
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
                   device=None, grid=None) -> Dict:
    """Dirichlet face values for velocity component `comp`, including the
    probtype inflow profiles (slabs built with the padding the solver's
    ghost fill has when it reaches each face axis) over `grid` (a rank's
    x slab on a mesh; else the deck's level)."""
    ev = cfg.velocity_ext_values(grid)
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


def _centroid_interp(a, fc, d, nd, comp_axis=False):
    """Bilinear interpolation of a d-face array `a` that carries one
    transverse ghost to the face fluid centroids `fc` (offsets in dx
    units): each transverse axis picks the neighbour toward the sign of
    its offset, weighted |c|, and the face itself, weighted 1 - |c|
    (EB_interp_CellCentroid_to_FaceCentroid).  comp_axis: `a` has a
    trailing component axis that fc does not."""
    t_axes = [ax for ax in range(nd) if ax != d]

    def fshift(sgns):
        out = a
        for ax in t_axes:
            s = sgns.get(ax, 0)
            out = window(out, ax, 1 + s, 1 - s)
        return out

    def cw(w):
        return w[..., None] if comp_axis else w

    a0 = fshift({})
    wshape = a0.shape[:-1] if comp_axis else a0.shape
    out = torch.zeros_like(a0)
    for picks in itertools.product((0, 1), repeat=len(t_axes)):
        wgt = torch.ones(wshape, dtype=a0.dtype, device=a0.device)
        chosen = [ax for ax, p in zip(t_axes, picks) if p]
        for ax, p in zip(t_axes, picks):
            c = fc[..., ax]
            wgt = wgt * (c.abs() if p else 1.0 - c.abs())
        if chosen:
            term = torch.zeros_like(a0)
            for sgns in itertools.product((-1, 1), repeat=len(chosen)):
                sel = torch.ones(wshape, dtype=torch.bool, device=a0.device)
                for ax, sg in zip(chosen, sgns):
                    c = fc[..., ax]
                    sel = sel & ((c > 0) if sg > 0 else (c <= 0))
                term = torch.where(cw(sel), fshift(dict(zip(chosen, sgns))),
                                   term)
        else:
            term = a0
        out = out + cw(wgt) * term
    return out


def eta_to_faces(eta_g1: torch.Tensor, grid: Grid,
                 eb=None) -> List[torch.Tensor]:
    """eta grown by 1 -> arithmetic average on all faces; on non-periodic
    domain faces copy the adjacent interior cell value (the reference's
    fixup_eta_on_domain_faces).  With embedded boundaries the face value
    is interpolated to the face fluid centroid (_centroid_interp; the
    reference's average_velocity_eta_to_faces, incflo_diffusion.cpp
    :235-283)."""
    nd = grid.ndim
    out = []
    for d in range(nd):
        face_g = 0.5 * (window(eta_g1, d, 0, 1) + window(eta_g1, d, 1, 0))
        t_axes = [a for a in range(nd) if a != d]

        def tint(a):
            for ax in t_axes:
                a = window(a, ax, 1, 1)
            return a

        if eb is not None and eb.face_cent:
            face = _centroid_interp(face_g, eb.face_cent[d], d, nd)
        else:
            face = tint(face_g)
        if not grid.periodic[d]:     # the level's own faces (Grid.edge)
            cells = tint(window(eta_g1, d, 1, 1))
            if grid.edge(d, 0):
                face = _set_face(face, d, 0, _face_slab(cells, d, 0))
            if grid.edge(d, 1):
                face = _set_face(face, d, -1, _face_slab(cells, d, -1))
        out.append(face)
    return out


# ---------------------------------------------------------------------
# embedded-boundary terms
# ---------------------------------------------------------------------

def _eb_faces(eta_faces, eb):
    if eb is None:
        return eta_faces
    return [eta_faces[d] * eb.afrac[d] for d in range(len(eta_faces))]


def _vfrac_or_one(eb):
    """vfrac, with 1 in covered cells (the row weight of a cut cell)."""
    return torch.where(eb.covered > 0.5, 1.0, eb.vfrac)


def _eb_wall_coef(eta_cell, grid, eb):
    """The EB no-slip wall coefficient (a diagonal term): flux/V =
    eta (A_eb/V) (0 - u_c)/d with d the centroid-to-wall distance along
    the EB normal, clamped below at 0.05 h (reference MLEBTensorOp's
    EB-Dirichlet stencil, DiffusionTensorOp.cpp:32-43); the flat
    first-order d = dx/2 where the geometry has no wall distances."""
    if eb.wall_dist is None or eb.area_ov is None:
        dx2 = sum(1.0 / (d * d) for d in grid.dx) / grid.ndim
        return 2.0 * eta_cell * eb.eb_area * dx2
    h = sum(grid.dx) / grid.ndim
    d = torch.clamp_min(eb.wall_dist, 0.05 * h)
    return eta_cell * eb.area_ov / d * eb.cut


def _eb_wall_correction(u_g, eta_cell, ebc, grid, eb, ng):
    """The second-order EB wall-flux deferred correction per unit volume:
    the true row eta A/V (2 u/d - n.grad u) against the implicit drag
    ebc u, evaluated on the previous iterate,
    eta A/V (n.grad u) - ebc u (incflo_tpu/ops/diffusion.py:220-266 with
    INCFLO_EB_JC off)."""
    from incflo_torch.eb.ops import eb_cc_derivative
    nd = grid.ndim
    aov = eta_cell * eb.area_ov
    out = []
    for c in range(u_g.shape[-1]):
        dudn = 0.0
        for ax in range(nd):
            dudn = dudn + eb.eb_normal[..., ax] * eb_cc_derivative(
                u_g, c, ax, grid, ng, eb)
        u_c = u_g[(slice(ng, -ng),) * nd + (c,)]
        out.append(aov * dudn - ebc * u_c)
    return torch.stack(out, dim=-1) * eb.cut[..., None]


def _probe_interp(u, eb, grid, k):
    """Read of the cell-centred u (trailing component axis) at wall probe
    k: the multilinear corner gather minus its interpolation error
    1/2 sum_d f(1-f) h^2 u''_dd (exact for quadratics).  The probe form
    of the wall gradient that incflo_tpu switches on with INCFLO_EB_JC
    (diffusion.py:269-306); the step here keeps that switch off."""
    nd = grid.ndim
    lo = eb.probe_lo[..., k, :].long()
    fr = eb.probe_frac[..., k, :]

    def wrap(c, d):
        n = grid.n_cell[d]
        return torch.remainder(c, n) if grid.periodic[d] \
            else torch.clamp(c, 0, n - 1)

    out = 0.0
    for corner in itertools.product((0, 1), repeat=nd):
        idx, w = [], 1.0
        for d in range(nd):
            idx.append(wrap(lo[..., d] + corner[d], d))
            w = w * (fr[..., d] if corner[d] else 1.0 - fr[..., d])
        out = out + w[..., None] * u[tuple(idx)]
    if eb.probe_nn is not None:
        nn = eb.probe_nn[..., k, :].long()
        nn_idx = [wrap(nn[..., d], d) for d in range(nd)]
        u_nn = u[tuple(nn_idx)]
        corr = 0.0
        for d in range(nd):
            up, dn = list(nn_idx), list(nn_idx)
            up[d] = wrap(nn[..., d] + 1, d)
            dn[d] = wrap(nn[..., d] - 1, d)
            d2 = u[tuple(up)] - 2.0 * u_nn + u[tuple(dn)]
            f = fr[..., d]
            corr = corr + (0.5 * f * (1.0 - f))[..., None] * d2
        out = out - eb.probe_c2ok[..., k, None] * corr
    return out


def _eb_centroid_state_correction(u_g, bcoefs, grid, eb, ng):
    """Deferred correction for the centroid-valued cut-cell state: the
    stored cut-cell unknown is the fluid average (the centroid value),
    the face fluxes assume centre values, so div(b grad delta) with
    delta = -sum_d c_d dx_d du/dx_d in cut cells goes to the rhs
    (incflo_tpu/ops/diffusion.py:309-364)."""
    from incflo_torch.eb.ops import eb_cc_derivative
    nd = grid.ndim
    if eb.ccent_g2 is None:
        return None
    cent = eb.ccent_g2[(slice(2, -2),) * nd]
    cols = []
    for c in range(u_g.shape[-1]):
        acc = 0.0
        for ax in range(nd):
            g = eb_cc_derivative(u_g, c, ax, grid, ng, eb)
            acc = acc - cent[..., ax] * grid.dx[ax] * g
        cols.append(acc * eb.cut)
    dp = torch.stack(cols, dim=-1)
    # one ghost for the flux divergence: periodic wrap, else edge
    # replicate (a zero correction flux through domain faces); along x
    # of a slab the neighbours' rows
    first = lambda ax: (lambda t: t.narrow(ax, 0, 1))
    last = lambda ax: (lambda t: t.narrow(ax, t.shape[ax] - 1, 1))
    for ax in range(nd):
        dp = mg._pad(dp, ax, mesh_of(grid), grid.periodic[ax], first(ax),
                     last(ax))
    corr = 0.0
    for d in range(nd):
        gd = (window(dp, d, 1, 0) - window(dp, d, 0, 1)) / grid.dx[d]
        for ax in range(nd):
            if ax != d:
                gd = window(gd, ax, 1, 1)
        f = bcoefs[d] * gd
        corr = corr + (window(f, d, 1, 0) - window(f, d, 0, 1)) / grid.dx[d]
    return corr * eb.fluid[..., None]


def _eb_centroid_flux_correction(u_g, bcoefs, grid, eb, ng):
    """Deferred correction that moves the cut-face viscous gradients from
    the face centres to the face fluid centroids:
    div(b (grad_centroid - grad_centre)) on the previous iterate
    (incflo_tpu/ops/diffusion.py:366-430)."""
    nd = grid.ndim
    if eb.face_cent is None:
        return None
    corr = 0.0
    for d in range(nd):
        v = u_g
        for ax in range(nd):
            v = window(v, ax, ng - 1, ng - 1)
        # n+2 cells along d: the differences land on the n+1 faces, one
        # ghost left on every transverse axis for the centroid shifts
        g_ext = (window(v, d, 1, 0) - window(v, d, 0, 1)) / grid.dx[d]
        g0 = g_ext
        for ax in range(nd):
            if ax != d:
                g0 = window(g0, ax, 1, 1)
        g_til = _centroid_interp(g_ext, eb.face_cent[d], d, nd,
                                 comp_axis=True)
        df = bcoefs[d] * (g_til - g0)
        corr = corr + (window(df, d, 1, 0) - window(df, d, 0, 1)) \
            / grid.dx[d]
    return corr * eb.fluid[..., None]


def _eb_second_order(u_g, eta_cell, ebc, eta_b, grid, eb, ng):
    """The three deferred corrections of eb_wall_order = 2, summed: the
    wall flux, the face-centroid gradients, the centroid state."""
    corr = _eb_wall_correction(u_g, eta_cell, ebc, grid, eb, ng)
    fcorr = _eb_centroid_flux_correction(u_g, eta_b, grid, eb, ng)
    if fcorr is not None:
        corr = corr + fcorr
    scorr = _eb_centroid_state_correction(u_g, eta_b, grid, eb, ng)
    if scorr is not None:
        corr = corr + scorr
    return corr


# ---------------------------------------------------------------------
# explicit applies
# ---------------------------------------------------------------------

def compute_laps(tracer: torch.Tensor, eta_faces_per_comp,
                 cfg: IncfloConfig, grid: Grid, eb=None) -> torch.Tensor:
    """div(mu_s grad s) per tracer component (inhomogeneous BCs; EB walls
    are no-flux for scalars)."""
    bc_lo, bc_hi = scalar_solver_bc(cfg)
    out = []
    for n in range(tracer.shape[-1]):
        lev = mg.CellLevel(grid.dx, tuple(bc_lo), tuple(bc_hi),
                           alpha=0.0, beta=1.0, acoef=None,
                           bcoef=tuple(_eb_faces(eta_faces_per_comp[n], eb)),
                           mesh=mesh_of(grid))
        # L = -div(mu grad); laps = -L
        lap = -mg.cell_apply_inhom(
            tracer[..., n], lev,
            tracer_bvals(cfg, n, tracer.dtype, tracer.device))
        if eb is not None:
            lap = lap * eb.fluid / _vfrac_or_one(eb)
        out.append(lap)
    return torch.stack(out, dim=-1)


def compute_divtau(vel: torch.Tensor, vel_g: torch.Tensor,
                   rho: torch.Tensor, eta_faces, eta_g1: torch.Tensor,
                   cfg: IncfloConfig, grid: Grid, ng: int,
                   eb=None) -> torch.Tensor:
    """divtau = div(tau) / rho.  The scalar part div(eta grad u_c) uses
    the operator-consistent fluxes with the physical Dirichlet values;
    in tensor mode the transpose term is added from the grown velocity
    (reference DiffusionTensorOp::compute_divtau).  With embedded
    boundaries the wall drag -ebc u and, at eb_wall_order = 2, the
    second-order corrections enter, and the result is divided by vfrac
    in cut cells."""
    if cfg.use_tensor_correction:
        return _transpose_term(vel_g, eta_g1, grid, ng) / rho[..., None]
    eta_cell = inner(eta_g1, 1, grid.ndim)
    ebc = _eb_wall_coef(eta_cell, grid, eb) if eb is not None else None
    parts = []
    for c in range(grid.ndim):
        bc_lo, bc_hi = velocity_solver_bc(cfg, c)
        lev = mg.CellLevel(grid.dx, tuple(bc_lo), tuple(bc_hi),
                           alpha=0.0, beta=1.0, acoef=None,
                           bcoef=tuple(_eb_faces(eta_faces, eb)), ebc=ebc,
                           mesh=mesh_of(grid))
        lap = -mg.cell_apply_inhom(vel[..., c], lev,
                                   velocity_bvals(cfg, c, vel.dtype,
                                                  vel.device, grid))
        parts.append(lap)
    divtau = torch.stack(parts, dim=-1)
    if (eb is not None and eb.wall_dist is not None
            and cfg.eb_wall_order == 2):
        eta_b = [b[..., None] for b in _eb_faces(eta_faces, eb)]
        divtau = divtau + _eb_second_order(vel_g, eta_cell, ebc, eta_b,
                                           grid, eb, ng)
    if cfg.use_tensor_solve:
        divtau = divtau + _transpose_term(vel_g, eta_g1, grid, ng)
    if eb is not None:
        divtau = divtau * eb.fluid[..., None] / _vfrac_or_one(eb)[..., None]
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
                fixed_trips=None, eb=None):
    """CG on the full coupled tensor Helmholtz operator

        A(u) = aniso_helmholtz(u) - dt * cross_transpose(u)

    preconditioned by the EXACT inverse of the anisotropic part where it
    has a fast-diagonalization symbol (constant coefficients), else by
    the anisotropic solver's V-cycle.  Residuals use the inhomogeneous ghost
    fill (grow_fn), Krylov directions the homogeneous one (grow_hom_fn),
    which keeps A linear.  Adaptive loop of incflo_tpu/ops/diffusion.py
    :670-704: stop when the best residual is under tol, after maxiter,
    or after 5 non-improving iterations.  Each loop test reads one bool
    back to the host.  With embedded boundaries the cross term is
    weighted by vfrac, as the cut-cell rows are.

    fixed_trips = k runs instead exactly k masked trips of the same
    iteration and reads nothing back (the kernel-mode form of
    incflo_tpu/ops/diffusion.py:627-667): a trip changes the state only
    while the best residual is above tol and fewer than 5 trips in a row
    failed to improve it, so a converged solve stops changing."""
    lev0 = solver.levels[0]
    ndim = grid.ndim
    mesh = mesh_of(grid)

    def _cross(ug):
        tt = _transpose_term(ug, eta_g1, grid, ng, cross_only=True)
        if eb is not None:
            tt = tt * eb.vfrac[..., None]
        return tt

    def A_lin(p):
        return mg.cell_apply(p, lev0) - dt_diff * _cross(grow_hom_fn(p))

    def residual(u):
        return (rhs + dt_diff * _cross(grow_fn(u))
                - mg.cell_apply_inhom(u, lev0, bvals))

    sym = solver.symbol
    direct = (eb is None and sym is not None and sym.fwd is not None
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
                     direct=True, fixed_trips=None, eb=None,
                     solver_bc_override=None, bvals_override=None):
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
    not that one converged.

    Embedded boundaries (eb): the conservative cut-cell form
    (rho vfrac - dt [div(ap eta grad) - ebc]) u = rho vfrac u*, and in
    the batched branch with eb_wall_order = 2 one deferred-correction
    re-solve (incflo_tpu/ops/diffusion.py:730-860); covered cells end at
    zero.

    solver_bc_override ((axis, side) -> SolverBC) and bvals_override
    ((axis, side) -> face values, components last): the coarse-fine
    faces of an AMR patch, Dirichlet with the parent's interpolated
    velocity (incflo_tpu/ops/diffusion.py:711-750)."""
    dtype = vel.dtype
    if eb is not None:
        eta_cell = inner(eta_g1, 1, grid.ndim)
        ebc = _eb_wall_coef(eta_cell, grid, eb)
        acoef = rho * _vfrac_or_one(eb)
    else:
        ebc = None
        acoef = rho
    faces = _eb_faces(eta_faces, eb)
    bcs_all = [_overridden(velocity_solver_bc(cfg, c), solver_bc_override)
               for c in range(grid.ndim)]

    def bvals_of(c):
        return _bvals(velocity_bvals(cfg, c, dtype, vel.device, grid),
                      bvals_override, c)

    if not all(b == bcs_all[0] for b in bcs_all):
        comps = []
        for c in range(grid.ndim):
            bc_lo, bc_hi = bcs_all[c]
            solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=1.0,
                                   beta=dt_diff, acoef=acoef,
                                   bcoef=tuple(faces), ebc=ebc,
                                   direct=direct, mesh=mesh_of(grid))
            comps.append(solver.solve_inhom(
                acoef * vel[..., c], bvals_of(c), x0=vel[..., c],
                rtol=cfg.tensor_mg_rtol, atol=cfg.tensor_mg_atol,
                maxiter=cfg.tensor_mg_maxiter, presmooth=4))
        out = torch.stack(comps, dim=-1)
        if eb is not None:
            out = out * eb.fluid[..., None]
        if return_tensor_res:
            z = torch.zeros((), dtype=dtype, device=vel.device)
            return out, z, torch.full((), float("inf"), dtype=dtype,
                                      device=vel.device)
        return out
    tensor = (cfg.use_tensor_solve and grow_fn is not None
              and eta_g1 is not None)
    if prebuilt_solver is not None:     # (an EB deck never has one)
        solver = prebuilt_solver.with_beta(dt_diff)
    else:
        eta_b = []
        for d in range(grid.ndim):
            scale_np = np.ones((grid.ndim,), np.float64)
            if tensor:
                scale_np[d] = 2.0
            eta_b.append(faces[d][..., None]
                         * torch.as_tensor(scale_np, dtype=dtype,
                                           device=vel.device))
        bc_lo, bc_hi = bcs_all[0]
        solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=1.0,
                               beta=dt_diff, acoef=acoef[..., None],
                               bcoef=tuple(eta_b),
                               ebc=None if ebc is None else ebc[..., None],
                               direct=direct, mesh=mesh_of(grid))
    bvals = {}
    per_comp = [bvals_of(c) for c in range(grid.ndim)]
    for ax in range(cfg.ndim):
        if grid.periodic[ax]:
            continue
        for side in range(2):
            vals = [bv[(ax, side)] for bv in per_comp]
            vals = torch.broadcast_tensors(*vals)
            bvals[(ax, side)] = torch.stack(vals, dim=-1)
    rhs = acoef[..., None] * vel
    out = solver.solve_inhom(rhs, bvals, x0=vel, rtol=cfg.tensor_mg_rtol,
                             atol=cfg.tensor_mg_atol,
                             maxiter=cfg.tensor_mg_maxiter, presmooth=4)
    if (eb is not None and eb.wall_dist is not None
            and grow_fn is not None and cfg.eb_wall_order == 2):
        # second-order EB: one deferred-correction re-solve with the wall
        # flux, the cut-face gradients and the cut-cell state upgraded
        rhs = rhs + dt_diff * _eb_second_order(grow_fn(out), eta_cell, ebc,
                                               eta_b, grid, eb, ng)
        out = solver.solve_inhom(rhs, bvals, x0=out,
                                 rtol=cfg.tensor_mg_rtol,
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
                          fixed_trips=fixed_trips, eb=eb)
        if return_tensor_res:
            out, cg_res = out
            if eb is not None:
                out = out * eb.fluid[..., None]
            return out, cg_res, cg_tol
    if eb is not None:
        out = out * eb.fluid[..., None]
    if return_tensor_res:
        z = torch.zeros((), dtype=dtype, device=vel.device)
        return out, z, torch.full((), float("inf"), dtype=dtype,
                                  device=vel.device)
    return out


def _overridden(bcs_pair, override):
    """(bc_lo, bc_hi) with the (axis, side) -> SolverBC of `override`."""
    lo, hi = list(bcs_pair[0]), list(bcs_pair[1])
    for (ax, side), bc in (override or {}).items():
        (lo if side == 0 else hi)[ax] = bc
    return lo, hi


def _bvals(base, override, comp):
    """Face values `base` with component `comp` of `override` on its
    faces."""
    out = dict(base)
    for key, arr in (override or {}).items():
        out[key] = arr[..., comp]
    return out


def diffuse_scalar(tracer: torch.Tensor, rho: torch.Tensor,
                   eta_faces_per_comp, dt_diff, cfg: IncfloConfig,
                   grid: Grid, eb=None, solver_bc_override=None,
                   bvals_override=None) -> torch.Tensor:
    """(rho - dt div(mu_s grad)) s = rho s* per tracer, from the warm
    start s* after 4 fine-level sweeps.  The solver is built from the
    step's rho and never looks for a direct solve (as incflo_tpu's,
    built inside a trace).  Embedded boundaries: rows weighted by vfrac,
    no-flux EB walls, covered cells at zero.  The overrides as for
    diffuse_velocity, per tracer (incflo_tpu/ops/diffusion.py:872-895)."""
    bc_lo, bc_hi = _overridden(scalar_solver_bc(cfg), solver_bc_override)
    acoef = rho * _vfrac_or_one(eb) if eb is not None else rho
    comps = []
    for n in range(tracer.shape[-1]):
        solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=1.0,
                               beta=dt_diff, acoef=acoef,
                               bcoef=tuple(_eb_faces(eta_faces_per_comp[n],
                                                     eb)),
                               direct=False, mesh=mesh_of(grid))
        comps.append(solver.solve_inhom(
            acoef * tracer[..., n],
            _bvals(tracer_bvals(cfg, n, tracer.dtype, tracer.device),
                   bvals_override, n),
            x0=tracer[..., n], rtol=cfg.diff_mg_rtol, atol=cfg.diff_mg_atol,
            maxiter=cfg.diff_mg_maxiter, presmooth=4))
    out = torch.stack(comps, dim=-1)
    if eb is not None:
        out = out * eb.fluid[..., None]
    return out
