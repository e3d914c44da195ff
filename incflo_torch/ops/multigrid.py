"""Cell-centred and nodal operators and their solvers (port of the parts
of incflo_tpu/ops/multigrid.py that the shear3d step runs).

Two operator families:

  CellLevel  : L(phi) = alpha*a*phi - beta*div(b grad phi), phi at cell
               centres, b at faces.  The MAC projection (alpha=0,
               b=1/rho) and the diffusion Helmholtz solves (alpha=1,
               a=rho, beta=dt, b=eta).
  NodalLevel : the Q1 finite-element nodal sigma-Poisson operator of the
               approximate projection (AMReX MLNodeLaplacian).

CellSolver and NodalSolver take the direct path only: constant-coefficient
operators with every axis <= 256 cells are solved by per-axis fast
diagonalization (ops/spectral.py), longer periodic axes by rfftn.  Where
the JAX package would run a multigrid V-cycle they raise; the V-cycles,
the PCG and the smoother kernels come with ROADMAP A9.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import torch


class SolverBC(enum.IntEnum):
    PERIODIC = 0
    NEUMANN = 1     # homogeneous Neumann (zero flux)
    DIRICHLET = 2   # value on the domain face


_VCYCLE = ("multigrid V-cycles are not ported yet (ROADMAP A9): "
           "incflo_torch solves constant-coefficient systems directly")


# =====================================================================
# small helpers
# =====================================================================

def _slice_axis(x, axis, sl):
    s = [slice(None)] * x.dim()
    s[axis] = sl
    return x[tuple(s)]


def _wrap_pad(x, axis, lo=1, hi=1):
    n = x.shape[axis]
    parts = []
    if lo:
        parts.append(x.narrow(axis, n - lo, lo))
    parts.append(x)
    if hi:
        parts.append(x.narrow(axis, 0, hi))
    return torch.cat(parts, dim=axis)


def _zero_pad(x, axis, lo=1, hi=1):
    parts = []
    shape = list(x.shape)
    if lo:
        shape[axis] = lo
        parts.append(x.new_zeros(shape))
    parts.append(x)
    if hi:
        shape[axis] = hi
        parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim=axis)


def _maxnorm(x):
    return torch.max(torch.abs(x))


def _move(obj, device):
    """Copy of a solver object with every tensor moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(o, device) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _move(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


# =====================================================================
# Cell-centred operator: alpha*a*phi - beta*div(b grad phi)
# =====================================================================

@dataclasses.dataclass(frozen=True)
class CellLevel:
    """Coefficients of one level of a cell-centred operator."""
    dx: Tuple[float, ...]
    bc_lo: Tuple[int, ...]        # SolverBC per axis
    bc_hi: Tuple[int, ...]
    alpha: float
    beta: object                  # float or 0-d tensor (dt)
    acoef: Optional[torch.Tensor]          # (cells) or None (== 0)
    bcoef: Tuple[torch.Tensor, ...]        # per axis, faces (n+1 along axis)
    ebc: Optional[torch.Tensor] = None     # EB wall coefficient (A11)


def _cell_pad_hom(x, lev: CellLevel):
    """Pad phi by one ghost per axis with homogeneous solver BCs.
    DIRICHLET uses the maxorder-3 ghost g = -2*phi0 + phi1/3."""
    for ax in range(len(lev.dx)):
        if lev.bc_lo[ax] == SolverBC.PERIODIC:
            x = _wrap_pad(x, ax)
            continue
        n = x.shape[ax]
        q0l = x.narrow(ax, 0, 1)
        q1l = x.narrow(ax, 1, 1) if n > 1 else q0l
        q0h = x.narrow(ax, n - 1, 1)
        q1h = x.narrow(ax, n - 2, 1) if n > 1 else q0h
        lo = q0l if lev.bc_lo[ax] == SolverBC.NEUMANN else (-2.0 * q0l + q1l / 3.0)
        hi = q0h if lev.bc_hi[ax] == SolverBC.NEUMANN else (-2.0 * q0h + q1h / 3.0)
        x = torch.cat([lo, x, hi], dim=ax)
    return x


def _cell_pad_inhom(x, lev: CellLevel, bvals):
    """Like _cell_pad_hom with inhomogeneous Dirichlet face values:
    ghost = (8/3) b - 2 phi0 + phi1/3 (maxorder 3)."""
    for ax in range(len(lev.dx)):
        if lev.bc_lo[ax] == SolverBC.PERIODIC:
            x = _wrap_pad(x, ax)
            continue
        n = x.shape[ax]
        q0l = x.narrow(ax, 0, 1)
        q1l = x.narrow(ax, 1, 1) if n > 1 else q0l
        q0h = x.narrow(ax, n - 1, 1)
        q1h = x.narrow(ax, n - 2, 1) if n > 1 else q0h
        if lev.bc_lo[ax] == SolverBC.NEUMANN:
            lo = q0l
        else:
            bv = bvals.get((ax, 0), 0.0)
            lo = (8.0 / 3.0) * (bv + 0.0 * q0l) - 2.0 * q0l + q1l / 3.0
        if lev.bc_hi[ax] == SolverBC.NEUMANN:
            hi = q0h
        else:
            bv = bvals.get((ax, 1), 0.0)
            hi = (8.0 / 3.0) * (bv + 0.0 * q0h) - 2.0 * q0h + q1h / 3.0
        x = torch.cat([lo, x, hi], dim=ax)
    return x


def _set_face(flux, axis, idx, val):
    out = flux.clone()
    n = out.shape[axis]
    out.narrow(axis, idx % n, 1).fill_(val)
    return out


def _fluxes_of_padded(xp, lev: CellLevel):
    ndim = len(lev.dx)
    fluxes = []
    for ax in range(ndim):
        dxi = 1.0 / lev.dx[ax]
        v = xp
        for other in range(ndim):
            if other != ax:
                v = v.narrow(other, 1, v.shape[other] - 2)
        grad = (v.narrow(ax, 1, v.shape[ax] - 1)
                - v.narrow(ax, 0, v.shape[ax] - 1)) * dxi      # n+1 faces
        flux = lev.bcoef[ax] * grad
        if lev.bc_lo[ax] == SolverBC.NEUMANN:
            flux = _set_face(flux, ax, 0, 0.0)
        if lev.bc_hi[ax] == SolverBC.NEUMANN:
            flux = _set_face(flux, ax, -1, 0.0)
        fluxes.append(flux)
    return fluxes


def cell_fluxes_inhom(x, lev: CellLevel, bvals):
    """b*grad(x) on all faces with inhomogeneous Dirichlet values."""
    return _fluxes_of_padded(_cell_pad_inhom(x, lev, bvals), lev)


def cell_fluxes(x, lev: CellLevel):
    """b*grad(x) on the n+1 faces of every axis (homogeneous BCs): the
    discrete fluxes the operator divergences, and the MAC-projection
    velocity correction."""
    return _fluxes_of_padded(_cell_pad_hom(x, lev), lev)


def _apply_from_fluxes(x, lev: CellLevel, fluxes):
    out = lev.alpha * (lev.acoef * x if lev.acoef is not None else 0.0 * x)
    if lev.ebc is not None:
        out = out + lev.beta * lev.ebc * x
    for ax, flux in enumerate(fluxes):
        dxi = 1.0 / lev.dx[ax]
        n = flux.shape[ax]
        div = (flux.narrow(ax, 1, n - 1) - flux.narrow(ax, 0, n - 1)) * dxi
        out = out - lev.beta * div
    return out


def cell_apply_inhom(x, lev: CellLevel, bvals):
    """L(x) with inhomogeneous Dirichlet boundary values."""
    return _apply_from_fluxes(x, lev, cell_fluxes_inhom(x, lev, bvals))


def cell_apply(x, lev: CellLevel):
    """L(x) with homogeneous BCs."""
    return _apply_from_fluxes(x, lev, cell_fluxes(x, lev))


def cell_diag(lev: CellLevel):
    """Analytic diagonal of cell_apply."""
    ndim = len(lev.dx)
    shape = lev.bcoef[0].shape
    cells = tuple(n - (1 if ax == 0 else 0) for ax, n in enumerate(shape))
    b0 = lev.bcoef[0]
    d = lev.alpha * (lev.acoef if lev.acoef is not None else 0.0)
    d = torch.zeros(cells, dtype=b0.dtype, device=b0.device) + d
    if lev.ebc is not None:
        d = d + lev.beta * lev.ebc
    for ax in range(ndim):
        dx2i = 1.0 / (lev.dx[ax] ** 2)
        b = lev.bcoef[ax]
        n = b.shape[ax]
        blo = b.narrow(ax, 0, n - 1)
        bhi = b.narrow(ax, 1, n - 1)
        clo = torch.ones_like(blo)
        chi = torch.ones_like(bhi)
        # boundary coefficient of phi0 in the boundary-face flux:
        # Neumann -> 0 ; Dirichlet maxorder-3 ghost -> 3
        if lev.bc_lo[ax] != SolverBC.PERIODIC:
            c = 0.0 if lev.bc_lo[ax] == SolverBC.NEUMANN else 3.0
            clo = _set_face(clo, ax, 0, c)
        if lev.bc_hi[ax] != SolverBC.PERIODIC:
            c = 0.0 if lev.bc_hi[ax] == SolverBC.NEUMANN else 3.0
            chi = _set_face(chi, ax, -1, c)
        d = d + lev.beta * (blo * clo + bhi * chi) * dx2i
    return d


def _coarsen_cells(a, ndim):
    """Average 2^ndim children -> coarse cells."""
    for ax in range(ndim):
        n = a.shape[ax]
        a = 0.5 * (_slice_axis(a, ax, slice(0, n, 2))
                   + _slice_axis(a, ax, slice(1, n, 2)))
    return a


def _coarsen_face(b, axis, ndim):
    """Coarsen a face coefficient: fine faces at even normal index,
    averaged over the 2^(ndim-1) transverse fine faces."""
    b = _slice_axis(b, axis, slice(0, b.shape[axis], 2))
    for ax in range(ndim):
        if ax == axis:
            continue
        n = b.shape[ax]
        b = 0.5 * (_slice_axis(b, ax, slice(0, n, 2))
                   + _slice_axis(b, ax, slice(1, n, 2)))
    return b


class CellSolver:
    """Solver for the cell-centred operator on one grid (direct path)."""

    def __init__(self, dx, bc_lo, bc_hi, alpha, beta, acoef, bcoef,
                 max_levels=30, ebc=None):
        ndim = len(dx)
        self.ndim = ndim
        if ebc is not None:
            raise NotImplementedError("EB wall coefficients come with "
                                      "ROADMAP A11")
        levels: List[CellLevel] = []
        lev = CellLevel(tuple(dx), tuple(int(b) for b in bc_lo),
                        tuple(int(b) for b in bc_hi), alpha, beta,
                        acoef, tuple(bcoef), None)
        cells = tuple(acoef.shape[:ndim]) if acoef is not None else tuple(
            bcoef[0].shape[ax] - (1 if ax == 0 else 0) for ax in range(ndim))
        # the coarsened hierarchy the V-cycles of ROADMAP A9 will run on;
        # with_beta rescales its diagonals
        while True:
            levels.append(lev)
            if len(levels) >= max_levels:
                break
            if any(n % 2 != 0 or n < 4 for n in cells):
                break
            cells = tuple(n // 2 for n in cells)
            lev = CellLevel(
                tuple(d * 2 for d in lev.dx), lev.bc_lo, lev.bc_hi,
                lev.alpha, lev.beta,
                _coarsen_cells(lev.acoef, ndim) if lev.acoef is not None else None,
                tuple(_coarsen_face(lev.bcoef[ax], ax, ndim)
                      for ax in range(ndim)), None)
        self.levels = levels
        self.diags = [cell_diag(l) for l in levels]
        self.singular = (alpha == 0.0) and all(
            b != SolverBC.DIRICHLET for b in list(bc_lo) + list(bc_hi))
        from incflo_torch.ops import spectral
        self.symbol = spectral.cell_symbol(levels[0])

    def to(self, device) -> "CellSolver":
        out = copy.copy(self)
        out.levels = [_move(l, device) for l in self.levels]
        out.diags = [d.to(device) for d in self.diags]
        out.symbol = _move(self.symbol, device)
        return out

    def with_beta(self, beta):
        """Same coefficient hierarchy, new beta scalar (beta = dt per
        step); only the beta-scaled diagonals are recomputed."""
        out = copy.copy(self)
        out.levels = [dataclasses.replace(l, beta=beta) for l in self.levels]
        out.diags = []
        for l_old, d_old in zip(self.levels, self.diags):
            base = l_old.alpha * (l_old.acoef if l_old.acoef is not None
                                  else 0.0)
            faceparts = (d_old - base) / l_old.beta
            out.diags.append(base + beta * faceparts)
        return out

    def solve(self, rhs):
        """x = L^{-1} rhs by the direct solve (exact to rounding, so no
        tolerance or iteration count applies)."""
        lev = self.levels[0]
        sym = self.symbol
        if self.singular:
            rhs = rhs - torch.mean(rhs)
        if not (sym is not None
                and tuple(rhs.shape[:self.ndim]) == sym.cells
                and (rhs.dim() > self.ndim or not sym.batched)):
            raise NotImplementedError(_VCYCLE)
        from incflo_torch.ops import spectral
        return spectral.solve(sym, rhs, lev.alpha, lev.beta, self.singular)

    def solve_inhom(self, rhs, bvals):
        """Solve with inhomogeneous Dirichlet face values `bvals`
        ((axis, side) -> value), folded into the RHS."""
        offset = cell_apply_inhom(torch.zeros_like(rhs), self.levels[0],
                                  bvals)
        return self.solve(rhs - offset)


# =====================================================================
# Nodal operator: the Q1 FEM sigma-Poisson operator
# =====================================================================

@dataclasses.dataclass(frozen=True)
class NodalLevel:
    dx: Tuple[float, ...]
    periodic: Tuple[bool, ...]
    bc_lo: Tuple[int, ...]
    bc_hi: Tuple[int, ...]
    sigma: Optional[torch.Tensor]            # (cells); dropped by with_stencil
    sigma_pad: Optional[torch.Tensor] = None  # padded by 1 per axis
    cells: Optional[Tuple[int, ...]] = None

    def with_stencil(self):
        s = self.sigma
        for ax in range(len(self.dx)):
            s = _wrap_pad(s, ax) if self.periodic[ax] else _zero_pad(s, ax)
        return dataclasses.replace(self, sigma=None, sigma_pad=s,
                                   cells=tuple(self.sigma.shape))


def _node_to_cellgrad(phi, lev: NodalLevel, axis):
    """G_axis: gradient at cell centres from nodal phi (average of the
    2^(D-1) node-pair differences / dx)."""
    ndim = len(lev.dx)
    p = phi
    for ax in range(ndim):
        if lev.periodic[ax]:
            p = _wrap_pad(p, ax, lo=0, hi=1)
    n = p.shape[axis]
    g = (p.narrow(axis, 1, n - 1) - p.narrow(axis, 0, n - 1)) / lev.dx[axis]
    for ax in range(ndim):
        if ax == axis:
            continue
        m = g.shape[ax]
        g = 0.5 * (g.narrow(ax, 0, m - 1) + g.narrow(ax, 1, m - 1))
    return g


def nodal_divergence(u_pad: Sequence[torch.Tensor], dx) -> torch.Tensor:
    """D: divergence at ALL nodes (n_cells+1 per axis) of a cell-centred
    vector padded by one ghost per axis (the ghosts encode the BC)."""
    ndim = len(dx)
    out = 0.0
    for axis in range(ndim):
        u = u_pad[axis]
        n = u.shape[axis]
        t = (u.narrow(axis, 1, n - 1) - u.narrow(axis, 0, n - 1)) / dx[axis]
        for ax in range(ndim):
            if ax == axis:
                continue
            m = t.shape[ax]
            t = 0.5 * (t.narrow(ax, 0, m - 1) + t.narrow(ax, 1, m - 1))
        out = out + t
    return out


def _nodes_unique(x_allnodes, lev: NodalLevel):
    """Drop the duplicated high node on periodic axes."""
    for ax in range(len(lev.dx)):
        if lev.periodic[ax]:
            x_allnodes = x_allnodes.narrow(ax, 0, x_allnodes.shape[ax] - 1)
    return x_allnodes


def _set_slab(x, axis, idx, val):
    out = x.clone()
    n = out.shape[axis]
    sl = out.narrow(axis, 0 if idx == 0 else n - 1, 1)
    if isinstance(val, torch.Tensor):
        sl.copy_(val)
    else:
        sl.fill_(val)
    return out


def _apply_dirichlet_mask(nodal, lev: NodalLevel, identity_from=None):
    """Rows of Dirichlet boundary nodes become identity (phi itself)."""
    for ax in range(len(lev.dx)):
        if lev.periodic[ax]:
            continue
        if lev.bc_lo[ax] == SolverBC.DIRICHLET:
            src = (identity_from.narrow(ax, 0, 1)
                   if identity_from is not None else 0.0)
            nodal = _set_slab(nodal, ax, 0, src)
        if lev.bc_hi[ax] == SolverBC.DIRICHLET:
            m = identity_from.shape[ax] if identity_from is not None else 0
            src = (identity_from.narrow(ax, m - 1, 1)
                   if identity_from is not None else 0.0)
            nodal = _set_slab(nodal, ax, -1, src)
    return nodal


def _zero_dirichlet(nodal, lev: NodalLevel):
    return _apply_dirichlet_mask(nodal, lev, identity_from=None)


def nodal_apply(phi, lev: NodalLevel):
    """L(phi) via the factorized Q1 FEM element stencil (+ identity on
    Dirichlet rows): L(phi) = -(1/V) sum_p C_p A_p^T (sigma . (A_p phi))
    over the 2^D-1 sign patterns p in {s,d}^D \\ {s..s}, with the same
    hierarchical shift sharing as incflo_tpu."""
    ndim = len(lev.dx)
    assert lev.sigma_pad is not None, "use NodalLevel.with_stencil()"
    sig = lev.sigma_pad
    for ax in range(ndim):
        sig = sig.narrow(ax, 1, lev.cells[ax])
    p = phi
    for ax in range(ndim):
        if lev.periodic[ax]:
            p = _wrap_pad(p, ax, lo=0, hi=1)
    vol = 1.0
    for d in lev.dx:
        vol *= d

    def coef(pattern):
        C = 0.0
        for d in range(ndim):
            if pattern[d] != "d":
                continue
            term = 1.0 / lev.dx[d]
            for a in range(ndim):
                if a == d:
                    continue
                term *= (lev.dx[a] / 4.0) if pattern[a] == "s" \
                    else (lev.dx[a] / 12.0)
            C += term
        return -C / vol

    parts = {(): p}
    for ax in range(ndim):
        new = {}
        for key, y in parts.items():
            m = y.shape[ax]
            lo = y.narrow(ax, 0, m - 1)
            hi = y.narrow(ax, 1, m - 1)
            new[key + ("s",)] = lo + hi
            new[key + ("d",)] = lo - hi
        parts = new
    t = {pat: (coef(pat) * sig * y) if "d" in pat else None
         for pat, y in parts.items()}
    for ax in range(ndim - 1, -1, -1):
        m = lev.cells[ax]
        new = {}
        for key in {k[:-1] for k in t}:
            ts = t.get(key + ("s",))
            td = t.get(key + ("d",))
            if ts is None and td is None:
                new[key] = None
                continue
            a = (0.0 if ts is None else ts) + (0.0 if td is None else td)
            b = (0.0 if ts is None else ts) - (0.0 if td is None else td)
            if lev.periodic[ax]:
                bp = _wrap_pad(b, ax, lo=1, hi=0)
                new[key] = a + bp.narrow(ax, 0, m)
            else:
                ap = _zero_pad(a, ax)
                bp = _zero_pad(b, ax)
                new[key] = ap.narrow(ax, 1, m + 1) + bp.narrow(ax, 0, m + 1)
        t = new
    return _apply_dirichlet_mask(t[()], lev, identity_from=phi)


class NodalSolver:
    """Solver for the nodal sigma-Poisson system (direct path)."""

    def __init__(self, dx, periodic, bc_lo, bc_hi, sigma, max_levels=30):
        ndim = len(dx)
        self.ndim = ndim
        levels: List[NodalLevel] = []
        lev = NodalLevel(tuple(dx), tuple(periodic),
                         tuple(int(b) for b in bc_lo),
                         tuple(int(b) for b in bc_hi), sigma)
        cells = tuple(sigma.shape)
        while True:
            levels.append(lev.with_stencil())
            if len(levels) >= max_levels:
                break
            if any(n % 2 != 0 or n < 4 for n in cells):
                break
            cells = tuple(n // 2 for n in cells)
            lev = NodalLevel(tuple(d * 2 for d in lev.dx), lev.periodic,
                             lev.bc_lo, lev.bc_hi,
                             _coarsen_cells(lev.sigma, ndim))
        self.levels = levels
        self.singular = all(
            b != SolverBC.DIRICHLET for b in list(bc_lo) + list(bc_hi))
        from incflo_torch.ops import spectral
        self.symbol = spectral.nodal_symbol(levels[0])

    def to(self, device) -> "NodalSolver":
        out = copy.copy(self)
        out.levels = [_move(l, device) for l in self.levels]
        out.symbol = _move(self.symbol, device)
        return out

    def solve(self, rhs):
        """x = L^{-1} rhs by the direct solve (exact to rounding)."""
        lev = self.levels[0]
        if self.singular:
            rhs = rhs - torch.mean(rhs)
        rhs = _zero_dirichlet(rhs, lev)
        if not (self.symbol is not None
                and tuple(rhs.shape) == self.symbol.cells):
            raise NotImplementedError(_VCYCLE)
        from incflo_torch.ops import spectral
        return spectral.solve(self.symbol, rhs, 0.0, 1.0, self.singular)

    def grad_at_cells(self, phi):
        """Gradient of nodal phi at cell centres, components last."""
        lev = self.levels[0]
        return torch.stack([_node_to_cellgrad(phi, lev, ax)
                            for ax in range(self.ndim)], dim=-1)
