"""Cell-centred and nodal operators and their solvers (port of
incflo_tpu/ops/multigrid.py for one-level steps: periodic, Neumann and
Dirichlet sides on any axis, 2D and 3D, embedded boundaries included).

Two operator families:

  CellLevel  : L(phi) = alpha*a*phi - beta*div(b grad phi), phi at cell
               centres, b at faces.  The MAC projection (alpha=0,
               b=1/rho) and the diffusion Helmholtz solves (alpha=1,
               a=rho, beta=dt, b=eta).
  NodalLevel : the Q1 finite-element nodal sigma-Poisson operator of the
               approximate projection (AMReX MLNodeLaplacian).

CellSolver and NodalSolver solve constant-coefficient operators directly
(per-axis fast diagonalization for axes <= 256 cells, rfftn for longer
periodic axes; ops/spectral.py) and everything else by geometric
multigrid: V-cycles over the coarsened hierarchy (2^D cell averaging /
nodal full weighting down, (bi/tri)linear prolongation up), red-black
Gauss-Seidel with analytic diagonals as the smoother.  The cell solver
wraps the V-cycle in conjugate gradients, the nodal solver iterates it.

JAX's lax.while_loop / lax.cond are Python loops here that read one bool
per iteration back to the host; COUNTS tallies those reads, the solves
and their iterations.  On every 3D level the smoothers run through
ops/smoother_kernels (CUDA kernels on the card, one launch a call; their
plain versions on the CPU), walls included, the cut-cell levels of the
EB solves too (the EB wall term folded into the cell kernel's diag).  A
2D level is smoothed in plain PyTorch on either device, in incflo_tpu's
own jnp arithmetic (multigrid.py:425-451 and :1018-1030; see
CellSolver._smooth_res).

Embedded boundaries: the cell operator takes the EB wall coefficient
ebc (L += beta*ebc*phi); the cut-cell nodal projection takes either the
exact octant operator eb_nodal_apply (P^T L_fine P on the 2x lattice)
precomputed as 3^D-point coarse-node stencils (EBNodalSolver, plain
PyTorch, probed on the solver's device) or the regular NodalSolver on
the octant lattice.

On an x slab of a mesh (parallel/mesh.py) a level carries the mesh: its
x pads come from the neighbouring ranks, but at the level's own x faces
where x ends in walls (the first rank's low side, the last rank's high
side: _pad, _side_bc; a nodal slab there holds node nx on the last rank,
_nodes_unique), and its norms, means and CG dots are global.  A constant-coefficient solver is the whole level's
direct solver cut to the slab (CellSolver.shard, NodalSolver.shard;
spectral.shard_symbol).  Multigrid runs on the slab (a solver built with
mesh=, or shard() of one without a direct solve or with the rfftn one,
which does not cut to a slab): the hierarchy's depth
comes from the whole level's extents, so it is the one rank's hierarchy;
its levels are slabs, coarsened rank by rank, as long as a level's slab
is even (its first x index keeps the global colour parity) and at least
as wide as the halo of the calls on it (smoother_kernels.slab_depth: 4
planes for a cell V-cycle's sweeps, 6 for a nodal one's, 18 and 50 for
their bottoms); the smoothers there are the slab forms of the kernels
(smoother_kernels.cell_smooth_slab / nodal_smooth_slab) on a 3D level
and, on a 2D level, the plain flux-form sweeps on the same extended slab
(CellSolver / NodalSolver._smooth_slab_2d: one halo exchange of x and b
a call, x open at the slab's edges, counted in SLAB_2D), their
coefficients extended by the neighbours' planes once per hierarchy and
depth.  The levels below go to every rank whole (SlabMesh.all_gather_x
of the coefficients once, of the coarse residual in each V-cycle): each
rank runs the same coarse V-cycle on the same bits and keeps its rows of
the correction.  A hierarchy whose fine level is already too narrow
runs whole on every rank from the fine level down.  Every level smooths
what the one-rank hierarchy smooths, bit for bit; only the CG's dots,
summed rank by rank, round differently.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class SolverBC(enum.IntEnum):
    PERIODIC = 0
    NEUMANN = 1     # homogeneous Neumann (zero flux)
    DIRICHLET = 2   # value on the domain face


# host-side tallies of the iterative solves since reset_counts(): solves
# that iterated, their CG iterations / V-cycles, the adaptive tensor CG's
# iterations (ops/diffusion.py), and the bools read back from the device
# to steer the loops
COUNTS = {"cell_solves": 0, "cell_iters": 0, "nodal_solves": 0,
          "nodal_cycles": 0, "tensor_cg_iters": 0, "host_syncs": 0}
# None, or a list to which each nodal solve that iterated appends
# (final max-norm residual, the tolerance it was held to, V-cycles,
# maxiter), the first two as 0-d tensors (appending reads nothing back)
NODAL_LOG = None
# the same for each cell solve whose CG iterated (the best residual)
CELL_LOG = None
# the 27-point (9-point in 2D) EB nodal smoother's calls on slab levels
# (EBNodalSolver._smooth_res: plain PyTorch, no kernel), since
# reset_counts()
STENCIL_SLAB = {"calls": 0}
# the plain flux-form sweeps' calls on 2D slab levels (CellSolver and
# NodalSolver._smooth_res: plain PyTorch, one halo exchange a call),
# since reset_counts()
SLAB_2D = {"cell": 0, "nodal": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    STENCIL_SLAB["calls"] = 0
    for k in SLAB_2D:
        SLAB_2D[k] = 0


def host_bool(flag) -> bool:
    """Read a 0-d bool tensor back to the host (one device sync)."""
    COUNTS["host_syncs"] += 1
    return bool(flag)


# =====================================================================
# small helpers
# =====================================================================

def _slice_axis(x, axis, sl):
    s = [slice(None)] * x.dim()
    s[axis] = sl
    return x[tuple(s)]


def _wrap_pad(x, axis, lo=1, hi=1, mesh=None):
    """Periodic pad of lo and hi entries along axis; along x of a slab
    (mesh given) the neighbouring ranks' entries."""
    if mesh is not None and axis == 0:
        return mesh.halo_x(x, lo, hi)
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


def _edge_pad(x, axis, lo=1, hi=1):
    n = x.shape[axis]
    parts = [x.narrow(axis, 0, 1)] * lo + [x] + [x.narrow(axis, n - 1, 1)] * hi
    return torch.cat(parts, dim=axis)


def _on_slab_x(axis, mesh, periodic) -> bool:
    """Along `axis` the array is a rank's x slab of a level whose x ends
    in boundaries: its pads take the neighbours' rows inside and the
    level's boundary pad at the level's own x faces (SlabMesh.ends)."""
    return axis == 0 and mesh is not None and not periodic


def _pad(x, axis, mesh, periodic, lo_fn, hi_fn, lo=1, hi=1):
    """x padded by lo and hi entries along axis: the wrap (the
    neighbouring ranks' entries along x of a slab) on a periodic axis,
    else lo_fn(x) / hi_fn(x) beyond the level's boundary and, along x of
    a slab, the neighbours' entries inside (None pads nothing)."""
    if periodic:
        return _wrap_pad(x, axis, lo, hi, mesh)
    if _on_slab_x(axis, mesh, periodic):
        return mesh.halo_x(x, lo, hi, periodic=False, ends=(lo_fn, hi_fn))
    parts = ([lo_fn(x)] if lo_fn is not None and lo else []) + [x] \
        + ([hi_fn(x)] if hi_fn is not None and hi else [])
    return torch.cat(parts, dim=axis)


def _zero_rows(axis, k=1):
    """A pad function: k zero entries along axis."""
    def rows(x):
        shape = list(x.shape)
        shape[axis] = k
        return x.new_zeros(shape)
    return rows


def _side_bc(lev, axis, side):
    """The solver BC of one side of an axis as a level's array sees it:
    the level's own, but PERIODIC (the neighbours' rows) on an x side of
    a slab that is not the level's own x face."""
    code = lev.bc_lo[axis] if side == 0 else lev.bc_hi[axis]
    if (_on_slab_x(axis, lev.mesh, code == SolverBC.PERIODIC)
            and not lev.mesh.ends(False)[side]):
        return SolverBC.PERIODIC
    return code


def checkerboards(shape, dtype, device, ndim):
    """Red and black masks over the first `ndim` (spatial) axes, as
    floats; trailing component axes are uncoloured."""
    par = 0
    for ax in range(ndim):
        view = [1] * len(shape)
        view[ax] = shape[ax]
        par = par + torch.arange(shape[ax], device=device).reshape(view)
    red = ((par % 2) == 0).to(dtype)
    red = torch.broadcast_to(red, tuple(shape))
    return red, 1.0 - red


def _rb_sweeps(x, b, dinv, apply, n, want_residual, ndim):
    """n red-black Gauss-Seidel sweeps of L = apply with the guarded
    inverse diagonal dinv, each colour a full-residual update (the
    arithmetic of incflo_tpu's jnp smoothers), + the residual b - L(x)."""
    red, black = checkerboards(x.shape, x.dtype, x.device, ndim)
    for _ in range(int(n)):
        x = x + red * (b - apply(x)) * dinv
        x = x + black * (b - apply(x)) * dinv
    return x, (b - apply(x)) if want_residual else None


def _maxnorm(x, mesh=None):
    m = torch.max(torch.abs(x))
    return m if mesh is None else mesh.all_reduce_max(m)


def _mean(x, mesh=None):
    """The whole level's mean: on a mesh its sum and its count over the
    ranks in one all-reduce (the slabs of a node field differ in rows)."""
    if mesh is None:
        return torch.mean(x)
    n = torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
    tot = mesh.all_reduce_sum(torch.stack([torch.sum(x), n]))
    return tot[0] / tot[1]


def _dot(a, b, mesh=None):
    d = torch.sum(a * b)
    return d if mesh is None else mesh.all_reduce_sum(d)


def _depths(cells, max_levels):
    """The cell extents of each level of a hierarchy over the whole level
    `cells`: halved while every extent is even and at least 4."""
    shapes = [tuple(cells)]
    while len(shapes) < max_levels and all(n % 2 == 0 and n >= 4
                                           for n in shapes[-1]):
        shapes.append(tuple(n // 2 for n in shapes[-1]))
    return shapes


def _slab_levels(shapes, mesh, nu, nu_bottom):
    """How many leading levels of the hierarchy `shapes` stay x slabs on
    `mesh`: each must split into even slabs at least as wide as the
    deepest halo of its smoother calls (nu sweeps with the residual;
    the bottom's nu_bottom)."""
    from incflo_torch.ops import smoother_kernels as sk
    if mesh is None:
        return len(shapes)
    for li, cells in enumerate(shapes):
        nxl, rem = divmod(cells[0], mesh.size)
        sweeps = nu_bottom if li == len(shapes) - 1 else nu
        if rem or nxl % 2 or nxl < sk.slab_depth(sweeps, True)[0]:
            return li
    return len(shapes)


def _chunks(n, nxl, want_residual):
    """Split n sweeps on a slab of nxl rows into calls whose halo fits
    the neighbours' slabs: (sweeps, residual) per call; sweeps done in
    several calls give the bits of one call."""
    from incflo_torch.ops import smoother_kernels as sk
    per = max(1, (nxl - 2) // 2)
    if sk.slab_depth(n, want_residual)[0] <= nxl:
        return [(n, want_residual)]
    out = [(per, False)] * ((n - 1) // per)
    return out + [(n - per * len(out), want_residual)]


def _open_x(codes_lo, codes_hi, mesh, periodic):
    """The solver BCs of a 2D extended slab (the _smooth_slab_2d sweeps
    of CellSolver and NodalSolver): y the level's; along x the level's
    code on a side that is the level's own x face (SlabMesh.ends),
    NEUMANN -- open: the edge rows, which are thrown away, see no
    neighbour -- on every other side (smoother_kernels.slab_bc's
    rule)."""
    ends = mesh.ends(periodic)
    lo = (codes_lo[0] if ends[0] else int(SolverBC.NEUMANN),)
    hi = (codes_hi[0] if ends[1] else int(SolverBC.NEUMANN),)
    return lo + tuple(codes_lo[1:]), hi + tuple(codes_hi[1:])


def _slab_sweeps_2d(mesh, x, b, n, want_residual, cells, periodic, kind,
                    level_of):
    """The 2D flux-form sweeps on a slab level (CellSolver and
    NodalSolver._smooth_slab_2d): per call one halo exchange of x and b,
    as deep as the sweeps reach (smoother_kernels.slab_depth, lo even:
    the colours keep the global parity), the sweeps on the extended slab
    with x open (_open_x), the slab's rows kept -- the whole level's rows
    bit for bit.  cells: the level's x cells on this rank;
    level_of(lo, hi): dinv and the apply of the slab extended by (lo,
    hi); kind: the SLAB_2D count."""
    from incflo_torch.ops import smoother_kernels as sk
    rows = x.shape[0]
    res = None
    for k, want in _chunks(n, cells, want_residual):
        if k == 0 and not want:
            continue
        dinv, apply = level_of(*sk.slab_depth(k, want))
        lo, _, xe, be = sk._slab_halo(mesh, x, b, k, want, cells, periodic)
        xe, re = _rb_sweeps(xe, be, dinv, apply, k, want, 2)
        SLAB_2D[kind] += 1
        x = xe.narrow(0, lo, rows)
        res = None if re is None else re.narrow(0, lo, rows)
    return x, res


class _SlabCoefs:
    """A slab level's smoother coefficients extended by the neighbours'
    x planes: exchanged once at the depth the first call needs and again
    only when a call needs more, narrowed for each call.  periodic False:
    the level's x ends in boundaries, and nothing is taken across them
    (SlabMesh.depths)."""

    def __init__(self, mesh, tensors, periodic=True):
        self.mesh, self.base, self.periodic = mesh, tensors, periodic
        self.lo = self.hi = -1
        self.ext = None

    def get(self, lo, hi):
        if lo > self.lo or hi > self.hi:
            self.lo, self.hi = max(lo, self.lo), max(hi, self.hi)
            self.ext = self.mesh.halo_x(self.base, self.lo, self.hi,
                                        periodic=self.periodic)
        # the rows the exchange gave and the call takes (SlabMesh.depths)
        elo, ehi = self.mesh.depths(self.lo, self.hi, self.periodic)
        lo, hi = self.mesh.depths(lo, hi, self.periodic)
        cut = lambda t: t.narrow(0, elo - lo,
                                 t.shape[0] - (elo - lo) - (ehi - hi))
        return [cut(t) for t in self.ext]


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
    ebc: Optional[torch.Tensor] = None     # EB wall coefficient:
                                           # L += beta * ebc * phi
    mesh: object = None                    # parallel.mesh.SlabMesh of a slab


def _cell_ghost(lev: CellLevel, ax, side, bvals=None):
    """The pad function of one side of a walled axis: the ghost of a
    homogeneous Neumann (q0) or maxorder-3 Dirichlet side (-2 q0 + q1/3),
    with face values bvals ((axis, side) -> value) (8/3) b - 2 q0 + q1/3."""
    code = lev.bc_lo[ax] if side == 0 else lev.bc_hi[ax]

    def ghost(x):
        n = x.shape[ax]
        q0 = x.narrow(ax, 0 if side == 0 else n - 1, 1)
        q1 = x.narrow(ax, 1 if side == 0 else n - 2, 1) if n > 1 else q0
        if code == SolverBC.NEUMANN:
            return q0
        if bvals is None:
            return -2.0 * q0 + q1 / 3.0
        bv = bvals.get((ax, side), 0.0)
        return (8.0 / 3.0) * (bv + 0.0 * q0) - 2.0 * q0 + q1 / 3.0
    return ghost


def _cell_pad(x, lev: CellLevel, bvals=None):
    """Pad phi by one ghost per axis with homogeneous solver BCs:
    DIRICHLET uses the maxorder-3 ghost g = -2*phi0 + phi1/3; with
    inhomogeneous Dirichlet face values bvals g = (8/3) b - 2 phi0 +
    phi1/3.  Along x of a slab the neighbours' rows, the ghosts at the
    level's own x faces only (_pad)."""
    for ax in range(len(lev.dx)):
        x = _pad(x, ax, lev.mesh, lev.bc_lo[ax] == SolverBC.PERIODIC,
                 _cell_ghost(lev, ax, 0, bvals),
                 _cell_ghost(lev, ax, 1, bvals))
    return x



def _set_face(flux, axis, idx, val):
    out = flux.clone()
    n = out.shape[axis]
    out.narrow(axis, idx % n, 1).fill_(val)
    return out


def _fluxes_of_padded(xp, lev: CellLevel, xfaces=None):
    """b*grad of the padded xp on the n+1 faces of every axis.  xfaces:
    the x face coefficients as each cell's low and high face, two cell
    arrays (an extended slab, CellSolver._smooth_slab_2d, whose face at
    the level's periodic wrap is face 0 for one cell and face n for the
    other); the x fluxes are then each cell's (low, high) pair, the same
    products of the same values."""
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
        if ax == 0 and xfaces is not None:
            n = grad.shape[0] - 1
            flo = xfaces[0] * grad.narrow(0, 0, n)
            fhi = xfaces[1] * grad.narrow(0, 1, n)
            if _side_bc(lev, ax, 0) == SolverBC.NEUMANN:
                flo = _set_face(flo, ax, 0, 0.0)
            if _side_bc(lev, ax, 1) == SolverBC.NEUMANN:
                fhi = _set_face(fhi, ax, -1, 0.0)
            fluxes.append((flo, fhi))
            continue
        flux = lev.bcoef[ax] * grad
        if _side_bc(lev, ax, 0) == SolverBC.NEUMANN:
            flux = _set_face(flux, ax, 0, 0.0)
        if _side_bc(lev, ax, 1) == SolverBC.NEUMANN:
            flux = _set_face(flux, ax, -1, 0.0)
        fluxes.append(flux)
    return fluxes


def cell_fluxes_inhom(x, lev: CellLevel, bvals):
    """b*grad(x) on all faces with inhomogeneous Dirichlet values."""
    return _fluxes_of_padded(_cell_pad(x, lev, bvals), lev)


def cell_fluxes(x, lev: CellLevel):
    """b*grad(x) on the n+1 faces of every axis (homogeneous BCs): the
    discrete fluxes the operator divergences, and the MAC-projection
    velocity correction."""
    return _fluxes_of_padded(_cell_pad(x, lev), lev)


def _apply_from_fluxes(x, lev: CellLevel, fluxes):
    out = lev.alpha * (lev.acoef * x if lev.acoef is not None else 0.0 * x)
    if lev.ebc is not None:
        out = out + lev.beta * lev.ebc * x
    for ax, flux in enumerate(fluxes):
        dxi = 1.0 / lev.dx[ax]
        if isinstance(flux, tuple):         # each cell's (low, high) face
            div = (flux[1] - flux[0]) * dxi
        else:
            n = flux.shape[ax]
            div = (flux.narrow(ax, 1, n - 1)
                   - flux.narrow(ax, 0, n - 1)) * dxi
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
        lo_bc, hi_bc = _side_bc(lev, ax, 0), _side_bc(lev, ax, 1)
        if lo_bc != SolverBC.PERIODIC:
            c = 0.0 if lo_bc == SolverBC.NEUMANN else 3.0
            clo = _set_face(clo, ax, 0, c)
        if hi_bc != SolverBC.PERIODIC:
            c = 0.0 if hi_bc == SolverBC.NEUMANN else 3.0
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


def _interleave(even, odd, axis):
    st = torch.stack([even, odd], dim=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _prolong_cells(c, lev: CellLevel):
    """(Bi/tri)linear cell-centred prolongation of a correction:
    fine[2i] = 0.75*c[i] + 0.25*c[i-1], fine[2i+1] = 0.75*c[i] + 0.25*c[i+1]
    with ghost = wrap (periodic), edge (Neumann), zero (Dirichlet)."""
    for ax in range(len(lev.dx)):
        ends = []
        for side, code in ((0, lev.bc_lo[ax]), (1, lev.bc_hi[ax])):
            k = 0 if side == 0 else -1
            ends.append((lambda x, k=k, ax=ax: x.narrow(
                ax, k % x.shape[ax], 1))
                if code == SolverBC.NEUMANN else _zero_rows(ax))
        cp = _pad(c, ax, lev.mesh, lev.bc_lo[ax] == SolverBC.PERIODIC,
                  *ends)
        n = cp.shape[ax]
        mid = cp.narrow(ax, 1, n - 2)
        even = 0.75 * mid + 0.25 * cp.narrow(ax, 0, n - 2)
        odd = 0.75 * mid + 0.25 * cp.narrow(ax, 2, n - 2)
        c = _interleave(even, odd, ax)
    return c


def _gather_rows(mesh, t, faces=False):
    """The whole level of slab field t on every rank (None stays None)."""
    return None if t is None else mesh.all_gather_x(t, faces)


def _level_maxima(diags, levels):
    """max|diag| of each level: on the slab levels of a mesh the whole
    level's, in one all-reduce; None (the diag's own) elsewhere."""
    out = [None] * len(diags)
    slab = [i for i, l in enumerate(levels) if l.mesh is not None]
    if slab:
        m = torch.stack([torch.max(torch.abs(diags[i])) for i in slab])
        m = levels[slab[0]].mesh.all_reduce_max(m)
        for k, i in enumerate(slab):
            out[i] = m[k]
    return out


def _on_whole(mesh, fn, x, b, want_residual, extra_last=False):
    """fn (a whole-level V-cycle) on the gathered x and b; this rank's
    rows of the iterate and of the residual (extra_last: the nodes of a
    level whose x ends in boundaries, SlabMesh.all_gather_x)."""
    x, r = fn(mesh.all_gather_x(x, extra_last=extra_last),
              mesh.all_gather_x(b, extra_last=extra_last),
              want_residual=want_residual)
    return mesh.slab(x), None if r is None else mesh.slab(r)


class CellSolver:
    """Geometric multigrid (and, for constant coefficients, a direct
    solve) for the cell-centred operator on one grid.

    direct=False skips the search for a constant-coefficient direct
    solve, which reads the coefficients back to the host: the solvers a
    variable-density step builds from its current state pass it, as
    incflo_tpu's are built inside a trace and never find one.

    mesh: acoef, bcoef (and ebc) are rank mesh.rank's x slab of a level
    (nxl + 1 x faces), and the solver runs multigrid on the slab (module
    docstring); it never solves directly."""

    def __init__(self, dx, bc_lo, bc_hi, alpha, beta, acoef, bcoef,
                 max_levels=30, nu1=1, nu2=1, nu_bottom=8, ebc=None,
                 direct=True, mesh=None):
        # V(1,1) + 8 bottom sweeps: CG acceleration tolerates the weaker
        # preconditioner
        ndim = len(dx)
        self.ndim = ndim
        self.nu1, self.nu2, self.nu_bottom = nu1, nu2, nu_bottom
        levels: List[CellLevel] = []
        lev = CellLevel(tuple(dx), tuple(int(b) for b in bc_lo),
                        tuple(int(b) for b in bc_hi), alpha, beta,
                        acoef, tuple(bcoef), ebc, mesh)
        cells = tuple(acoef.shape[:ndim]) if acoef is not None else tuple(
            bcoef[0].shape[ax] - (1 if ax == 0 else 0) for ax in range(ndim))
        if mesh is not None:
            cells = (cells[0] * mesh.size,) + cells[1:]
        shapes = _depths(cells, max_levels)
        self.n_slab = _slab_levels(shapes, mesh, max(nu1, nu2), nu_bottom)
        self._whole = None
        for li in range(len(shapes)):
            if li == self.n_slab:
                # this level and the coarser ones: whole on every rank
                tail = CellSolver(
                    lev.dx, lev.bc_lo, lev.bc_hi, alpha, beta,
                    _gather_rows(mesh, lev.acoef),
                    tuple(_gather_rows(mesh, b, faces=ax == 0)
                          for ax, b in enumerate(lev.bcoef)),
                    len(shapes) - li, nu1, nu2, nu_bottom,
                    _gather_rows(mesh, lev.ebc), direct=False)
                if li == 0:
                    self._whole = tail
                    levels.append(lev)
                else:
                    levels.extend(tail.levels)
                break
            levels.append(lev)
            if li + 1 < len(shapes):
                lev = CellLevel(
                    tuple(d * 2 for d in lev.dx), lev.bc_lo, lev.bc_hi,
                    lev.alpha, lev.beta,
                    _coarsen_cells(lev.acoef, ndim)
                    if lev.acoef is not None else None,
                    tuple(_coarsen_face(lev.bcoef[ax], ax, ndim)
                          for ax in range(ndim)),
                    # ebc ~ area/volume: the EB area is kept under
                    # coarsening, so the coefficient halves per level
                    0.5 * _coarsen_cells(lev.ebc, ndim)
                    if lev.ebc is not None else None, mesh)
        self.levels = levels
        self.diags = [cell_diag(l) for l in levels]
        self._coefs = None
        self._ext = {}
        self.singular = (alpha == 0.0) and (ebc is None) and all(
            b != SolverBC.DIRICHLET for b in list(bc_lo) + list(bc_hi))
        self.symbol = None
        if direct and mesh is None:
            from incflo_torch.ops import spectral
            self.symbol = spectral.cell_symbol(levels[0])

    @property
    def mesh(self):
        return self.levels[0].mesh

    def smoother_coefs(self):
        """(dinvs, fhis, fwalls): per level, what the smoother kernel
        reads beside diag -- the guarded reciprocal of the diagonal (from
        its global max, with the EB wall term included, so it is taken
        once per hierarchy and not in every call; on a mesh the slab
        levels' maxima in one all-reduce), the cell-shaped
        high-face coefficients scaled by
        beta/dx^2 (faces 1..n of each axis: on a walled axis the last is
        the high wall face) and, per walled axis, the low wall face
        (face 0, which the wrap of a periodic axis finds at face n) as a
        plane of extent 1, else None; a level with the EB wall term
        passes face 0 of its periodic axes too, whose coefficients differ
        from face n's (the viscosity at the face centroids of the two
        ends), so that the kernel applies cell_apply's operator.
        cell_diag's factor 3 of a Dirichlet wall and the smoother's
        one-third term are taken from this same face coefficient on every
        level.  Built at the first
        smooth: a solver that only ever solves directly never pays for
        them."""
        if self._coefs is None:
            from incflo_torch.ops import smoother_kernels as sk
            dmax = _level_maxima(self.diags, self.levels)
            dinvs = [sk.guarded_reciprocal(d, m)
                     for d, m in zip(self.diags, dmax)]
            if self.ndim != 3:       # the plain 2D sweep reads dinv alone
                self._coefs = (dinvs, None, None)
                return self._coefs
            fhis, fwalls = [], []
            for lev, diag in zip(self.levels, self.diags):
                fh, fw = [], []
                for ax in range(3):
                    b = lev.bcoef[ax]
                    scale = lev.beta / (lev.dx[ax] * lev.dx[ax])
                    hi = scale * b.narrow(ax, 1, b.shape[ax] - 1)
                    fh.append(hi.expand_as(diag).contiguous())
                    if lev.bc_lo[ax] == SolverBC.PERIODIC and lev.ebc is None:
                        fw.append(None)
                    else:
                        lo = scale * b.narrow(ax, 0, 1)
                        fw.append(lo.expand_as(diag.narrow(ax, 0, 1))
                                  .contiguous())
                fhis.append(tuple(fh))
                fwalls.append(tuple(fw))
            self._coefs = (dinvs, fhis, fwalls)
        return self._coefs

    def to(self, device) -> "CellSolver":
        out = copy.copy(self)
        out.levels = [_move(l, device) for l in self.levels]
        out.diags, out._coefs, out.symbol = _move(
            [self.diags, self._coefs, self.symbol], device)
        out._ext = {}
        if self._whole is not None:
            out._whole = self._whole.to(device)
        return out

    def shard(self, mesh) -> "CellSolver":
        """This whole-level solver cut to the rank's x slab: the fine
        level's coefficients on the slab's cells and faces (nxl + 1 x
        faces).  A direct solver keeps the symbol's x transforms on the
        slab's columns; any other, and one whose symbol is the rfftn form
        (spectral.shard_symbol), runs multigrid on the slab."""
        from incflo_torch.ops import spectral
        lev = self.levels[0]
        nxl = (lev.bcoef[0].shape[0] - 1) // mesh.size   # nx + 1 x faces
        x0 = mesh.rank * nxl
        rows = lambda a, n: None if a is None else a.narrow(0, x0, n)
        acoef, ebc = rows(lev.acoef, nxl), rows(lev.ebc, nxl)
        bcoef = tuple(rows(b, nxl + (1 if ax == 0 else 0))
                      for ax, b in enumerate(lev.bcoef))
        sym = None if self.symbol is None \
            else spectral.shard_symbol(self.symbol, mesh)
        if sym is None:
            return CellSolver(lev.dx, lev.bc_lo, lev.bc_hi, lev.alpha,
                              lev.beta, acoef, bcoef, nu1=self.nu1,
                              nu2=self.nu2, nu_bottom=self.nu_bottom,
                              ebc=ebc, direct=False, mesh=mesh)
        local = dataclasses.replace(lev, acoef=acoef, bcoef=bcoef, mesh=mesh)
        out = copy.copy(self)
        out.levels = [local]
        out.diags = [cell_diag(local)]
        out._coefs = None
        out._ext = {}
        out.symbol = sym
        return out

    def with_beta(self, beta):
        """Same coefficient hierarchy, new beta scalar (beta = dt per
        step); only the beta-scaled diagonals are recomputed here, and
        the smoother's coefficients when a smooth next needs them."""
        out = copy.copy(self)
        out.levels = [dataclasses.replace(l, beta=beta) for l in self.levels]
        out.diags = []
        for l_old, d_old in zip(self.levels, self.diags):
            base = l_old.alpha * (l_old.acoef if l_old.acoef is not None
                                  else 0.0)
            faceparts = (d_old - base) / l_old.beta
            out.diags.append(base + beta * faceparts)
        out._coefs = None
        out._ext = {}
        if self._whole is not None:
            out._whole = self._whole.with_beta(beta)
        return out

    # -- smoother and V-cycle ------------------------------------------
    def _smooth_res(self, x, b, li, n, want_residual):
        """n red-black sweeps (+ the residual b - L(x)) on level li: a 3D
        level in the kernel's diag-extracted form on either device, the
        EB wall term folded into diag, a slab level through the slab form
        (in calls whose halo fits the neighbours' slabs); a 2D level in
        incflo_tpu's flux form (multigrid.py:425-451), on either
        device."""
        from incflo_torch.ops import smoother_kernels as sk
        dinvs, fhis, fwalls = self.smoother_coefs()
        lev = self.levels[li]
        if self.ndim != 3:
            if lev.mesh is not None:
                return self._smooth_slab_2d(x, b, li, n, want_residual)
            return _rb_sweeps(x, b, dinvs[li], lambda v: cell_apply(v, lev),
                              n, want_residual, self.ndim)
        bc = (lev.bc_lo, lev.bc_hi)
        if lev.mesh is None:
            return sk.cell_smooth(x, b, self.diags[li], dinvs[li], fhis[li],
                                  n, want_residual, bc=bc, Fwall=fwalls[li])
        periodic = lev.bc_lo[0] == SolverBC.PERIODIC
        if li not in self._ext:
            planes = [w for w in fwalls[li][1:] if w is not None]
            self._ext[li] = _SlabCoefs(lev.mesh, [self.diags[li], dinvs[li],
                                                  *fhis[li], *planes],
                                       periodic)
        # the level's low x wall face: the first rank's face 0
        xwall = fwalls[li][0] if lev.mesh.ends(periodic)[0] else None
        xwrap = self._xwrap(li) if periodic and fwalls[li][0] is not None \
            else None
        res = None
        for k, want in _chunks(n, x.shape[0], want_residual):
            ext = self._ext[li].get(*sk.slab_depth(k, want))
            planes = iter(ext[5:])
            fw = (xwall,) + tuple(None if w is None else next(planes)
                                  for w in fwalls[li][1:])
            x, res = sk.cell_smooth_slab(lev.mesh, x, b, ext[0], ext[1],
                                         ext[2:5], k, want, bc=bc, Fwall=fw,
                                         xwrap=xwrap)
        return x, res

    def _smooth_slab_2d(self, x, b, li, n, want_residual):
        """The 2D flux-form sweeps on slab level li (_slab_sweeps_2d).
        The coefficients come extended by the neighbours' rows once a
        hierarchy and depth (_SlabCoefs): dinv, the x faces as each
        cell's low and high face (at a periodic wrap face 0 and face n
        differ on the EB wall term's levels), the y faces, acoef and
        ebc."""
        lev = self.levels[li]
        mesh = lev.mesh
        periodic = lev.bc_lo[0] == SolverBC.PERIODIC
        key = ("2d", li)
        if key not in self._ext:
            bx = lev.bcoef[0]
            m = bx.shape[0] - 1
            self._ext[key] = _SlabCoefs(mesh, [
                self.smoother_coefs()[0][li], bx.narrow(0, 0, m),
                bx.narrow(0, 1, m), lev.bcoef[1],
                *(t for t in (lev.acoef, lev.ebc) if t is not None)],
                periodic)
        bc_lo, bc_hi = _open_x(lev.bc_lo, lev.bc_hi, mesh, periodic)

        def level_of(lo, hi):
            # dinv, the x faces (low, high), the y faces, [acoef], [ebc]
            ext = self._ext[key].get(lo, hi)
            rest = iter(ext[4:])
            elev = dataclasses.replace(
                lev, bc_lo=bc_lo, bc_hi=bc_hi,
                acoef=None if lev.acoef is None else next(rest),
                bcoef=(None, ext[3]),
                ebc=None if lev.ebc is None else next(rest), mesh=None)
            return ext[0], lambda v: _apply_from_fluxes(
                v, elev, _fluxes_of_padded(_cell_pad(v, elev), elev,
                                           (ext[1], ext[2])))
        return _slab_sweeps_2d(mesh, x, b, n, want_residual, x.shape[0],
                               periodic, "cell", level_of)

    def _xwrap(self, li):
        """The x wrap plane of slab level li (a periodic x whose face 0
        differs from face n: the EB wall term's levels): the level's face
        0, the first rank's own and the last rank's from its right
        neighbour, the first rank (one exchange a hierarchy, every rank
        in it)."""
        key = ("xwrap", li)
        if key not in self._ext:
            mesh = self.levels[li].mesh
            w = self.smoother_coefs()[2][li][0]
            self._ext[key] = mesh.halo_x(w, 0, 1).narrow(
                0, 0 if mesh.rank == 0 else 1, 1).contiguous()
        return self._ext[key]

    def _smooth(self, x, b, li, n):
        return self._smooth_res(x, b, li, n, False)[0]

    def _vcycle(self, x, b, li=0, want_residual=False):
        if self._whole is not None:
            return _on_whole(self.mesh, self._whole._vcycle, x, b,
                             want_residual)
        if li == len(self.levels) - 1:
            return self._smooth_res(x, b, li, self.nu_bottom, want_residual)
        x, r = self._smooth_res(x, b, li, self.nu1, True)
        rc = _coarsen_cells(r, self.ndim)
        mesh = self.levels[li].mesh if li + 1 == self.n_slab else None
        if mesh is not None:          # the coarser levels: whole
            rc = mesh.all_gather_x(rc)
        ec, _ = self._vcycle(torch.zeros_like(rc), rc, li + 1)
        e = _prolong_cells(ec, self.levels[li + 1])
        x = x + (e if mesh is None else mesh.slab(e))
        return self._smooth_res(x, b, li, self.nu2, want_residual)

    def solve_info(self, rhs, x0=None, rtol=1e-11, atol=1e-14, maxiter=200,
                   presmooth=0):
        """(x, resnorm, iters) with L x = rhs.  Constant-coefficient
        operators are solved directly (iters = 1, resnorm not computed).
        Otherwise V-cycle-preconditioned conjugate gradients from x0,
        ended by the tolerance max(rtol*|rhs|, atol) on the max-norm
        residual, by maxiter, or by stagnation (5 iterations without
        improving the best residual: the floor of the working precision);
        the best iterate is returned.  presmooth > 0 runs that many
        fine-level sweeps first and skips the CG when they already reach
        the tolerance (the diagonally dominant Helmholtz solves from a
        warm start).  Each loop test reads one bool back to the host."""
        lev = self.levels[0]
        mesh = lev.mesh
        if self._whole is not None:
            xw = None if x0 is None else mesh.all_gather_x(x0)
            x, res, it = self._whole.solve_info(
                mesh.all_gather_x(rhs), xw, rtol, atol, maxiter, presmooth)
            return mesh.slab(x), res, it
        if self.singular:
            rhs = rhs - _mean(rhs, mesh)
        sym = self.symbol
        if (sym is not None
                and tuple(rhs.shape[:self.ndim]) == sym.cells
                and (rhs.dim() > self.ndim or not sym.batched)):
            from incflo_torch.ops import spectral
            x = spectral.solve(sym, rhs, lev.alpha, lev.beta, self.singular)
            return x, torch.zeros((), dtype=rhs.dtype, device=rhs.device), 1
        if x0 is None:
            x0 = torch.zeros_like(rhs)
        tol = torch.clamp_min(rtol * _maxnorm(rhs, mesh), atol)
        r0 = rhs - cell_apply(x0, lev)
        res0 = _maxnorm(r0, mesh)
        if presmooth > 0 and host_bool(res0 > tol):
            x0 = self._smooth(x0, rhs, 0, presmooth)
            r0 = rhs - cell_apply(x0, lev)
            res0 = _maxnorm(r0, mesh)
        x, res, it = x0, res0, 0
        if host_bool(res0 > tol):
            COUNTS["cell_solves"] += 1
            r = r0
            p, _ = self._vcycle(torch.zeros_like(r0), r0)
            rz = _dot(r0, p, mesh)
            # CG's max-norm residual is non-monotone: track the best
            # iterate and stop only after several non-improving iterations
            xb, rb = x0, res0
            bad = torch.zeros((), dtype=torch.int32, device=rhs.device)
            while it < maxiter and host_bool((rb > tol) & (bad < 5)):
                Ap = cell_apply(p, lev)
                denom = _dot(p, Ap, mesh)
                a = rz / torch.where(denom == 0, 1.0, denom)
                x = x + a * p
                r = r - a * Ap
                z, _ = self._vcycle(torch.zeros_like(r), r)
                rz_new = _dot(r, z, mesh)
                p = z + (rz_new / torch.where(rz == 0, 1.0, rz)) * p
                rz = rz_new
                new_res = _maxnorm(r, mesh)
                improved = new_res < 0.999 * rb
                xb = torch.where(improved, x, xb)
                rb = torch.minimum(rb, new_res)
                bad = torch.where(improved, 0, bad + 1)
                it += 1
            COUNTS["cell_iters"] += it
            x, res = xb, rb
            if CELL_LOG is not None:
                CELL_LOG.append((res, tol, it, maxiter))
        if self.singular:
            x = x - _mean(x, mesh)
        return x, res, it

    def solve(self, rhs, **kw):
        """x of solve_info."""
        return self.solve_info(rhs, **kw)[0]

    def solve_inhom(self, rhs, bvals, **kw):
        """Solve with inhomogeneous Dirichlet face values `bvals`
        ((axis, side) -> value), folded into the RHS."""
        offset = cell_apply_inhom(torch.zeros_like(rhs), self.levels[0],
                                  bvals)
        return self.solve(rhs - offset, **kw)


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
    mesh: object = None                       # SlabMesh of a slab

    def with_stencil(self):
        s = self.sigma
        for ax in range(len(self.dx)):
            s = _pad(s, ax, self.mesh, self.periodic[ax], _zero_rows(ax),
                     _zero_rows(ax))
        return dataclasses.replace(self, sigma=None, sigma_pad=s,
                                   cells=tuple(self.sigma.shape))


def _node_hi_pad(p, lev: NodalLevel, ax):
    """Nodal phi with the node above the array's last cell along ax: the
    wrap of a periodic axis (the right neighbour's first node along x of
    a slab); along x of a slab of a level whose x ends in boundaries the
    right neighbour's first node, which the last rank holds itself."""
    if lev.periodic[ax] or _on_slab_x(ax, lev.mesh, lev.periodic[ax]):
        return _pad(p, ax, lev.mesh, lev.periodic[ax], None, None, 0, 1)
    return p


def _node_to_cellgrad(phi, lev: NodalLevel, axis):
    """G_axis: gradient at cell centres from nodal phi (average of the
    2^(D-1) node-pair differences / dx)."""
    ndim = len(lev.dx)
    p = phi
    for ax in range(ndim):
        p = _node_hi_pad(p, lev, ax)
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
    """Drop the duplicated high node on periodic axes, and along x of a
    slab the node the right neighbour holds (all but the last rank of a
    level whose x ends in boundaries)."""
    for ax in range(len(lev.dx)):
        if lev.periodic[ax] or (_on_slab_x(ax, lev.mesh, False)
                                and not lev.mesh.ends(False)[1]):
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
    """Rows of Dirichlet boundary nodes become identity (phi itself);
    along x of a slab on the ranks that hold the level's x faces."""
    for ax in range(len(lev.dx)):
        if lev.periodic[ax]:
            continue
        if _side_bc(lev, ax, 0) == SolverBC.DIRICHLET:
            src = (identity_from.narrow(ax, 0, 1)
                   if identity_from is not None else 0.0)
            nodal = _set_slab(nodal, ax, 0, src)
        if _side_bc(lev, ax, 1) == SolverBC.DIRICHLET:
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
        p = _node_hi_pad(p, lev, ax)
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
                bp = _wrap_pad(b, ax, lo=1, hi=0, mesh=lev.mesh)
                new[key] = a + bp.narrow(ax, 0, m)
            elif _on_slab_x(ax, lev.mesh, False):
                # node i takes a(i) + b(i - 1): b of the left neighbour's
                # last cell, zero beyond the level's faces
                bp = _pad(b, ax, lev.mesh, False, _zero_rows(ax), None,
                          1, 0)
                if lev.mesh.ends(False)[1]:
                    new[key] = _zero_pad(a, ax, 0, 1) + bp
                else:
                    new[key] = a + bp.narrow(ax, 0, m)
            else:
                ap = _zero_pad(a, ax)
                bp = _zero_pad(b, ax)
                new[key] = ap.narrow(ax, 1, m + 1) + bp.narrow(ax, 0, m + 1)
        t = new
    return _apply_dirichlet_mask(t[()], lev, identity_from=phi)


def _nodal_weight0(lev: NodalLevel) -> float:
    """Q1 stencil weight of the node itself (Delta = 0):
    -(1/V) sum_d (1/h_d) prod_{d' != d} (h_d'/3)."""
    ndim = len(lev.dx)
    vol = 1.0
    for d in lev.dx:
        vol *= d
    w = 0.0
    for d in range(ndim):
        term = 1.0 / lev.dx[d]
        for dp in range(ndim):
            if dp != d:
                term *= lev.dx[dp] / 3.0
        w += term
    return -w / vol


def nodal_diag(lev: NodalLevel):
    """diag(L): the Delta = 0 stencil coefficient times the box-sum of the
    2^D sigmas around the node; 1 on Dirichlet rows."""
    ndim = len(lev.dx)
    s0 = lev.sigma_pad
    for ax in range(ndim):
        n_nodes = lev.cells[ax] + 1
        s0 = s0.narrow(ax, 0, n_nodes) + s0.narrow(ax, 1, n_nodes)
    s0 = _nodes_unique(s0, lev)
    d = _nodal_weight0(lev) * s0
    return _apply_dirichlet_mask(d, lev, identity_from=torch.ones_like(d))


def _restrict_nodal(r, lev_f: NodalLevel):
    """Full weighting (1/4, 1/2, 1/4)^D onto coincident coarse nodes."""
    for ax in range(len(lev_f.dx)):
        rp = _pad(r, ax, lev_f.mesh, lev_f.periodic[ax], _zero_rows(ax),
                  _zero_rows(ax))
        n = rp.shape[ax]
        fw = (0.25 * rp.narrow(ax, 0, n - 2) + 0.5 * rp.narrow(ax, 1, n - 2)
              + 0.25 * rp.narrow(ax, 2, n - 2))
        r = _slice_axis(fw, ax, slice(0, fw.shape[ax], 2))
    return r


def _prolong_nodal(c, lev_f: NodalLevel):
    """Linear nodal prolongation: even fine nodes copy, odd average."""
    for ax in range(len(lev_f.dx)):
        n = c.shape[ax]
        # the node above the last: the wrap, or the right neighbour's
        # (every rank of a slab takes part in the exchange)
        cp = _node_hi_pad(c, lev_f, ax)
        if cp.shape[ax] > n:
            even = cp.narrow(ax, 0, n)
            odd = 0.5 * (cp.narrow(ax, 0, n) + cp.narrow(ax, 1, n))
            c = _interleave(even, odd, ax)
        else:
            odd = 0.5 * (c.narrow(ax, 0, n - 1) + c.narrow(ax, 1, n - 1))
            body = _interleave(c.narrow(ax, 0, n - 1), odd, ax)
            c = torch.cat([body, c.narrow(ax, n - 1, 1)], dim=ax)
    return c


class NodalSolver:
    """Geometric multigrid (and, for constant sigma, a direct solve) for
    the nodal sigma-Poisson system.  direct=False as for CellSolver;
    mesh: sigma is rank mesh.rank's x slab of a level, and the solver
    runs multigrid on the slab, as CellSolver's (the nodes of an x that
    ends in boundaries: nxl + 1 rows on the last rank)."""

    def __init__(self, dx, periodic, bc_lo, bc_hi, sigma, max_levels=30,
                 nu1=2, nu2=2, nu_bottom=24, direct=True, mesh=None):
        ndim = len(dx)
        self.ndim = ndim
        self.nu1, self.nu2, self.nu_bottom = nu1, nu2, nu_bottom
        levels: List[NodalLevel] = []
        sigmas = []
        lev = NodalLevel(tuple(dx), tuple(periodic),
                         tuple(int(b) for b in bc_lo),
                         tuple(int(b) for b in bc_hi), sigma, mesh=mesh)
        cells = tuple(sigma.shape)
        if mesh is not None:
            cells = (cells[0] * mesh.size,) + cells[1:]
        shapes = _depths(cells, max_levels)
        self.n_slab = _slab_levels(shapes, mesh, max(nu1, nu2), nu_bottom)
        self._whole = None
        tail = None
        for li in range(len(shapes)):
            if li == self.n_slab:
                # this level and the coarser ones: whole on every rank
                tail = NodalSolver(lev.dx, lev.periodic, lev.bc_lo,
                                   lev.bc_hi, mesh.all_gather_x(lev.sigma),
                                   len(shapes) - li, nu1, nu2, nu_bottom,
                                   direct=False)
                if li == 0:
                    self._whole = tail
                break
            levels.append(lev.with_stencil())
            sigmas.append(lev.sigma.contiguous())
            if li + 1 < len(shapes):
                lev = NodalLevel(tuple(d * 2 for d in lev.dx), lev.periodic,
                                 lev.bc_lo, lev.bc_hi,
                                 _coarsen_cells(lev.sigma, ndim), mesh=mesh)
        if self._whole is not None:     # the fine slab, for the operators
            levels.append(lev.with_stencil())
            sigmas.append(lev.sigma.contiguous())
        self.levels = levels
        self.sigmas = sigmas    # interior (unpadded) sigma of each level
        self.diags = [nodal_diag(l) for l in levels]
        # guarded: nodes surrounded by (near-)zero sigma get no update
        from incflo_torch.ops import smoother_kernels as sk
        self.dinvs = [sk.guarded_reciprocal(d, m) for d, m in zip(
            self.diags, _level_maxima(self.diags, levels))]
        if tail is not None and self._whole is None:
            self.levels += tail.levels
            self.sigmas += tail.sigmas
            self.diags += tail.diags
            self.dinvs += tail.dinvs
        self._ext = {}
        self.singular = all(
            b != SolverBC.DIRICHLET for b in list(bc_lo) + list(bc_hi))
        self.symbol = None
        if direct and mesh is None:
            from incflo_torch.ops import spectral
            self.symbol = spectral.nodal_symbol(levels[0])

    @property
    def mesh(self):
        return self.levels[0].mesh

    def to(self, device) -> "NodalSolver":
        out = copy.copy(self)
        out.levels = [_move(l, device) for l in self.levels]
        out.sigmas, out.diags, out.dinvs, out.symbol = _move(
            [self.sigmas, self.diags, self.dinvs, self.symbol], device)
        out._ext = {}
        if self._whole is not None:
            out._whole = self._whole.to(device)
        return out

    def shard(self, mesh) -> "NodalSolver":
        """This whole-level solver cut to the rank's x slab (its nxl
        unique x nodes): a direct solver keeps the symbol's x transforms
        on the slab's columns (sigma padded by the neighbours' cells);
        any other, and one whose symbol is the rfftn form, runs
        multigrid on the slab."""
        from incflo_torch.ops import spectral
        lev = self.levels[0]
        nxl = lev.cells[0] // mesh.size
        sym = None if self.symbol is None \
            else spectral.shard_symbol(self.symbol, mesh)
        if sym is None:
            return NodalSolver(lev.dx, lev.periodic, lev.bc_lo, lev.bc_hi,
                               self.sigmas[0].narrow(0, mesh.rank * nxl, nxl),
                               nu1=self.nu1, nu2=self.nu2,
                               nu_bottom=self.nu_bottom, direct=False,
                               mesh=mesh)
        local = dataclasses.replace(
            lev, sigma_pad=lev.sigma_pad.narrow(0, mesh.rank * nxl, nxl + 2),
            cells=(nxl,) + tuple(lev.cells[1:]), mesh=mesh)
        out = copy.copy(self)
        out.levels = [local]
        out.sigmas = out.diags = out.dinvs = None
        out._ext = {}
        out.symbol = sym
        return out

    # -- smoother and V-cycle ------------------------------------------
    def _smooth_res(self, x, b, li, n, want_residual):
        """n red-black sweeps (+ the residual b - L(x)) on level li,
        walls included, on either device: a 3D level through the
        `nodal_smooth` kernel (a slab level through its slab form, in
        calls whose halo fits the neighbours' slabs), a 2D level in plain
        PyTorch."""
        lev = self.levels[li]
        if self.ndim != 3:      # incflo_tpu's jnp sweep, multigrid.py:1022
            if lev.mesh is not None:
                return self._smooth_slab_2d(x, b, li, n, want_residual)
            return _rb_sweeps(x, b, self.dinvs[li],
                              lambda v: nodal_apply(v, lev), n,
                              want_residual, self.ndim)
        from incflo_torch.ops import smoother_kernels as sk
        bc = tuple(tuple(SolverBC.PERIODIC if per else code
                         for per, code in zip(lev.periodic, codes))
                   for codes in (lev.bc_lo, lev.bc_hi))
        if lev.mesh is None:
            return sk.nodal_smooth(x, b, self.sigmas[li], self.dinvs[li],
                                   lev.dx, n, want_residual, bc=bc)
        dinvs, sigmas = self._slab_coefs(li)
        res = None
        for k, want in _chunks(n, lev.cells[0], want_residual):
            lo, hi = sk.slab_depth(k, want)
            dinv, = dinvs.get(lo, hi)
            sigma, = sigmas.get(lo, max(hi - 1, 0))
            x, res = sk.nodal_smooth_slab(lev.mesh, x, b, sigma, dinv,
                                          lev.dx, k, want, bc=bc)
        return x, res

    def _slab_coefs(self, li):
        """Slab level li's dinv and sigma, extended by the neighbours'
        rows once a hierarchy and depth (_SlabCoefs)."""
        if li not in self._ext:
            per = self.levels[li].periodic[0]
            mesh = self.levels[li].mesh
            self._ext[li] = (_SlabCoefs(mesh, [self.dinvs[li]], per),
                             _SlabCoefs(mesh, [self.sigmas[li]], per))
        return self._ext[li]

    def _smooth_slab_2d(self, x, b, li, n, want_residual):
        """The 2D nodal sweeps on slab level li (_slab_sweeps_2d): the
        extended slab's nodes lo + rows + hi, its cells one fewer (sigma
        extended by (lo, hi - 1))."""
        lev = self.levels[li]
        mesh = lev.mesh
        per = lev.periodic[0]
        dinvs, sigmas = self._slab_coefs(li)

        def level_of(lo, hi):
            key = ("2d", li, lo, hi)
            if key not in self._ext:
                bc_lo, bc_hi = _open_x(lev.bc_lo, lev.bc_hi, mesh, per)
                self._ext[key] = NodalLevel(
                    lev.dx, (False,) + lev.periodic[1:], bc_lo, bc_hi,
                    sigmas.get(lo, max(hi - 1, 0))[0]).with_stencil()
            elev = self._ext[key]
            return dinvs.get(lo, hi)[0], lambda v: nodal_apply(v, elev)
        return _slab_sweeps_2d(mesh, x, b, n, want_residual, lev.cells[0],
                               per, "nodal", level_of)

    def _vcycle(self, x, b, li=0, want_residual=False):
        if self._whole is not None:
            return _on_whole(self.mesh, self._whole._vcycle, x, b,
                             want_residual, not self.levels[0].periodic[0])
        lev = self.levels[li]
        if li == len(self.levels) - 1:
            return self._smooth_res(x, b, li, self.nu_bottom, want_residual)
        x, r = self._smooth_res(x, b, li, self.nu1, True)
        rc = _restrict_nodal(_zero_dirichlet(r, lev), lev)
        mesh = lev.mesh if li + 1 == self.n_slab else None
        if mesh is not None:          # the coarser levels: whole
            rc = mesh.all_gather_x(rc, extra_last=not lev.periodic[0])
        rc = _zero_dirichlet(rc, self.levels[li + 1])
        ec, _ = self._vcycle(torch.zeros_like(rc), rc, li + 1)
        if mesh is None:
            x = x + _prolong_nodal(ec, lev)
        else:
            x = x + mesh.slab(_prolong_nodal(
                ec, dataclasses.replace(lev, mesh=None)))
        return self._smooth_res(x, b, li, self.nu2, want_residual)

    def solve_info(self, rhs, x0=None, rtol=1e-11, atol=1e-14, maxiter=100,
                   dirichlet_vals=None):
        """(x, resnorm, cycles) with L x = rhs.  dirichlet_vals ((axis,
        side) -> node slab) makes those Dirichlet rows inhomogeneous: the
        identity rows converge to the given values (an AMR patch's
        coarse-fine closure; incflo_tpu/ops/multigrid.py:1047-1066; on a
        mesh those of y and z faces, the slab's rows of them, gathered
        whole with rhs where the hierarchy runs whole).
        Constant sigma without them is solved directly (cycles = 1,
        resnorm not computed).  Otherwise V-cycles
        from x0 until the max-norm residual is under max(rtol*|rhs|, atol),
        maxiter is reached, or a cycle gains less than 0.1% (true
        stagnation at the rounding floor: stiff variable-coefficient
        problems legitimately converge at 0.95-0.99 per cycle and must
        not be cut off early).  Each loop test reads one bool back to the
        host."""
        lev = self.levels[0]
        mesh = lev.mesh
        if self._whole is not None:
            extra = not lev.periodic[0]
            xw = None if x0 is None else mesh.all_gather_x(x0,
                                                           extra_last=extra)
            dw = None if dirichlet_vals is None else {
                k: mesh.all_gather_x(v, extra_last=extra)
                for k, v in dirichlet_vals.items()}
            x, res, it = self._whole.solve_info(
                mesh.all_gather_x(rhs, extra_last=extra), xw, rtol, atol,
                maxiter, dw)
            return mesh.slab(x), res, it
        if self.singular:
            rhs = rhs - _mean(rhs, mesh)
        rhs = _zero_dirichlet(rhs, lev)
        for (ax, side), val in (dirichlet_vals or {}).items():
            bc = lev.bc_lo[ax] if side == 0 else lev.bc_hi[ax]
            if not lev.periodic[ax] and bc == SolverBC.DIRICHLET:
                rhs = _set_slab(rhs, ax, 0 if side == 0 else -1, val)
        if (self.symbol is not None and dirichlet_vals is None
                and tuple(rhs.shape) == self.symbol.cells):
            from incflo_torch.ops import spectral
            x = spectral.solve(self.symbol, rhs, 0.0, 1.0, self.singular)
            return x, torch.zeros((), dtype=rhs.dtype, device=rhs.device), 1
        if x0 is None:
            x0 = torch.zeros_like(rhs)
        tol = rtol * _maxnorm(rhs, mesh)
        tol = torch.maximum(tol, atol.to(tol.dtype)) \
            if isinstance(atol, torch.Tensor) else torch.clamp_min(tol, atol)
        x, it = x0, 0
        res = _maxnorm(rhs - nodal_apply(x0, lev), mesh)
        prev = torch.full_like(res, float("inf"))
        while it < maxiter and host_bool((res > tol) & (res < 0.999 * prev)):
            x, r = self._vcycle(x, rhs, want_residual=True)
            prev, res = res, _maxnorm(r, mesh)
            it += 1
        if it:
            COUNTS["nodal_solves"] += 1
            COUNTS["nodal_cycles"] += it
            if NODAL_LOG is not None:
                NODAL_LOG.append((res, tol, it, maxiter))
        if self.singular:
            x = x - _mean(x, mesh)
        return x, res, it

    def solve(self, rhs, **kw):
        """x of solve_info."""
        return self.solve_info(rhs, **kw)[0]

    def grad_at_cells(self, phi):
        """Gradient of nodal phi at cell centres, components last."""
        lev = self.levels[0]
        return torch.stack([_node_to_cellgrad(phi, lev, ax)
                            for ax in range(self.ndim)], dim=-1)


# =====================================================================
# The exact cut-cell nodal operator (embedded boundaries)
# =====================================================================

def eb_nodal_apply(phi, lev: NodalLevel, fine_lev: NodalLevel):
    """The exact octant-weighted cut-cell nodal FEM apply P^T L_fine P:
    the coarse Q1 basis is exact on the 2x lattice under linear nodal
    prolongation P, so the cut-cell weak form equals the regular
    fine-lattice operator with per-octant sigma (sigma_cell x octant
    fluid fraction) between P^T and P; the -1/volume scaling of both
    operators absorbs P^T's 2^D, L_c = R(L_f(P phi))
    (incflo_tpu/ops/multigrid.py:886-904)."""
    yf = nodal_apply(_prolong_nodal(phi, fine_lev), fine_lev)
    # the fine Dirichlet rows carry identity(phi); those equations belong
    # to the coarse boundary rows
    yf = _zero_dirichlet(yf, fine_lev)
    y = _restrict_nodal(yf, fine_lev)
    return _apply_dirichlet_mask(y, lev, identity_from=phi)


def eb_fine_level(sigma, vfrac_oct, lev: NodalLevel) -> NodalLevel:
    """The 2x-refined NodalLevel whose sigma is the octant-weighted cell
    sigma (the integration data of the exact cut-cell operator)."""
    s = sigma
    for ax in range(len(lev.dx)):
        s = torch.repeat_interleave(s, 2, dim=ax)
    return NodalLevel(tuple(d / 2 for d in lev.dx), lev.periodic,
                      lev.bc_lo, lev.bc_hi, s * vfrac_oct).with_stencil()


def eb_nodal_divergence(upads_fine, fine_lev: NodalLevel):
    """The right-hand side consistent with eb_nodal_apply:
    R(D_fine(u_fine))."""
    df = _nodes_unique(nodal_divergence(upads_fine, fine_lev.dx), fine_lev)
    return _restrict_nodal(df, fine_lev)


def _stencil_offsets(ndim):
    return list(itertools.product((-1, 0, 1), repeat=ndim))


def _probe_period(n, periodic):
    """Per-axis comb period: >= 3 so that the neighbours {i-1, i, i+1}
    fall in distinct residue classes; on a periodic axis it divides the
    node count (a colouring consistent with the wrap)."""
    if not periodic:
        return 4
    for p in (4, 3):
        if n % p == 0:
            return p
    return n       # the full per-axis basis (small coarse levels)


def extract_node_stencil(apply_fn, node_shape, periodic, dtype,
                         device="cpu"):
    """The 3^D-point stencil of a linear radius-1 nodal operator, probed
    with per-axis lattice combs: the neighbours of a node span 3
    consecutive residues per axis, so the residue classes modulo a
    period >= 3 tell every neighbour apart.  Returns a (3^D, *nodes)
    float64 numpy array, row k the coefficient of offset
    _stencil_offsets(ndim)[k]: at node j, the response at j to the comb
    of the class of j + offset.  apply_fn takes and returns tensors of
    `dtype` on `device`; the bookkeeping is host numpy."""
    ndim = len(node_shape)
    P = [_probe_period(node_shape[ax], periodic[ax]) for ax in range(ndim)]
    idx = np.indices(node_shape)

    def class_of(pos):
        c = np.zeros(node_shape, np.int64)
        for ax in range(ndim):
            c = c * P[ax] + pos[ax] % P[ax]
        return c

    cid = class_of(idx)
    nclass = int(np.prod(P))
    # the response to every class's comb (zero for a class with no node)
    resp = np.zeros((nclass,) + tuple(node_shape), np.float64)
    for c in range(nclass):
        v = cid == c
        if v.any():
            resp[c] = apply_fn(torch.as_tensor(v, dtype=dtype,
                                               device=device)).cpu().numpy()
    coefs = np.zeros((3 ** ndim,) + tuple(node_shape), np.float64)
    for k, off in enumerate(_stencil_offsets(ndim)):
        # a periodic axis of extent 2 aliases offsets -1 and +1 onto one
        # node: the summed coupling goes to the +1 leg only
        if any(off[ax] == -1 and periodic[ax] and node_shape[ax] == 2
               for ax in range(ndim)):
            continue
        pos = [idx[ax] + off[ax] for ax in range(ndim)]
        valid = np.ones(node_shape, bool)
        for ax in range(ndim):
            if not periodic[ax]:
                valid &= (pos[ax] >= 0) & (pos[ax] < node_shape[ax])
        got = np.take_along_axis(resp, class_of(pos)[None], 0)[0]
        coefs[k] = np.where(valid, got, 0.0)
    return coefs


@dataclasses.dataclass(frozen=True)
class StencilNodalLevel:
    dx: Tuple[float, ...]
    periodic: Tuple[bool, ...]
    bc_lo: Tuple[int, ...]
    bc_hi: Tuple[int, ...]
    cells: Tuple[int, ...]
    coefs: torch.Tensor        # (3^D, *node_shape)
    index: torch.Tensor        # (3^D, nodes): stencil_index of the nodes

    def meta_lev(self) -> NodalLevel:
        """The sigma-free NodalLevel of the transfer and BC helpers."""
        return NodalLevel(self.dx, self.periodic, self.bc_lo, self.bc_hi,
                          None, None, self.cells)


def stencil_index(node_shape, periodic, device=None) -> torch.Tensor:
    """(3^D, nodes) flat indices of each node's neighbour at each offset
    of _stencil_offsets: wrapped on periodic axes, and N (one past the
    last node, where stencil_nodal_apply keeps a zero) outside the
    domain."""
    ndim = len(node_shape)
    n = int(np.prod(node_shape))
    idx = np.indices(node_shape).reshape(ndim, -1)
    rows = []
    for off in _stencil_offsets(ndim):
        j = idx + np.asarray(off)[:, None]
        valid = np.ones(n, bool)
        for ax in range(ndim):
            if periodic[ax]:
                j[ax] %= node_shape[ax]
            else:
                valid &= (j[ax] >= 0) & (j[ax] < node_shape[ax])
                j[ax] = np.clip(j[ax], 0, node_shape[ax] - 1)
        lin = np.ravel_multi_index(tuple(j), node_shape)
        rows.append(np.where(valid, lin, n))
    return torch.as_tensor(np.stack(rows), device=device)


def stencil_nodal_apply(phi, st: StencilNodalLevel):
    """y[i] = sum_o coefs_o[i] * phi[i+o]: wrap on periodic axes, a zero
    neighbour outside the domain (the boundary rows' coefficients encode
    the BC, Dirichlet identity rows included).  One gather of the 3^D
    neighbours (st.index), a product and a sum over the offsets: three
    operations where a loop over the offsets takes 2 x 3^D (the sum's
    order rounds differently, within 1e-14 of the loop's)."""
    flat = torch.cat([phi.reshape(-1), phi.new_zeros(1)])
    nb = st.coefs.shape[0]
    return (st.coefs.reshape(nb, -1) * flat[st.index]).sum(0).reshape(
        phi.shape)


class EBNodalSolver:
    """Geometric multigrid on the precomputed cut-cell nodal stencils
    (incflo_tpu/ops/multigrid.py:1213-1330), plain PyTorch on either
    device.  The finest stencil is probed from eb_nodal_apply, each
    coarser one is the Galerkin product R L P of the level above, which
    stays 3^D-point under linear prolongation and full weighting.  Built
    once per geometry on the host, in hat form (sigma = 1/rho0; the
    in-step operator is dt times it), on the device of `sigma`: the
    probes apply the operator there, the bookkeeping is host numpy.
    solve() has NodalSolver's stopping rule."""

    def __init__(self, dx, periodic, bc_lo, bc_hi, sigma, vfrac_oct,
                 max_levels=30, nu1=2, nu2=2, nu_bottom=40):
        ndim = len(dx)
        self.ndim = ndim
        self.nu1, self.nu2, self.nu_bottom = nu1, nu2, nu_bottom
        periodic = tuple(bool(p) for p in periodic)
        bc_lo = tuple(int(b) for b in bc_lo)
        bc_hi = tuple(int(b) for b in bc_hi)
        dtype, device = sigma.dtype, sigma.device
        cells = tuple(sigma.shape)
        meta0 = NodalLevel(tuple(dx), periodic, bc_lo, bc_hi, None, None,
                           cells)
        flev = eb_fine_level(sigma, vfrac_oct, meta0)
        node_shape = tuple(c if periodic[ax] else c + 1
                           for ax, c in enumerate(cells))
        c0 = extract_node_stencil(lambda v: eb_nodal_apply(v, meta0, flev),
                                  node_shape, periodic, dtype, device)
        levels = [StencilNodalLevel(
            tuple(dx), periodic, bc_lo, bc_hi, cells,
            torch.as_tensor(c0, dtype=dtype, device=device),
            stencil_index(node_shape, periodic, device))]
        while (len(levels) < max_levels
               and all(n % 2 == 0 and n >= 4 for n in cells)):
            cells = tuple(n // 2 for n in cells)
            prev = levels[-1]
            meta_c = NodalLevel(tuple(d * 2 for d in prev.dx), periodic,
                                bc_lo, bc_hi, None, None, cells)
            meta_f = prev.meta_lev()

            def rap(v, prev=prev, meta_c=meta_c, meta_f=meta_f):
                y = stencil_nodal_apply(_prolong_nodal(v, meta_f), prev)
                y = _zero_dirichlet(y, meta_f)
                return _apply_dirichlet_mask(_restrict_nodal(y, meta_f),
                                             meta_c, identity_from=v)

            nsh = tuple(c if periodic[ax] else c + 1
                        for ax, c in enumerate(cells))
            cc = extract_node_stencil(rap, nsh, periodic, dtype, device)
            levels.append(StencilNodalLevel(
                meta_c.dx, periodic, bc_lo, bc_hi, cells,
                torch.as_tensor(cc, dtype=dtype, device=device),
                stencil_index(nsh, periodic, device)))
        self.levels = levels
        from incflo_torch.ops import smoother_kernels as sk
        center = _stencil_offsets(ndim).index((0,) * ndim)
        self.dinvs = [sk.guarded_reciprocal(st.coefs[center])
                      for st in levels]
        self.singular = all(
            b != SolverBC.DIRICHLET for b in list(bc_lo) + list(bc_hi))
        self._ext = {}          # slab levels' cut stencils (shard)
        self.mesh = None
        self.n_slab = 0

    def to(self, device) -> "EBNodalSolver":
        out = copy.copy(self)
        out.levels = [_move(l, device) for l in self.levels]
        out.dinvs = _move(self.dinvs, device)
        out._ext = {}
        return out

    def shard(self, mesh) -> "EBNodalSolver":
        """This whole-level hierarchy on rank mesh.rank's x slab: every
        rank keeps the whole stencils (built from the same geometry, no
        exchange) and cuts each slab level's coefficients, with the deep
        halo of a call, from them (SlabMesh.cut_x).  The levels whose
        slabs are even and at least as wide as their calls' halos stay
        slabs (_slab_levels, as NodalSolver's); the ones below run whole
        on every rank, the coarse residual gathered (all_gather_x)."""
        out = copy.copy(self)
        out.mesh = mesh
        out.n_slab = _slab_levels([st.cells for st in self.levels], mesh,
                                  max(self.nu1, self.nu2), self.nu_bottom)
        out._ext = {}
        return out

    def _meta(self, li, slab=None):
        """Level li's NodalLevel of the transfers and BC helpers: on a
        slab level (or with slab True) the slab's cells and the mesh."""
        meta = self.levels[li].meta_lev()
        if self.mesh is None or not (li < self.n_slab if slab is None
                                     else slab):
            return meta
        mesh = self.mesh
        cells = (meta.cells[0] // mesh.size,) + tuple(meta.cells[1:])
        return dataclasses.replace(meta, cells=cells, mesh=mesh)

    def _slab_stencil(self, li, lo, hi):
        """(level, dinv) of slab level li extended by (lo, hi) x rows
        (none across the level's own x faces): the whole level's
        coefficients and guarded inverse diagonal cut to those rows
        (SlabMesh.cut_x), the neighbour index of the extended nodes with
        x open (stencil_index, non-periodic along x).  Built once for
        each depth."""
        key = (li, lo, hi)
        if key not in self._ext:
            st = self.levels[li]
            per = st.periodic[0]
            cut = lambda a, axis: self.mesh.cut_x(
                a, lo, hi, layout="node", periodic=per, beyond="none",
                axis=axis).contiguous()
            coefs = cut(st.coefs, 1)
            shape = tuple(coefs.shape[1:])
            ext = dataclasses.replace(
                st, coefs=coefs,
                index=stencil_index(shape, (False,) + st.periodic[1:],
                                    coefs.device))
            self._ext[key] = (ext, cut(self.dinvs[li], 0))
        return self._ext[key]

    def _apply0(self, x):
        """The fine level's operator on x; on a mesh on this rank's rows:
        one halo row a side and the cut stencil, or, where the fine level
        runs whole, on the gathered x."""
        st, mesh = self.levels[0], self.mesh
        if mesh is None:
            return stencil_nodal_apply(x, st)
        per = st.periodic[0]
        if self.n_slab == 0:
            return mesh.slab(stencil_nodal_apply(
                mesh.all_gather_x(x, extra_last=not per), st))
        lo, hi = mesh.depths(1, 1, per)
        ext, _ = self._slab_stencil(0, lo, hi)
        xe = mesh.halo_x(x, 1, periodic=per)
        return stencil_nodal_apply(xe, ext).narrow(0, lo, x.shape[0])

    def _smooth_res(self, x, b, li, n, want_residual):
        """n red-black sweeps (+ the residual) of the 27-point stencil,
        plain PyTorch on either device.  A slab level: per call one halo
        exchange of x and b, deep enough that the extended slab's edge
        planes (x open: no neighbour across) never reach the slab's rows
        (smoother_kernels.slab_depth, lo even: the extended slab starts
        on the global colour parity), the same sweeps on the extended
        slab, the slab's rows kept -- the whole level's rows bit for
        bit."""
        if li >= self.n_slab:
            st = self.levels[li]
            return _rb_sweeps(x, b, self.dinvs[li],
                              lambda v: stencil_nodal_apply(v, st), n,
                              want_residual, self.ndim)
        from incflo_torch.ops import smoother_kernels as sk
        mesh = self.mesh
        per = self.levels[li].periodic[0]
        rows = x.shape[0]
        res = None
        for k, want in _chunks(n, self._meta(li).cells[0], want_residual):
            if k == 0 and not want:
                continue
            depth = sk.slab_depth(k, want)
            lo, hi = mesh.depths(*depth, per)
            if (mesh.rank * self._meta(li).cells[0] - lo) % 2:
                raise ValueError("EB nodal slab sweep off the global colour "
                                 "parity")
            ext, dinv = self._slab_stencil(li, lo, hi)
            xe, be = mesh.halo_x([x, b], *depth, periodic=per)
            xe, re = _rb_sweeps(xe, be, dinv,
                                lambda v: stencil_nodal_apply(v, ext), k,
                                want, self.ndim)
            STENCIL_SLAB["calls"] += 1
            x = xe.narrow(0, lo, rows)
            res = None if re is None else re.narrow(0, lo, rows)
        return x, res

    def _vcycle(self, x, b, want_residual=False):
        if self.mesh is not None and self.n_slab == 0:
            return _on_whole(self.mesh, self._cycle, x, b, want_residual,
                             not self.levels[0].periodic[0])
        return self._cycle(x, b, want_residual=want_residual)

    def _cycle(self, x, b, li=0, want_residual=False):
        """The V-cycle from level li: the slab levels on this rank's rows,
        the levels below whole on every rank."""
        meta = self._meta(li)
        if li == len(self.levels) - 1:
            return self._smooth_res(x, b, li, self.nu_bottom, want_residual)
        x, r = self._smooth_res(x, b, li, self.nu1, True)
        rc = _restrict_nodal(_zero_dirichlet(r, meta), meta)
        gather = li < self.n_slab and li + 1 == self.n_slab
        if gather:                    # the coarser levels: whole
            rc = self.mesh.all_gather_x(rc,
                                        extra_last=not meta.periodic[0])
        rc = _zero_dirichlet(rc, self._meta(li + 1))
        ec, _ = self._cycle(torch.zeros_like(rc), rc, li + 1)
        if gather:
            x = x + self.mesh.slab(_prolong_nodal(
                ec, self.levels[li].meta_lev()))
        else:
            x = x + _prolong_nodal(ec, meta)
        return self._smooth_res(x, b, li, self.nu2, want_residual)

    def solve_info(self, rhs, x0=None, rtol=1e-11, atol=1e-14, maxiter=100):
        """(x, resnorm, cycles): NodalSolver.solve_info's loop and
        tallies on the stencil hierarchy; on a mesh with the whole
        level's norms and means."""
        mesh = self.mesh
        meta = self._meta(0, slab=mesh is not None)
        if self.singular:
            rhs = rhs - _mean(rhs, mesh)
        rhs = _zero_dirichlet(rhs, meta)
        if x0 is None:
            x0 = torch.zeros_like(rhs)
        tol = rtol * _maxnorm(rhs, mesh)
        tol = torch.maximum(tol, atol.to(tol.dtype)) \
            if isinstance(atol, torch.Tensor) else torch.clamp_min(tol, atol)
        x, it = x0, 0
        res = _maxnorm(rhs - self._apply0(x0), mesh)
        prev = torch.full_like(res, float("inf"))
        while it < maxiter and host_bool((res > tol) & (res < 0.999 * prev)):
            x, r = self._vcycle(x, rhs, want_residual=True)
            prev, res = res, _maxnorm(r, mesh)
            it += 1
        if it:
            COUNTS["nodal_solves"] += 1
            COUNTS["nodal_cycles"] += it
            if NODAL_LOG is not None:
                NODAL_LOG.append((res, tol, it, maxiter))
        if self.singular:
            x = x - _mean(x, mesh)
        return x, res, it

    def solve(self, rhs, **kw):
        """x of solve_info."""
        return self.solve_info(rhs, **kw)[0]
