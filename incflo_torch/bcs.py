"""Boundary conditions and functional ghost-cell fill (torch port of
incflo_tpu/bcs.py).

State tensors carry NO ghost cells.  `grow(field, ng, ...)` returns a new
tensor padded by `ng` ghost layers per axis, filled according to the
per-component BC type matrix (reference
src/boundary_conditions/boundary_conditions.cpp:134-345):

  velocity: pressure_in/out -> foextrap | mass_inflow/no_slip -> ext_dir
            slip_wall -> hoextrap tangential + ext_dir normal | periodic -> int_dir
  density : pressure_in/out & no_slip -> foextrap | slip -> hoextrap
            mass_inflow -> ext_dir | periodic -> int_dir
  tracer  : same matrix as density
  force   : periodic -> int_dir, else foextrap
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import numpy as np
import torch

from incflo_torch.grid import Grid
from incflo_torch.parallel.mesh import mesh_of


class BCType(enum.IntEnum):
    """Per-component, per-face ghost fill rule (AMReX BCType analog)."""
    int_dir = 0      # periodic wrap
    ext_dir = 1      # Dirichlet value placed in ghost cells
    foextrap = 2     # first-order extrapolation (copy nearest interior)
    hoextrap = 3     # quadratic extrapolation through 3 interior cells
    reflect_even = 4
    reflect_odd = 5
    # coarse-fine fill: ghosts carry interpolated parent cell data; fills
    # like ext_dir but stencils treat the ghosts as interior cells
    cf_fill = 6


class BCKind(enum.IntEnum):
    """Physical boundary kinds (reference incflo.H:509-512 `BC` enum)."""
    periodic = 0
    pressure_inflow = 1
    pressure_outflow = 2
    mass_inflow = 3
    no_slip_wall = 4
    slip_wall = 5
    undefined = 6


_BC_NAMES = {
    "pressure_inflow": BCKind.pressure_inflow, "pi": BCKind.pressure_inflow,
    "pressure_outflow": BCKind.pressure_outflow, "po": BCKind.pressure_outflow,
    "mass_inflow": BCKind.mass_inflow, "mi": BCKind.mass_inflow,
    "no_slip_wall": BCKind.no_slip_wall, "nsw": BCKind.no_slip_wall,
    "slip_wall": BCKind.slip_wall, "sw": BCKind.slip_wall,
}


def bc_kind_from_string(s: str) -> BCKind:
    return _BC_NAMES.get(s.lower(), BCKind.undefined)


# A BCRec table: int array (ncomp, ndim, 2) of BCType values.
BCRecs = np.ndarray


def make_bcrecs(ncomp: int, ndim: int) -> BCRecs:
    return np.full((ncomp, ndim, 2), int(BCType.int_dir), dtype=np.int32)


def velocity_bcrecs(bc_kind: np.ndarray, ndim: int) -> BCRecs:
    """bc_kind: (ndim, 2) of BCKind (boundary_conditions.cpp:134-205)."""
    rec = make_bcrecs(ndim, ndim)
    for ax in range(ndim):
        for side in range(2):
            k = BCKind(int(bc_kind[ax, side]))
            if k in (BCKind.pressure_inflow, BCKind.pressure_outflow):
                rec[:, ax, side] = BCType.foextrap
            elif k in (BCKind.mass_inflow, BCKind.no_slip_wall):
                rec[:, ax, side] = BCType.ext_dir
            elif k == BCKind.slip_wall:
                rec[:, ax, side] = BCType.hoextrap
                rec[ax, ax, side] = BCType.ext_dir  # normal component
            elif k == BCKind.periodic:
                rec[:, ax, side] = BCType.int_dir
    return rec


def scalar_bcrecs(bc_kind: np.ndarray, ncomp: int, ndim: int) -> BCRecs:
    """Density/tracer matrix (boundary_conditions.cpp:207-308)."""
    rec = make_bcrecs(ncomp, ndim)
    for ax in range(ndim):
        for side in range(2):
            k = BCKind(int(bc_kind[ax, side]))
            if k in (BCKind.pressure_inflow, BCKind.pressure_outflow,
                     BCKind.no_slip_wall):
                rec[:, ax, side] = BCType.foextrap
            elif k == BCKind.slip_wall:
                rec[:, ax, side] = BCType.hoextrap
            elif k == BCKind.mass_inflow:
                rec[:, ax, side] = BCType.ext_dir
            elif k == BCKind.periodic:
                rec[:, ax, side] = BCType.int_dir
    return rec


def force_bcrecs(bc_kind: np.ndarray, ncomp: int, ndim: int) -> BCRecs:
    """Force matrix (boundary_conditions.cpp:310-344)."""
    rec = make_bcrecs(ncomp, ndim)
    for ax in range(ndim):
        for side in range(2):
            k = BCKind(int(bc_kind[ax, side]))
            rec[:, ax, side] = (BCType.int_dir if k == BCKind.periodic
                                else BCType.foextrap)
    return rec


class ExtDirValues:
    """Dirichlet ghost values per face/component, including the probtype
    inflow velocity profiles of the reference's IncfloVelFill functor
    (src/prob/prob_bc.H:43-106)."""

    def __init__(self, grid: Grid, values: np.ndarray, probtype: int = 0):
        # values: (ndim, 2, ncomp) constants per face per component
        self.grid = grid
        self.values = np.asarray(values, dtype=np.float64)
        self.ncomp = self.values.shape[-1]
        self.probtype = probtype

    def _coord(self, axis: int, pads: Sequence[int], dtype,
               device) -> torch.Tensor:
        """Normalized cell-center coordinates ((i+0.5)/n in the root
        domain frame, prob_bc.H:49) along `axis` including the current
        ghost padding, broadcast-shaped for the field layout; on a
        rank's x slab (parallel/mesh.SlabGrid) i is the level's index."""
        n = self.grid.n_cell[axis]
        p = pads[axis]
        dx = self.grid.dx[axis]
        off = self.grid.prob_lo[axis] - self.grid.origin[axis]
        length = self.grid.domain_length[axis]
        i0 = getattr(self.grid, "x0", 0) if axis == 0 else 0
        c = (off + (torch.arange(i0 - p, i0 + n + p, dtype=dtype,
                                 device=device) + 0.5) * dx) / length
        shape = [1] * (self.grid.ndim + 1)
        shape[axis] = -1
        return c.reshape(shape)

    def slab(self, face_ax: int, side: int, comp: int,
             pads: Sequence[int], dtype, g: int = 1,
             device=None) -> torch.Tensor:
        """Value tensor (broadcastable over the ghost block) for one face
        and one component.  `pads` = ghost layers already present per
        axis; profile slabs are constant along the normal, so `g` is
        unused here."""
        v = float(self.values[face_ax, side, comp])
        pt = self.probtype
        ndim = self.grid.ndim
        crd = lambda a: self._coord(a, pads, dtype, device)
        if side == 0 and self._is_vel():
            if pt == 31 and face_ax == 0 and comp == 0:
                y = crd(1)
                return v * 6.0 * y * (1.0 - y)
            if pt == 311 and face_ax == 0 and comp == 0 and ndim == 3:
                z = crd(2)
                return v * 6.0 * z * (1.0 - z)
            if pt == 41 and face_ax == 0 and comp == 0 and ndim == 3:
                z = crd(2)
                return 0.5 * z
            if pt == 32 and face_ax == 1 and comp == 1 and ndim == 3:
                z = crd(2)
                return v * 6.0 * z * (1.0 - z)
            if pt == 322 and face_ax == 1 and comp == 1:
                x = crd(0)
                return v * 6.0 * x * (1.0 - x)
            if pt == 33 and face_ax == 2 and comp == 2 and ndim == 3:
                x = crd(0)
                return v * 6.0 * x * (1.0 - x)
            if pt == 333 and face_ax == 2 and comp == 2 and ndim == 3:
                y = crd(1)
                return v * 6.0 * y * (1.0 - y)
        return torch.tensor(v, dtype=dtype, device=device)

    def _is_vel(self) -> bool:
        return self.ncomp == self.grid.ndim


def slab_bcrecs(bcrecs: BCRecs, grid: Grid) -> BCRecs:
    """bcrecs as the stencils of a rank's x slab read them: int_dir (the
    neighbours' rows, which the ghost fill put there) on an x side that
    is not the level's own x face (Grid.edge), so that the boundary forms
    of the advection schemes act on the level's faces alone."""
    inner = [side for side in range(2)
             if not grid.periodic[0] and not grid.edge(0, side)]
    if not inner:
        return bcrecs
    out = np.array(bcrecs, copy=True)
    for side in inner:
        out[:, 0, side] = int(BCType.int_dir)
    return out


def _take(field, ax, idx_from, idx_to):
    return field.narrow(ax, idx_from, idx_to - idx_from)


def grow(field: torch.Tensor, ng, grid: Grid, bcrecs: BCRecs,
         ext_values: Optional[ExtDirValues] = None) -> torch.Tensor:
    """Pad `field` ((*grid.cell_shape, ncomp)) by ghost layers per axis.

    `ng` is an int or per-axis sequence.  Axes are filled in order (x then
    y then z) so that later axes re-fill the corners of earlier ghosts,
    matching AMReX filcc + physbc-functor order.  On an x slab of a mesh
    (grid.mesh, parallel/mesh.py) the x ghosts come from the neighbouring
    ranks (SlabMesh.halo_x), but beyond the level's own x faces (an end
    rank of a level whose x is not periodic, SlabGrid.x_edge), whose
    ghosts take the physical fill."""
    ndim = grid.ndim
    assert field.dim() == ndim + 1, "grow() expects a trailing component axis"
    ncomp = field.shape[-1]
    ngs = [ng] * ndim if np.isscalar(ng) else list(ng)
    pads = [0] * ndim

    mesh = mesh_of(grid)
    for ax in range(ndim):
        g = ngs[ax]
        if g == 0:
            continue
        if grid.periodic[ax] and not (ax == 0 and mesh is not None):
            n = field.shape[ax]
            field = torch.cat([_take(field, ax, n - g, n), field,
                               _take(field, ax, 0, g)], dim=ax)
            pads[ax] = g
            continue

        def block(fld, side, ax=ax, g=g):
            return torch.cat([
                _ghost_block(fld[..., c:c + 1], ax, side, g, grid, pads,
                             BCType(bcrecs[c, ax, side]), ext_values, c)
                for c in range(ncomp)], dim=-1)

        if ax == 0 and mesh is not None:
            # an x slab: the ghosts are the neighbours' rows, but beyond
            # the level's own x faces
            field = mesh.halo_x(field, g, periodic=grid.periodic[0],
                                ends=(lambda f: block(f, 0),
                                      lambda f: block(f, 1)))
        else:
            field = torch.cat([block(field, 0), field, block(field, 1)],
                              dim=ax)
        pads[ax] = g
    return field


def grow_scalar(field: torch.Tensor, ng, grid: Grid, bcrecs: BCRecs,
                ext_values: Optional[ExtDirValues] = None) -> torch.Tensor:
    """grow() for a scalar field without component axis."""
    return grow(field[..., None], ng, grid, bcrecs, ext_values)[..., 0]


def _ghost_block(fc, ax, side, g, grid, pads, bct, ext_values, comp):
    """Ghost block of width g on one side of axis `ax` for one component
    (fc keeps its singleton trailing comp axis)."""
    n = fc.shape[ax]
    if side == 0:
        q0 = _take(fc, ax, 0, 1)
        q1 = _take(fc, ax, 1, 2) if n > 1 else q0
        q2 = _take(fc, ax, 2, 3) if n > 2 else q1
    else:
        q0 = _take(fc, ax, n - 1, n)
        q1 = _take(fc, ax, n - 2, n - 1) if n > 1 else q0
        q2 = _take(fc, ax, n - 3, n - 2) if n > 2 else q1

    reps = [1] * fc.dim()

    if bct == BCType.foextrap:
        reps[ax] = g
        return q0.repeat(reps)
    if bct == BCType.hoextrap:
        # first ghost: quadratic extrapolation through the boundary face
        # (AMReX filcc: 1/8*(15 q0 - 10 q1 + 3 q2)); farther ghosts copy q0
        if n > 2:
            g1 = 0.125 * (15.0 * q0 - 10.0 * q1 + 3.0 * q2)
        else:
            g1 = 0.5 * (3.0 * q0 - q1)
        if g == 1:
            return g1
        reps[ax] = g - 1
        far = q0.repeat(reps)
        return torch.cat([far, g1], dim=ax) if side == 0 else \
            torch.cat([g1, far], dim=ax)
    if bct == BCType.ext_dir or bct == BCType.cf_fill:
        shape = list(fc.shape)
        shape[ax] = g
        if ext_values is not None:
            val = ext_values.slab(ax, side, comp, pads, fc.dtype, g=g,
                                  device=fc.device)
        else:
            val = torch.zeros((), dtype=fc.dtype, device=fc.device)
        return torch.broadcast_to(val, shape).to(fc.dtype)
    if bct == BCType.reflect_even or bct == BCType.reflect_odd:
        k = min(g, n)
        blk = _take(fc, ax, 0, k) if side == 0 else _take(fc, ax, n - k, n)
        blk = torch.flip(blk, dims=(ax,))
        if bct == BCType.reflect_odd:
            blk = -blk
        if k < g:  # degenerate tiny box: pad with edge
            reps[ax] = g - k
            pad = q0.repeat(reps)
            blk = torch.cat([pad, blk] if side == 0 else [blk, pad], dim=ax)
        return blk
    # int_dir on a non-periodic axis should not happen
    raise ValueError(f"Bad BCType {bct} on non-periodic axis {ax}")
