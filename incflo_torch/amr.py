"""Adaptive mesh refinement, dense-fine mode (port of incflo_tpu/amr.py).

The solution advances on the finest level's dense uniform grid
(n_cell * ref_ratio^max_level) with one Simulation and no subcycling;
the AMR STRUCTURE is kept as data: ErrorEst tagging (rho / grad-rho
thresholds, static regions; reference incflo_tagging.cpp:11-141) gives
per-level refinement masks on the regrid_int cadence, and plotfiles
expose the multi-level hierarchy (level l = the fine solution averaged
down to level l's resolution plus its mask).  The patch mode that saves
cells is amr_patch.py.  With embedded boundaries the fine Simulation
builds the fine level's cut-cell geometry, and TagCutCells
(incflo_tpu/amr.py:175-180) ORs its cut cells, averaged down to each
level, into that level's mask before the error buffer.

Given a SlabMesh (parallel/mesh.py) the fine level is split along x like
any one-level deck, and every coarser level's view and mask are the
rank's rows of that level (its cut cells from the fine slab's): each
level's slab must be a whole number of its cells, so where the base
level does not split over the ranks (SlabMesh.splits) the fine level is
held whole on every rank
(a Simulation with no mesh: it runs as on one device), as incflo_tpu
replicates an axis that does not divide its mesh.  The tags' x
differences and the error buffer's x dilation read the neighbours' rows
(halo_x).  `mesh` is the run's mesh (who writes the files); `sim.mesh`
the fine level's, None where it is held whole.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from incflo_torch.config import IncfloConfig
from incflo_torch.grid import Grid
from incflo_torch.ops import multigrid as mg
from incflo_torch.simulation import Simulation
from incflo_torch.state import LevelState, SimState


def average_down(field: torch.Tensor, ratio: int, ndim: int) -> torch.Tensor:
    """2^d-child averaging, `ratio` a power of 2 (amrex average_down)."""
    out = field
    r = ratio
    while r > 1:
        out = mg._coarsen_cells(out, ndim)
        r //= 2
    return out


def _x_halo(mesh, t, periodic, beyond):
    """t (a rank's rows of a level) with one row from each x neighbour;
    beyond the level's own x faces beyond(edge row)."""
    return mesh.halo_x(t, 1, periodic=periodic,
                       ends=(lambda x: beyond(x.narrow(0, 0, 1)),
                             lambda x: beyond(x.narrow(0, x.shape[0] - 1,
                                                       1))))


def _dilate(mask: torch.Tensor, n: int, grid: Grid,
            mesh=None) -> torch.Tensor:
    """Grow a boolean mask by n cells (the error buffer); on a mesh the
    mask is the rank's rows, and x reads the neighbours' rows."""
    m = mask.to(torch.float32)
    for _ in range(n):
        acc = m
        for ax in range(grid.ndim):
            if ax == 0 and mesh is not None:
                k = m.shape[0]
                ext = _x_halo(mesh, m, grid.periodic[0], torch.zeros_like)
                up, dn = ext.narrow(0, 0, k), ext.narrow(0, 2, k)
            elif grid.periodic[ax]:
                up = torch.roll(m, 1, dims=ax)
                dn = torch.roll(m, -1, dims=ax)
            else:
                k = m.shape[ax]
                z = torch.zeros_like(m.narrow(ax, 0, 1))
                up = torch.cat([z, m.narrow(ax, 0, k - 1)], dim=ax)
                dn = torch.cat([m.narrow(ax, 1, k - 1), z], dim=ax)
            acc = torch.maximum(acc, torch.maximum(up, dn))
        m = acc
    return m > 0.5


class AMRSimulation:
    """Dense-fine driver of amr.max_level > 0 decks.  device as for
    Simulation (None: the card); mesh: the SlabMesh the fine level is
    split over."""

    def __init__(self, cfg: IncfloConfig, device=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.base_grid = cfg.grid
        self.max_level = cfg.max_level
        self.ratio = cfg.ref_ratio
        fine_factor = self.ratio ** self.max_level
        fine_grid = Grid(tuple(n * fine_factor for n in cfg.grid.n_cell),
                         cfg.grid.prob_lo, cfg.grid.prob_hi,
                         cfg.grid.periodic)
        self.fine_cfg = dataclasses.replace(cfg, grid=fine_grid)
        # the fine level is split where the base level splits (each
        # level's rows then average down within a rank), else held whole
        split = mesh is not None and mesh.splits(cfg.grid)
        self.sim = Simulation(self.fine_cfg, device=device,
                              mesh=mesh if split else None)
        self.device = self.sim.device
        self.dtype = self.sim.dtype
        # masks[l] marks the region level l+1 covers, at level l's size
        # (on a split fine level the rank's rows of it)
        self.masks: List[Optional[torch.Tensor]] = [None] * self.max_level

    def level_grid(self, lev: int) -> Grid:
        f = self.ratio ** lev
        return Grid(tuple(n * f for n in self.base_grid.n_cell),
                    self.base_grid.prob_lo, self.base_grid.prob_hi,
                    self.base_grid.periodic)

    def level_view(self, s: SimState, lev: int) -> LevelState:
        """Level-l view of the solution (average_down of the fine data;
        on a mesh the rank's rows of it)."""
        r = self.ratio ** (self.max_level - lev)
        nd = self.base_grid.ndim
        lvl = s.level
        if r == 1:
            return lvl
        return LevelState(
            velocity=average_down(lvl.velocity, r, nd),
            density=average_down(lvl.density, r, nd),
            tracer=average_down(lvl.tracer, r, nd),
            gp=average_down(lvl.gp, r, nd),
            p=lvl.p[tuple(slice(0, n, r) for n in lvl.p.shape)],
            mac_phi=average_down(lvl.mac_phi, r, nd),
        )

    # ErrorEst (reference incflo_tagging.cpp)
    def _tag_impl(self, fine_density: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        mesh = self.sim.mesh
        eb = self.sim.eb
        masks = []
        for lev in range(self.max_level):
            g = self.level_grid(lev)
            r = self.ratio ** (self.max_level - lev)
            rho = average_down(fine_density, r, g.ndim)
            # the level's x rows this rank holds
            x0 = 0 if mesh is None else mesh.rank * rho.shape[0]
            tags = torch.zeros(rho.shape, dtype=torch.bool,
                               device=rho.device)
            if lev < len(cfg.rhoerr):
                tags |= rho > cfg.rhoerr[lev]
            if lev < len(cfg.gradrhoerr):
                thr = cfg.gradrhoerr[lev]
                for ax in range(g.ndim):
                    if ax == 0 and mesh is not None:
                        n = rho.shape[0]
                        rp = _x_halo(mesh, rho, g.periodic[0], lambda e: e)
                        dp = (rp.narrow(0, 2, n) - rho).abs()
                        dm = (rho - rp.narrow(0, 0, n)).abs()
                    elif g.periodic[ax]:
                        dp = (torch.roll(rho, -1, dims=ax) - rho).abs()
                        dm = (rho - torch.roll(rho, 1, dims=ax)).abs()
                    else:
                        n = rho.shape[ax]
                        rp = torch.cat([rho.narrow(ax, 0, 1), rho,
                                        rho.narrow(ax, n - 1, 1)], dim=ax)
                        dp = (rp.narrow(ax, 2, n) - rho).abs()
                        dm = (rho - rp.narrow(ax, 0, n)).abs()
                    tags |= torch.maximum(dp, dm) > thr
            if cfg.tag_region:
                inside = torch.ones(rho.shape, dtype=torch.bool,
                                    device=rho.device)
                for ax in range(g.ndim):
                    c = g.cell_centers_1d(ax)
                    if ax == 0:
                        c = c[x0:x0 + rho.shape[0]]
                    c = torch.as_tensor(c, device=rho.device).reshape(
                        [-1 if a == ax else 1 for a in range(g.ndim)])
                    inside &= (c >= cfg.tag_region_lo[ax]) \
                        & (c <= cfg.tag_region_hi[ax])
                tags |= inside
            if eb is not None:
                # TagCutCells (forced on with EB)
                tags |= average_down((eb.cut > 0.5).to(torch.float32), r,
                                     g.ndim) > 0.0
            masks.append(_dilate(tags, 2, g, mesh))   # the error buffer
        return masks

    def regrid(self, s: SimState):
        self.masks = self._tag_impl(s.level.density)

    def init_state(self) -> SimState:
        s = self.sim.init_state()
        self.regrid(s)
        return s

    def advance(self, s: SimState) -> SimState:
        s = self.sim.advance(s)
        if self.cfg.regrid_int > 0 and int(s.step) % self.cfg.regrid_int == 0:
            self.regrid(s)
        return s
