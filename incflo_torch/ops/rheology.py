"""Rheology: strain-rate magnitude and non-Newtonian viscosity models
(port of incflo_tpu/ops/rheology.py).

Reference: src/rheology/incflo_rheology.cpp:8-140 (NonNewtonianViscosity
functor with Papanastasiou regularisation) and src/derive/incflo_derive_K.H
(incflo_strainrate: ||2S|| via central differences; incflo_strainrate_eb
at cut cells).  A non-Newtonian fluid's velocity operator is built every
step from this viscosity (ops/diffusion.diffuse_velocity), and with
explicit diffusion compute_dt takes the diffusive CFL from it.
"""

from __future__ import annotations

import torch

from incflo_torch.config import FluidModel, IncfloConfig
from incflo_torch.grid import Grid
from incflo_torch.ops.mathutil import expterm
from incflo_torch.ops.stencil import window
from incflo_torch.parallel.mesh import mesh_of


def strainrate(vel_g: torch.Tensor, grid: Grid, ng: int, out_ng: int = 0
               ) -> torch.Tensor:
    """sqrt(2 ux^2 + 2 vy^2 [+ 2 wz^2] + (uy+vx)^2 [+ (vz+wy)^2 + (wx+uz)^2])
    by central differences on the interior grown by out_ng (needs
    ng >= out_ng+1 ghosts on vel_g)."""
    ndim = grid.ndim
    trim = ng - out_ng

    def d(comp, axis):
        v = vel_g[..., comp]
        g = 0.5 * (window(v, axis, 2, 0) - window(v, axis, 0, 2)) / grid.dx[axis]
        for ax in range(ndim):
            t = (trim - 1) if ax == axis else trim
            g = window(g, ax, t, t)
        return g

    if ndim == 2:
        ux, vx = d(0, 0), d(1, 0)
        uy, vy = d(0, 1), d(1, 1)
        return torch.sqrt(2 * ux * ux + 2 * vy * vy + (uy + vx) ** 2)
    ux, vx, wx = d(0, 0), d(1, 0), d(2, 0)
    uy, vy, wy = d(0, 1), d(1, 1), d(2, 1)
    uz, vz, wz = d(0, 2), d(1, 2), d(2, 2)
    return torch.sqrt(2 * ux * ux + 2 * vy * vy + 2 * wz * wz
                      + (uy + vx) ** 2 + (vz + wy) ** 2 + (wx + uz) ** 2)


def viscosity_of_strainrate(sr: torch.Tensor,
                            cfg: IncfloConfig) -> torch.Tensor:
    """The NonNewtonianViscosity functor."""
    m = cfg.fluid_model
    if m == FluidModel.Newtonian:
        return torch.full_like(sr, cfg.mu)
    if m == FluidModel.powerlaw:
        return cfg.mu * torch.pow(sr, cfg.n_0 - 1.0)
    if m == FluidModel.Bingham:
        return cfg.mu + cfg.tau_0 * expterm(sr / cfg.papa_reg) / cfg.papa_reg
    if m == FluidModel.HerschelBulkley:
        return ((cfg.mu * torch.pow(sr, cfg.n_0) + cfg.tau_0)
                * expterm(sr / cfg.papa_reg) / cfg.papa_reg)
    if m == FluidModel.deSouzaMendesDutra:
        return ((cfg.mu * torch.pow(sr, cfg.n_0) + cfg.tau_0)
                * expterm(sr * (cfg.eta_0 / cfg.tau_0)) * (cfg.eta_0 / cfg.tau_0))
    raise ValueError(m)


def compute_viscosity(vel_g: torch.Tensor, grid: Grid, ng: int,
                      cfg: IncfloConfig, out_ng: int = 1,
                      eb=None) -> torch.Tensor:
    """eta on the interior grown by out_ng ghosts (reference
    compute_viscosity_at_level uses growntilebox(1)).  With embedded
    boundaries (eb/ops.EBArrays) the interior cut cells take the
    quadratic one-sided strain-rate stencils toward connected cells
    (reference incflo_strainrate_eb; incflo_tpu/ops/rheology.py:79-84):
    differencing across covered cells would overstate the strain rate
    next to every wall.  The ghost ring keeps the central differences
    (the reference's, whose cut-cell stencils cover the interior); on a
    rank's x slab the x ghost rows the slab shares with its neighbours
    are their interior rows, corrected there, by a halo exchange (the
    level's own ghosts, at the wrap of a periodic x too, as computed)."""
    if cfg.fluid_model == FluidModel.Newtonian:
        shape = tuple(n + 2 * out_ng for n in grid.cell_shape)
        return torch.full(shape, cfg.mu, dtype=vel_g.dtype,
                          device=vel_g.device)
    sr = strainrate(vel_g, grid, ng, out_ng)
    if eb is not None:
        from incflo_torch.eb import ops as ebops
        sr_eb = ebops.eb_strainrate(vel_g, grid, ng, eb)
        sr = sr.clone()
        ctr = sr[tuple(slice(out_ng, out_ng + n) for n in grid.cell_shape)]
        ctr.copy_(torch.where(eb.cut > 0.5, sr_eb, ctr))
        mesh = mesh_of(grid)
        if mesh is not None and out_ng > 0:
            n = sr.shape[0]
            sr = mesh.halo_x(sr.narrow(0, out_ng, n - 2 * out_ng), out_ng,
                             periodic=False,
                             ends=(lambda _: sr.narrow(0, 0, out_ng),
                                   lambda _: sr.narrow(0, n - out_ng,
                                                       out_ng)))
    return viscosity_of_strainrate(sr, cfg)
