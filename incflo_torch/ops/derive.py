"""Derived quantities: vorticity, divergence, error against the exact
solution (port of incflo_tpu/ops/derive.py).

Reference: src/derive/incflo_derive.cpp (the vorticity driver) and
src/derive/incflo_error.cpp (DiffFromExact for probtypes 1 and 2, the
convergence-order harness).  Plain PyTorch on the tensors' device: the
plotfiles call these once per write.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from incflo_torch.grid import Grid
from incflo_torch.ops.stencil import window

PI = math.pi
TWOPI = 2.0 * math.pi


def _cc_deriv(vel_g, comp, axis, grid, ng):
    v = vel_g[..., comp]
    g = 0.5 * (window(v, axis, 2, 0) - window(v, axis, 0, 2)) / grid.dx[axis]
    for ax in range(grid.ndim):
        t = (ng - 1) if ax == axis else ng
        g = window(g, ax, t, t)
    return g


def vorticity(vel_g: torch.Tensor, grid: Grid, ng: int) -> torch.Tensor:
    """2D: omega_z; 3D: |curl u| (reference incflo_derive.cpp:142-300)."""
    if grid.ndim == 2:
        vx = _cc_deriv(vel_g, 1, 0, grid, ng)
        uy = _cc_deriv(vel_g, 0, 1, grid, ng)
        return vx - uy
    wx = _cc_deriv(vel_g, 2, 0, grid, ng)
    vx = _cc_deriv(vel_g, 1, 0, grid, ng)
    wy = _cc_deriv(vel_g, 2, 1, grid, ng)
    uy = _cc_deriv(vel_g, 0, 1, grid, ng)
    vz = _cc_deriv(vel_g, 1, 2, grid, ng)
    uz = _cc_deriv(vel_g, 0, 2, grid, ng)
    return torch.sqrt((wy - vz) ** 2 + (uz - wx) ** 2 + (vx - uy) ** 2)


def divu_cc(vel_g: torch.Tensor, grid: Grid, ng: int) -> torch.Tensor:
    """Cell-centered central divergence."""
    out = None
    for d in range(grid.ndim):
        g = _cc_deriv(vel_g, d, d, grid, ng)
        out = g if out is None else out + g
    return out


# ---------------------------------------------------------------------
# exact solutions (probtype 1: steady Taylor-Green; 2: decaying vortex)
# ---------------------------------------------------------------------

def _centers(grid: Grid, dtype, device):
    xs = []
    for ax in range(grid.ndim):
        c = (np.arange(grid.n_cell[ax]) + 0.5) * grid.dx[ax]
        shape = [1] * grid.ndim
        shape[ax] = -1
        xs.append(torch.tensor(c.reshape(shape), dtype=dtype, device=device))
    return xs


def exact_velocity(probtype: int, grid: Grid, time: float, dtype, device):
    """Cell-centered exact velocity components (list of ndim tensors)."""
    xs = _centers(grid, dtype, device)
    x, y = xs[0], xs[1]
    if probtype == 1:
        u = torch.sin(TWOPI * x) * torch.cos(TWOPI * y)
        v = -torch.cos(TWOPI * x) * torch.sin(TWOPI * y)
        if grid.ndim == 3:
            z = xs[2]
            u = u * torch.cos(TWOPI * z)
            v = v * torch.cos(TWOPI * z)
    elif probtype == 2:
        u0 = v0 = 1.0
        visc = 0.001
        omega = PI * PI * visc
        dec = math.exp(-2.0 * omega * time)
        u = u0 - torch.cos(PI * (x - u0 * time)) \
            * torch.sin(PI * (y - v0 * time)) * dec
        v = v0 + torch.sin(PI * (x - u0 * time)) \
            * torch.cos(PI * (y - v0 * time)) * dec
    else:
        raise ValueError("exact solution only for probtype 1/2")
    comps = [u.expand(grid.cell_shape), v.expand(grid.cell_shape)]
    if grid.ndim == 3:
        comps.append(torch.zeros(grid.cell_shape, dtype=dtype,
                                 device=device))
    return comps


def exact_pressure(probtype: int, grid: Grid, time: float, dt: float, dtype,
                   device):
    """Cell-centered exact pressure (the reference evaluates the error on
    cell-centered averages of nodal p; pressure lives at t - dt/2)."""
    xs = _centers(grid, dtype, device)
    x, y = xs[0], xs[1]
    if probtype == 1:
        p = 0.25 * torch.cos(2 * TWOPI * x) + 0.25 * torch.cos(2 * TWOPI * y)
    elif probtype == 2:
        u0 = v0 = 1.0
        visc = 0.001
        omega = PI * PI * visc
        t_p = time - 0.5 * dt
        p = -0.25 * (torch.cos(TWOPI * (x - u0 * t_p))
                     + torch.cos(TWOPI * (y - v0 * t_p))) \
            * math.exp(-4.0 * omega * t_p)
    else:
        raise ValueError("exact solution only for probtype 1/2")
    return p.expand(grid.cell_shape)


def node_to_cell(p_nodal: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Average nodal pressure to cell centers (amrex
    average_node_to_cellcenter)."""
    p = p_nodal
    for ax in range(grid.ndim):
        if grid.periodic[ax]:
            p = torch.cat([p, p.narrow(ax, 0, 1)], dim=ax)
        p = 0.5 * (window(p, ax, 0, 1) + window(p, ax, 1, 0))
    return p
