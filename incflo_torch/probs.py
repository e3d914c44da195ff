"""Initial conditions keyed by incflo.probtype (port of
incflo_tpu/probs.py:50-294; reference src/prob/prob_init_fluid.cpp).

Ported: probtype 21, the double shear layer of the shear3d deck,
probtype 5, the Rayleigh-Taylor interface of the rt deck, and the 2D
vortices of probtypes 1 (Taylor-Green, the tgv2d deck) and 2 (the
decaying Taylor vortex).  The other probtypes raise and name the ROADMAP
item that ports them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from incflo_torch.config import IncfloConfig
from incflo_torch.grid import Grid
from incflo_torch.ops.mathutil import safe_tanh
from incflo_torch.state import LevelState, zeros_level

TWOPI = 2.0 * math.pi

PI = math.pi

_LATER = {3: "A8", 4: "A8", 11: "A9c", 111: "A9c",
          112: "A9c", 113: "A9c", 12: "A9c", 6: "A11"}


def _coords_no_offset(grid: Grid, dtype, device):
    """(i+0.5)*dx per axis in the root-domain index frame, broadcastable."""
    out = []
    for ax in range(grid.ndim):
        off = grid.prob_lo[ax] - grid.origin[ax]
        c = off + (np.arange(grid.n_cell[ax]) + 0.5) * grid.dx[ax]
        shape = [1] * grid.ndim
        shape[ax] = -1
        out.append(torch.as_tensor(c.reshape(shape), dtype=dtype,
                                   device=device))
    return out


def _coords_with_offset(grid: Grid, dtype, device):
    """prob_lo + (i+0.5)*dx per axis, broadcastable."""
    out = []
    for ax in range(grid.ndim):
        c = grid.prob_lo[ax] + (np.arange(grid.n_cell[ax]) + 0.5) * grid.dx[ax]
        shape = [1] * grid.ndim
        shape[ax] = -1
        out.append(torch.as_tensor(c.reshape(shape), dtype=dtype,
                                   device=device))
    return out


def _init_rayleigh_taylor(cfg, grid, st, dtype, device) -> LevelState:
    """probtype 5: heavy fluid (rho 2, tracer 1) over light (rho 0.5,
    tracer 0) across a tanh interface of width 0.005 at mid-height,
    perturbed by a cosine of the distance from the domain's axis."""
    cs = grid.cell_shape
    nd = grid.ndim
    coords = _coords_with_offset(grid, dtype, device)
    rho_1, rho_2 = 0.5, 2.0
    tra_1, tra_2 = 0.0, 1.0
    width = 0.005
    splitx = 0.5 * (grid.prob_lo[0] + grid.prob_hi[0])
    L_x = grid.prob_hi[0] - grid.prob_lo[0]
    half = torch.as_tensor(0.5 * L_x, dtype=dtype, device=device)
    if nd == 2:
        x, up = coords
        r2d = torch.minimum(torch.abs(x - splitx), half)
    else:
        x, y, up = coords
        splity = 0.5 * (grid.prob_lo[1] + grid.prob_hi[1])
        r2d = torch.minimum(torch.hypot(x - splitx, y - splity), half)
    pert = 0.5 - 0.01 * torch.cos(2.0 * PI * r2d / L_x)
    prof = 0.5 * (1.0 + safe_tanh((up - pert) / width))
    density = torch.broadcast_to(rho_1 + (rho_2 - rho_1) * prof,
                                 cs).contiguous()
    tracer = torch.zeros(cs + (cfg.ntrac,), dtype=dtype, device=device)
    tracer[..., 0] = torch.broadcast_to(tra_1 + (tra_2 - tra_1) * prof, cs)
    velocity = torch.zeros(cs + (nd,), dtype=dtype, device=device)
    return st._replace(velocity=velocity, density=density, tracer=tracer)


def _init_vortex(cfg, grid, st, dtype, device) -> LevelState:
    """probtype 1, the Taylor-Green vortex u = sin(2 pi x) cos(2 pi y),
    v = -cos(2 pi x) sin(2 pi y); probtype 2, the decaying Taylor vortex
    u = 1 - cos(pi x) sin(pi y), v = 1 + sin(pi x) cos(pi y).  A third
    velocity component is zero."""
    cs = grid.cell_shape
    x, y = _coords_no_offset(grid, dtype, device)[:2]
    if cfg.probtype == 1:
        u = torch.sin(TWOPI * x) * torch.cos(TWOPI * y)
        v = -torch.cos(TWOPI * x) * torch.sin(TWOPI * y)
    else:
        u = 1.0 - torch.cos(PI * x) * torch.sin(PI * y)
        v = 1.0 + torch.sin(PI * x) * torch.cos(PI * y)
    comps = [torch.broadcast_to(u, cs), torch.broadcast_to(v, cs)]
    if grid.ndim == 3:
        comps.append(torch.zeros(cs, dtype=dtype, device=device))
    return st._replace(
        velocity=torch.stack(comps, dim=-1).contiguous(),
        density=torch.full(cs, cfg.ro_0, dtype=dtype, device=device))


def init_fluid(cfg: IncfloConfig, grid: Grid, dtype, device) -> LevelState:
    """prob_init_fluid: the t=0 LevelState on `grid`."""
    pt = cfg.probtype
    if pt not in (1, 2, 5, 21):
        item = _LATER.get(pt, "A8/A9c/A11")
        raise NotImplementedError(
            f"incflo_torch: probtype {pt} is not ported yet "
            f"(ROADMAP {item}); this package runs probtypes 1, 2, 5 and "
            f"21")
    st = zeros_level(grid, cfg.ntrac, dtype, device)
    if pt in (1, 2):
        return _init_vortex(cfg, grid, st, dtype, device)
    if pt == 5:
        return _init_rayleigh_taylor(cfg, grid, st, dtype, device)
    cs = grid.cell_shape
    nd = grid.ndim
    density = torch.full(cs, cfg.ro_0, dtype=dtype, device=device)
    coords = _coords_no_offset(grid, dtype, device)
    x, y = coords[0], coords[1]
    vel_comps = [
        torch.broadcast_to(safe_tanh(30.0 * (0.25 - torch.abs(y - 0.5))), cs),
        torch.broadcast_to(0.05 * torch.sin(TWOPI * x), cs)]
    if nd == 3:
        vel_comps.append(torch.zeros(cs, dtype=dtype, device=device))
    r = torch.sqrt((x - 0.5) ** 2 + (y - 0.25) ** 2)
    tracer = torch.zeros(cs + (cfg.ntrac,), dtype=dtype, device=device)
    tracer[..., 0] = torch.broadcast_to(
        torch.where(r < 0.1, torch.zeros_like(r), torch.full_like(r, 0.01)),
        cs)
    velocity = torch.stack(vel_comps, dim=-1).contiguous()
    return st._replace(velocity=velocity, density=density, tracer=tracer)
