"""Initial conditions keyed by incflo.probtype (port of
incflo_tpu/probs.py; reference src/prob/prob_init_fluid.cpp:6-683).

Ported: the uniform state of probtypes 0 and 114, the 2D vortices 1
(Taylor-Green, the tgv2d deck) and 2 (the decaying Taylor vortex), the 3D
Taylor-Green vortex 3, Couette 4, Rayleigh-Taylor 5 (the rt deck), the
Boussinesq tuscan 11 and bubbles 111-113, the periodic tracer 12, the
double shear layers 21 (the shear3d deck), 22 and 23, and the plane
Poiseuille and channel family 31, 311, 32, 322, 33, 333 and 41, and the
slanted EB channel 6.
Coordinates follow the reference: most probtypes use x = (i+0.5) dx with
no prob_lo offset; Rayleigh-Taylor adds prob_lo.
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

_POISEUILLE = (31, 311, 32, 322, 33, 333, 41)


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


def _norm_coord(grid, axis, dtype, device):
    """(i+0.5)/n along `axis`, broadcastable."""
    shape = [1] * grid.ndim
    shape[axis] = -1
    c = (np.arange(grid.n_cell[axis]) + 0.5) / grid.n_cell[axis]
    return torch.as_tensor(c.reshape(shape), dtype=dtype, device=device)


def _index_coord(grid, axis):
    """The cell index along `axis` as a host array, broadcastable."""
    shape = [1] * grid.ndim
    shape[axis] = -1
    return np.arange(grid.n_cell[axis]).reshape(shape)


def _where(mask, a, b, cs, dtype, device):
    """a where the host mask holds, else b, broadcast to the cells."""
    return torch.broadcast_to(torch.as_tensor(
        np.where(mask, a, b), dtype=dtype, device=device), cs)


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


def _init_shear_layer(cfg, grid, vel_comps, tracer, dtype, device):
    """probtypes 21, 22 and 23: a double shear layer across y (21), z
    (22) or x (23), a 0.05 sine perturbation, and a tracer 0.01 outside
    a disc of radius 0.1."""
    cs = grid.cell_shape
    pt = cfg.probtype
    coords = _coords_no_offset(grid, dtype, device)

    def layer(s):
        return torch.broadcast_to(safe_tanh(30.0 * (0.25 - torch.abs(s - 0.5))),
                                  cs)

    def pert(s):
        return torch.broadcast_to(0.05 * torch.sin(TWOPI * s), cs)

    zero = torch.zeros(cs, dtype=dtype, device=device)
    if pt == 21:
        x, y = coords[0], coords[1]
        vel_comps[0], vel_comps[1] = layer(y), pert(x)
        if grid.ndim == 3:
            vel_comps[2] = zero
        r = torch.sqrt((x - 0.5) ** 2 + (y - 0.25) ** 2)
    elif pt == 22:
        y, z = coords[1], coords[2]
        vel_comps[1], vel_comps[2], vel_comps[0] = layer(z), pert(y), zero
        r = torch.sqrt((y - 0.5) ** 2 + (z - 0.5) ** 2)
    else:
        x, z = coords[0], coords[2]
        vel_comps[2], vel_comps[0], vel_comps[1] = layer(x), pert(z), zero
        r = torch.sqrt((x - 0.5) ** 2 + (z - 0.5) ** 2)
    tracer[..., 0] = torch.broadcast_to(
        torch.where(r < 0.1, torch.zeros_like(r), torch.full_like(r, 0.01)),
        cs)


def _init_bubble(cfg, grid, tracer, dtype, device):
    """probtypes 111-113, the Boussinesq bubble: at rest, tracer 0.01
    outside a sphere (a disc in 2D) of radius 0.1 centred at 0.25 on two
    axes and 0.5 on the third (x for 111, y for 112, z for 113)."""
    cs = grid.cell_shape
    pt = cfg.probtype
    coords = _coords_no_offset(grid, dtype, device)
    if grid.ndim == 2:
        x, y = coords
        r = torch.sqrt((x - 0.25) ** 2 + (y - 0.5) ** 2)
    else:
        x, y, z = coords
        cx, cy, cz = {111: (0.5, 0.25, 0.25), 112: (0.25, 0.5, 0.25),
                      113: (0.25, 0.25, 0.5)}[pt]
        r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
    tracer[..., 0] = torch.broadcast_to(
        torch.where(r < 0.1, torch.zeros_like(r), torch.full_like(r, 0.01)),
        cs)


def _init_periodic_tracer(grid, vel_comps, tracer, dtype, device):
    """probtype 12: u = 1 and exponentially growing sine waves in the
    other components and the tracer (3D; the 2D form of incflo_tpu is a
    reduction the reference does not define)."""
    cs = grid.cell_shape
    coords = _coords_no_offset(grid, dtype, device)
    C = TWOPI / (grid.prob_hi[0] - grid.prob_lo[0])
    A = 1.0
    vel_comps[0] = torch.ones(cs, dtype=dtype, device=device)
    if grid.ndim == 3:
        x, y, z = coords
        vel_comps[1] = torch.broadcast_to(
            0.1 * (torch.sin(C * (x + z) - 0.00042) + 1.0) * torch.exp(y), cs)
        vel_comps[2] = torch.broadcast_to(
            0.1 * (torch.sin(C * (x + y) - 0.00042) + 1.0) * torch.exp(z), cs)
        tracer[..., 0] = torch.broadcast_to(
            A * (torch.sin(C * (y + z) - 0.00042) + 1.0) * torch.exp(x), cs)
    else:
        x, y = coords
        vel_comps[1] = torch.broadcast_to(
            0.1 * (torch.sin(C * x - 0.00042) + 1.0) * torch.exp(y), cs)
        tracer[..., 0] = torch.broadcast_to(
            A * (torch.sin(C * y - 0.00042) + 1.0) * torch.exp(x), cs)


def _init_plane_poiseuille(cfg, grid, vel_comps, dtype, device):
    """probtypes 31, 311, 32, 322, 33, 333 and 41 (reference
    prob_init_fluid.cpp:526-683): a parabolic profile 6 a s (1 - s) of
    one component across one axis (41: a linear 0.5 z), and tracer
    bands along the flow axis -- 1 up to an eighth of it, 2 up to half,
    3 up to three quarters in the first three tracers.  Returns the
    tracer."""
    cs = grid.cell_shape
    nd = grid.ndim
    pt = cfg.probtype
    for d in range(nd):
        vel_comps[d] = torch.zeros(cs, dtype=dtype, device=device)

    def parab(axis, amp):
        s = _norm_coord(grid, axis, dtype, device)
        return torch.broadcast_to(6.0 * amp * s * (1.0 - s), cs)

    if pt == 31:
        vel_comps[0], tr_axis = parab(1, cfg.ic_u), 0
    elif pt == 311:
        vel_comps[0], tr_axis = parab(2, cfg.ic_u), 0
    elif pt == 41:
        z = _norm_coord(grid, 2, dtype, device)
        vel_comps[0], tr_axis = torch.broadcast_to(0.5 * z, cs), 0
    elif pt == 32:
        vel_comps[1], tr_axis = parab(2, cfg.ic_v), 1
    elif pt == 322:
        vel_comps[1], tr_axis = parab(0, cfg.ic_v), 1
    elif pt == 33:
        vel_comps[2], tr_axis = parab(0, cfg.ic_w), 2
    else:
        vel_comps[2], tr_axis = parab(1, cfg.ic_w), 2
    idx = _index_coord(grid, tr_axis)
    dhi = grid.n_cell[tr_axis] - 1
    tracer = torch.zeros(cs + (cfg.ntrac,), dtype=dtype, device=device)
    for n, (cut, val) in enumerate(((dhi // 8, 1.0), (dhi // 2, 2.0),
                                    (dhi * 3 // 4, 3.0))[:cfg.ntrac]):
        tracer[..., n] = _where(idx <= cut, val, 0.0, cs, dtype, device)
    return tracer


def _init_channel_slant(cfg, grid, vel_comps, tracer, dtype, device):
    """channel_slant, the rotated EB cylinder (reference
    prob_init_fluid.cpp:230-265): with cylinder.rotation > 0 the velocity
    lies along the rotated axis and the tracers are bands along x;
    otherwise the uniform start.  Returns the tracer."""
    rotation = 0.0
    if cfg.pp is not None:
        rotation = float(cfg.pp.scoped("cylinder").query("rotation", 0))
    rotation = rotation / 180.0 * math.pi
    if rotation <= 0:
        return tracer
    cs = grid.cell_shape
    u = cfg.ic_u
    vel_comps[0] = torch.full(cs, u * math.cos(rotation), dtype=dtype,
                              device=device)
    vel_comps[1] = torch.full(cs, u * math.sin(rotation), dtype=dtype,
                              device=device)
    if grid.ndim == 3:
        vel_comps[2] = torch.zeros(cs, dtype=dtype, device=device)
    idx = _index_coord(grid, 0)
    dhi = grid.n_cell[0] - 1
    bands = [(dhi // 8, 1.0), (dhi // 2, 2.0), (dhi * 3 // 4, 3.0)]
    out = torch.zeros(cs + (cfg.ntrac,), dtype=dtype, device=device)
    for n, (last, val) in enumerate(bands[:cfg.ntrac]):
        out[..., n] = _where(idx <= last, val, 0.0, cs, dtype, device)
    return out


def init_fluid(cfg: IncfloConfig, grid: Grid, dtype, device) -> LevelState:
    """prob_init_fluid: the t=0 LevelState on `grid`.  Unless a probtype
    sets them, the velocity is (ic_u, ic_v, ic_w), the density ro_0 and
    the tracer zero."""
    pt = cfg.probtype
    st = zeros_level(grid, cfg.ntrac, dtype, device)
    if pt in (1, 2):
        return _init_vortex(cfg, grid, st, dtype, device)
    if pt == 5:
        return _init_rayleigh_taylor(cfg, grid, st, dtype, device)
    cs = grid.cell_shape
    nd = grid.ndim
    density = torch.full(cs, cfg.ro_0, dtype=dtype, device=device)
    vel_comps = [torch.full(cs, v, dtype=dtype, device=device)
                 for v in (cfg.ic_u, cfg.ic_v, cfg.ic_w)[:nd]]
    tracer = torch.zeros(cs + (cfg.ntrac,), dtype=dtype, device=device)
    if pt in (0, 114):
        pass
    elif pt == 3:          # Taylor-Green 3D
        x, y, z = _coords_no_offset(grid, dtype, device)
        vel_comps[0] = torch.broadcast_to(
            torch.sin(TWOPI * x) * torch.cos(TWOPI * y)
            * torch.cos(TWOPI * z), cs)
        vel_comps[1] = torch.broadcast_to(
            -torch.cos(TWOPI * x) * torch.sin(TWOPI * y)
            * torch.cos(TWOPI * z), cs)
        vel_comps[2] = torch.zeros(cs, dtype=dtype, device=device)
    elif pt == 4:          # Couette: u *= (y - 0.5), y = (j + 0.5) / ny
        yn = _norm_coord(grid, 1, dtype, device)
        vel_comps[0] = vel_comps[0] * torch.broadcast_to(yn - 0.5, cs)
        for d in range(1, nd):
            vel_comps[d] = torch.zeros(cs, dtype=dtype, device=device)
    elif pt == 11:         # tuscan: tracer 0.01 above mid-height, at rest
        half = grid.n_cell[nd - 1] // 2
        for d in range(nd):
            vel_comps[d] = torch.zeros(cs, dtype=dtype, device=device)
        density = torch.ones(cs, dtype=dtype, device=device)
        tracer[..., 0] = _where(_index_coord(grid, nd - 1) > half, 0.01,
                                0.0, cs, dtype, device)
    elif pt in (111, 112, 113):
        for d in range(nd):
            vel_comps[d] = torch.zeros(cs, dtype=dtype, device=device)
        density = torch.ones(cs, dtype=dtype, device=device)
        _init_bubble(cfg, grid, tracer, dtype, device)
    elif pt == 12:
        _init_periodic_tracer(grid, vel_comps, tracer, dtype, device)
    elif pt in (21, 22, 23):
        _init_shear_layer(cfg, grid, vel_comps, tracer, dtype, device)
    elif pt in _POISEUILLE:
        tracer = _init_plane_poiseuille(cfg, grid, vel_comps, dtype, device)
    elif pt == 6:
        tracer = _init_channel_slant(cfg, grid, vel_comps, tracer, dtype,
                                     device)
    else:
        raise ValueError(f"prob_init_fluid: unknown probtype {pt}")
    velocity = torch.stack(vel_comps, dim=-1).contiguous()
    return st._replace(velocity=velocity, density=density, tracer=tracer)


def smooth_perturbation(grid: Grid, seed: int, amp: float = 0.01):
    """A smooth, not divergence-free velocity perturbation from a seed,
    cell-centred, components last (numpy): component c is
    amp * prod_ax sin(2 pi x_ax / L_ax + phase[c, ax]), the phases drawn
    from numpy's generator.  Added to a start, it gives the projections
    real work where a deck's own flow is an exact channel profile whose
    pressure is rounding noise."""
    nd = grid.ndim
    phase = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, (nd, nd))
    c = [grid.prob_lo[ax] + (np.arange(grid.n_cell[ax]) + 0.5) * grid.dx[ax]
         for ax in range(nd)]
    x = np.meshgrid(*c, indexing="ij")
    L = [grid.prob_hi[ax] - grid.prob_lo[ax] for ax in range(nd)]
    comps = []
    for k in range(nd):
        w = amp * np.ones(grid.cell_shape)
        for ax in range(nd):
            w = w * np.sin(2 * np.pi * x[ax] / L[ax] + phase[k, ax])
        comps.append(w)
    return np.stack(comps, axis=-1)
