"""Initial conditions keyed by incflo.probtype (port of
incflo_tpu/probs.py:50-294; reference src/prob/prob_init_fluid.cpp).

This slice ports probtype 21, the double shear layer of the shear3d
deck.  The other probtypes raise and name the ROADMAP item that ports
them.
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

_LATER = {1: "A8", 2: "A8", 3: "A8", 4: "A8", 5: "A9b", 11: "A9b",
          111: "A9b", 112: "A9b", 113: "A9b", 12: "A9b", 6: "A11"}


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


def init_fluid(cfg: IncfloConfig, grid: Grid, dtype, device) -> LevelState:
    """prob_init_fluid: the t=0 LevelState on `grid`."""
    pt = cfg.probtype
    if pt != 21:
        item = _LATER.get(pt, "A8/A9b/A11")
        raise NotImplementedError(
            f"incflo_torch: probtype {pt} is not ported yet "
            f"(ROADMAP {item}); this slice runs probtype 21")
    st = zeros_level(grid, cfg.ntrac, dtype, device)
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
