"""The benchmark's inputs: each deck's initial condition written again
here (incflo's prob_init_fluid for the deck's probtype), with a seeded
perturbation small against the deck's own, made on the device.  The
same fields go to the program and to the reference.

A seed draws only phases, of modes a tenth or less of the deck's own
perturbation: every seed gives the same amplitudes and the same sizes,
so the work a step does is alike from seed to seed."""

from __future__ import annotations

import math

import numpy as np
import torch


def _centres(grid, dtype, device):
    out = []
    for ax in range(3):
        c = grid.prob_lo[ax] + (np.arange(grid.n_cell[ax]) + 0.5) \
            * grid.dx[ax]
        shape = [1, 1, 1]
        shape[ax] = -1
        out.append(torch.as_tensor(c.reshape(shape), dtype=dtype,
                                   device=device))
    return out


def _shear_layer(deck, phase, dtype, device):
    """probtype 21: u = tanh(30 (0.25 - |y - 0.5|)), v = 0.05 sin(2 pi x),
    w = 0, tracer 0.01 outside a disc of radius 0.1 about (0.5, 0.25);
    seeded: v += 0.0005 sin(4 pi x + a) and w = 0.0005 sin(2 pi x + b)
    sin(2 pi y + c) cos(2 pi z / Lz + d)."""
    g = deck.grid
    cs = g.cell_shape
    x, y, z = _centres(g, dtype, device)
    lz = g.prob_hi[2] - g.prob_lo[2]
    a, b, c, d = phase[:4]
    u = torch.tanh(30.0 * (0.25 - torch.abs(y - 0.5)))
    v = 0.05 * torch.sin(2 * math.pi * x) \
        + 0.0005 * torch.sin(4 * math.pi * x + a)
    w = 0.0005 * torch.sin(2 * math.pi * x + b) \
        * torch.sin(2 * math.pi * y + c) \
        * torch.cos(2 * math.pi * z / lz + d)
    vel = torch.stack([torch.broadcast_to(f, cs) for f in (u, v, w)], dim=-1)
    r = torch.sqrt((x - 0.5) ** 2 + (y - 0.25) ** 2)
    tra = torch.broadcast_to(torch.where(r < 0.1, torch.zeros_like(r),
                                        torch.full_like(r, 0.01)), cs)
    rho = torch.full(cs, deck.ro_0, dtype=dtype, device=device)
    return vel.contiguous(), rho, tra[..., None].contiguous()


def _rayleigh_taylor(deck, phase, dtype, device):
    """probtype 5: density 2 over 0.5 (tracer 1 over 0) across a tanh
    interface of width 0.005 at height 0.5 - 0.01 cos(2 pi r / Lx), r the
    distance from the vertical axis through the domain's centre (capped
    at Lx / 2), at rest; seeded: the interface height moves by
    0.0002 cos(4 pi x / Lx + a) cos(4 pi y / Ly + b)
    + 0.0001 cos(6 pi x / Lx + c) cos(2 pi y / Ly + d)."""
    g = deck.grid
    cs = g.cell_shape
    x, y, z = _centres(g, dtype, device)
    lx = g.prob_hi[0] - g.prob_lo[0]
    ly = g.prob_hi[1] - g.prob_lo[1]
    cx = 0.5 * (g.prob_lo[0] + g.prob_hi[0])
    cy = 0.5 * (g.prob_lo[1] + g.prob_hi[1])
    r = torch.minimum(torch.hypot(x - cx, y - cy),
                      torch.as_tensor(0.5 * lx, dtype=dtype, device=device))
    a, b, c, d = phase[:4]
    h = 0.5 - 0.01 * torch.cos(2 * math.pi * r / lx) \
        + 0.0002 * torch.cos(4 * math.pi * x / lx + a) \
        * torch.cos(4 * math.pi * y / ly + b) \
        + 0.0001 * torch.cos(6 * math.pi * x / lx + c) \
        * torch.cos(2 * math.pi * y / ly + d)
    prof = torch.broadcast_to(0.5 * (1.0 + torch.tanh((z - h) / 0.005)), cs)
    rho = (0.5 + 1.5 * prof).contiguous()
    tra = prof[..., None].contiguous()
    vel = torch.zeros(cs + (3,), dtype=dtype, device=device)
    return vel, rho, tra


INITIAL = {21: _shear_layer, 5: _rayleigh_taylor}


def initial_fields(deck, seed: int, dtype, device):
    """(velocity, density, tracer) of the deck's probtype from the seed."""
    phase = np.random.default_rng(seed).uniform(0.0, 2 * math.pi, 8)
    return INITIAL[deck.probtype](deck, [float(p) for p in phase], dtype,
                                  device)
