"""A frozen copy of the plain versions of the smoother kernels of
incflo_torch/csrc/smoothers.cu (incflo_torch/ops/smoother_kernels.py):
red-black Gauss-Seidel sweeps of the cell-centred operator and of the Q1
nodal operator, walls included.  The roofline counts a smoother call's
operations on them (benchmark/roofline/kernels.py), so that a later
change to the kernels cannot move its own yardstick."""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

PERIODIC, NEUMANN, DIRICHLET = 0, 1, 2
THIRD = 1.0 / 3.0    # the ghost's x1/3, as a product (the kernel's kThird)


def guarded_reciprocal(diag: torch.Tensor, dmax=None) -> torch.Tensor:
    """1/diag, and 0 where |diag| <= 1e-8 max|diag|: near-degenerate rows
    get no update instead of a 1/eps-amplified one.  dmax: max|diag| over
    the whole level where diag is a slab of it (else diag's own)."""
    if dmax is None:
        dmax = torch.max(torch.abs(diag))
    ok = torch.abs(diag) > 1e-8 * dmax
    return torch.where(ok, 1.0 / torch.where(ok, diag, 1.0), 0.0)


def nodal_coefs(dx: Sequence[float]) -> Tuple[float, ...]:
    """C_p of the 7 rank-1 terms (scaled by -1/V), indexed by
    p0*4 + p1*2 + p2 with a set bit for a `d` axis; entry 0 (sss) is 0."""
    vol = dx[0] * dx[1] * dx[2]
    out = []
    for pattern in itertools.product((0, 1), repeat=3):
        C = 0.0
        for d in range(3):
            if not pattern[d]:
                continue
            term = 1.0 / dx[d]
            for a in range(3):
                if a != d:
                    term *= (dx[a] / 12.0) if pattern[a] else (dx[a] / 4.0)
            C += term
        out.append(-C / vol)
    return tuple(out)


def checkerboard(shape, device):
    """True on red points: (i + j + k) even over the 3 spatial axes,
    broadcast over trailing components."""
    par = 0
    for ax in range(3):
        view = [1] * len(shape)
        view[ax] = shape[ax]
        par = par + torch.arange(shape[ax], device=device).reshape(view)
    return (par % 2) == 0


def cell_neighbour_coefs(F, bc=None, Fwall=None, xwrap=None):
    """(Ehi, Elo): per axis, the coefficients of x(i+e_ax) and x(i-e_ax)
    in L(x) = diag*x - sum_ax (Ehi*x(i+e_ax) + Elo*x(i-e_ax)), neighbours
    taken with periodic wrap.  On a periodic axis they are the cell's
    high face and its low face (the wrapped F).  On a walled axis the
    coefficient across the wall is 0, and a Dirichlet wall adds a third
    of its face coefficient to the opposite one.  A periodic axis with
    Fwall[ax] given (its face 0 differs from face n) takes that plane as
    the coefficient of x(n-1) in the rows of its first cells.  xwrap
    (plane, planes): on an extended slab of such a level, the level's
    x wrap plane takes the place of the x neighbour's F in the rows of
    those interior x planes (where the level's cell 0 lies)."""
    lo, hi = _bc_codes(bc)
    Ehi, Elo = [], []
    for ax in range(3):
        fhi = F[ax]
        flo = torch.roll(fhi, 1, dims=ax)
        if lo[ax] == PERIODIC and Fwall is not None and Fwall[ax] is not None:
            n = fhi.shape[ax]
            flo = torch.cat([Fwall[ax], flo.narrow(ax, 1, n - 1)], dim=ax)
        if ax == 0 and xwrap is not None:
            plane, at = xwrap
            for i in at:
                flo = torch.cat([flo.narrow(0, 0, i), plane,
                                 flo.narrow(0, i + 1, flo.shape[0] - i - 1)])
        if lo[ax] != PERIODIC:
            n = fhi.shape[ax]
            zero = torch.zeros_like(fhi.narrow(ax, 0, 1))
            first = fhi.narrow(ax, 0, 1)
            if lo[ax] == DIRICHLET:
                first = first + Fwall[ax] * THIRD
            last = flo.narrow(ax, n - 1, 1)
            if hi[ax] == DIRICHLET:
                last = last + fhi.narrow(ax, n - 1, 1) * THIRD
            fhi = torch.cat([first, fhi.narrow(ax, 1, n - 2), zero], dim=ax)
            flo = torch.cat([zero, flo.narrow(ax, 1, n - 2), last], dim=ax)
        Ehi.append(fhi)
        Elo.append(flo)
    return Ehi, Elo


def _cell_apply_plain(x, diag, F, Flo):
    out = diag * x
    for ax in range(3):
        xE = torch.roll(x, -1, dims=ax)
        xW = torch.roll(x, 1, dims=ax)
        out = out - (F[ax] * xE + Flo[ax] * xW)
    return out


def cell_smooth_plain(x, b, diag, dinv, F, nsweeps: int,
                      want_residual: bool = False, bc=None, Fwall=None,
                      open_x=(False, False), xwrap=None):
    """Plain version of the `cell_smooth` kernel, walls included; open_x:
    of its slab form (cell_smooth_ext), the x sides (low, high) that are
    open -- Neumann, and the low one without a wall plane; xwrap: the
    level's x wrap plane inside the extended slab
    (cell_neighbour_coefs)."""
    F, Flo = cell_neighbour_coefs(F, bc, Fwall, xwrap)
    isred = checkerboard(x.shape, x.device)
    red = isred.to(x.dtype)
    black = (~isred).to(x.dtype)
    for _ in range(nsweeps):
        x = x + red * (b - _cell_apply_plain(x, diag, F, Flo)) * dinv
        x = x + black * (b - _cell_apply_plain(x, diag, F, Flo)) * dinv
    res = (b - _cell_apply_plain(x, diag, F, Flo)) if want_residual else None
    return x, res


def nodal_apply_plain(phi, sigma, coefs, bc=None):
    """L(phi) of the Q1 nodal operator in multigrid.nodal_apply's
    operation order: phi wrapped by one node on each periodic axis, the
    contraction tree down the axes, C_p*sigma, the scatter tree back up
    with S^T(ts) + D^T(td) = (ts + td) + shift(ts - td) -- the shift
    wraps on a periodic axis and brings in exact zeros at both ends of a
    walled one -- and identity rows on Dirichlet sides."""
    lo, hi = _bc_codes(bc)
    p = phi
    for ax in range(3):
        if lo[ax] == PERIODIC:
            p = torch.cat([p, p.narrow(ax, 0, 1)], dim=ax)
    parts = {(): p}
    for ax in range(3):
        new = {}
        for key, v in parts.items():
            m = v.shape[ax]
            a, b = v.narrow(ax, 0, m - 1), v.narrow(ax, 1, m - 1)
            new[key + (0,)] = a + b
            new[key + (1,)] = a - b
        parts = new
    t = {pat: (coefs[pat[0] * 4 + pat[1] * 2 + pat[2]] * sigma * v)
         if any(pat) else None for pat, v in parts.items()}
    for ax in (2, 1, 0):
        new = {}
        for key in {k[:-1] for k in t}:
            ts, td = t[key + (0,)], t[key + (1,)]
            s0 = 0.0 if ts is None else ts
            a, b = s0 + td, s0 - td
            m = a.shape[ax]
            if lo[ax] == PERIODIC:
                new[key] = a + torch.cat([b.narrow(ax, m - 1, 1),
                                          b.narrow(ax, 0, m - 1)], dim=ax)
            else:
                zero = torch.zeros_like(a.narrow(ax, 0, 1))
                new[key] = (torch.cat([a, zero], dim=ax)
                            + torch.cat([zero, b], dim=ax))
        t = new
    out = t[()]
    for ax in range(3):
        n = out.shape[ax]
        for side, code in ((0, lo[ax]), (n - 1, hi[ax])):
            if code == DIRICHLET:
                out = out.clone()
                out.narrow(ax, side, 1).copy_(phi.narrow(ax, side, 1))
    return out


def nodal_smooth_plain(x, b, sigma, dinv, dx, nsweeps: int,
                       want_residual: bool = False, bc=None):
    """Plain version of the `nodal_smooth` kernel, walls included."""
    coefs = nodal_coefs(dx)
    isred = checkerboard(x.shape, x.device)
    red = isred.to(x.dtype)
    black = (~isred).to(x.dtype)
    for _ in range(nsweeps):
        x = x + red * (b - nodal_apply_plain(x, sigma, coefs, bc)) * dinv
        x = x + black * (b - nodal_apply_plain(x, sigma, coefs, bc)) * dinv
    res = ((b - nodal_apply_plain(x, sigma, coefs, bc)) if want_residual
           else None)
    return x, res


def _bc_codes(bc):
    """((lo0, lo1, lo2), (hi0, hi1, hi2)) as ints; None is periodic."""
    if bc is None:
        return (PERIODIC,) * 3, (PERIODIC,) * 3
    lo, hi = bc
    lo, hi = tuple(int(v) for v in lo), tuple(int(v) for v in hi)
    if len(lo) != 3 or len(hi) != 3:
        raise ValueError("bc must hold one (lo, hi) code per axis")
    return lo, hi
