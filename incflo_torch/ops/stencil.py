"""Shift/slope stencil primitives on dense tensors (port of
incflo_tpu/ops/stencil.py).

All functions take tensors that already carry enough ghost layers and
return tensors on a smaller index range -- callers track ranges
explicitly.
"""

from __future__ import annotations

import torch


def shift(a: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """out[i] = a[i+off] along axis, trimming |off| cells from the
    opposite end."""
    n = a.shape[axis]
    if off >= 0:
        return a.narrow(axis, off, n - off)
    return a.narrow(axis, 0, n + off)


def window(a: torch.Tensor, axis: int, lo_trim: int,
           hi_trim: int) -> torch.Tensor:
    """Trim lo_trim cells from the low end and hi_trim from the high end."""
    return a.narrow(axis, lo_trim, a.shape[axis] - lo_trim - hi_trim)


def inner(a: torch.Tensor, ng, ndim=None) -> torch.Tensor:
    """Strip `ng` ghost layers from every spatial axis (first `ndim`)."""
    nd = ndim if ndim is not None else a.dim()
    ngs = [ng] * nd if isinstance(ng, int) else list(ng)
    for ax in range(nd):
        if ngs[ax]:
            a = window(a, ax, ngs[ax], ngs[ax])
    return a


def mc_slope(qm, q, qp):
    """Monotonized-central limited slope (order-2 amrex_calc_xslope)."""
    dl = 2.0 * (q - qm)
    dr = 2.0 * (qp - q)
    dc = 0.5 * (qp - qm)
    s = torch.minimum(torch.minimum(dl.abs(), dc.abs()), dr.abs())
    s = torch.where(dl * dr > 0.0, s, torch.zeros_like(s))
    return torch.where(dc > 0.0, s, -s)


def mc_slope_extdir(qm, q, qp, on_lo_bdry, on_hi_bdry):
    """MC slope with the one-sided boundary form next to ext_dir /
    hoextrap faces (AMReX_Slopes_K.H amrex_calc_xslope_extdir)."""
    dl = 2.0 * (q - qm)
    dr = 2.0 * (qp - q)
    dc = 0.5 * (qp - qm)
    dc = torch.where(on_lo_bdry, (qp + 3.0 * q - 4.0 * qm) / 3.0, dc)
    dc = torch.where(on_hi_bdry, (4.0 * qp - 3.0 * q - qm) / 3.0, dc)
    s = torch.minimum(torch.minimum(dl.abs(), dc.abs()), dr.abs())
    s = torch.where(dl * dr > 0.0, s, torch.zeros_like(s))
    return torch.where(dc > 0.0, s, -s)


def face_avg(a: torch.Tensor, axis: int) -> torch.Tensor:
    """0.5*(a[i-1]+a[i]) on the n-1 interior faces of axis."""
    return 0.5 * (window(a, axis, 1, 0) + window(a, axis, 0, 1))


def diff_along(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i+1]-a[i] along axis (n-1 results for n entries)."""
    return window(a, axis, 1, 0) - window(a, axis, 0, 1)


def comp_stack(parts, axis: int = -1) -> torch.Tensor:
    """Stack per-component fields along a trailing component axis."""
    assert axis == -1
    return torch.stack(parts, dim=-1)
