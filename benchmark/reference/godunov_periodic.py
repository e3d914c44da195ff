"""A frozen copy of the plain versions of the three Godunov kernels of
incflo_torch/csrc/godunov.cu (incflo_torch/ops/godunov_kernels.py: the
periodic algebra of the corner-transport-upwind chain, PPM or PLM, on
(nx, ny, nz) tensors).  The reference step of a fully periodic 3D deck
advects with them, and the roofline counts the kernels' operations on
them (benchmark/roofline), so a later change to the program's kernels
moves neither the reference nor the yardstick.

  uad_plain        the transverse face velocities (kernel `uad`)
  predict_d_plain  the MAC face velocity of direction d (`predict_d`)
  advect_comp_plain  dq/dt of one component (`advect`)
"""

from __future__ import annotations

from typing import List, Sequence

import torch

SMALL_VEL = 1.0e-8          # reference incflo_godunov_ppm.H:16

def _sh(a, ax, s):
    """a(idx + s e_ax), periodic."""
    return a if s == 0 else torch.roll(a, -s, dims=ax)


def _div(a, c):
    """a / c for a Python float c, as the kernels divide: PyTorch divides
    a CUDA tensor by a Python float as a product with its reciprocal,
    which rounds differently; by a 0-d tensor it divides."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _van_leer(a, b, c):
    """vanLeer(center, plus, minus) (godunov_ppm.H:18-28)."""
    dsc = 0.5 * (b - c)
    dsl = 2.0 * (a - c)
    dsr = 2.0 * (b - a)
    lim = torch.sign(dsc) * torch.minimum(
        dsc.abs(), torch.minimum(dsl.abs(), dsr.abs()))
    return torch.where(dsl * dsr > 1.0e-20, lim, 0.0)


def _mc2_parts(a, b, c):
    dl = 2.0 * (b - a)
    dr = 2.0 * (c - b)
    dc = 0.5 * (c - a)
    dlim = torch.where(dl * dr >= 0.0, torch.minimum(dl.abs(), dr.abs()),
                       0.0)
    return dc, dlim


def _mc4(qm2, qm1, q0, qp1, qp2):
    """Order-4 MC slope (amrex_calc_xslope order 4, periodic interior)."""
    dcm, dlimm = _mc2_parts(qm2, qm1, q0)
    sm = torch.sign(dcm) * torch.minimum(dcm.abs(), dlimm)
    dcp, dlimp = _mc2_parts(q0, qp1, qp2)
    sp = torch.sign(dcp) * torch.minimum(dcp.abs(), dlimp)
    dc, dlim = _mc2_parts(qm1, q0, qp1)
    dq = (4.0 / 3.0) * dc - (1.0 / 6.0) * (sp + sm)
    return torch.sign(dq) * torch.minimum(dq.abs(), dlim)


def _upwind(lo, hi, w):
    st = torch.where(w >= 0.0, lo, hi)
    return torch.where(w.abs() < SMALL_VEL, 0.5 * (hi + lo), st)


def _riemann(stl, sth):
    st = torch.where(stl + sth >= 0.0, stl, sth)
    ltm = ((stl <= 0.0) & (sth >= 0.0)) | ((stl + sth).abs() < SMALL_VEL)
    return torch.where(ltm, 0.0, st)


def _traces(q, ax, wlo, whi, dtdx, use_ppm):
    """Per-cell characteristic traces (Im, Ip) along `ax` with wave speeds
    wlo/whi at the cell's lo/hi faces."""
    sm2, sm1, s0, sp1, sp2 = (_sh(q, ax, s) for s in (-2, -1, 0, 1, 2))
    if not use_ppm:
        slp = _mc4(sm2, sm1, s0, sp1, sp2)
        Im = s0 + 0.5 * (-1.0 - wlo * dtdx) * slp
        Ip = s0 + 0.5 * (1.0 - whi * dtdx) * slp
        return Im, Ip
    d1 = _van_leer(s0, sp1, sm1)
    d2 = _van_leer(sm1, s0, sm2)
    sedge1 = 0.5 * (s0 + sm1) - (1.0 / 6.0) * (d1 - d2)
    sedge1 = torch.clamp(sedge1, torch.minimum(s0, sm1),
                         torch.maximum(s0, sm1))
    d1p = _van_leer(sp1, sp2, s0)
    sedge2 = 0.5 * (sp1 + s0) - (1.0 / 6.0) * (d1p - d1)
    sedge2 = torch.clamp(sedge2, torch.minimum(s0, sp1),
                         torch.maximum(s0, sp1))
    flat = (sedge2 - s0) * (s0 - sedge1) < 0.0
    big_p = (sedge2 - s0).abs() >= 2.0 * (sedge1 - s0).abs()
    big_m = (sedge1 - s0).abs() >= 2.0 * (sedge2 - s0).abs()
    sp = torch.where(flat, s0,
                     torch.where(big_p, 3.0 * s0 - 2.0 * sedge1, sedge2))
    sm = torch.where(flat, s0,
                     torch.where(~big_p & big_m, 3.0 * s0 - 2.0 * sedge2,
                                 sedge1))
    s6 = 6.0 * s0 - 3.0 * (sm + sp)
    sig_p = whi.abs() * dtdx
    sig_m = wlo.abs() * dtdx
    Ip = torch.where(whi > SMALL_VEL,
                     sp - 0.5 * sig_p * ((sp - sm)
                                         - (1.0 - 2.0 / 3.0 * sig_p) * s6),
                     s0)
    Im = torch.where(wlo < -SMALL_VEL,
                     sm + 0.5 * sig_m * ((sp - sm)
                                         + (1.0 - 2.0 / 3.0 * sig_m) * s6),
                     s0)
    return Im, Ip


def _faces_full(a, d):
    """Cell-shaped lo-face array -> standard n+1 layout along d."""
    return torch.cat([a, a.narrow(d, 0, 1)], dim=d)


def uad_plain(grid, vel, dt, use_ppm: bool) -> List[torch.Tensor]:
    """Plain version of the `uad` kernel: three cell-shaped face arrays
    (entry i = the lo face of cell i)."""
    out = []
    for ax in range(3):
        v = vel[..., ax]
        Im, Ip = _traces(v, ax, v, v, _div(dt, grid.dx[ax]), use_ppm)
        out.append(_riemann(_sh(Ip, ax, -1), Im))
    return out


def predict_d_plain(grid, vel, uad, force_d, dt, d: int,
                    use_ppm: bool) -> torch.Tensor:
    """Plain version of the `predict_d` kernel: the MAC face velocity of
    direction d in the standard n+1 layout."""
    dx = grid.dx
    comp = [vel[..., c] for c in range(3)]
    xlo, xhi, edge = {}, {}, {}
    for ax in range(3):
        Im, Ip = _traces(comp[d], ax, comp[ax], comp[ax], _div(dt, dx[ax]),
                         use_ppm)
        xlo[ax] = _sh(Ip, ax, -1)
        xhi[ax] = Im
        edge[ax] = _upwind(xlo[ax], xhi[ax], uad[ax])
    stl, sth = xlo[d], xhi[d]
    for t in (a for a in range(3) if a != d):
        o = 3 - d - t
        corr_o = (_div(dt, 6.0 * dx[o]) * (_sh(uad[o], o, 1) + uad[o])
                  * (_sh(edge[o], o, 1) - edge[o]))
        inter = _upwind(xlo[t] - _sh(corr_o, t, -1), xhi[t] - corr_o,
                        uad[t])
        corr_t = (_div(dt, 4.0 * dx[t]) * (_sh(uad[t], t, 1) + uad[t])
                  * (_sh(inter, t, 1) - inter))
        stl = stl - _sh(corr_t, d, -1)
        sth = sth - corr_t
    if force_d is not None:
        stl = stl + 0.5 * dt * _sh(force_d, d, -1)
        sth = sth + 0.5 * dt * force_d
    return _faces_full(_riemann(stl, sth), d)


def advect_comp_plain(grid, q, umac, force_q, dt, icons: bool,
                      use_ppm: bool) -> torch.Tensor:
    """Plain version of the `advect` kernel: dq/dt of one component."""
    dx = grid.dx
    mac = [umac[ax].narrow(ax, 0, grid.n_cell[ax]) for ax in range(3)]
    mac_hi = [_sh(mac[ax], ax, 1) for ax in range(3)]
    xlo, xhi, edge = {}, {}, {}
    for ax in range(3):
        Im, Ip = _traces(q, ax, mac[ax], mac_hi[ax], _div(dt, dx[ax]),
                         use_ppm)
        xlo[ax] = _sh(Ip, ax, -1)
        xhi[ax] = Im
        edge[ax] = _upwind(xlo[ax], xhi[ax], mac[ax])
    rate = None
    for d in range(3):
        stl, sth = xlo[d], xhi[d]
        for t in (a for a in range(3) if a != d):
            o = 3 - d - t
            e_lo, e_hi = edge[o], _sh(edge[o], o, 1)
            if icons:
                corr_o = (_div(dt, 3.0 * dx[o])
                          * ((e_hi * mac_hi[o] - e_lo * mac[o])
                             - q * (mac_hi[o] - mac[o])))
            else:
                corr_o = (_div(dt, 6.0 * dx[o])
                          * (mac_hi[o] + mac[o]) * (e_hi - e_lo))
            inter = _upwind(xlo[t] - _sh(corr_o, t, -1), xhi[t] - corr_o,
                            mac[t])
            i_hi = _sh(inter, t, 1)
            if icons:
                corr_t = (_div(dt, 2.0 * dx[t])
                          * ((i_hi * mac_hi[t] - inter * mac[t])
                             - q * (mac_hi[t] - mac[t])))
            else:
                corr_t = (_div(dt, 4.0 * dx[t])
                          * (mac_hi[t] + mac[t]) * (i_hi - inter))
            stl = stl - _sh(corr_t, d, -1)
            sth = sth - corr_t
        if force_q is not None:
            stl = stl + 0.5 * dt * _sh(force_q, d, -1)
            sth = sth + 0.5 * dt * force_q
        qf = _upwind(stl, sth, mac[d])
        qf_hi = _sh(qf, d, 1)
        if icons:
            term = _div(mac[d] * qf - mac_hi[d] * qf_hi, dx[d])
        else:
            term = _div(0.5 * (mac[d] + mac_hi[d]) * (qf - qf_hi), dx[d])
        rate = term if rate is None else rate + term
    return rate


def predict(grid, vel, forces, dt, use_ppm: bool) -> List[torch.Tensor]:
    """The MAC face velocities of a fully periodic 3D grid: uad, then
    predict_d for d = 0, 1, 2.  vel and forces (or None) (nx, ny, nz, 3);
    dt a 0-d tensor."""
    uad = uad_plain(grid, vel, dt, use_ppm)
    return [predict_d_plain(grid, vel, uad,
                            None if forces is None else forces[..., d],
                            dt, d, use_ppm) for d in range(3)]


def advect(grid, q, umac, forces, dt, iconserv: Sequence[int],
           use_ppm: bool) -> torch.Tensor:
    """dq/dt of every component of q (nx, ny, nz, ncomp)."""
    return torch.stack(
        [advect_comp_plain(grid, q[..., n], umac,
                           None if forces is None else forces[..., n], dt,
                           bool(iconserv[n]), use_ppm)
         for n in range(q.shape[-1])], dim=-1)
