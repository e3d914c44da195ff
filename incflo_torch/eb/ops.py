"""EB cut-cell operators (port of incflo_tpu/eb/ops.py): the cut-cell
convective rate, flux redistribution, the small-cell correction,
connectivity, and the one-sided derivatives at cut cells.

Reference: src/convection/incflo_compute_advection_term.cpp
(compute_convective_rate_eb :384-428, redistribute_eb :430-515) and
incflo_correct_small_cells.cpp.  The scatter-with-atomics redistribution
is a gather over the 3^d - 1 neighbour offsets; connectivity, the
neighbour volume sums, the least-squares normal matrices and the wall
probes are static geometry, built on the host with numpy
(build_eb_arrays) and moved once to the simulation's device as the
tensors of EBArrays.  Everything that runs per step is plain PyTorch on
that device: incflo_tpu runs it in jnp, with no Pallas kernel.

On an x slab of a mesh (parallel/mesh.py) every rank builds the whole
level's arrays from the deck and keeps its rows of them (slab_arrays):
the cell arrays its nxl rows, the x face arrays its nxl + 1 faces, the
arrays with ghost cells (ccent_g2, conn_g1, lsq_minv_g1, near_g1) their
ghost rows from the whole level, the octant fractions its 2 nxl rows.
The per-step operators then run on the slab's ghost-filled windows as
on the whole level; redistribution reads its x neighbours from a
one-row halo exchange of the cut-cell rate and of the senders' shares.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from incflo_torch.eb.geometry import COVERED, CUT, REGULAR, EBData
from incflo_torch.grid import Grid
from incflo_torch.ops.stencil import window
from incflo_torch.parallel.mesh import mesh_of


@dataclasses.dataclass(frozen=True)
class EBArrays:
    """Static cut-cell data as tensors on the simulation's device."""
    vfrac: torch.Tensor
    afrac: Tuple[torch.Tensor, ...]
    cut: torch.Tensor          # 1.0 where cut
    covered: torch.Tensor      # 1.0 where covered
    fluid: torch.Tensor        # 1 - covered
    small: torch.Tensor        # vfrac < 1e-4 but not covered
    eb_area: torch.Tensor      # EB boundary area fraction per cell
    # redistribution statics
    nbr_conn: torch.Tensor     # (noff, cells) connectivity masks
    vtot: torch.Tensor         # sum of the connected neighbours' vfrac
    wtot_inv: torch.Tensor     # 1 / sum of the connected neighbours' weights
    offsets: tuple             # the offset tuples of nbr_conn's rows
    # centroid-aware MOL statics (eb/mol.py)
    face_cent: Tuple[torch.Tensor, ...] = ()  # per axis: faces+(d,), dx units
    ccent_g2: Optional[torch.Tensor] = None   # cell fluid centroid, 2 ghosts
    conn_g1: Optional[torch.Tensor] = None    # (noff, cells+2), 1 ghost
    # packed symmetric inverse of the least-squares normal matrix
    # (2D: [xx, xy, yy]; 3D: [xx, xy, xz, yy, yz, zz])
    lsq_minv_g1: Optional[torch.Tensor] = None
    near_g1: Optional[torch.Tensor] = None    # 1.0 within 2 cells of the EB
    # octant (2x lattice) fluid fractions of the exact nodal operator
    vfrac_oct: Optional[torch.Tensor] = None
    # Dirichlet wall-stencil geometry (ops/diffusion._eb_wall_coef):
    # centroid-to-wall distance, |A_eb|/V and the unit normal into the
    # fluid per cut cell
    wall_dist: Optional[torch.Tensor] = None
    area_ov: Optional[torch.Tensor] = None
    eb_normal: Optional[torch.Tensor] = None
    # wall-gradient probe statics of incflo_tpu's opt-in INCFLO_EB_JC
    # correction, which the port leaves off: built for parity of the
    # arrays, read by nothing on the step
    probe_lo: Optional[torch.Tensor] = None
    probe_frac: Optional[torch.Tensor] = None
    probe_ok: Optional[torch.Tensor] = None
    probe_nn: Optional[torch.Tensor] = None
    probe_c2ok: Optional[torch.Tensor] = None
    # on an x slab (slab_arrays): vfrac and, per offset, connectivity x
    # cut, with one x row a side from the whole level (zero beyond its
    # own x faces), for redistribute's x neighbours; the octant fractions
    # with one x ghost row a side (wrap, or edge at the level's x faces)
    vfrac_x1: Optional[torch.Tensor] = None
    conn_cut_x1: Optional[torch.Tensor] = None
    vfrac_oct_x1: Optional[torch.Tensor] = None


def _connectivity(eb: EBData, grid: Grid) -> Tuple[np.ndarray, list]:
    """Boolean connectivity masks per neighbor offset, approximating
    AMReX's EBCellFlag connectivity: a neighbor is connected if it is
    uncovered and some axis-ordered face path between the two cells has
    open faces (afrac > 0) through uncovered intermediate cells."""
    nd = grid.ndim
    n = grid.n_cell
    cov = (eb.flags == COVERED)

    def pad_bool(a, val=True):
        return np.pad(a, 1, constant_values=val)

    covp = pad_bool(cov)
    for d in range(nd):
        if grid.periodic[d]:
            sl_lo = [slice(1, -1)] * nd
            sl_hi = [slice(1, -1)] * nd
            sl_lo[d] = slice(0, 1)
            sl_hi[d] = slice(-1, None)
            src_hi = [slice(1, -1)] * nd
            src_lo = [slice(1, -1)] * nd
            src_hi[d] = slice(-2, -1)
            src_lo[d] = slice(1, 2)
            covp[tuple(sl_lo)] = covp[tuple(src_hi)]
            covp[tuple(sl_hi)] = covp[tuple(src_lo)]

    # face-open masks: open[d][cell, toward +] etc., padded
    def face_open(d):
        a = eb.afrac[d] > 1e-12
        return a   # faces n+1 along d

    opens = [face_open(d) for d in range(nd)]

    def cell_at(arr_p, off):
        sl = [slice(1 + off[d], 1 + off[d] + n[d]) for d in range(nd)]
        return arr_p[tuple(sl)]

    def step_open(pos_off, d, sgn):
        """Face between cell (i+pos_off) and (i+pos_off+sgn*e_d) open?"""
        a = opens[d]
        idx = []
        for ax in range(nd):
            if ax == d:
                f = pos_off[ax] + (1 if sgn > 0 else 0)
                idx.append(_face_take(a.shape[ax], f, n[ax],
                                      grid.periodic[ax]))
            else:
                idx.append(_cell_take(a.shape[ax], pos_off[ax], n[ax],
                                      grid.periodic[ax]))
        return a[np.ix_(*idx)]

    offsets = [off for off in itertools.product((-1, 0, 1), repeat=nd)
               if any(off)]
    masks = []
    for off in offsets:
        nbr_ok = ~cell_at(covp, off)
        # all axis orderings of the staircase path
        axes = [d for d in range(nd) if off[d] != 0]
        path_ok = np.zeros(n, bool)
        for perm in itertools.permutations(axes):
            ok = np.ones(n, bool)
            pos = [0] * nd
            for step_i, d in enumerate(perm):
                sgn = off[d]
                ok &= step_open(tuple(pos), d, sgn)
                pos[d] += sgn
                if step_i < len(perm) - 1:   # intermediate cell open?
                    ok &= ~cell_at(covp, tuple(pos))
            path_ok |= ok
        masks.append(nbr_ok & path_ok)
    return np.stack(masks), offsets


def _cell_take(size, off, n, periodic):
    idx = np.arange(n) + off
    if periodic:
        return idx % n
    return np.clip(idx, 0, n - 1)  # afrac lookups clipped (masked anyway)


def _face_take(size, f, n, periodic):
    idx = np.arange(n) + f
    if periodic:
        # faces 0..n with face n == face 0
        return idx % n
    return np.clip(idx, 0, n)


def _pad_geom(a: np.ndarray, k: int, grid: Grid, ncomp_axes: int = 0
              ) -> np.ndarray:
    """Pad static geometry by k ghost cells per spatial axis: periodic
    wrap, else edge replicate (domain-adjacent geometry is regular in all
    supported decks; boundary faces are overridden by the BC path).
    ncomp_axes trailing axes are never padded."""
    out = a
    for ax in range(grid.ndim):
        p = [(0, 0)] * a.ndim
        p[ax] = (k, k)
        mode = "wrap" if grid.periodic[ax] else "edge"
        out = np.pad(out, p, mode=mode)
    return out


def _dilate_np(mask: np.ndarray, k: int, grid: Grid) -> np.ndarray:
    """Grow a boolean mask by k cells (host-side, wrap/edge like _pad_geom)."""
    m = mask
    for _ in range(k):
        mp = _pad_geom(m, 1, grid)
        acc = m.copy()
        for ax in range(grid.ndim):
            sl_lo = [slice(1, 1 + s) for s in m.shape]
            sl_hi = [slice(1, 1 + s) for s in m.shape]
            sl_lo[ax] = slice(0, m.shape[ax])
            sl_hi[ax] = slice(2, m.shape[ax] + 2)
            acc |= mp[tuple(sl_lo)] | mp[tuple(sl_hi)]
        m = acc
    return m


def _lsq_statics(eb: EBData, grid: Grid, conn: np.ndarray, offsets):
    """Static least-squares slope geometry on the grown-by-1 box:
    M(i) = sum_off conn(i,off) * delta delta^T,
    delta = off + ccent(i+off) - ccent(i);
    returns (ccent_g2, conn_g1, packed Minv_g1).  The normal matrix is
    pure geometry, so its (pseudo)inverse is precomputed host-side and
    the runtime slope is npack multiply-adds per cell."""
    nd = grid.ndim
    ccent_g2 = _pad_geom(eb.centroid, 2, grid, ncomp_axes=1)
    conn_g1 = np.stack([_pad_geom(m, 1, grid) for m in conn])
    g1_shape = tuple(s + 2 for s in grid.n_cell)
    M = np.zeros(g1_shape + (nd, nd))
    c0 = ccent_g2[tuple(slice(1, 1 + s) for s in g1_shape)]
    for m, off in zip(conn_g1, offsets):
        cn = ccent_g2[tuple(slice(1 + off[ax], 1 + off[ax] + g1_shape[ax])
                            for ax in range(nd))]
        delta = np.asarray(off, float) + cn - c0
        w = m.astype(float)
        for a in range(nd):
            for b in range(a, nd):
                M[..., a, b] += w * delta[..., a] * delta[..., b]
    for a in range(nd):
        for b in range(a):
            M[..., a, b] = M[..., b, a]
    # pseudo-inverse: rank-deficient neighborhoods (sliver cells connected
    # along fewer than nd directions) get the minimum-norm least-squares
    # slope in the spanned directions and zero across the unseen ones;
    # fully isolated/covered cells get Minv = 0 (slope 0)
    Minv = np.linalg.pinv(M, rcond=1e-10, hermitian=True)
    pairs = [(a, b) for a in range(nd) for b in range(a, nd)]
    packed = np.stack([Minv[..., a, b] for a, b in pairs], axis=-1)
    return ccent_g2, conn_g1, packed


PROBE_D1 = 1.5   # probe distances from the wall, in units of min(dx)
PROBE_D2 = 3.0


def _wall_probes(eb: EBData, grid: Grid):
    """Statics for the Johansen-Colella second-order EB wall gradient:
    for every cut cell, two trilinear interpolation points along the
    INWARD wall normal at d1/d2 = PROBE_D1/D2 * min(dx) from the wall.
    A probe is usable only when all 2^D surrounding cells have their
    center in the fluid (REGULAR, or cut with vfrac > 0.5 as the
    standard center-in-fluid proxy -- a solid-side center would poison
    the trilinear read); cells failing that keep the centroid-Taylor
    fallback.
    Reference discretization: MLEBABecLap/MLEBTensorOp EB-Dirichlet
    flux stencils (src/diffusion/DiffusionTensorOp.cpp:32-43)."""
    nd = grid.ndim
    n = grid.n_cell
    dx = np.asarray(grid.dx, np.float64)
    if eb.wall_dist is None:
        return None
    hmin = dx.min()
    ctr = np.stack(np.meshgrid(*[(np.arange(m) + 0.5) * dx[d]
                                 for d, m in enumerate(n)],
                               indexing="ij"), axis=-1)
    xw = ctr + eb.centroid * dx - eb.wall_dist[..., None] * eb.eb_normal
    cut = eb.flags == CUT
    usable = (eb.flags == REGULAR) | (cut & (eb.vfrac > 0.5))
    regp = np.pad(usable, 1, constant_values=False)
    for d in range(nd):
        if grid.periodic[d]:
            sl_lo = [slice(1, -1)] * nd
            sl_hi = [slice(1, -1)] * nd
            sl_lo[d] = slice(0, 1)
            sl_hi[d] = slice(-1, None)
            src_hi = [slice(1, -1)] * nd
            src_lo = [slice(1, -1)] * nd
            src_hi[d] = slice(-2, -1)
            src_lo[d] = slice(1, 2)
            regp[tuple(sl_lo)] = regp[tuple(src_hi)]
            regp[tuple(sl_hi)] = regp[tuple(src_lo)]
    def usable_at(ci):
        """All-usable test for integer cell indices ci (cells, D)."""
        in_dom = np.ones(n, bool)
        idx = []
        for d in range(nd):
            c = ci[..., d]
            if grid.periodic[d]:
                idx.append(c % n[d])
            else:
                in_dom &= (c >= 0) & (c < n[d])
                idx.append(np.clip(c, 0, n[d] - 1))
        return in_dom & regp[tuple(i + 1 for i in idx)]

    lo_all, fr_all, nn_all = [], [], []
    ok = cut & (eb.wall_dist > 0)
    c2ok = np.ones(n + (2,), bool)
    for k, dist in ((0, PROBE_D1 * hmin), (1, PROBE_D2 * hmin)):
        p = xw + dist * eb.eb_normal              # physical probe point
        g = p / dx - 0.5                          # cell-index space
        lo = np.floor(g).astype(np.int64)
        fr = g - lo
        nn = np.rint(g).astype(np.int64)
        lo_all.append(lo)
        fr_all.append(fr)
        nn_all.append(nn)
        for corner in itertools.product((0, 1), repeat=nd):
            ok = ok & usable_at(lo + np.asarray(corner))
        # curvature-correction stencil: nn and its +-1 axis neighbors
        cu = usable_at(nn)
        for d in range(nd):
            e = np.zeros(nd, np.int64)
            e[d] = 1
            cu = cu & usable_at(nn + e) & usable_at(nn - e)
        c2ok[..., k] = cu
    probe_lo = np.stack(lo_all, axis=-2)          # (cells, 2, D)
    probe_frac = np.stack(fr_all, axis=-2)
    probe_nn = np.stack(nn_all, axis=-2)
    return (probe_lo, probe_frac, ok.astype(np.float64), probe_nn,
            c2ok.astype(np.float64))


def build_eb_arrays(eb: EBData, grid: Grid, dtype, device) -> EBArrays:
    """The static cut-cell tensors of `eb` on `device` (host numpy, as
    incflo_tpu/eb/ops.py:330-395)."""
    conn, offsets = _connectivity(eb, grid)
    nd = grid.ndim
    n = grid.n_cell
    cut = (eb.flags == CUT)
    cov = (eb.flags == COVERED)

    def nbr(arr, off):
        out = arr
        for d in range(nd):
            if off[d] == 0:
                continue
            out = np.roll(out, -off[d], axis=d)
            if not grid.periodic[d]:
                sl = [slice(None)] * nd
                if off[d] > 0:
                    sl[d] = slice(n[d] - off[d], n[d])
                else:
                    sl[d] = slice(0, -off[d])
                out[tuple(sl)] = 0.0
        return out

    vtot = np.zeros(n)
    wtot = np.zeros(n)
    for m, off in zip(conn, offsets):
        vtot += m * nbr(eb.vfrac, off)
        wtot += m * nbr(eb.vfrac, off)   # weight 1 inside the domain
    small = (eb.vfrac < 1e-4) & ~cov

    ccent_g2, conn_g1, lsq_minv = _lsq_statics(eb, grid, conn, offsets)
    near = _dilate_np(eb.flags != REGULAR, 2, grid)
    near_g1 = _pad_geom(near, 1, grid)

    def mk(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            dtype=dtype, device=device)

    def mk_int(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    face_cent = tuple(mk(fc) for fc in eb.face_cent) \
        if eb.face_cent is not None \
        else tuple(mk(np.zeros(a.shape + (nd,))) for a in eb.afrac)
    probes = _wall_probes(eb, grid)
    return EBArrays(
        vfrac=mk(eb.vfrac),
        afrac=tuple(mk(a) for a in eb.afrac),
        cut=mk(cut), covered=mk(cov), fluid=mk(~cov), small=mk(small),
        eb_area=mk(eb.eb_area),
        nbr_conn=mk(conn),
        # masked reciprocals, not eps-regularized: 1/(0 + 1e-80) = 1e80
        # overflows to inf in float32 and inf*0 = NaN would poison the
        # redistribution in covered cells
        vtot=mk(np.where(vtot > 0.0, vtot, 1.0)),
        wtot_inv=mk(np.where(wtot > 0.0,
                             1.0 / np.where(wtot > 0.0, wtot, 1.0), 0.0)),
        offsets=tuple(offsets),
        face_cent=face_cent,
        ccent_g2=mk(ccent_g2),
        conn_g1=mk(conn_g1),
        lsq_minv_g1=mk(lsq_minv),
        near_g1=mk(near_g1),
        vfrac_oct=mk(eb.vfrac_oct) if eb.vfrac_oct is not None else None,
        wall_dist=mk(eb.wall_dist) if eb.wall_dist is not None else None,
        area_ov=mk(_area_over_volume(eb, grid)),
        eb_normal=mk(eb.eb_normal),
        **(dict(probe_lo=mk_int(probes[0]), probe_frac=mk(probes[1]),
                probe_ok=mk(probes[2]), probe_nn=mk_int(probes[3]),
                probe_c2ok=mk(probes[4]))
           if probes is not None else {}),
    )


def slab_arrays(eb: EBArrays, mesh, grid: Grid) -> EBArrays:
    """This rank's x slab of the whole level's arrays `eb` (the level
    `grid`; a cut, no exchange: SlabMesh.cut_x).  The wall probes hold
    flat whole-level indices and no step reads them: None on a slab."""
    per = grid.periodic[0]
    n = grid.n_cell[0]
    nxl = n // mesh.size
    x0 = mesh.rank * nxl

    def cut(a, layout="cell", axis=0):
        if a is None:
            return None
        return mesh.cut_x(a, layout=layout, periodic=per,
                          axis=axis).contiguous()

    def ghosted(a, g, axis=0):
        """Rows of an array that carries g ghost cells a side: its
        ghost rows are the whole level's (wrap or edge at its faces)."""
        return None if a is None else a.narrow(axis, x0, nxl + 2 * g) \
            .contiguous()

    cells = ("vfrac", "cut", "covered", "fluid", "small", "eb_area", "vtot",
             "wtot_inv", "wall_dist", "area_ov", "eb_normal")
    conn_cut = eb.nbr_conn * eb.cut
    return dataclasses.replace(
        eb, **{k: cut(getattr(eb, k)) for k in cells},
        afrac=tuple(cut(a, "face" if d == 0 else "cell")
                    for d, a in enumerate(eb.afrac)),
        face_cent=tuple(cut(a, "face" if d == 0 else "cell")
                        for d, a in enumerate(eb.face_cent)),
        nbr_conn=cut(eb.nbr_conn, axis=1),
        ccent_g2=ghosted(eb.ccent_g2, 2),
        conn_g1=ghosted(eb.conn_g1, 1, axis=1),
        lsq_minv_g1=ghosted(eb.lsq_minv_g1, 1),
        near_g1=ghosted(eb.near_g1, 1),
        vfrac_oct=cut(eb.vfrac_oct, "octant"),
        probe_lo=None, probe_frac=None, probe_ok=None, probe_nn=None,
        probe_c2ok=None,
        vfrac_x1=mesh.cut_x(eb.vfrac, 1, periodic=per, beyond="zero"),
        conn_cut_x1=mesh.cut_x(conn_cut, 1, periodic=per, beyond="zero",
                               axis=1),
        vfrac_oct_x1=None if eb.vfrac_oct is None else mesh.cut_x(
            eb.vfrac_oct, 1, layout="octant", periodic=per))


def _area_over_volume(eb: EBData, grid: Grid) -> np.ndarray:
    """|A_eb| / V_cell (physical 1/length) from the divergence theorem:
    A_eb n_d = (afrac_lo - afrac_hi)_d * V/dx_d, exact for planar cuts
    including anisotropic dx."""
    nd = grid.ndim
    n = grid.n_cell
    s = np.zeros(n)
    for d in range(nd):
        a = eb.afrac[d]
        lo = np.take(a, range(0, n[d]), axis=d)
        hi = np.take(a, range(1, n[d] + 1), axis=d)
        s = s + ((lo - hi) / grid.dx[d]) ** 2
    return np.sqrt(s)


def _roll_nbr(a: torch.Tensor, off, grid: Grid, x1: bool = False):
    """a(i+off) over the first ndim axes (trailing axes ride along), zero
    beyond non-periodic domain faces.  x1: a carries one x row a side
    (a rank's slab with its halo), and x takes its neighbour from it."""
    out = a
    for d in range(grid.ndim):
        if d == 0 and x1:
            out = out.narrow(0, 1 + off[0], out.shape[0] - 2)
            continue
        if off[d] == 0:
            continue
        out = torch.roll(out, -off[d], dims=d)
        if not grid.periodic[d]:
            n = grid.n_cell[d]
            idx = torch.arange(n, device=a.device) + off[d]
            valid = (idx >= 0) & (idx < n)
            shape = [1] * out.dim()
            shape[d] = -1
            out = out * valid.reshape(shape).to(out.dtype)
    return out


def eb_convective_rate(fluxes: Sequence[torch.Tensor], grid: Grid,
                       eb: EBArrays) -> torch.Tensor:
    """Cut-cell finite-volume rate: the regular flux difference in regular
    cells, (1/vfrac) sum(ap f) in cut cells, 0 in covered cells
    (reference compute_convective_rate_eb)."""
    out = None
    for d in range(grid.ndim):
        af = eb.afrac[d][..., None] * fluxes[d]
        t = (window(af, d, 0, 1) - window(af, d, 1, 0)) * (1.0 / grid.dx[d])
        out = t if out is None else out + t
    vf = torch.where(eb.covered > 0.5, 1.0, eb.vfrac)
    out = out / vf[..., None]
    return out * eb.fluid[..., None]


def redistribute(dUdt_in: torch.Tensor, grid: Grid, eb: EBArrays
                 ) -> torch.Tensor:
    """Mass-conservative neighbourhood redistribution of the cut-cell
    defect (reference redistribute_eb, gather form).  On an x slab the x
    neighbours come from one-row halos of dUdt_in and of the senders'
    shares, and the static ones from the slab's vfrac_x1 and
    conn_cut_x1."""
    mesh = mesh_of(grid)
    slab = mesh is not None

    def halo(t):
        zero = lambda x: torch.zeros_like(x.narrow(0, 0, 1))
        return mesh.halo_x(t, 1, periodic=grid.periodic[0],
                           ends=(zero, zero))

    vf = eb.vfrac[..., None]
    # divnc: the connected neighbours' volume-weighted average of dUdt_in
    du = halo(dUdt_in) if slab else dUdt_in
    vfn = eb.vfrac_x1 if slab else eb.vfrac
    acc = 0.0
    for m, off in zip(eb.nbr_conn, eb.offsets):
        acc = acc + (m * _roll_nbr(vfn, off, grid, slab))[..., None] \
            * _roll_nbr(du, off, grid, slab)
    divnc = acc / eb.vtot[..., None]
    optmp = (1.0 - vf) * (divnc - dUdt_in) * (eb.cut[..., None])
    delm = -vf * optmp
    send = delm * eb.wtot_inv[..., None]      # per-cut-cell share
    # gather: cell c receives send(c - off) for each offset where the
    # sender c - off is cut and connected toward +off
    if slab:
        send = halo(send)
    mc = eb.conn_cut_x1 if slab else eb.nbr_conn * eb.cut
    recv = 0.0
    for m, off in zip(mc, eb.offsets):
        neg = tuple(-o for o in off)
        contrib = m[..., None] * send
        recv = recv + _roll_nbr(contrib, neg, grid, slab)
    return dUdt_in + optmp + recv


def correct_small_cells(vel: torch.Tensor, umac: Sequence[torch.Tensor],
                        grid: Grid, eb: EBArrays) -> torch.Tensor:
    """Cells with 0 < vfrac < 1e-4: the cell velocity becomes the
    area-weighted average of the face MAC velocities (reference
    incflo_correct_small_cells.cpp:5-75)."""
    comps = []
    for d in range(grid.ndim):
        ap, u = eb.afrac[d], umac[d]
        ap_lo, ap_hi = window(ap, d, 0, 1), window(ap, d, 1, 0)
        u_lo, u_hi = window(u, d, 0, 1), window(u, d, 1, 0)
        denom = ap_lo + ap_hi
        avg = torch.where(denom > 1e-30,
                          (ap_lo * u_lo + ap_hi * u_hi)
                          / torch.clamp_min(denom, 1e-30),
                          vel[..., d])
        comps.append(torch.where(eb.small > 0.5, avg, vel[..., d]))
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------
# one-sided derivatives at cut cells (reference incflo_derive_K.H:7-164:
# quadratic one-sided (-1.5, 2, -0.5) stencils toward connected cells)
# ---------------------------------------------------------------------

def _axis_conn(eb: EBArrays, axis: int, sign: int):
    """Connectivity mask toward the +/- unit offset along `axis`."""
    off = tuple(sign if d == axis else 0 for d in range(eb.vfrac.dim()))
    return eb.nbr_conn[eb.offsets.index(off)]


def eb_cc_derivative(q_g: torch.Tensor, comp, axis: int, grid: Grid,
                     ng: int, eb: EBArrays) -> torch.Tensor:
    """d q[..., comp] / dx_axis at the interior cell centres: central in
    regular cells; the quadratic one-sided (-1.5, 2, -0.5) stencil toward
    the connected side at cut cells with a covered neighbour (ng >= 2)."""
    nd = grid.ndim
    v = q_g[..., comp] if comp is not None else q_g

    def interior(a, shift):
        """a(i + shift e_axis) on the interior cells."""
        out = a
        for ax in range(nd):
            lo = ng + (shift if ax == axis else 0)
            hi = ng - (shift if ax == axis else 0)
            out = window(out, ax, lo, hi)
        return out

    idx = 1.0 / grid.dx[axis]
    c0, c1, c2 = -1.5, 2.0, -0.5
    central = 0.5 * (interior(v, 1) - interior(v, -1)) * idx
    backward = -(c0 * interior(v, 0) + c1 * interior(v, -1)
                 + c2 * interior(v, -2)) * idx
    forward = (c0 * interior(v, 0) + c1 * interior(v, 1)
               + c2 * interior(v, 2)) * idx
    conn_p = _axis_conn(eb, axis, +1) > 0.5
    conn_m = _axis_conn(eb, axis, -1) > 0.5
    cut = eb.cut > 0.5
    # each one-sided stencil needs the opposite side connected 2 deep; an
    # isolated sliver (both sides covered) gets derivative 0
    one_sided = torch.where(cut & ~conn_p & conn_m, backward,
                            torch.where(cut & ~conn_m & conn_p, forward,
                                        central))
    one_sided = torch.where(cut & ~conn_p & ~conn_m, 0.0, one_sided)
    return one_sided * eb.fluid


def eb_strainrate(vel_g: torch.Tensor, grid: Grid, ng: int, eb: EBArrays
                  ) -> torch.Tensor:
    """||2S|| with one-sided derivatives at cut cells, on the interior
    (reference incflo_strainrate_eb)."""
    def d(c, ax):
        return eb_cc_derivative(vel_g, c, ax, grid, ng, eb)
    if grid.ndim == 2:
        ux, vx = d(0, 0), d(1, 0)
        uy, vy = d(0, 1), d(1, 1)
        return torch.sqrt(2 * ux * ux + 2 * vy * vy + (uy + vx) ** 2)
    ux, vx, wx = d(0, 0), d(1, 0), d(2, 0)
    uy, vy, wy = d(0, 1), d(1, 1), d(2, 1)
    uz, vz, wz = d(0, 2), d(1, 2), d(2, 2)
    return torch.sqrt(2 * ux * ux + 2 * vy * vy + 2 * wz * wz
                      + (uy + vx) ** 2 + (vz + wy) ** 2 + (wx + uz) ** 2)


def eb_vorticity(vel_g: torch.Tensor, grid: Grid, ng: int, eb: EBArrays
                 ) -> torch.Tensor:
    """2D omega_z / 3D |curl u| with one-sided cut-cell derivatives
    (reference incflo_derive.cpp, EB branches)."""
    def d(c, ax):
        return eb_cc_derivative(vel_g, c, ax, grid, ng, eb)
    if grid.ndim == 2:
        return d(1, 0) - d(0, 1)
    wy, vz = d(2, 1), d(1, 2)
    uz, wx = d(0, 2), d(2, 0)
    vx, uy = d(1, 0), d(0, 1)
    return torch.sqrt((wy - vz) ** 2 + (uz - wx) ** 2 + (vx - uy) ** 2)
