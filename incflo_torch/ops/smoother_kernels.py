"""Red-black Gauss-Seidel smoothers of the multigrid V-cycles on 3D
grids: the hand-written CUDA kernel families of
incflo_torch/csrc/smoothers.cu and their plain PyTorch versions.

  cell_smooth(x, b, diag, dinv, F, nsweeps, want_residual,
              bc=None, Fwall=None) -> (x, res)
      replaces incflo_tpu/ops/pallas_cell.py:_smooth_kernel (:65) and
      :_tiled_kernel (:191) on fully periodic levels (launch counter
      "cell_smooth") and incflo_tpu/ops/pallas_smoother.py:_rb_kernel
      (:71) on levels with walls ("cell_smooth_walled").  nsweeps
      red-black sweeps of

          L(x) = diag*x - sum_ax (F_ax * x(i+e_ax) + F_ax(i-e_ax) * x(i-e_ax))

      the diag-extracted form of alpha*a*x - beta*div(b grad x): `diag`
      is multigrid.cell_diag, `dinv` its guarded reciprocal, F = (F0, F1,
      F2) the high-face coefficients of each cell pre-scaled by
      beta/dx_ax^2.  All arrays are (nx, ny, nz) or (nx, ny, nz, nc) with
      nc uncoloured trailing components (the batched velocity solve).
      `res` is b - L(x) after the sweeps, or None.

      Walls: bc = (lo, hi), each a triple of codes per axis (0 periodic,
      1 homogeneous Neumann, 2 homogeneous Dirichlet with the maxorder-3
      ghost -2*x0 + x1/3; multigrid.SolverBC).  On a walled axis F's last
      entry is the high wall face and Fwall[ax], of extent 1 along ax,
      the low wall face, scaled like F.  `diag` carries the wall faces
      with factor 0 (Neumann) or 3 (Dirichlet), as multigrid.cell_diag
      builds it.  A wall cell has no neighbour across the wall, and a
      Dirichlet wall adds a third of its face coefficient to the
      neighbour on the other side (`cell_neighbour_coefs`).  Unlike the
      Pallas kernel, whose black pass sees the pre-sweep ghost at a
      non-periodic x boundary, every pass here sees the ghosts of the
      current iterate on every axis, as the jnp smoother does.

  nodal_smooth(x, b, sigma, dinv, dx, nsweeps, want_residual,
               bc=None) -> (x, res)
      replaces incflo_tpu/ops/pallas_nodal.py:_smooth_kernel (:133) and
      :_tiled_kernel (:221) on fully periodic levels ("nodal_smooth"),
      and the jnp sweep incflo_tpu runs on levels with walls
      (incflo_tpu/ops/multigrid.py:1018; "nodal_smooth_walled").  The
      same sweeps of the Q1 finite-element nodal sigma-Poisson operator
      in its 7 rank-1 terms (multigrid.nodal_apply): x/b/dinv at the
      nodes (nx, ny, nz), sigma at the cells.  On a walled axis (bc as
      for cell_smooth, at least 2 cells) the level has one node more
      than cells, sigma outside the domain is zero and a node on a
      Dirichlet side is an identity row.

  cell_smooth_slab(mesh, x, b, diag, dinv, F, nsweeps, want_residual,
                   bc=None, Fwall=None, xwrap=None) -> (x, res)
  nodal_smooth_slab(mesh, x, b, sigma, dinv, dx, nsweeps, want_residual,
                    bc=None) -> (x, res)
      the same sweeps on rank mesh.rank's x slab of a level
      (parallel/mesh.py): on the slab's rows, each call gives the bits
      the whole-level call gives (launch counters "cell_smooth_slab",
      "nodal_smooth_slab").  One exchange and one launch a call: the
      wrapper takes a deep x halo of x and b from the neighbouring ranks,
      (lo, hi) = slab_depth(nsweeps, want_residual) rows, and runs the
      kernel above on the extended slab of nxl + lo + hi planes with x
      open -- walled with Neumann codes, so a point on its first or last
      plane has no neighbour across, which is the existing walled mode
      and needs no code of its own in csrc/smoothers.cu -- and keeps the
      slab's own planes.  Where the level's x ends in walls (Neumann or
      Dirichlet, the nodal outflow plane included) the first rank's low
      side and the last rank's high side are the level's own x faces
      (SlabMesh.ends): no halo rows there, and the extended slab takes
      the level's code on that side (slab_bc) -- the kernel's per-side
      codes already take a wall on one x side and Neumann on the other
      -- with the level's low wall plane on the first rank; a nodal slab
      of such a level holds node nx on the last rank (nxl + 1 rows).  A
      periodic x whose face 0 differs from face n (the EB wall term's
      levels, whose whole-level call takes face 0 from a wrap plane)
      passes that plane as xwrap: the first rank's extended slab reads
      it in the row of the level's cell 0 (plane lo), the last rank's in
      the row of its halo copy of cell 0 (plane lo + nxl), where the open
      slab would read the plane before's F, face n (csrc/smoothers.cu:
      XW, xw_at).
      An edge plane is wrong from the first colour
      pass, and each pass carries the error one plane in: after
      2 nsweeps passes the first 2 nsweeps planes of each side are
      wrong, and the residual one more, so hi = 2 nsweeps (+ 1 with the
      residual) keeps the slab's planes exact.  lo is hi rounded up to
      even: the kernels colour a point by (i + j + k) % 2 of its index in
      the array they are given, and with the slab's first global x index
      x0 even (the multigrid levels that run here have even nxl) an even
      lo (none at the level's low x face) puts the extended slab's planes
      on the global parity.  The
      level's coefficients come extended by the same (lo, hi) (multigrid
      exchanges them once per hierarchy and depth): diag and dinv
      (dinv from the whole level's max |diag|, guarded_reciprocal with
      the mesh), F, the y and z wall planes, and sigma over the extended
      slab's nxl + lo + hi - 1 cells.  A colour pass a call instead
      (one exchange of the edge planes before each pass) would make
      2 nsweeps + 1 exchanges where this makes one; each exchange on
      ranks that share a card is a device -> host -> device round trip
      (PERF.md), so the halo is taken deep and the edge planes are
      recomputed instead.

What bounds them on an H100 is latency: a 2-sweep call moves a few MB
at the fine level and far less below it, against microseconds a launch
or a grid barrier.  So a call is one launch, in two regimes
(csrc/smoothers.cu): on a small level (up to 1024 cells or 128 nodes of
each colour) one CTA runs every colour pass and the residual with block
barriers between them, the iterate in shared memory; above it a
cooperative launch of the co-resident CTAs does, with grid barriers, the
cell coefficients held in shared memory and the nodal stencil evaluated
in shared-memory bricks.  A pass enumerates only the points of the
colour it updates.  The TPU kernels' whole-level-in-VMEM form, their
x-slab tiles with a shrinking halo, the (8, 128) shape rules and the
walled kernel's merged (y, z) lane axis answer that machine's fast
memory and do not carry over: odd sizes, an axis of 2 cells and walls
on any axis take the same kernels.

The cell pass updates in place (a cell's stencil touches only the other
colour; a level with an odd periodic axis, whose wrap joins two cells of
one colour, goes between two buffers instead); the nodal stencil couples
nodes of one colour and the update reads the old x everywhere, so a
nodal pass writes a second buffer.  Both kernels repeat the plain
versions' operation order and are built without FMA contraction, so
kernel and plain version agree to the last bit.

LAUNCHES counts the wrapper calls that launched a kernel, per family;
DEVICE_LAUNCHES the device launches they enqueued, as the C entry counts
them at its launch sites (one each); LAST_PLAN what the last call of a
family launched.  A wrapper's keyword `_regime` forces the resident (1)
or grid (2) regime, for tests and measurements only.  Every wrapper
takes the plain version only for tensors on the CPU.  On a CUDA tensor
it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import itertools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from incflo_torch.ops import cuda_build
from incflo_torch.ops.cuda_build import DT_CODE, check_rc, ptr, stream

SOURCE = cuda_build.CSRC_DIR / "smoothers.cu"

# launch counters: one per kernel family, raised by the wrapper where it
# launches the kernel and nowhere else; DEVICE_LAUNCHES by the number of
# device launches the C entry counts at its launch sites
LAUNCHES = {"cell_smooth": 0, "cell_smooth_walled": 0, "nodal_smooth": 0,
            "nodal_smooth_walled": 0, "cell_smooth_slab": 0,
            "nodal_smooth_slab": 0}
DEVICE_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# per family, the last call's (regime: 1 resident / 2 grid, CTAs, threads
# per CTA, coefficient slots held per colour (cell) or 1 when every CTA
# holds its brick (nodal))
LAST_PLAN = {}

# TPU kernels each CUDA kernel family replaces (file:line of the Pallas
# body): the whole-level kernel, and its x-slab tiled form for levels
# over the VMEM budget
REPLACES = {
    "cell_smooth": "incflo_tpu/ops/pallas_cell.py:65",
    "cell_smooth_walled": "incflo_tpu/ops/pallas_smoother.py:71",
    "nodal_smooth": "incflo_tpu/ops/pallas_nodal.py:133",
    # no Pallas body: incflo_tpu smooths walled nodal levels in jnp
    "nodal_smooth_walled": "incflo_tpu/ops/multigrid.py:1018",
    # the slab forms: under a mesh incflo_tpu turns its smoother kernels
    # off (pallas_cell.py:126-127, pallas_nodal.py:158-159,
    # pallas_smoother.py:154-155) and sweeps in jnp, GSPMD deriving the
    # halos
    "cell_smooth_slab": "incflo_tpu/ops/pallas_smoother.py:71",
    "nodal_smooth_slab": "incflo_tpu/ops/multigrid.py:1018",
}
ALSO_REPLACES = {
    "cell_smooth": "incflo_tpu/ops/pallas_cell.py:191",
    "nodal_smooth": "incflo_tpu/ops/pallas_nodal.py:221",
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        DEVICE_LAUNCHES[k] = 0


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


# ---------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------

PERIODIC, NEUMANN, DIRICHLET = 0, 1, 2
THIRD = 1.0 / 3.0    # the ghost's x1/3, as a product (the kernel's kThird)


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
    _check_cell(x, b, diag, dinv, F, nsweeps, bc, Fwall, open_x, xwrap)
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
    _check_nodal(x, b, sigma, dinv, dx, nsweeps, bc)
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


# ---------------------------------------------------------------------
# scope and argument checks
# ---------------------------------------------------------------------

def _check_same(name, t, like, shape=None):
    """t has like's dtype and device, and like's shape or `shape`."""
    shape = tuple(like.shape) if shape is None else tuple(shape)
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape \
            or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(
            f"{name}: expected {like.dtype} {shape} on "
            f"{like.device}, got {getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} on "
            f"{getattr(t, 'device', None)}")


def _check_common(x, nsweeps, ndims):
    if x.dtype not in DT_CODE:
        raise TypeError(f"smoother kernels take float32/float64, got "
                        f"{x.dtype}")
    if x.dim() not in ndims:
        raise NotImplementedError(
            "incflo_torch smoother kernels cover 3D levels; ops/multigrid.py "
            "smooths a 2D level in plain PyTorch")
    if int(nsweeps) < 0:
        raise ValueError(f"nsweeps must be >= 0, got {nsweeps}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"level {tuple(x.shape)} is too large for the "
                         "kernels' 32-bit indices")


def _bc_codes(bc):
    """((lo0, lo1, lo2), (hi0, hi1, hi2)) as ints; None is periodic."""
    if bc is None:
        return (PERIODIC,) * 3, (PERIODIC,) * 3
    lo, hi = bc
    lo, hi = tuple(int(v) for v in lo), tuple(int(v) for v in hi)
    if len(lo) != 3 or len(hi) != 3:
        raise ValueError("bc must hold one (lo, hi) code per axis")
    return lo, hi


def _check_bc(bc, shape, min_walled, what):
    """The walled axes of bc on a level of `shape` (at least `min_walled`
    `what` along each)."""
    lo, hi = _bc_codes(bc)
    walled = []
    for ax in range(3):
        codes = (lo[ax], hi[ax])
        if any(c not in (PERIODIC, NEUMANN, DIRICHLET) for c in codes):
            raise ValueError(f"axis {ax}: unknown BC codes {codes}")
        if (lo[ax] == PERIODIC) != (hi[ax] == PERIODIC):
            raise ValueError(f"axis {ax}: periodic on one side only")
        if lo[ax] == PERIODIC:
            continue
        if shape[ax] < min_walled:
            raise ValueError(f"axis {ax}: a walled axis needs >= "
                             f"{min_walled} {what}")
        walled.append(ax)
    return walled


def _check_cell(x, b, diag, dinv, F, nsweeps, bc=None, Fwall=None,
                open_x=(False, False), xwrap=None):
    """Argument checks of cell_smooth; True when an axis has walls.
    open_x: the open x sides (low, high) of an extended slab; the low
    wall plane Fwall[0] is asked for exactly where the low side is the
    level's wall.  xwrap: (plane of extent 1 along x, interior x planes
    of an extended slab with both x sides open)."""
    _check_common(x, nsweeps, (3, 4))
    if len(F) != 3:
        raise ValueError("F must hold one face coefficient per axis")
    for name, t in (("b", b), ("diag", diag), ("dinv", dinv), ("F0", F[0]),
                    ("F1", F[1]), ("F2", F[2])):
        _check_same(name, t, x)
    walled = _check_bc(bc, x.shape, 2, "cells")
    for ax in walled:
        if ax == 0 and open_x[0]:
            continue
        if Fwall is None or Fwall[ax] is None:
            raise ValueError(f"axis {ax}: walled, but Fwall[{ax}] (its low "
                             "wall face coefficients) is missing")
    for ax in range(3):
        if Fwall is not None and Fwall[ax] is not None:
            _check_same(f"Fwall[{ax}]", Fwall[ax], x.narrow(ax, 0, 1))
    if xwrap is not None:
        plane, at = xwrap
        _check_same("xwrap", plane, x.narrow(0, 0, 1))
        if not all(open_x) or not 1 <= len(at) <= 2 or any(
                not 0 < i < x.shape[0] - 1 for i in at):
            raise ValueError(f"xwrap: planes {tuple(at)} of an extended "
                             f"slab of {x.shape[0]} open on both x sides")
    return bool(walled)


def _check_nodal(x, b, sigma, dinv, dx, nsweeps, bc=None):
    """Argument checks of nodal_smooth; True when an axis has walls."""
    _check_common(x, nsweeps, (3,))
    if len(dx) != 3:
        raise ValueError("dx must hold one spacing per axis")
    for name, t in (("b", b), ("dinv", dinv)):
        _check_same(name, t, x)
    walled = _check_bc(bc, x.shape, 3, "nodes (2 cells)")
    cells = tuple(n - (ax in walled) for ax, n in enumerate(x.shape))
    _check_same("sigma", sigma, x, cells)
    return bool(walled)


# ---------------------------------------------------------------------
# build and bind (ops/cuda_build.py): built at first use
# ---------------------------------------------------------------------

_LIB = None


def build(ptxas_verbose: bool = False) -> Path:
    """Compile csrc/smoothers.cu unless this source's library exists."""
    return cuda_build.build(SOURCE, ptxas_verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        IP = ctypes.POINTER(I)
        lib.smoother_cell.argtypes = (
            [I] + [P] * 11 + [I] * 2 + [IP] + [P] * 3 + [I] * 6
            + [IP, IP, P])
        lib.smoother_nodal.argtypes = (
            [I] + [P] * 4 + [ctypes.POINTER(ctypes.c_double), IP] + [P] * 3
            + [I] * 5 + [IP, IP, P])
        lib.smoother_graph_kernels.argtypes = [P, IP]
        lib.smoother_cell.restype = I
        lib.smoother_nodal.restype = I
        lib.smoother_graph_kernels.restype = I
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def _bc_array(bc):
    lo, hi = _bc_codes(bc)
    return (ctypes.c_int * 6)(*(c for ax in range(3) for c in (lo[ax], hi[ax])))


def _launched(name, rc, launches, plan):
    check_rc(name, rc)
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[name] += launches.value
    LAST_PLAN[name] = tuple(plan)


def cell_smooth(x, b, diag, dinv, F, nsweeps: int,
                want_residual: bool = False, bc=None, Fwall=None, *,
                _regime: int = 0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`cell_smooth` kernel: nsweeps red-black sweeps (+ the residual),
    periodic, Neumann or Dirichlet on each side of each axis.  `_regime`:
    0 lets the kernel choose by the level's size (resident up to 1024
    cells of each colour), 1 forces resident, 2 grid."""
    walls = _check_cell(x, b, diag, dinv, F, nsweeps, bc, Fwall)
    if x.device.type == "cpu":
        return cell_smooth_plain(x, b, diag, dinv, F, nsweeps, want_residual,
                                 bc, Fwall)
    return _launch_cell("cell_smooth_walled" if walls else "cell_smooth",
                        x, b, diag, dinv, F, nsweeps, want_residual, bc,
                        Fwall, _regime)


def _launch_cell(family, x, b, diag, dinv, F, nsweeps, want_residual, bc,
                 Fwall, regime, xwrap=None):
    x, b, diag, dinv = (t.contiguous() for t in (x, b, diag, dinv))
    F = [f.contiguous() for f in F]
    lo, _ = _bc_codes(bc)
    planes = [Fwall[ax].contiguous()
              if Fwall is not None and Fwall[ax] is not None else None
              for ax in range(3)]
    xw, at = (None, ()) if xwrap is None else (xwrap[0].contiguous(),
                                               tuple(xwrap[1]))
    at = at + (-1,) * (2 - len(at))
    out = torch.empty_like(x)
    res = torch.empty_like(x) if want_residual else None
    # the wrap of an odd periodic axis couples two cells of one colour:
    # the passes then go between two buffers and not in place
    odd_wrap = any(lo[ax] == PERIODIC and x.shape[ax] > 1
                   and x.shape[ax] % 2 for ax in range(3))
    tmp = torch.empty_like(x) if odd_wrap and nsweeps > 0 else None
    nc = x.shape[3] if x.dim() == 4 else 1
    launches, plan = ctypes.c_int(0), (ctypes.c_int * 4)()
    rc = _lib().smoother_cell(
        DT_CODE[x.dtype], ptr(x), ptr(b), ptr(diag), ptr(dinv),
        ptr(F[0]), ptr(F[1]), ptr(F[2]),
        *(None if w is None else ptr(w) for w in planes),
        None if xw is None else ptr(xw), int(at[0]), int(at[1]),
        _bc_array(bc),
        ptr(out), None if tmp is None else ptr(tmp),
        ptr(res) if want_residual else None, *x.shape[:3], nc,
        int(nsweeps), int(regime), ctypes.byref(launches), plan, stream(x))
    _launched(family, rc, launches, plan)
    return out, res


def nodal_smooth(x, b, sigma, dinv, dx, nsweeps: int,
                 want_residual: bool = False, bc=None, *, _regime: int = 0
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`nodal_smooth` kernel: nsweeps red-black sweeps (+ the residual),
    periodic, Neumann or Dirichlet on each side of each axis.  `_regime`
    as for cell_smooth (resident up to 128 nodes of each colour)."""
    walls = _check_nodal(x, b, sigma, dinv, dx, nsweeps, bc)
    if x.device.type == "cpu":
        return nodal_smooth_plain(x, b, sigma, dinv, dx, nsweeps,
                                  want_residual, bc)
    return _launch_nodal("nodal_smooth_walled" if walls else "nodal_smooth",
                         x, b, sigma, dinv, dx, nsweeps, want_residual, bc,
                         _regime)


def _launch_nodal(family, x, b, sigma, dinv, dx, nsweeps, want_residual, bc,
                  regime):
    x, b, sigma, dinv = (t.contiguous() for t in (x, b, sigma, dinv))
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    res = torch.empty_like(x) if want_residual else None
    coefs = (ctypes.c_double * 8)(*nodal_coefs([float(d) for d in dx]))
    launches, plan = ctypes.c_int(0), (ctypes.c_int * 4)()
    rc = _lib().smoother_nodal(
        DT_CODE[x.dtype], ptr(x), ptr(b), ptr(sigma), ptr(dinv), coefs,
        _bc_array(bc), ptr(out), ptr(tmp),
        ptr(res) if want_residual else None, *x.shape, int(nsweeps),
        int(regime), ctypes.byref(launches), plan, stream(x))
    _launched(family, rc, launches, plan)
    return out, res


# ---------------------------------------------------------------------
# slab forms: a rank's x slab of a level
# ---------------------------------------------------------------------

def slab_depth(nsweeps: int, want_residual: bool) -> Tuple[int, int]:
    """(lo, hi): the x rows a slab call takes from its left and right
    neighbours -- 2 nsweeps (+ 1 with the residual), lo rounded up to
    even for the colour parity."""
    h = 2 * int(nsweeps) + (1 if want_residual else 0)
    return h + h % 2, h


def slab_bc(bc, ends=(False, False)):
    """The codes of an extended slab: y and z the level's; along x the
    level's code on a side that is the level's own x face (`ends`, the
    first rank's low side and the last rank's high side of a level whose
    x ends in walls; SlabMesh.ends), Neumann -- open: the edge planes,
    whose rows are thrown away, see no neighbour -- on every other
    side."""
    lo, hi = _bc_codes(bc)
    if lo[0] == PERIODIC and any(ends):
        raise ValueError("a periodic x has no x faces of its own")
    return ((lo[0] if ends[0] else NEUMANN,) + lo[1:],
            (hi[0] if ends[1] else NEUMANN,) + hi[1:])


def cell_smooth_ext(x, b, diag, dinv, F, nsweeps: int,
                    want_residual: bool = False, bc=None, Fwall=None, *,
                    ends=(False, False), xwrap=None, _regime: int = 0):
    """The slab form's launch: the `cell_smooth` kernel on an extended
    slab (all arrays nxl + lo + hi planes along x) with x open but on the
    level's own x faces (`ends`, slab_bc); bc gives the level's codes,
    Fwall the y and z wall planes over the extended slab and, where the
    low x side is the level's wall, its plane; xwrap (plane, planes) the
    x wrap plane of a periodic x whose face 0 differs from face n, at
    the extended slab's planes of the level's cell 0.  Returns every
    plane; the slab's nxl are exact."""
    bc = slab_bc(bc, ends)
    Fwall = (Fwall[0] if ends[0] else None,) + tuple(Fwall[1:]) \
        if Fwall is not None else None
    opened = (not ends[0], not ends[1])
    _check_cell(x, b, diag, dinv, F, nsweeps, bc, Fwall, open_x=opened,
                xwrap=xwrap)
    if x.device.type == "cpu":
        return cell_smooth_plain(x, b, diag, dinv, F, nsweeps, want_residual,
                                 bc, Fwall, open_x=opened, xwrap=xwrap)
    return _launch_cell("cell_smooth_slab", x, b, diag, dinv, F, nsweeps,
                        want_residual, bc, Fwall, _regime, xwrap)


def nodal_smooth_ext(x, b, sigma, dinv, dx, nsweeps: int,
                     want_residual: bool = False, bc=None, *,
                     ends=(False, False), _regime: int = 0):
    """The nodal slab form's launch: `nodal_smooth` on an extended slab
    of nodes (sigma one cell fewer along x) with x open but on the
    level's own x faces (`ends`, slab_bc)."""
    bc = slab_bc(bc, ends)
    _check_nodal(x, b, sigma, dinv, dx, nsweeps, bc)
    if x.device.type == "cpu":
        return nodal_smooth_plain(x, b, sigma, dinv, dx, nsweeps,
                                  want_residual, bc)
    return _launch_nodal("nodal_smooth_slab", x, b, sigma, dinv, dx, nsweeps,
                         want_residual, bc, _regime)


def _slab_halo(mesh, x, b, nsweeps, want_residual, nxl, periodic):
    """(lo, hi) of the call, none across the level's own x faces, and x,
    b extended by them; raises where the extended slab would not start
    on the global colour parity or the neighbours' slabs are too
    narrow.  nxl: the slab's cells along x."""
    depth = slab_depth(nsweeps, want_residual)
    lo, hi = mesh.depths(*depth, periodic)
    if (mesh.rank * nxl - lo) % 2:
        raise ValueError(f"slab smoother: a slab of {nxl} rows starts on an "
                         "odd x index; its level runs whole on every rank")
    if depth[0] > nxl:
        raise ValueError(f"slab smoother: {nsweeps} sweeps need {depth[0]} "
                         f"halo rows, the slabs hold {nxl}")
    xe, be = mesh.halo_x([x, b], *depth, periodic=periodic)
    return lo, hi, xe, be


def _rows(t, lo, nxl):
    return None if t is None else t.narrow(0, lo, nxl)


def cell_smooth_slab(mesh, x, b, diag, dinv, F, nsweeps: int,
                     want_residual: bool = False, bc=None, Fwall=None, *,
                     xwrap=None, _regime: int = 0):
    """`cell_smooth` on this rank's x slab (x, b: nxl rows): one halo
    exchange of x and b, one launch on the extended slab.  diag, dinv, F
    and the y and z planes of Fwall come extended by slab_depth(nsweeps,
    want_residual) rows (SlabMesh.depths: none across the level's own x
    faces); on the first rank of a level whose x ends in walls Fwall[0]
    is the level's low x wall plane.  xwrap: on a periodic x whose face 0
    differs from face n (the EB velocity levels), the level's face 0
    plane, which the first rank's extended slab reads at the level's
    cell 0 (its plane lo) and the last rank's at its halo copy of it
    (plane lo + nxl) in place of face n."""
    nxl = x.shape[0]
    if nsweeps == 0 and not want_residual:
        return x, None
    periodic = _bc_codes(bc)[0][0] == PERIODIC
    lo, _, xe, be = _slab_halo(mesh, x, b, nsweeps, want_residual, nxl,
                               periodic)
    if xwrap is not None:
        # an edge plane's row is thrown away whatever it reads
        at = tuple(i for i, mine in ((lo, mesh.rank == 0),
                                     (lo + nxl, mesh.rank == mesh.size - 1))
                   if mine and i < xe.shape[0] - 1)
        xwrap = (xwrap, at) if at else None
    out, res = cell_smooth_ext(xe, be, diag, dinv, F, nsweeps, want_residual,
                               bc, Fwall, ends=mesh.ends(periodic),
                               xwrap=xwrap, _regime=_regime)
    return _rows(out, lo, nxl), _rows(res, lo, nxl)


def nodal_smooth_slab(mesh, x, b, sigma, dinv, dx, nsweeps: int,
                      want_residual: bool = False, bc=None, *,
                      _regime: int = 0):
    """`nodal_smooth` on this rank's x slab of nodes: nxl rows (node n of
    a periodic x axis is node 0: nodes split like cells), and on the last
    rank of a level whose x ends in boundaries nxl + 1.  dinv comes
    extended by slab_depth's (lo, hi) rows, sigma by (lo, hi - 1), both
    without rows across the level's own x faces."""
    rows = x.shape[0]
    if nsweeps == 0 and not want_residual:
        return x, None
    periodic = _bc_codes(bc)[0][0] == PERIODIC
    ends = mesh.ends(periodic)
    lo, _, xe, be = _slab_halo(mesh, x, b, nsweeps, want_residual,
                               rows - int(ends[1]), periodic)
    out, res = nodal_smooth_ext(xe, be, sigma, dinv, dx, nsweeps,
                                want_residual, bc, ends=ends,
                                _regime=_regime)
    return _rows(out, lo, rows), _rows(res, lo, rows)


def graph_kernels(graph: "torch.cuda.CUDAGraph") -> int:
    """Kernel nodes of a CUDA graph captured with keep_graph=True."""
    n = ctypes.c_int(0)
    check_rc("smoother_graph_kernels", _lib().smoother_graph_kernels(
        ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(n)))
    return n.value
