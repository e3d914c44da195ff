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

  nodal_smooth(x, b, sigma, dinv, dx, nsweeps, want_residual) -> (x, res)
      replaces incflo_tpu/ops/pallas_nodal.py:_smooth_kernel (:133) and
      :_tiled_kernel (:221).  The same sweeps of the Q1 finite-element
      nodal sigma-Poisson operator in its 7 rank-1 terms
      (multigrid.nodal_apply): sigma at cells, x/b/dinv at nodes, all
      (nx, ny, nz).  Fully periodic levels only: levels with walls take
      multigrid.nodal_smooth_walled, plain PyTorch on either device.

What bounds them on an H100: bytes.  A colour pass moves 8 (cell) or 5
(nodal) arrays for 20 or ~400 operations per point, so a 2-sweep call
with residual is 5 passes over the level.  Each wrapper call is one C
call that enqueues 2*nsweeps + 1 launches (a launch is the grid-wide
barrier a colour pass needs); fusing them into one cooperative launch
with the coefficients held on chip is later work.  The TPU kernels'
whole-level-in-VMEM form, their x-slab tiles with a shrinking halo and
the (8, 128) shape rules are answers to that machine's fast memory and
do not carry over: one kernel family covers every level size, odd sizes
and an axis of 2 cells included.  Nor do the walled Pallas kernel's
merged (y, z) lane axis, its x slabs of TBx+8 rows and its padded x
ghosts: with one launch per colour pass a wall is two compares per axis
in the thread of a boundary cell, on x as on y and z.

The cell pass updates in place (a cell's stencil touches only the other
colour; a level with an odd periodic axis, whose wrap joins two cells of
one colour, goes between two buffers instead); the nodal stencil couples
nodes of one colour and the update reads the old x everywhere, so a
nodal pass writes a second buffer.
Both kernels repeat the plain versions' operation order and are built
without FMA contraction, so kernel and plain version agree to rounding.

Every wrapper takes the plain version only for tensors on the CPU.  On
a CUDA tensor it launches the kernel or raises: there is no fallback.
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
# launches the kernel and nowhere else
LAUNCHES = {"cell_smooth": 0, "cell_smooth_walled": 0, "nodal_smooth": 0}

# TPU kernels each CUDA kernel family replaces (file:line of the Pallas
# body): the whole-level kernel, and its x-slab tiled form for levels
# over the VMEM budget
REPLACES = {
    "cell_smooth": "incflo_tpu/ops/pallas_cell.py:65",
    "cell_smooth_walled": "incflo_tpu/ops/pallas_smoother.py:71",
    "nodal_smooth": "incflo_tpu/ops/pallas_nodal.py:133",
}
ALSO_REPLACES = {
    "cell_smooth": "incflo_tpu/ops/pallas_cell.py:191",
    "nodal_smooth": "incflo_tpu/ops/pallas_nodal.py:221",
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def guarded_reciprocal(diag: torch.Tensor) -> torch.Tensor:
    """1/diag, and 0 where |diag| <= 1e-8 max|diag|: near-degenerate rows
    get no update instead of a 1/eps-amplified one."""
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


def cell_neighbour_coefs(F, bc=None, Fwall=None):
    """(Ehi, Elo): per axis, the coefficients of x(i+e_ax) and x(i-e_ax)
    in L(x) = diag*x - sum_ax (Ehi*x(i+e_ax) + Elo*x(i-e_ax)), neighbours
    taken with periodic wrap.  On a periodic axis they are the cell's
    high face and its low face (the wrapped F).  On a walled axis the
    coefficient across the wall is 0, and a Dirichlet wall adds a third
    of its face coefficient to the opposite one."""
    lo, hi = _bc_codes(bc)
    Ehi, Elo = [], []
    for ax in range(3):
        fhi = F[ax]
        flo = torch.roll(fhi, 1, dims=ax)
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
                      want_residual: bool = False, bc=None, Fwall=None):
    """Plain version of the `cell_smooth` kernel, walls included."""
    _check_cell(x, b, diag, dinv, F, nsweeps, bc, Fwall)
    F, Flo = cell_neighbour_coefs(F, bc, Fwall)
    isred = checkerboard(x.shape, x.device)
    red = isred.to(x.dtype)
    black = (~isred).to(x.dtype)
    for _ in range(nsweeps):
        x = x + red * (b - _cell_apply_plain(x, diag, F, Flo)) * dinv
        x = x + black * (b - _cell_apply_plain(x, diag, F, Flo)) * dinv
    res = (b - _cell_apply_plain(x, diag, F, Flo)) if want_residual else None
    return x, res


def nodal_apply_plain(phi, sigma, coefs):
    """L(phi) of the periodic Q1 nodal operator: contraction tree down
    the axes, C_p*sigma, scatter tree back up with
    S^T(ts) + D^T(td) = (ts + td) + shift(ts - td)."""
    parts = {(): phi}
    for ax in range(3):
        new = {}
        for key, v in parts.items():
            hi = torch.roll(v, -1, dims=ax)
            new[key + (0,)] = v + hi
            new[key + (1,)] = v - hi
        parts = new
    t = {p: (coefs[p[0] * 4 + p[1] * 2 + p[2]] * sigma * v) if any(p)
         else None for p, v in parts.items()}
    for ax in (2, 1, 0):
        new = {}
        for key in {k[:-1] for k in t}:
            ts, td = t[key + (0,)], t[key + (1,)]
            s0 = 0.0 if ts is None else ts
            new[key] = (s0 + td) + torch.roll(s0 - td, 1, dims=ax)
        t = new
    return t[()]


def nodal_smooth_plain(x, b, sigma, dinv, dx, nsweeps: int,
                       want_residual: bool = False):
    """Plain version of the `nodal_smooth` kernel."""
    _check_nodal(x, b, sigma, dinv, dx, nsweeps)
    coefs = nodal_coefs(dx)
    isred = checkerboard(x.shape, x.device)
    red = isred.to(x.dtype)
    black = (~isred).to(x.dtype)
    for _ in range(nsweeps):
        x = x + red * (b - nodal_apply_plain(x, sigma, coefs)) * dinv
        x = x + black * (b - nodal_apply_plain(x, sigma, coefs)) * dinv
    res = (b - nodal_apply_plain(x, sigma, coefs)) if want_residual else None
    return x, res


# ---------------------------------------------------------------------
# scope and argument checks
# ---------------------------------------------------------------------

def _check_same(name, t, like):
    if not isinstance(t, torch.Tensor) or t.shape != like.shape \
            or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(
            f"{name}: expected {like.dtype} {tuple(like.shape)} on "
            f"{like.device}, got {getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} on "
            f"{getattr(t, 'device', None)}")


def _check_common(x, nsweeps, ndims):
    if x.dtype not in DT_CODE:
        raise TypeError(f"smoother kernels take float32/float64, got "
                        f"{x.dtype}")
    if x.dim() not in ndims:
        raise NotImplementedError(
            "incflo_torch smoother kernels cover 3D levels; 2D comes with "
            "ROADMAP A8")
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


def _check_cell(x, b, diag, dinv, F, nsweeps, bc=None, Fwall=None):
    """Argument checks of cell_smooth; True when an axis has walls."""
    _check_common(x, nsweeps, (3, 4))
    if len(F) != 3:
        raise ValueError("F must hold one face coefficient per axis")
    for name, t in (("b", b), ("diag", diag), ("dinv", dinv), ("F0", F[0]),
                    ("F1", F[1]), ("F2", F[2])):
        _check_same(name, t, x)
    lo, hi = _bc_codes(bc)
    walls = False
    for ax in range(3):
        codes = (lo[ax], hi[ax])
        if any(c not in (PERIODIC, NEUMANN, DIRICHLET) for c in codes):
            raise ValueError(f"axis {ax}: unknown BC codes {codes}")
        if (lo[ax] == PERIODIC) != (hi[ax] == PERIODIC):
            raise ValueError(f"axis {ax}: periodic on one side only")
        if lo[ax] == PERIODIC:
            continue
        walls = True
        if x.shape[ax] < 2:
            raise ValueError(f"axis {ax}: a walled axis needs >= 2 cells")
        if Fwall is None or Fwall[ax] is None:
            raise ValueError(f"axis {ax}: walled, but Fwall[{ax}] (its low "
                             "wall face coefficients) is missing")
        plane = x.narrow(ax, 0, 1)
        _check_same(f"Fwall[{ax}]", Fwall[ax], plane)
    return walls


def _check_nodal(x, b, sigma, dinv, dx, nsweeps):
    _check_common(x, nsweeps, (3,))
    if len(dx) != 3:
        raise ValueError("dx must hold one spacing per axis")
    for name, t in (("b", b), ("sigma", sigma), ("dinv", dinv)):
        _check_same(name, t, x)


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
        lib.smoother_cell.argtypes = (
            [I] + [P] * 10 + [ctypes.POINTER(I)] + [P] * 3 + [I] * 5 + [P])
        lib.smoother_nodal.argtypes = (
            [I] + [P] * 4 + [ctypes.POINTER(ctypes.c_double)] + [P] * 3
            + [I] * 4 + [P])
        lib.smoother_cell.restype = I
        lib.smoother_nodal.restype = I
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def cell_smooth(x, b, diag, dinv, F, nsweeps: int,
                want_residual: bool = False, bc=None, Fwall=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`cell_smooth` kernel: nsweeps red-black sweeps (+ the residual),
    periodic, Neumann or Dirichlet on each side of each axis."""
    walls = _check_cell(x, b, diag, dinv, F, nsweeps, bc, Fwall)
    if x.device.type == "cpu":
        return cell_smooth_plain(x, b, diag, dinv, F, nsweeps, want_residual,
                                 bc, Fwall)
    x, b, diag, dinv = (t.contiguous() for t in (x, b, diag, dinv))
    F = [f.contiguous() for f in F]
    lo, hi = _bc_codes(bc)
    planes = [Fwall[ax].contiguous() if lo[ax] != PERIODIC else None
              for ax in range(3)]
    codes = (ctypes.c_int * 6)(*(c for ax in range(3)
                                 for c in (lo[ax], hi[ax])))
    out = torch.empty_like(x)
    res = torch.empty_like(x) if want_residual else None
    # the wrap of an odd periodic axis couples two cells of one colour:
    # the passes then go between two buffers and not in place
    odd_wrap = any(lo[ax] == PERIODIC and x.shape[ax] > 1
                   and x.shape[ax] % 2 for ax in range(3))
    tmp = torch.empty_like(x) if odd_wrap and nsweeps > 0 else None
    nc = x.shape[3] if x.dim() == 4 else 1
    name = "cell_smooth_walled" if walls else "cell_smooth"
    rc = _lib().smoother_cell(
        DT_CODE[x.dtype], ptr(x), ptr(b), ptr(diag), ptr(dinv),
        ptr(F[0]), ptr(F[1]), ptr(F[2]),
        *(None if w is None else ptr(w) for w in planes), codes, ptr(out),
        None if tmp is None else ptr(tmp),
        ptr(res) if want_residual else None, *x.shape[:3], nc,
        int(nsweeps), stream(x))
    check_rc(name, rc)
    LAUNCHES[name] += 1
    return out, res


def nodal_smooth(x, b, sigma, dinv, dx, nsweeps: int,
                 want_residual: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`nodal_smooth` kernel: nsweeps red-black sweeps (+ the residual)."""
    _check_nodal(x, b, sigma, dinv, dx, nsweeps)
    if x.device.type == "cpu":
        return nodal_smooth_plain(x, b, sigma, dinv, dx, nsweeps,
                                  want_residual)
    x, b, sigma, dinv = (t.contiguous() for t in (x, b, sigma, dinv))
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    res = torch.empty_like(x) if want_residual else None
    coefs = (ctypes.c_double * 8)(*nodal_coefs([float(d) for d in dx]))
    rc = _lib().smoother_nodal(
        DT_CODE[x.dtype], ptr(x), ptr(b), ptr(sigma), ptr(dinv), coefs,
        ptr(out), ptr(tmp), ptr(res) if want_residual else None,
        *x.shape, int(nsweeps), stream(x))
    check_rc("nodal_smooth", rc)
    LAUNCHES["nodal_smooth"] += 1
    return out, res
