"""Exact direct solves for constant-coefficient operators (port of
incflo_tpu/ops/spectral.py).

Two diagonalizations, both built when a solver is constructed, from the
SAME discrete operators (multigrid.cell_apply / nodal_apply):

1. Fast diagonalization: the constant-coefficient cell operator is a
   Kronecker sum of 1D operators for any BC mix; per-axis 1D matrices
   are probed from the real operator, eigendecomposed with numpy, and
   the solve is one matrix product per axis per direction around an
   elementwise eigenvalue division.  The fully periodic nodal FEM
   operator is diagonalized by the orthonormal real tensor-Fourier basis
   with eigenvalues from its DFT symbol.  Used for axes up to 256 cells.
2. rfftn/irfftn with the DFT symbol of the operator's delta response,
   for fully periodic grids with longer axes.

On an x slab of a mesh (parallel/mesh.py) a fast-diagonalization solve
runs its x contraction as the scaling-book form that
incflo_tpu/ops/spectral.py:57-61 names: a local partial product with the
transform's columns of the slab's rows, then a reduce-scatter that sums
the partial products over the ranks and leaves each rank its own rows
(shard_symbol, solve).  The y and z contractions and the eigenvalue
division stay local, and the zero mode of a singular solve lies on rank
0 (a non-singular solve never reads it).  Any x basis cuts so: the
Fourier basis of a periodic x, the eigenvectors of a walled or
inflow/outflow x (a non-symmetric Dirichlet row's included), whose
columns a rank takes are its cells' positions and modes.  The rfftn
form has no sharded symbol: under a mesh its level's solves run
V-cycles on the slab, as incflo_tpu's spectral.usable makes them run
under its mesh (incflo_tpu/ops/spectral.py:57-71).

Matrix products run in full float32 or float64: incflo_torch sets
`torch.backends.cuda.matmul.allow_tf32 = False` and float32 matmul
precision "highest" when it is imported (TF32 would wreck these solves).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# matmul diagonalization is O(N) operations per element per axis; past
# this axis size the O(log N) FFT wins
FASTDIAG_MAX_AXIS = 256


def set_matmul_precision() -> None:
    """Full-precision float32 matrix products (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _const_val(arr, comp_axes: int = 0) -> Optional[np.ndarray]:
    """Spatially constant value of `arr` per trailing component; None if
    it is not constant."""
    if arr is None:
        return None
    a = arr.detach().cpu().numpy()
    comp_shape = a.shape[a.ndim - comp_axes:] if comp_axes else ()
    flat = a.reshape(-1, *comp_shape) if comp_axes else a.reshape(-1, 1)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    if not np.all(lo == hi):
        return None
    return lo.reshape(comp_shape)


@dataclasses.dataclass(frozen=True)
class Symbol:
    """Diagonalization of a constant-coefficient operator.

    sym_face : eigenvalues of the (alpha=0, beta=1) operator, scaled by
               beta at solve time (rfftn grid when fwd is None, per-axis
               eigenmode grid otherwise).
    a0       : constant acoef value (per component), scaled by alpha at
               solve time; None == 0.
    fwd/inv  : per-axis (N, N) transform matrices (fast diagonalization)
               or None (rfftn form).
    cells    : spatial shape the symbol was built for.
    batched  : symbol carries a trailing component axis.
    origin   : bool mask of `cells`, True at the spatial origin (the zero
               mode of a singular solve; fast diagonalization only).
    mesh     : the SlabMesh of a slab's symbol (shard_symbol), else None:
               cells, sym_face and origin are the slab's x rows, fwd[0]
               and inv[0] the columns of those rows.
    """
    sym_face: torch.Tensor
    a0: Optional[torch.Tensor]
    fwd: Optional[Tuple[torch.Tensor, ...]]
    inv: Optional[Tuple[torch.Tensor, ...]]
    cells: Tuple[int, ...]
    batched: bool
    origin: Optional[torch.Tensor] = None
    mesh: object = None


def _real_fourier_basis(n: int, dtype):
    """Orthonormal real Fourier basis of Z_n (columns): constant, then
    (cos, sin) pairs, then the alternating mode for even n."""
    j = np.arange(n)
    cols = [np.full(n, 1.0 / np.sqrt(n))]
    freqs = [0]
    for k in range(1, (n + 1) // 2):
        w = 2.0 * np.pi * k / n
        cols.append(np.sqrt(2.0 / n) * np.cos(w * j))
        cols.append(np.sqrt(2.0 / n) * np.sin(w * j))
        freqs += [k, k]
    if n % 2 == 0:
        cols.append(((-1.0) ** j) / np.sqrt(n))
        freqs.append(n // 2)
    return np.stack(cols, axis=1).astype(dtype), np.asarray(freqs)


def _fd_apply_np(fwds, invs, lam, v):
    """Numpy reference of the fast-diag operator: inv diag(lam) fwd v."""
    h = v
    for d, f in enumerate(fwds):
        h = np.moveaxis(np.tensordot(h, f, axes=([d], [1])), -1, d)
    h = h * lam
    for d, b in enumerate(invs):
        h = np.moveaxis(np.tensordot(h, b, axes=([d], [1])), -1, d)
    return h


def _fastdiag_from_delta(resp, cells, dtype):
    """(fwd, inv, lam) of the real-basis fast diagonalization of a fully
    periodic operator from its delta response; None if the stencil is
    not even-symmetric per axis (checked by reconstructing the
    response)."""
    if any(n > FASTDIAG_MAX_AXIS for n in cells):
        return None
    ndim = len(cells)
    npd = _np_dtype(dtype)
    r = resp.detach().cpu().numpy()
    sym = np.fft.fftn(r, axes=tuple(range(ndim))).real
    qs_np, fmaps = zip(*(_real_fourier_basis(n, npd) for n in cells))
    lam = sym[np.ix_(*fmaps)].astype(npd)
    delta = np.zeros(r.shape, npd)
    delta[(0,) * ndim] = 1.0
    fwds = tuple(q.T for q in qs_np)
    err = np.abs(_fd_apply_np(fwds, qs_np, lam, delta) - r).max()
    if err > 1e-4 * max(np.abs(r).max(), 1e-30):
        return None
    return (tuple(torch.as_tensor(np.ascontiguousarray(f)) for f in fwds),
            tuple(torch.as_tensor(np.ascontiguousarray(q)) for q in qs_np),
            torch.as_tensor(lam))


def _delta(cells, dtype, comp=()):
    d = torch.zeros(tuple(cells) + tuple(comp), dtype=dtype)
    d[(0,) * len(cells)] = 1.0
    return d


def _rfft_sym(resp, ndim):
    """Real symbol of a symmetric stencil from its delta response."""
    return torch.fft.rfftn(resp, dim=tuple(range(ndim))).real


def _extract_1d_matrix(dx, bc_lo, bc_hi, axis, n, ndim, dtype):
    """Dense 1D operator matrix A[i,j] = (L e_j)_i along `axis` for the
    unit-coefficient (alpha=0, beta=1, b=1) cell operator with its
    BC-modified boundary rows, probed on a skinny grid (n cells along
    `axis`, 4 along the others) and read on an interior line."""
    from incflo_torch.ops import multigrid as mg
    cells_s = [4] * ndim
    cells_s[axis] = n
    bco = []
    for d in range(ndim):
        shape = tuple(c + (1 if d2 == d else 0)
                      for d2, c in enumerate(cells_s))
        bco.append(torch.ones(shape + (1,), dtype=dtype))
    lev_s = mg.CellLevel(tuple(dx), tuple(bc_lo), tuple(bc_hi),
                         0.0, 1.0, None, tuple(bco))
    eye = torch.eye(n, dtype=dtype)                    # (pos, probe)
    rs = [1] * ndim + [n]
    rs[axis] = n
    x = torch.ones(tuple(cells_s) + (n,), dtype=dtype) * eye.reshape(rs)
    resp = mg.cell_apply(x, lev_s)
    line = tuple(slice(None) if d == axis else 1 for d in range(ndim))
    return resp[line].numpy().astype(np.float64)       # (pos, probe)


def _kron_fastdiag(lev, cells, dtype, bvals, comp):
    """Fast diagonalization of the constant-coefficient cell operator
    (a Kronecker sum of 1D operators for any BC mix).  Verified against
    the real operator on a random field; None on failure."""
    from incflo_torch.ops import multigrid as mg
    if any(n > FASTDIAG_MAX_AXIS for n in cells):
        return None
    ndim = len(lev.dx)
    npd = _np_dtype(dtype)
    fwds, invs, ws = [], [], []
    for d in range(ndim):
        A = _extract_1d_matrix(lev.dx, lev.bc_lo, lev.bc_hi, d,
                               cells[d], ndim, dtype)
        if np.abs(A - A.T).max() <= 1e-10 * max(np.abs(A).max(), 1e-30):
            w, V = np.linalg.eigh(A)
            F = V.T
        else:                      # maxorder-3 Dirichlet rows
            w, V = np.linalg.eig(A)
            if np.abs(w.imag).max() > 1e-10 * max(np.abs(w).max(), 1e-30):
                return None
            order = np.argsort(w.real)
            w, V = w.real[order], V.real[:, order]
            if np.linalg.cond(V) > 1e7:
                return None
            F = np.linalg.inv(V)
        fwds.append(F)
        invs.append(V)
        ws.append(w)
    # lam[k1..kD(,c)] = sum_d b_d(,c) * w_d[k_d]
    lam = np.zeros(cells + comp, np.float64)
    for d in range(ndim):
        shape = [1] * (ndim + len(comp))
        shape[d] = cells[d]
        wd = ws[d].reshape(shape)
        bd = np.asarray(bvals[d], np.float64).reshape((1,) * ndim + comp)
        lam = lam + bd * wd
    rng = np.random.default_rng(0)
    v = rng.standard_normal(cells + comp)
    lev1 = dataclasses.replace(lev, alpha=0.0, beta=1.0)
    av_true = mg.cell_apply(torch.as_tensor(v, dtype=dtype).to(
        lev.bcoef[0].device), lev1).cpu().numpy().astype(np.float64)
    av_fd = _fd_apply_np(fwds, invs, lam, v)
    tol = 2e-4 if dtype == torch.float32 else 1e-9
    if np.abs(av_fd - av_true).max() > tol * max(np.abs(av_true).max(),
                                                 1e-30):
        return None
    return (tuple(torch.as_tensor(np.ascontiguousarray(f.astype(npd)))
                  for f in fwds),
            tuple(torch.as_tensor(np.ascontiguousarray(v_.astype(npd)))
                  for v_ in invs),
            torch.as_tensor(lam.astype(npd)))


def cell_symbol(lev) -> Optional[Symbol]:
    """Symbol for multigrid.CellLevel, or None if ineligible."""
    from incflo_torch.ops import multigrid as mg
    ndim = len(lev.dx)
    if lev.ebc is not None:
        return None
    comp_axes = lev.bcoef[0].dim() - ndim
    bvals = [_const_val(b, comp_axes) for b in lev.bcoef]
    if any(v is None for v in bvals):
        return None
    a0 = None
    if lev.acoef is not None:
        a0 = _const_val(lev.acoef, lev.acoef.dim() - ndim)
        if a0 is None:
            return None
    batched = lev.bcoef[0].dim() > ndim
    cells = tuple(lev.bcoef[0].shape[ax] - (1 if ax == 0 else 0)
                  for ax in range(ndim))
    dtype = lev.bcoef[0].dtype
    comp = tuple(lev.bcoef[0].shape[ndim:]) if batched else ()
    a0t = None if a0 is None else torch.as_tensor(a0, dtype=dtype)
    fd = _kron_fastdiag(lev, cells, dtype, bvals, comp)
    if fd is not None:
        fwd, inv, lam = fd
        return Symbol(sym_face=lam, a0=a0t, fwd=fwd, inv=inv, cells=cells,
                      batched=batched, origin=_origin(cells))
    all_periodic = all(b == mg.SolverBC.PERIODIC
                       for b in list(lev.bc_lo) + list(lev.bc_hi))
    if not all_periodic:
        return None          # the rfftn form needs translation invariance
    lev1 = dataclasses.replace(lev, alpha=0.0, beta=1.0)
    resp = mg.cell_apply(_delta(cells, dtype, comp), lev1)
    return Symbol(sym_face=_rfft_sym(resp, ndim), a0=a0t, fwd=None,
                  inv=None, cells=cells, batched=batched)


def nodal_symbol(lev) -> Optional[Symbol]:
    """Symbol for multigrid.NodalLevel (all periodic: the nodal phi has
    N entries per axis, no duplicated wrap plane)."""
    from incflo_torch.ops import multigrid as mg
    ndim = len(lev.dx)
    if not all(lev.periodic):
        return None
    sp = lev.sigma_pad if lev.sigma is None else lev.sigma
    if _const_val(sp) is None:
        return None
    cells = lev.cells if lev.cells is not None else tuple(lev.sigma.shape)
    dtype = sp.dtype
    resp = mg.nodal_apply(_delta(cells, dtype), lev)
    fd = _fastdiag_from_delta(resp, cells, dtype)
    if fd is not None:
        fwd, inv, lam = fd
        return Symbol(sym_face=lam, a0=None, fwd=fwd, inv=inv,
                      cells=cells, batched=False, origin=_origin(cells))
    return Symbol(sym_face=_rfft_sym(resp, ndim), a0=None, fwd=None,
                  inv=None, cells=cells, batched=False)


def _contract(h, m, axis):
    """h'_k = sum_j m[k, j] h_j along `axis` (one matrix product)."""
    out = torch.tensordot(h, m, dims=([axis], [1]))
    return torch.movedim(out, -1, axis)


def shard_symbol(sym: Symbol, mesh) -> Optional[Symbol]:
    """The whole level's symbol cut to the rank's x slab: the slab's rows
    of the eigenvalues and of the zero-mode mask, and the slab's columns
    of the x transforms (a position j of the forward transform, a mode k
    of the inverse).  None for the rfftn form, which does not cut: the
    caller solves by V-cycles on the slab."""
    if sym.fwd is None:
        return None
    nxl = sym.cells[0] // mesh.size
    x0 = mesh.rank * nxl
    cols = lambda m: m.narrow(1, x0, nxl).contiguous()
    rows = lambda a: a.narrow(0, x0, nxl).contiguous()
    return dataclasses.replace(
        sym, sym_face=rows(sym.sym_face),
        fwd=(cols(sym.fwd[0]),) + tuple(sym.fwd[1:]),
        inv=(cols(sym.inv[0]),) + tuple(sym.inv[1:]),
        cells=(nxl,) + tuple(sym.cells[1:]), origin=rows(sym.origin),
        mesh=mesh)


def _origin(cells):
    """Bool mask of `cells`, True at the spatial origin only."""
    m = torch.zeros(cells, dtype=torch.bool)
    m[(0,) * len(cells)] = True
    return m


def _at_origin(sym: Symbol, x):
    """sym.origin broadcastable against x (spatial axes first)."""
    return sym.origin.reshape(sym.cells + (1,) * (x.dim() - len(sym.cells)))


def solve(sym: Symbol, rhs, alpha, beta, singular: bool):
    """x = L^{-1} rhs, exact up to rounding.  alpha/beta may be 0-d
    tensors (CellSolver.with_beta rescales beta = dt every step).  For
    singular (pure Poisson) operators the zero mode of rhs is projected
    out and x has zero mean."""
    ndim = len(sym.cells)
    axes = tuple(range(ndim))
    batched_rhs = rhs.dim() > ndim
    s = sym.sym_face
    if sym.a0 is not None:
        s = alpha * sym.a0 + beta * s
    else:
        s = beta * s
    if sym.batched and not batched_rhs:
        raise ValueError("batched symbol needs batched rhs")
    if batched_rhs and not sym.batched:
        s = s[..., None]
    zero = (0,) * ndim
    mesh = sym.mesh
    if sym.fwd is not None:
        h = rhs
        for d, f in enumerate(sym.fwd):
            h = _contract(h, f, d)
            if d == 0 and mesh is not None:
                h = mesh.reduce_scatter_x(h)
        if singular:
            # mask form of the zero mode, as in the step2d kernel: no
            # element is set, so the solve captures in a CUDA graph
            s = torch.where(_at_origin(sym, s), 1.0, s)
            h = torch.where(_at_origin(sym, h), 0.0, h)
        h = h / s
        for d, b in enumerate(sym.inv):
            h = _contract(h, b, d)
            if d == 0 and mesh is not None:
                h = mesh.reduce_scatter_x(h)
        # contiguous: the contractions leave the axes permuted in memory,
        # and a state field that kept that layout would sum in another
        # order than the same field read back from a checkpoint
        return h.to(rhs.dtype).contiguous()
    rh = torch.fft.rfftn(rhs, dim=axes)
    if singular:
        s = s.clone()
        s[zero] = 1.0
        rh = rh.clone()
        rh[zero] = 0.0
    x = torch.fft.irfftn(rh / s, s=sym.cells, dim=axes).to(rhs.dtype)
    if singular:
        x = x - torch.mean(x, dim=axes, keepdim=True)
    return x
