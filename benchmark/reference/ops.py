"""Discrete operators of the reference step, written from incflo's
discretisation (cell-centred MAC and diffusion operators, the Q1
finite-element nodal projection), plain PyTorch on whole arrays.

Fields carry no ghosts; components are last.  Boundary codes per axis
side: "P" periodic, "N" homogeneous Neumann (no flux through the face),
"D" Dirichlet with the face value taken by the maxorder-3 ghost
g = (8/3) b - 2 q0 + q1 / 3 (AMReX MLMG's default for these solves)."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from benchmark.reference.deck import BCType


def _take(a, ax, start, stop):
    return a.narrow(ax, start, stop - start)


def window(a, ax, lo, hi):
    """`a` with lo entries dropped at the start of `ax` and hi at its end."""
    return a.narrow(ax, lo, a.shape[ax] - lo - hi)


def inner(a, ng, ndim=3):
    for ax in range(ndim):
        a = window(a, ax, ng, ng)
    return a


# ---------------------------------------------------------------------
# ghost fill of cell fields by their boundary records, axis by axis so
# that later axes fill the corners of earlier ones
# ---------------------------------------------------------------------

def grow(field, ng, grid, bcrecs):
    """field (*cells, ncomp) grown by ng ghosts on every axis."""
    for ax in range(grid.ndim):
        n = field.shape[ax]
        if grid.periodic[ax]:
            field = torch.cat([_take(field, ax, n - ng, n), field,
                               _take(field, ax, 0, ng)], dim=ax)
            continue
        blocks = []
        for side in (0, 1):
            comps = [_ghost(field[..., c:c + 1], ax, side, ng,
                            BCType(int(bcrecs[c, ax, side])))
                     for c in range(field.shape[-1])]
            blocks.append(torch.cat(comps, dim=-1))
        field = torch.cat([blocks[0], field, blocks[1]], dim=ax)
    return field


def grow_scalar(field, ng, grid, bcrecs):
    return grow(field[..., None], ng, grid, bcrecs)[..., 0]


def _ghost(fc, ax, side, g, bct):
    n = fc.shape[ax]
    idx = (0, 1, 2) if side == 0 else (n - 1, n - 2, n - 3)
    q0, q1, q2 = (_take(fc, ax, i, i + 1) for i in idx)
    reps = [1] * fc.dim()
    reps[ax] = g
    if bct == BCType.foextrap:
        return q0.repeat(reps)
    if bct == BCType.ext_dir:
        return torch.zeros_like(q0).repeat(reps)
    if bct == BCType.hoextrap:
        g1 = 0.125 * (15.0 * q0 - 10.0 * q1 + 3.0 * q2)
        reps[ax] = g - 1
        far = q0.repeat(reps)
        return torch.cat([far, g1] if side == 0 else [g1, far], dim=ax)
    raise ValueError(f"ghost fill {bct!r} is not used by these decks")


# ---------------------------------------------------------------------
# cell-centred operator  L x = acoef x - beta div(b grad x)
# ---------------------------------------------------------------------

class CellOp:
    """bc: per axis (lo, hi) codes; bcoef: per axis a number or a face
    array (n + 1 along the axis); acoef: a number, a cell array or None
    (zero)."""

    def __init__(self, grid, bc, bcoef, acoef=None, beta=1.0):
        self.grid, self.bc, self.bcoef = grid, bc, bcoef
        self.acoef, self.beta = acoef, beta

    def _pad(self, x, bvals):
        for ax in range(3):
            lo, hi = self.bc[ax]
            n = x.shape[ax]
            if lo == "P":
                x = torch.cat([_take(x, ax, n - 1, n), x, _take(x, ax, 0, 1)],
                              dim=ax)
                continue
            ghosts = []
            for side, code in ((0, lo), (1, hi)):
                i0, i1 = (0, 1) if side == 0 else (n - 1, n - 2)
                q0, q1 = _take(x, ax, i0, i0 + 1), _take(x, ax, i1, i1 + 1)
                if code == "N":
                    ghosts.append(q0)
                else:
                    bv = 0.0 if bvals is None else bvals.get((ax, side), 0.0)
                    ghosts.append((8.0 / 3.0) * bv - 2.0 * q0 + q1 / 3.0)
            x = torch.cat([ghosts[0], x, ghosts[1]], dim=ax)
        return x

    def fluxes(self, x, bvals=None):
        """b grad x on the n + 1 faces of every axis."""
        xp = self._pad(x, bvals)
        out = []
        for ax in range(3):
            v = xp
            for other in range(3):
                if other != ax:
                    v = window(v, other, 1, 1)
            f = self.bcoef[ax] * ((window(v, ax, 1, 0) - window(v, ax, 0, 1))
                                  / self.grid.dx[ax])
            lo, hi = self.bc[ax]
            if lo == "N" or hi == "N":
                f = f.clone()
                if lo == "N":
                    f.narrow(ax, 0, 1).zero_()
                if hi == "N":
                    f.narrow(ax, f.shape[ax] - 1, 1).zero_()
            out.append(f)
        return out

    def apply(self, x, bvals=None):
        out = 0.0 * x if self.acoef is None else self.acoef * x
        for ax, f in enumerate(self.fluxes(x, bvals)):
            out = out - self.beta * (window(f, ax, 1, 0) - window(f, ax, 0, 1)) \
                / self.grid.dx[ax]
        return out

    def matrix_1d(self, ax):
        """The 1D matrix of -d/dx (d/dx) along ax (unit coefficient, the
        axis's boundary rows), the separable part of a preconditioner."""
        n = self.grid.n_cell[ax]
        h2 = self.grid.dx[ax] ** 2
        m = np.zeros((n, n))
        for i in range(n):
            m[i, i] = 2.0
            if i > 0:
                m[i, i - 1] = -1.0
            if i < n - 1:
                m[i, i + 1] = -1.0
        lo, hi = self.bc[ax]
        if lo == "P":
            m[0, n - 1] = m[n - 1, 0] = -1.0
        for row, nb, code in ((0, 1, lo), (n - 1, n - 2, hi)):
            if code == "N":
                m[row, row] = 1.0
            elif code == "D":                  # the maxorder-3 ghost
                m[row, row] = 4.0
                m[row, nb] = -4.0 / 3.0
        return m / h2


def mac_divergence(umac, grid):
    out = 0.0
    for d in range(3):
        out = out + (window(umac[d], d, 1, 0) - window(umac[d], d, 0, 1)) \
            / grid.dx[d]
    return out


def inv_rho_on_faces(rho_g1, grid):
    """1 / (the average of the two cells' densities) on the n + 1 faces
    of every axis, from the density grown by one ghost."""
    out = []
    for d in range(3):
        r = rho_g1
        for ax in range(3):
            if ax != d:
                r = window(r, ax, 1, 1)
        out.append(1.0 / (0.5 * (window(r, d, 0, 1) + window(r, d, 1, 0))))
    return out


def transpose_term(vel_g, mu, grid, ng, cross_only=False):
    """sum_d d/dx_d [mu d u_d / dx_c] for each component c of the grown
    velocity: on d faces the compact difference for c == d, the average
    of the two cells' central differences for c != d.  cross_only leaves
    out c == d."""
    out = [0.0] * 3
    for d in range(3):
        for c in range(3):
            u = vel_g[..., d]
            if c == d:
                if cross_only:
                    continue
                for ax in range(3):
                    if ax != d:
                        u = window(u, ax, ng, ng)
                u = window(u, d, ng - 1, ng - 1)
                dudx = (window(u, d, 1, 0) - window(u, d, 0, 1)) / grid.dx[d]
            else:
                g = 0.5 * (window(u, c, 2, 0) - window(u, c, 0, 2)) / grid.dx[c]
                for ax in range(3):
                    if ax == c:
                        t = (ng - 1) - (1 if ax == d else 0)
                    else:
                        t = ng - (1 if ax == d else 0)
                    g = window(g, ax, t, t)
                dudx = 0.5 * (window(g, d, 0, 1) + window(g, d, 1, 0))
            flux = mu * dudx
            out[c] = out[c] + (window(flux, d, 1, 0) - window(flux, d, 0, 1)) \
                / grid.dx[d]
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------
# nodal projection: Q1 finite elements, sigma constant in each cell
# ---------------------------------------------------------------------

def _pad_nodes(phi, grid):
    """Nodes 0..n on every axis (the wrap of node 0 on periodic axes)."""
    for ax in range(3):
        if grid.periodic[ax]:
            phi = torch.cat([phi, phi.narrow(ax, 0, 1)], dim=ax)
    return phi


def _fold_nodes(a, grid):
    """Inverse of _pad_nodes for a sum: node n adds into node 0."""
    for ax in range(3):
        if grid.periodic[ax]:
            n = a.shape[ax] - 1
            body = a.narrow(ax, 0, n).clone()
            body.narrow(ax, 0, 1).add_(a.narrow(ax, n, 1))
            a = body
    return a


def q1_element(dx):
    """The 8 x 8 element stiffness of the trilinear element on a cell of
    sides dx, corners ordered (i, j, k) in {0, 1}^3, over the volume."""
    def stiff(h):
        return np.array([[1.0, -1.0], [-1.0, 1.0]]) / h

    def mass(h):
        return np.array([[2.0, 1.0], [1.0, 2.0]]) * h / 6.0

    ke = np.zeros((8, 8))
    for d in range(3):
        m = [stiff(h) if a == d else mass(h) for a, h in enumerate(dx)]
        ke += np.kron(np.kron(m[0], m[1]), m[2])
    return ke / (dx[0] * dx[1] * dx[2])


def nodal_apply(phi, sigma, grid, ke):
    """A phi = (1/V) sum over cells of sigma K_e phi, assembled: the
    negative of incflo's nodal sigma-Laplacian (symmetric, positive
    semi-definite).  phi on the unique nodes; ke a tensor (8, 8)."""
    p = _pad_nodes(phi, grid)
    n = grid.n_cell
    corners = torch.stack([p[i:i + n[0], j:j + n[1], k:k + n[2]]
                           for i, j, k in itertools.product((0, 1), repeat=3)])
    local = (ke @ corners.reshape(8, -1)).reshape(corners.shape) * sigma
    out = torch.zeros_like(p)
    for c, (i, j, k) in enumerate(itertools.product((0, 1), repeat=3)):
        out[i:i + n[0], j:j + n[1], k:k + n[2]] += local[c]
    return _fold_nodes(out, grid)


def nodal_divergence(vel, grid):
    """Divergence of the cell velocity at the unique nodes: each
    component padded by one ghost per axis (the wrap on periodic axes,
    zero beyond a wall), differenced across its own axis and averaged
    over the node's cells on the other two."""
    out = 0.0
    for axis in range(3):
        u = vel[..., axis]
        for ax in range(3):
            n = u.shape[ax]
            if grid.periodic[ax]:
                u = torch.cat([_take(u, ax, n - 1, n), u, _take(u, ax, 0, 1)],
                              dim=ax)
            else:
                z = torch.zeros_like(_take(u, ax, 0, 1))
                u = torch.cat([z, u, z], dim=ax)
        t = (window(u, axis, 1, 0) - window(u, axis, 0, 1)) / grid.dx[axis]
        for ax in range(3):
            if ax != axis:
                t = 0.5 * (window(t, ax, 0, 1) + window(t, ax, 1, 0))
        out = out + t
    for ax in range(3):             # all nodes -> the unique ones
        if grid.periodic[ax]:
            out = window(out, ax, 0, 1)
    return out


def nodal_grad(phi, grid):
    """Gradient of nodal phi at the cell centres: each axis's node-pair
    differences averaged over the cell's four pairs."""
    p = _pad_nodes(phi, grid)
    comps = []
    for axis in range(3):
        g = (window(p, axis, 1, 0) - window(p, axis, 0, 1)) / grid.dx[axis]
        for ax in range(3):
            if ax != axis:
                g = 0.5 * (window(g, ax, 0, 1) + window(g, ax, 1, 0))
        comps.append(g)
    return torch.stack(comps, dim=-1)


def node_matrices_1d(grid, ax):
    """(stiffness, mass) of the 1D linear element along ax, assembled
    over the axis's unique nodes."""
    n, h = grid.n_cell[ax], grid.dx[ax]
    m = n if grid.periodic[ax] else n + 1
    k = np.zeros((m, m))
    ms = np.zeros((m, m))
    for e in range(n):
        a, b = e, (e + 1) % m
        for (i, j), kv, mv in (((a, a), 1, 2), ((b, b), 1, 2),
                               ((a, b), -1, 1), ((b, a), -1, 1)):
            k[i, j] += kv / h
            ms[i, j] += mv * h / 6.0
    return k, ms
