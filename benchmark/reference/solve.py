"""Krylov solves of the reference step: preconditioned CG for the
symmetric systems and BiCGStab for the others, each preconditioned by
the exact inverse of a constant-coefficient, separable operator (fast
diagonalisation: one dense eigenbasis per axis, applied as matrix
products).  With constant coefficients the preconditioner is the
operator's inverse and a solve takes one or two iterations; with a
variable density it is the mean-density operator's.  Solves run to a
few hundred ulps of the data type, well past the program's tolerances,
so that what the comparison reads is the program's error."""

from __future__ import annotations

import numpy as np
import torch


def _axis_matmul(x, m, ax):
    """sum_j m[i, j] x[..., j, ...] along axis ax."""
    return torch.movedim(torch.movedim(x, ax, -1) @ m.T, -1, ax)


class FastDiag:
    """y = G (F r / D) per axis: F and G the forward and back transforms
    of each axis, D the eigenvalue sum; a zero eigenvalue (the constant
    null space of a singular operator) gives zero."""

    def __init__(self, fwd, back, lam, dtype, device):
        self.fwd = [torch.as_tensor(f, dtype=dtype, device=device)
                    for f in fwd]
        self.back = [torch.as_tensor(b, dtype=dtype, device=device)
                     for b in back]
        d = lam
        inv = np.where(np.abs(d) > 1e-12 * np.abs(d).max(), 1.0 / np.where(
            d == 0, 1.0, d), 0.0)
        self.inv = torch.as_tensor(inv, dtype=dtype, device=device)

    @classmethod
    def cell(cls, mats, a, scales, dtype, device):
        """a I + sum_d scales[d] mats[d] (mats: 1D matrices with real
        eigenvalues; maxorder-3 Dirichlet rows are not symmetric)."""
        fwd, back, lams = [], [], []
        for m in mats:
            if np.array_equal(m, m.T):
                w, v = np.linalg.eigh(m)
                fwd.append(v.T)
            else:
                w, v = np.linalg.eig(m)
                order = np.argsort(w.real)
                w, v = w.real[order], v.real[:, order]
                fwd.append(np.linalg.inv(v))
            back.append(v)
            lams.append(w)
        lam = a + (scales[0] * lams[0][:, None, None]
                   + scales[1] * lams[1][None, :, None]
                   + scales[2] * lams[2][None, None, :])
        return cls(fwd, back, lam, dtype, device)

    @classmethod
    def nodal(cls, pairs, sigma, dtype, device):
        """sigma sum_d K_d (x) M_others over the volume: the Q1 operator
        with constant sigma, from each axis's (stiffness, mass), by the
        generalised eigenproblems K v = lam M v (V^T M V = I)."""
        fwd, back, lams = [], [], []
        for k, m in pairs:
            c = np.linalg.cholesky(m)
            ci = np.linalg.inv(c)
            w, q = np.linalg.eigh(ci @ k @ ci.T)
            v = ci.T @ q
            fwd.append(v.T)
            back.append(v)
            lams.append(w)
        lam = sigma * (lams[0][:, None, None] + lams[1][None, :, None]
                       + lams[2][None, None, :])
        return cls(fwd, back, lam, dtype, device)

    def __call__(self, r):
        y = r
        for ax, f in enumerate(self.fwd):
            y = _axis_matmul(y, f, ax)
        y = y * self.inv
        for ax, b in enumerate(self.back):
            y = _axis_matmul(y, b, ax)
        return y


def _tol(dtype):
    return 200.0 * torch.finfo(dtype).eps


def _dot(a, b):
    return torch.sum(a * b)


def pcg(apply, rhs, prec, x0=None, maxiter=200, singular=False):
    """Preconditioned CG for a symmetric positive (semi-)definite
    operator; singular: the constant null space is projected out of the
    right-hand side and of every preconditioned residual."""
    def proj(v):
        return v - v.mean() if singular else v

    rhs = proj(rhs)
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply(x)
    bnorm = torch.linalg.vector_norm(rhs)
    if float(bnorm) == 0.0:
        return x
    tol = _tol(rhs.dtype) * bnorm
    z = proj(prec(r))
    p = z
    rz = _dot(r, z)
    best, best_res, bad = x, float("inf"), 0
    for _ in range(maxiter):
        ap = apply(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        res = float(torch.linalg.vector_norm(r))
        if res < 0.999 * best_res:
            best, best_res, bad = x, res, 0
        else:
            bad += 1
        if res <= tol or bad >= 5:
            break
        z = proj(prec(r))
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return best


def bicgstab(apply, rhs, prec, x0=None, maxiter=200):
    """Right-preconditioned BiCGStab for a nonsymmetric operator."""
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply(x)
    bnorm = torch.linalg.vector_norm(rhs)
    if float(bnorm) == 0.0:
        return x
    tol = _tol(rhs.dtype) * bnorm
    rhat = r.clone()
    rho = alpha = omega = torch.ones((), dtype=rhs.dtype, device=rhs.device)
    v = p = torch.zeros_like(rhs)
    best, best_res, bad = x, float("inf"), 0
    for _ in range(maxiter):
        rho_new = _dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = prec(p)
        v = apply(phat)
        alpha = rho_new / _dot(rhat, v)
        s = r - alpha * v
        shat = prec(s)
        t = apply(shat)
        tt = _dot(t, t)
        omega = _dot(t, s) / torch.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        res = float(torch.linalg.vector_norm(r))
        if res < 0.999 * best_res:
            best, best_res, bad = x, res, 0
        else:
            bad += 1
        if res <= tol or bad >= 5:
            break
    return best
