"""incflo_torch operators and direct solves against incflo_tpu, float64.

Tolerances: symbols and solves to 1e-12 relative (both packages probe
the same discrete operators and eigendecompose them with the same numpy
calls; only the order of the sums in the transforms differs); the
MAC-projected velocity is divergence-free to 1e-12 of the divergence it
started with (a direct solve, exact to rounding); the tensor velocity
diffusion to 1e-10 relative (an iterative CG stopped at 1e-11 of the
right-hand side in both packages).
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax.numpy as jnp

import bench
from incflo_tpu import bcs as jbcs
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.grid import Grid as JGrid
from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import mac_projection as jmac
from incflo_tpu.ops import multigrid as jmg

from incflo_torch import bcs as tbcs
from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.grid import Grid as TGrid
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import mac_projection as tmac
from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops import spectral as tsp

N = (16, 12, 8)
DX = (1.0 / 16, 1.0 / 12, 0.5 / 8)
P, NEU, DIR = 0, 1, 2


def _faces(val, comp=(), scale=None):
    out = []
    for d in range(3):
        shape = tuple(n + (1 if ax == d else 0) for ax, n in enumerate(N))
        a = np.full(shape + comp, val)
        if scale is not None:
            a = a * scale
        out.append(a)
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _check_symbol(jsym, tsym):
    assert jsym.cells == tsym.cells and jsym.batched == tsym.batched
    assert _rel(tsym.sym_face.numpy(), jsym.sym_face) <= 1e-12
    assert (jsym.fwd is None) == (tsym.fwd is None)
    if jsym.fwd is not None:
        for a, b in zip(tsym.fwd + tsym.inv, jsym.fwd + jsym.inv):
            assert _rel(a.numpy(), b) <= 1e-12
    if jsym.a0 is not None:
        assert _rel(tsym.a0.numpy(), jsym.a0) <= 1e-12


CELL_CASES = {
    "mac_periodic": dict(bc=([P] * 3, [P] * 3), alpha=0.0, acoef=None,
                         b=0.7, comp=(), scale=None),
    "mac_walled": dict(bc=([P, NEU, DIR], [P, NEU, NEU]), alpha=0.0,
                       acoef=None, b=0.7, comp=(), scale=None),
    "helmholtz_batched": dict(bc=([P] * 3, [P] * 3), alpha=1.0, acoef=1.2,
                              b=0.01, comp=(3,),
                              scale=np.array([1.0, 2.0, 1.0])),
}


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_cell_symbol_and_solve_match(case):
    c = CELL_CASES[case]
    lo, hi = c["bc"]
    bco = _faces(c["b"], c["comp"], c["scale"])
    ac = None if c["acoef"] is None else np.full(N + (1,) * len(c["comp"]),
                                                 c["acoef"])
    js = jmg.CellSolver(DX, lo, hi, alpha=c["alpha"], beta=1.0,
                        acoef=None if ac is None else jnp.asarray(ac),
                        bcoef=tuple(jnp.asarray(b) for b in bco))
    ts = tmg.CellSolver(DX, lo, hi, alpha=c["alpha"], beta=1.0,
                        acoef=None if ac is None else torch.as_tensor(ac),
                        bcoef=tuple(torch.as_tensor(b) for b in bco))
    _check_symbol(js.symbol, ts.symbol)
    beta = 0.37
    js, ts = js.with_beta(beta), ts.with_beta(beta)
    for a, b in zip(ts.diags, js.diags):
        assert _rel(a.numpy(), b) <= 1e-12
    rhs = np.random.default_rng(0).standard_normal(N + c["comp"])
    x_j, _, _ = js.solve(jnp.asarray(rhs))
    x_t = ts.solve(torch.as_tensor(rhs))
    assert _rel(x_t.numpy(), x_j) <= 1e-12
    r = rhs - np.mean(rhs) if ts.singular else rhs
    res = r - tmg.cell_apply(x_t, ts.levels[0]).numpy()
    assert np.abs(res).max() <= 1e-10 * np.abs(r).max()


def test_nodal_symbol_and_solve_match():
    sigma = np.full(N, 1.3)
    js = jmg.NodalSolver(DX, (True,) * 3, [P] * 3, [P] * 3,
                         jnp.asarray(sigma))
    ts = tmg.NodalSolver(DX, (True,) * 3, [P] * 3, [P] * 3,
                         torch.as_tensor(sigma))
    _check_symbol(js.symbol, ts.symbol)
    rng = np.random.default_rng(1)
    phi = rng.standard_normal(N)
    y_j = jmg.nodal_apply(jnp.asarray(phi), js.levels[0])
    y_t = tmg.nodal_apply(torch.as_tensor(phi), ts.levels[0])
    assert _rel(y_t.numpy(), y_j) <= 1e-12
    rhs = rng.standard_normal(N)
    x_j, _, _ = js.solve(jnp.asarray(rhs))
    x_t = ts.solve(torch.as_tensor(rhs))
    assert _rel(x_t.numpy(), x_j) <= 1e-12
    assert _rel(ts.grad_at_cells(x_t).numpy(), js.grad_at_cells(x_j)) <= 1e-12


def test_mac_projection_divergence_free():
    kw = dict(n_cell=N, prob_lo=(0.0,) * 3, prob_hi=(1.0, 1.0, 0.5),
              periodic=(True,) * 3)
    jg, tg = JGrid(**kw), TGrid(**kw)
    rng = np.random.default_rng(2)
    umac = []
    for d in range(3):
        a = rng.standard_normal(N)
        umac.append(np.concatenate([a, a.take([0], axis=d)], axis=d))
    rho_g1 = np.full(tuple(n + 2 for n in N), 1.25)
    bc_kind = np.zeros((3, 2), np.int32)
    jbeta = jmac.inv_rho_on_faces(jnp.asarray(rho_g1), jg)
    tbeta = tmac.inv_rho_on_faces(torch.as_tensor(rho_g1), tg)
    ju, jphi, _, _ = jmac.project_mac_velocities(
        [jnp.asarray(u) for u in umac], jbeta, jg, bc_kind)
    tu, tphi = tmac.project_mac_velocities(
        [torch.as_tensor(u) for u in umac], tbeta, tg, bc_kind)
    div0 = np.abs(tmac.mac_divergence(
        [torch.as_tensor(u) for u in umac], tg).numpy()).max()
    div1 = np.abs(tmac.mac_divergence(tu, tg).numpy()).max()
    assert div1 <= 1e-12 * div0
    assert _rel(tphi.numpy(), jphi) <= 1e-12
    for a, b in zip(tu, ju):
        assert _rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("mu,min_prec", [(2e-4, 1), (0.5, 4)])
def test_diffuse_velocity_matches(mu, min_prec):
    """The bench mu and a stiff mu whose cross coupling needs several CG
    iterations (counted as applications of the preconditioner)."""
    text, _ = bench._deck("shear3d", 16, "float64")
    text += f"\nincflo.mu = {mu}\n"
    jcfg, tcfg = JConfig.from_text(text), TConfig.from_text(text)
    jg, tg = jcfg.grid, tcfg.grid
    ng = 3
    rng = np.random.default_rng(3)
    vel = rng.standard_normal(jg.cell_shape + (3,))
    rho = np.ones(jg.cell_shape)
    eta_g1 = np.full(tuple(n + 2 for n in jg.cell_shape), mu)
    dt_diff = 0.5 * 0.05
    jrec, trec = jcfg.velocity_bcrecs(), tcfg.velocity_bcrecs()
    jev, tev = jcfg.velocity_ext_values(), tcfg.velocity_ext_values()
    jeta = jdiff.eta_to_faces(jnp.asarray(eta_g1), jg)
    teta = tdiff.eta_to_faces(torch.as_tensor(eta_g1), tg)
    for a, b in zip(teta, jeta):
        assert _rel(a.numpy(), b) <= 1e-15
    jout, jres, jtol = jdiff.diffuse_velocity(
        jnp.asarray(vel), jnp.asarray(rho), jeta, dt_diff, jcfg, jg,
        eta_g1=jnp.asarray(eta_g1), ng=ng,
        grow_fn=lambda v: jbcs.grow(v, ng, jg, jrec, jev),
        grow_hom_fn=lambda v: jbcs.grow(v, ng, jg, jrec),
        return_tensor_res=True)
    calls = {"n": 0}
    real = tsp.solve

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    with mock.patch.object(tdiff.spectral, "solve", counting):
        tout, tres, ttol = tdiff.diffuse_velocity(
            torch.as_tensor(vel), torch.as_tensor(rho), teta,
            torch.tensor(dt_diff, dtype=torch.float64), tcfg, tg,
            eta_g1=torch.as_tensor(eta_g1), ng=ng,
            grow_fn=lambda v: tbcs.grow(v, ng, tg, trec, tev),
            grow_hom_fn=lambda v: tbcs.grow(v, ng, tg, trec),
            return_tensor_res=True)
    # one direct Helmholtz solve, then one preconditioner solve per CG
    # iteration (plus the initial one)
    assert calls["n"] - 1 >= min_prec
    assert float(tres) <= float(ttol)
    assert _rel(ttol.numpy(), jtol) <= 1e-12
    assert _rel(tout.numpy(), jout) <= 1e-10
