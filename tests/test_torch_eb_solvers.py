"""EB solvers of incflo_torch against incflo_tpu (ROADMAP A11), float64
on the CPU, on the geometry of channel_cyl (16 x 8 x 8) and
poiseuille_cyl_bingham (16 x 16 x 8):

  * CellSolver with the EB wall coefficient ebc (the Newtonian cut-cell
    velocity operator: rho vfrac, area-fraction-weighted faces, the wall
    drag): its V-cycle PCG against incflo_tpu's, the same CG iterations
    and the solution within 1e-10.  The port smooths such a level in
    the `cell_smooth` kernel's form (its plain version here), beta*ebc
    folded into the diagonal; the same solve smoothed in incflo_tpu's
    flux form ends on the same iteration and within 1e-10 of it, and one
    smoother call of each form agrees to 1e-12 -- also on the velocity
    operator a poiseuille_cyl_bingham step builds, whose viscosity faces
    differ between face 0 and face n of the periodic z axis, which the
    kernel form then reads from a wrap plane;
  * eb_nodal_apply (P^T L_fine P on the octant lattice) and the
    EBNodalSolver: its 27-point stencils on every level within 1e-12 of
    incflo_tpu's, and a solve with equal V-cycles;
  * the octant-lattice NodalSolver of a variable-density EB deck: a
    solve with equal V-cycles.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import mac_projection as jmac
from incflo_tpu.ops import multigrid as jmg

from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops import smoother_kernels as sk

import torch_parity as tp

DECKS = ("channel_cyl", "poiseuille_cyl_bingham")


@pytest.fixture(scope="module", params=DECKS)
def eb(request):
    text = tp.eb_deck(request.param, 16)
    je, te, jg, tg = tp.eb_arrays(text)
    return request.param, text, je, te, jg, tg


def _count(tally, fn):
    import jax
    with tp.counted_loops(tally):
        out = fn()
        jax.effects_barrier()
    return out


def _velocity_operator(je, te, jg, tg, text):
    """Both packages' cut-cell Newtonian velocity solvers (one batched
    component here: x), beta = dt/2 = 0.005."""
    cfg = tp.incflo_torch.IncfloConfig.from_text(text)
    lo, hi = tdiff.velocity_solver_bc(cfg, 0)
    mu = 0.5
    beta = 0.005
    eta_c = np.full(tuple(tg.n_cell), mu)
    faces = [mu * te.afrac[d].numpy() for d in range(3)]
    ebc_t = tdiff._eb_wall_coef(torch.as_tensor(eta_c), tg, te)
    ebc_j = jdiff._eb_wall_coef(jnp.asarray(eta_c), jg, je)
    acoef = te.vfrac.numpy() + te.covered.numpy()    # rho = 1
    ts = tmg.CellSolver(tg.dx, lo, hi, 1.0, beta, torch.as_tensor(acoef),
                        tuple(torch.as_tensor(f) for f in faces), ebc=ebc_t,
                        direct=False)
    js = jmg.CellSolver(jg.dx, lo, hi, 1.0, beta, jnp.asarray(acoef),
                        tuple(jnp.asarray(f) for f in faces), ebc=ebc_j)
    return ts, js


def _flux_smooth(self, x, b, li, n, want_residual):
    """CellSolver._smooth_res in incflo_tpu's flux form (its jnp sweep,
    multigrid.py:425-451) on the same level."""
    dinvs = self.smoother_coefs()[0]
    lev = self.levels[li]
    return tmg._rb_sweeps(x, b, dinvs[li], lambda v: tmg.cell_apply(v, lev),
                          n, want_residual, self.ndim)


def test_cell_solver_with_wall_term(eb, monkeypatch):
    name, text, je, te, jg, tg = eb
    ts, js = _velocity_operator(je, te, jg, tg, text)
    rhs = tp.masked_random(tuple(tg.n_cell), te.fluid.numpy(), 21)
    tally = dict.fromkeys(tp.KINDS, 0)
    jx, _, jit = _count(tally, lambda: js.solve(jnp.asarray(rhs), rtol=1e-11,
                                                atol=1e-14, maxiter=200))
    tmg.reset_counts()
    tx, _, tit = ts.solve_info(torch.as_tensor(rhs), rtol=1e-11, atol=1e-14,
                               maxiter=200)
    assert tit == int(jit) == tally["cell_iters"] > 0
    assert tp.rel(tx.numpy(), jx) <= 1e-10
    # the same solve smoothed in the flux form
    monkeypatch.setattr(tmg.CellSolver, "_smooth_res", _flux_smooth)
    fx, _, fit = ts.solve_info(torch.as_tensor(rhs), rtol=1e-11, atol=1e-14,
                               maxiter=200)
    assert fit == tit
    assert tp.rel(fx.numpy(), tx.numpy()) <= 1e-10


def _smooths_as_the_flux_form(ts, levels, seed):
    """One 2-sweep smoother call with its residual on each of `levels`:
    the kernel form (cell_smooth_plain, ebc in diag) against the
    flux-form sweep of the same operator, to 1e-12."""
    for li in levels:
        lev = ts.levels[li]
        assert lev.ebc is not None and float(lev.ebc.abs().max()) > 0
        shape = tuple(ts.diags[li].shape)
        rng = np.random.default_rng(seed + li)
        x, b = (torch.as_tensor(rng.standard_normal(shape)) for _ in "xb")
        kernel = ts._smooth_res(x, b, li, 2, True)
        flux = _flux_smooth(ts, x, b, li, 2, True)
        for a, c in zip(flux, kernel):
            assert tp.rel(c.numpy(), a.numpy()) <= 1e-12


def test_folded_wall_term_smooths_as_the_flux_form(eb):
    """The fine and the first coarse level of the Newtonian operator."""
    name, text, je, te, jg, tg = eb
    ts, _ = _velocity_operator(je, te, jg, tg, text)
    _smooths_as_the_flux_form(ts, (0, 1), 22)


def test_kernel_form_takes_the_step_operator_wrap_plane(monkeypatch):
    """The cut-cell velocity solver of one poiseuille_cyl_bingham step
    (16 x 16 x 8, from a perturbed start): its z face 0 and face n
    differ, the kernel form takes face 0 from the wrap plane and smooths
    every level as the flux form does; without the plane it would
    not."""
    text = tp.eb_deck("poiseuille_cyl_bingham", 16)
    sim = tp.port_sim(text)
    solvers = []
    solve_info = tmg.CellSolver.solve_info

    def capture(self, rhs, **kw):
        if self.levels[0].ebc is not None and not solvers:
            solvers.append(self)
        return solve_info(self, rhs, **kw)
    monkeypatch.setattr(tmg.CellSolver, "solve_info", capture)
    sim.advance(tp.own_start(sim, tp.fluid_perturbation(sim, 7)))
    ts = solvers[0]
    bz = ts.levels[0].bcoef[2]
    gap = float((bz[:, :, :1] - bz[:, :, -1:]).abs().max())
    assert gap > 1e-3 * float(bz.abs().max())
    _smooths_as_the_flux_form(ts, range(len(ts.levels)), 26)
    # the wrap plane is what makes them agree
    dinvs, fhis, fwalls = ts.smoother_coefs()
    lev = ts.levels[0]
    x = torch.as_tensor(np.random.default_rng(27).standard_normal(
        tuple(ts.diags[0].shape)))
    no_plane = tuple(w if lev.bc_lo[ax] else None
                     for ax, w in enumerate(fwalls[0]))
    off = sk.cell_smooth(x, x, ts.diags[0], dinvs[0], fhis[0], 2, True,
                         bc=(lev.bc_lo, lev.bc_hi), Fwall=no_plane)
    flux = _flux_smooth(ts, x, x, 0, 2, True)
    assert tp.rel(off[1].numpy(), flux[1].numpy()) > 1e-3


def _fine_meta(tg, periodic):
    nd = tg.ndim
    neu = (int(tmg.SolverBC.NEUMANN),) * nd
    return (tmg.NodalLevel(tuple(d / 2 for d in tg.dx), periodic, neu, neu,
                           None, None, tuple(2 * n for n in tg.n_cell)),
            jmg.NodalLevel(tuple(d / 2 for d in tg.dx), periodic, neu, neu,
                           None, None, tuple(2 * n for n in tg.n_cell)))


def _nodal_setup(text, tg):
    cfg = tp.incflo_torch.IncfloConfig.from_text(text)
    lo, hi = jmac.projection_solver_bc(cfg.bc_kind, tg)
    nodes = tuple(n if p else n + 1 for n, p in zip(tg.n_cell, tg.periodic))
    return lo, hi, nodes


def test_eb_nodal_apply(eb):
    name, text, je, te, jg, tg = eb
    lo, hi, nodes = _nodal_setup(text, tg)
    sigma = np.full(tuple(tg.n_cell), 2.0)
    tmeta = tmg.NodalLevel(tg.dx, tg.periodic, tuple(lo), tuple(hi), None,
                           None, tuple(tg.n_cell))
    jmeta = jmg.NodalLevel(jg.dx, jg.periodic, tuple(lo), tuple(hi), None,
                           None, tuple(jg.n_cell))
    tf = tmg.eb_fine_level(torch.as_tensor(sigma), te.vfrac_oct, tmeta)
    jf = jmg.eb_fine_level(jnp.asarray(sigma), je.vfrac_oct, jmeta)
    phi = np.random.default_rng(23).standard_normal(nodes)
    got = tmg.eb_nodal_apply(torch.as_tensor(phi), tmeta, tf)
    want = jmg.eb_nodal_apply(jnp.asarray(phi), jmeta, jf)
    assert tp.rel(got.numpy(), want) <= 1e-12


@pytest.fixture(scope="module")
def eb_nodal(eb):
    name, text, je, te, jg, tg = eb
    lo, hi, nodes = _nodal_setup(text, tg)
    sigma = np.full(tuple(tg.n_cell), 1.0)
    ts = tmg.EBNodalSolver(tg.dx, tg.periodic, lo, hi,
                           torch.as_tensor(sigma), te.vfrac_oct)
    js = jmg.EBNodalSolver(jg.dx, jg.periodic, lo, hi, jnp.asarray(sigma),
                           je.vfrac_oct)
    return eb, ts, js, nodes


def test_eb_nodal_stencils(eb_nodal):
    _, ts, js, _ = eb_nodal
    assert len(ts.levels) == len(js.levels) >= 2
    for a, b in zip(ts.levels, js.levels):
        assert tp.rel(a.coefs.numpy(), b.coefs) <= 1e-12
        assert a.cells == b.cells
    for a, b in zip(ts.dinvs, js.dinvs):
        assert tp.rel(a.numpy(), b) <= 1e-12


def test_eb_nodal_solve(eb_nodal):
    (name, text, je, te, jg, tg), ts, js, nodes = eb_nodal
    rhs = np.random.default_rng(24).standard_normal(nodes)
    rhs -= rhs.mean()
    kw = dict(rtol=1e-9, atol=1e-14, maxiter=30)
    tally = dict.fromkeys(tp.KINDS, 0)
    jx, jres, jit = _count(tally, lambda: js.solve(jnp.asarray(rhs), **kw))
    tmg.reset_counts()
    tx, tres, tit = ts.solve_info(torch.as_tensor(rhs), **kw)
    assert tit == int(jit) == tally["nodal_cycles"] == \
        tmg.COUNTS["nodal_cycles"] > 0
    assert tp.rel(tx.numpy(), jx) <= 1e-10
    assert abs(float(tres) - float(jres)) <= 1e-10 * float(jres)


def test_octant_lattice_solve(eb):
    """The regular NodalSolver on the 2x octant lattice, sigma x octant
    fraction: the projection of a variable-density EB deck."""
    name, text, je, te, jg, tg = eb
    lo, hi, _ = _nodal_setup(text, tg)
    rng = np.random.default_rng(25)
    sigma = 1.0 + 0.5 * rng.random(tuple(tg.n_cell))
    sf = np.repeat(np.repeat(np.repeat(sigma, 2, 0), 2, 1), 2, 2) \
        * te.vfrac_oct.numpy()
    fdx = tuple(d / 2 for d in tg.dx)
    ts = tmg.NodalSolver(fdx, tg.periodic, lo, hi, torch.as_tensor(sf),
                         direct=False)
    js = jmg.NodalSolver(fdx, jg.periodic, lo, hi, jnp.asarray(sf))
    nodes = tuple(2 * n if p else 2 * n + 1
                  for n, p in zip(tg.n_cell, tg.periodic))
    rhs = rng.standard_normal(nodes)
    rhs -= rhs.mean()
    kw = dict(rtol=1e-6, atol=1e-14, maxiter=6)
    tally = dict.fromkeys(tp.KINDS, 0)
    jx, _, jit = _count(tally, lambda: js.solve(jnp.asarray(rhs), **kw))
    tx, _, tit = ts.solve_info(torch.as_tensor(rhs), **kw)
    assert tit == int(jit) > 0
    assert tp.rel(tx.numpy(), jx) <= 1e-10
