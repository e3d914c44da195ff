"""The pieces of the 2D MOL step of incflo_torch against incflo_tpu,
float64, inputs made from numpy seeds.

Tolerances: the MOL face velocities, fluxes and convective rate to 1e-13
relative to each output's max (the same elementwise operations in the
same order; only the libraries' rounding of a division by a Python float
may differ in the last bit); probtype 1 bit-equal; probtype 2 to float64
epsilon relative to the field's max (XLA's and PyTorch's float64 sine
round sin(pi x) differently in the last bit for some x: 16 of the 512
velocity values at 16x16 differ by 2.2e-16, where sin(2 pi x) of
probtype 1 agrees everywhere); the 2D cell and
nodal symbols and their direct solves, singular and not, to 1e-12 (the
same operators eigendecomposed by the same numpy calls, the transforms
summed in another order); the fixed-trip tensor CG against incflo_tpu's
kernel-mode form to 1e-10 (a CG on the same operator stopped by the same
rule, rounding apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import bench
from incflo_tpu import bcs as jbcs
from incflo_tpu import probs as jprobs
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import mol as jmol
from incflo_tpu.ops import multigrid as jmg
from incflo_tpu.ops import pallas_guard

from incflo_torch import bcs as tbcs
from incflo_torch import probs as tprobs
from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import mol as tmol
from incflo_torch.ops import multigrid as tmg

NG = 2
WALLS_Y = ('geometry.is_periodic = 1 0\nylo.type = "nsw"\nyhi.type = "nsw"\n'
           'ylo.velocity = 0.3 0.\nyhi.velocity = -0.2 0.\n')
# (name, cells, extra deck text): periodic square and oblong grids, and
# no-slip walls on y, whose ext_dir faces take the boundary value and
# whose slopes turn one-sided
MOL_CASES = {
    "periodic_16x16": (16, ""),
    "periodic_20x12": (20, "amr.n_cell = 20 12\ngeometry.prob_hi = 1. 0.6\n"),
    "walls_y_16x16": (16, WALLS_Y),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _configs(n, extra):
    text, _ = bench._deck("tgv2d", n, "float64")
    return JConfig.from_text(text + extra), TConfig.from_text(text + extra)


def _grown(jcfg, tcfg, seed):
    """A random velocity grown by NG ghosts in both packages (the ghost
    fill is bit-equal, tests/test_torch_config_bcs.py)."""
    vel = np.random.default_rng(seed).standard_normal(
        jcfg.grid.cell_shape + (2,))
    jg = jbcs.grow(jnp.asarray(vel), NG, jcfg.grid, jcfg.velocity_bcrecs(),
                   jcfg.velocity_ext_values())
    tg = tbcs.grow(torch.as_tensor(vel), NG, tcfg.grid,
                   tcfg.velocity_bcrecs(), tcfg.velocity_ext_values())
    return jg, tg


@pytest.mark.parametrize("case", sorted(MOL_CASES))
def test_predict_vels_on_faces_matches(case):
    jcfg, tcfg = _configs(*MOL_CASES[case])
    jg, tg = _grown(jcfg, tcfg, 1)
    ju = jmol.predict_vels_on_faces(jg, jcfg.grid, NG,
                                    jcfg.velocity_bcrecs())
    tu = tmol.predict_vels_on_faces(tg, tcfg.grid, NG,
                                    tcfg.velocity_bcrecs())
    for a, b in zip(tu, ju):
        assert _rel(a.numpy(), b) <= 1e-13


@pytest.mark.parametrize("case", sorted(MOL_CASES))
def test_convective_fluxes_and_rate_match(case):
    jcfg, tcfg = _configs(*MOL_CASES[case])
    jg, tg = _grown(jcfg, tcfg, 2)
    rng = np.random.default_rng(3)
    umac = []
    for d in range(2):
        shape = tuple(n + (1 if a == d else 0)
                      for a, n in enumerate(jcfg.grid.cell_shape))
        u = rng.standard_normal(shape)
        u[rng.random(shape) < 0.1] = 0.0       # the centred branch too
        umac.append(u)
    jf = jmol.compute_convective_fluxes(jg, [jnp.asarray(u) for u in umac],
                                        jcfg.grid, NG,
                                        jcfg.velocity_bcrecs())
    tf = tmol.compute_convective_fluxes(tg, [torch.as_tensor(u)
                                             for u in umac],
                                        tcfg.grid, NG,
                                        tcfg.velocity_bcrecs())
    for a, b in zip(tf, jf):
        assert _rel(a.numpy(), b) <= 1e-13
    assert _rel(tmol.convective_rate(tf, tcfg.grid).numpy(),
                jmol.convective_rate(jf, jcfg.grid)) <= 1e-13


@pytest.mark.parametrize("probtype", [1, 2])
@pytest.mark.parametrize("ndim", [2, 3])
def test_vortex_probtypes_bit_equal(probtype, ndim):
    deck = "tgv2d" if ndim == 2 else "shear3d"
    text, _ = bench._deck(deck, 16, "float64")
    text += f"incflo.probtype = {probtype}\n"
    jcfg, tcfg = JConfig.from_text(text), TConfig.from_text(text)
    jl = jprobs.init_fluid(jcfg, jcfg.grid, jnp.float64)
    tl = tprobs.init_fluid(tcfg, tcfg.grid, torch.float64, "cpu")
    for f in tl._fields:
        a, b = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
        assert a.shape == b.shape, f
        if probtype == 1:
            assert np.array_equal(a, b), f
        else:
            assert _rel(b, a) <= np.finfo(np.float64).eps, f


N2 = (16, 12)
DX2 = (1.0 / 16, 0.75 / 12)
P2 = (0, 0)


def _faces(val, comp=(), scale=None):
    out = []
    for d in range(2):
        shape = tuple(n + (1 if ax == d else 0) for ax, n in enumerate(N2))
        a = np.full(shape + comp, val)
        out.append(a if scale is None else a * scale)
    return out


def _check_symbol(jsym, tsym):
    assert jsym.cells == tsym.cells and jsym.batched == tsym.batched
    assert jsym.fwd is not None and tsym.fwd is not None
    assert _rel(tsym.sym_face.numpy(), jsym.sym_face) <= 1e-12
    for a, b in zip(tsym.fwd + tsym.inv, jsym.fwd + jsym.inv):
        assert _rel(a.numpy(), b) <= 1e-12


# the three direct solves of a tgv2d step: the MAC Poisson operator and
# the nodal one (singular), the batched velocity Helmholtz operator (not)
@pytest.mark.parametrize("case", ["mac_poisson", "helmholtz_batched",
                                  "nodal_poisson"])
def test_2d_symbols_and_solves_match(case):
    rng = np.random.default_rng(4)
    if case == "nodal_poisson":
        sigma = np.full(N2, 0.8)
        js = jmg.NodalSolver(DX2, (True, True), P2, P2, jnp.asarray(sigma))
        ts = tmg.NodalSolver(DX2, (True, True), P2, P2,
                             torch.as_tensor(sigma))
        comp = ()
    else:
        helm = case == "helmholtz_batched"
        comp = (2,) if helm else ()
        bco = _faces(0.01 if helm else 0.9, comp,
                     np.array([2.0, 1.0]) if helm else None)
        ac = np.full(N2 + (1,), 1.3) if helm else None
        kw = dict(alpha=1.0 if helm else 0.0, beta=1.0)
        js = jmg.CellSolver(DX2, P2, P2, acoef=None if ac is None
                            else jnp.asarray(ac),
                            bcoef=tuple(jnp.asarray(b) for b in bco), **kw)
        ts = tmg.CellSolver(DX2, P2, P2, acoef=None if ac is None
                            else torch.as_tensor(ac),
                            bcoef=tuple(torch.as_tensor(b) for b in bco),
                            **kw)
        if helm:
            js, ts = js.with_beta(0.37), ts.with_beta(0.37)
    _check_symbol(js.symbol, ts.symbol)
    assert ts.singular == (case != "helmholtz_batched")
    rhs = rng.standard_normal(N2 + comp)
    x_j = js.solve(jnp.asarray(rhs))[0]
    x_t = ts.solve(torch.as_tensor(rhs))
    assert _rel(x_t.numpy(), x_j) <= 1e-12
    if ts.singular:
        assert abs(float(x_t.mean())) <= 1e-12 * float(x_t.abs().max())


@pytest.mark.parametrize("mu,stiffness", [(0.01, 0.5), (0.5, 4.0)])
def test_fixed_trip_tensor_cg_matches_kernel_mode(mu, stiffness):
    """diffuse_velocity with fixed_trips=12 against incflo_tpu's kernel-
    mode form (pallas_guard.in_kernel(): 12 masked trips) on the tgv2d
    operator, with the prebuilt constant-coefficient solver the step uses
    (direct solve, direct preconditioner): the solution, the best
    residual and the tolerance.  The stiff case needs several trips."""
    text, _ = bench._deck("tgv2d", 16, "float64")
    text += f"incflo.mu = {mu}\n"
    jcfg, tcfg = JConfig.from_text(text), TConfig.from_text(text)
    jg, tg = jcfg.grid, tcfg.grid
    rng = np.random.default_rng(5)
    vel = rng.standard_normal(jg.cell_shape + (2,))
    rho = np.ones(jg.cell_shape)
    eta_g1 = np.full(tuple(n + 2 for n in jg.cell_shape), mu)
    dt_diff = stiffness * jg.dx[0] ** 2 / mu
    jrec, trec = jcfg.velocity_bcrecs(), tcfg.velocity_bcrecs()
    jev, tev = jcfg.velocity_ext_values(), tcfg.velocity_ext_values()
    jeta = jdiff.eta_to_faces(jnp.asarray(eta_g1), jg)
    teta = tdiff.eta_to_faces(torch.as_tensor(eta_g1), tg)
    # Simulation._build_static_solvers: eta doubled on each component's
    # own axis, acoef = ro_0, beta rescaled to dt_diff per solve
    bco = [np.full(tuple(n + (1 if a == d else 0)
                         for a, n in enumerate(jg.cell_shape)) + (2,), mu)
           * np.array([2.0, 1.0] if d == 0 else [1.0, 2.0])
           for d in range(2)]
    ac = np.ones(jg.cell_shape + (1,))
    jpre = jmg.CellSolver(jg.dx, P2, P2, alpha=1.0, beta=1.0,
                          acoef=jnp.asarray(ac),
                          bcoef=tuple(jnp.asarray(b) for b in bco))
    tpre = tmg.CellSolver(tg.dx, P2, P2, alpha=1.0, beta=1.0,
                          acoef=torch.as_tensor(ac),
                          bcoef=tuple(torch.as_tensor(b) for b in bco))
    pallas_guard.set_in_kernel(True)
    try:
        jout, jres, jtol = jax.jit(lambda v: jdiff.diffuse_velocity(
            v, jnp.asarray(rho), jeta, dt_diff, jcfg, jg,
            eta_g1=jnp.asarray(eta_g1), ng=NG,
            grow_fn=lambda x: jbcs.grow(x, NG, jg, jrec, jev),
            grow_hom_fn=lambda x: jbcs.grow(x, NG, jg, jrec),
            prebuilt_solver=jpre, return_tensor_res=True))(jnp.asarray(vel))
    finally:
        pallas_guard.set_in_kernel(False)
    tmg.reset_counts()
    tout, tres, ttol = tdiff.diffuse_velocity(
        torch.as_tensor(vel), torch.as_tensor(rho), teta,
        torch.tensor(dt_diff, dtype=torch.float64), tcfg, tg,
        eta_g1=torch.as_tensor(eta_g1), ng=NG,
        grow_fn=lambda v: tbcs.grow(v, NG, tg, trec, tev),
        grow_hom_fn=lambda v: tbcs.grow(v, NG, tg, trec),
        prebuilt_solver=tpre, return_tensor_res=True, fixed_trips=12)
    assert tmg.COUNTS["host_syncs"] == 0
    assert float(tres) <= float(ttol)
    assert _rel(ttol.numpy(), jtol) <= 1e-12
    assert abs(float(tres) - float(jres)) <= 1e-3 * float(ttol)
    assert _rel(tout.numpy(), jout) <= 1e-10
