"""incflo_torch's multigrid (ops/multigrid.py: hierarchies, transfer
operators, V-cycles, the V-cycle-preconditioned CG and the nodal V-cycle
iteration) against incflo_tpu, float64, 16x16x8, random positive
coefficients from a seed: fully periodic levels, and levels with Neumann
and Dirichlet walls (the rt deck's BC sets among them).

Tolerances: coefficients, diagonals and transfer operators 1e-13 (the
same sums in the same order); one V-cycle 1e-12; a whole solve the same
iteration count and the solution to 1e-10 of its max (rtol 1e-11: the
two smoothers differ by rounding -- incflo_tpu's jnp loop applies the
flux form of the cell operator, the port the kernels' diag-extracted
form -- and the iterations carry that rounding to about 1e-13).  The
walled solves are held to the same limits and must reach rtol 1e-11 /
atol 1e-14, as tests/test_multigrid.py asks of incflo_tpu.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import bench
from incflo_tpu import bcs as jbcs
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import mac_projection as jmac
from incflo_tpu.ops import multigrid as jmg

from incflo_torch import bcs as tbcs
from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import mac_projection as tmac
from incflo_torch.ops import multigrid as tmg

N = (16, 16, 8)
DX = (1.0 / 16, 1.0 / 16, 0.25 / 8)
P3 = (0, 0, 0)
PER = (True, True, True)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _faces(rng, comp=()):
    """Positive face coefficients with face n == face 0 (periodic)."""
    out = []
    for ax in range(3):
        f = 0.5 + rng.random(N + comp)
        out.append(np.concatenate([f, f.take([0], axis=ax)], axis=ax))
    return out


CELL_CASES = {
    # the MAC projection: singular Poisson, 1/rho on faces
    "poisson_singular": dict(alpha=0.0, beta=1.0, acoef=False, comp=()),
    # velocity diffusion: Helmholtz (acoef = rho, beta = dt), three
    # components in one solve; the scalar Helmholtz solve of the tracer
    # is held through diffuse_scalar below
    "helmholtz_batched": dict(alpha=1.0, beta=0.02, acoef=True, comp=(3,)),
}


@pytest.fixture(scope="module", params=sorted(CELL_CASES))
def cell_pair(request):
    c = CELL_CASES[request.param]
    rng = np.random.default_rng(7)
    bco = _faces(rng, c["comp"])
    ac = (0.6 + rng.random(N + (1,) * len(c["comp"]))) if c["acoef"] else None
    kw = dict(alpha=c["alpha"], beta=c["beta"])
    js = jmg.CellSolver(DX, P3, P3, acoef=None if ac is None
                        else jnp.asarray(ac),
                        bcoef=tuple(jnp.asarray(b) for b in bco), **kw)
    ts = tmg.CellSolver(DX, P3, P3, acoef=None if ac is None
                        else torch.as_tensor(ac),
                        bcoef=tuple(torch.as_tensor(b) for b in bco), **kw)
    rhs = rng.standard_normal(N + c["comp"])
    return js, ts, rhs


@pytest.fixture(scope="module")
def nodal_pair():
    rng = np.random.default_rng(8)
    sigma = 0.6 + 0.8 * rng.random(N)
    js = jmg.NodalSolver(DX, PER, P3, P3, jnp.asarray(sigma))
    ts = tmg.NodalSolver(DX, PER, P3, P3, torch.as_tensor(sigma))
    return js, ts, rng.standard_normal(N)


def test_cell_hierarchy_matches(cell_pair):
    js, ts, _ = cell_pair
    assert len(ts.levels) == len(js.levels) == 3      # 16x16x8 -> 4x4x2
    assert ts.symbol is None and js.symbol is None
    assert ts.singular == js.singular
    dinvs, fhis = ts.smoother_coefs()[:2]
    for li, (tl, jl) in enumerate(zip(ts.levels, js.levels)):
        assert tl.dx == jl.dx
        for a, b in zip(tl.bcoef, jl.bcoef):
            assert _rel(a, b) <= 1e-13
        if jl.acoef is not None:
            assert _rel(tl.acoef, jl.acoef) <= 1e-13
        jd = js.diags[li]
        assert _rel(ts.diags[li], jd) <= 1e-13
        assert _rel(dinvs[li], 1.0 / np.asarray(jd)) <= 1e-13
        for ax in range(3):
            hi = np.asarray(jl.bcoef[ax]).take(
                range(1, jl.bcoef[ax].shape[ax]), axis=ax)
            want = np.broadcast_to(jl.beta / jl.dx[ax] ** 2 * hi, jd.shape)
            assert _rel(fhis[li][ax], want) <= 1e-13


def test_cell_with_beta_rebuilds_smoother_coefs(cell_pair):
    js, ts, _ = cell_pair
    ts.smoother_coefs()
    js2, ts2 = js.with_beta(0.37), ts.with_beta(0.37)
    dinvs, fhis = ts2.smoother_coefs()[:2]
    for li, jd in enumerate(js2.diags):
        assert _rel(ts2.diags[li], jd) <= 1e-13
        assert _rel(dinvs[li], 1.0 / np.asarray(jd)) <= 1e-12
    lev = ts2.levels[0]
    hi = lev.bcoef[0].narrow(0, 1, N[0])
    assert _rel(fhis[0][0], np.broadcast_to(
        (0.37 / DX[0] ** 2 * hi).numpy(), ts2.diags[0].shape)) <= 1e-13


def test_cell_vcycle_matches(cell_pair):
    js, ts, rhs = cell_pair
    # jitted: run eagerly, the V-cycle compiles every jnp op on its own
    xj, rj = jax.jit(lambda b: js._vcycle(jnp.zeros_like(b), b,
                                          want_residual=True))(
        jnp.asarray(rhs))
    xt, rt = ts._vcycle(torch.zeros(rhs.shape, dtype=torch.float64),
                        torch.as_tensor(rhs), want_residual=True)
    assert _rel(xt, xj) <= 1e-12
    assert _rel(rt, rj) <= 1e-12


def test_cell_solve_matches(cell_pair):
    js, ts, rhs = cell_pair
    xj, resj, itj = js.solve(jnp.asarray(rhs))
    xt, rest, itt = ts.solve_info(torch.as_tensor(rhs))
    assert itt == int(itj) and itt > 1
    assert _rel(xt, xj) <= 1e-10
    r = rhs - rhs.mean() if ts.singular else rhs
    assert float(rest) <= 1e-11 * np.abs(r).max()
    true_res = r - tmg.cell_apply(xt, ts.levels[0]).numpy()
    assert np.abs(true_res).max() <= 1e-10 * np.abs(r).max()


def test_cell_solve_warm_start_and_presmooth(cell_pair):
    """x0 near the solution with presmooth=4 (the Helmholtz call of the
    step): fewer iterations than the cold solve, the same answer; from
    the solution itself no CG iteration at all."""
    js, ts, rhs = cell_pair
    x_cold, _, it_cold = ts.solve_info(torch.as_tensor(rhs))
    rng = np.random.default_rng(9)
    x0 = x_cold.numpy() * (1.0 + 1e-6 * rng.standard_normal(rhs.shape))
    xj, _, itj = js.solve(jnp.asarray(rhs), x0=jnp.asarray(x0), presmooth=4)
    xt, _, itt = ts.solve_info(torch.as_tensor(rhs), x0=torch.as_tensor(x0),
                               presmooth=4)
    assert itt == int(itj) and itt < it_cold
    assert _rel(xt, xj) <= 1e-10
    _, _, it0 = ts.solve_info(torch.as_tensor(rhs), x0=x_cold, rtol=1e-9,
                              presmooth=4)
    assert it0 == 0


def test_cell_solver_to_moves_every_tensor(cell_pair):
    _, ts, rhs = cell_pair
    ts.smoother_coefs()
    moved = ts.to("meta")
    dinvs, fhis = moved.smoother_coefs()[:2]
    tensors = list(moved.diags) + list(dinvs) + [f for t in fhis for f in t]
    for lev in moved.levels:
        tensors += list(lev.bcoef) + ([lev.acoef] if lev.acoef is not None
                                      else [])
    assert all(t.device.type == "meta" for t in tensors)


def test_prolong_cells_matches():
    rng = np.random.default_rng(10)
    c = rng.standard_normal((8, 8, 4, 2))
    for lo, hi in ((P3, P3), ((0, 1, 2), (0, 2, 1))):
        kw = dict(dx=DX, bc_lo=lo, bc_hi=hi, alpha=0.0, beta=1.0, acoef=None)
        jf = jmg._prolong_cells(jnp.asarray(c), jmg.CellLevel(bcoef=(), **kw))
        tf = tmg._prolong_cells(torch.as_tensor(c),
                                tmg.CellLevel(bcoef=(), **kw))
        assert tf.shape == (16, 16, 8, 2)
        assert _rel(tf, jf) <= 1e-15


@pytest.mark.parametrize("periodic", [PER, (True, False, False)])
def test_nodal_transfers_match(periodic):
    rng = np.random.default_rng(11)
    nodes_f = tuple(n + (0 if p else 1) for n, p in zip(N, periodic))
    nodes_c = tuple(n // 2 + (0 if p else 1) for n, p in zip(N, periodic))
    jl = jmg.NodalLevel(DX, periodic, P3, P3, None)
    tl = tmg.NodalLevel(DX, periodic, P3, P3, None)
    r = rng.standard_normal(nodes_f)
    jr = jmg._restrict_nodal(jnp.asarray(r), jl)
    tr = tmg._restrict_nodal(torch.as_tensor(r), tl)
    assert tr.shape == nodes_c and _rel(tr, jr) <= 1e-15
    c = rng.standard_normal(nodes_c)
    jp = jmg._prolong_nodal(jnp.asarray(c), jl)
    tp = tmg._prolong_nodal(torch.as_tensor(c), tl)
    assert tp.shape == nodes_f and _rel(tp, jp) <= 1e-15


def test_nodal_hierarchy_matches(nodal_pair):
    js, ts, _ = nodal_pair
    assert len(ts.levels) == len(js.levels) == 3
    assert ts.symbol is None and js.symbol is None
    for li in range(3):
        assert _rel(ts.sigmas[li], js._sigma_interior(li)) <= 1e-13
        assert ts.sigmas[li].shape == ts.diags[li].shape  # nodes == cells
        assert _rel(ts.diags[li], js.diags[li]) <= 1e-13
        assert _rel(ts.dinvs[li], js.dinvs[li]) <= 1e-13


def test_nodal_diag_dirichlet_rows_are_identity():
    rng = np.random.default_rng(12)
    sigma = 0.6 + rng.random(N)
    lo, hi = (0, 1, 2), (0, 1, 1)
    per = (True, False, False)
    jl = jmg.NodalLevel(DX, per, lo, hi, jnp.asarray(sigma)).with_stencil()
    tl = tmg.NodalLevel(DX, per, lo, hi, torch.as_tensor(sigma)).with_stencil()
    td = tmg.nodal_diag(tl)
    assert _rel(td, jmg.nodal_diag(jl)) <= 1e-13
    assert bool((td[:, :, 0] == 1.0).all())


def test_nodal_vcycle_matches(nodal_pair):
    js, ts, rhs = nodal_pair
    xj, rj = jax.jit(lambda b: js._vcycle(jnp.zeros_like(b), b,
                                          want_residual=True))(
        jnp.asarray(rhs))
    xt, rt = ts._vcycle(torch.zeros(N, dtype=torch.float64),
                        torch.as_tensor(rhs), want_residual=True)
    assert _rel(xt, xj) <= 1e-12
    assert _rel(rt, rj) <= 1e-12


def test_nodal_solve_matches(nodal_pair):
    js, ts, rhs = nodal_pair
    xj, resj, itj = js.solve(jnp.asarray(rhs))
    before = dict(tmg.COUNTS)
    xt, rest, itt = ts.solve_info(torch.as_tensor(rhs))
    assert itt == int(itj) and itt > 1
    assert _rel(xt, xj) <= 1e-10
    assert _rel(rest, resj) <= 1e-3
    assert tmg.COUNTS["nodal_cycles"] == before["nodal_cycles"] + itt
    # one bool read per loop test: every cycle and the test that ends it
    assert tmg.COUNTS["host_syncs"] == before["host_syncs"] + itt + 1
    # warm start from the solution: the first test ends the loop
    x2, _, it2 = ts.solve_info(torch.as_tensor(rhs), x0=xt, rtol=1e-9)
    assert it2 == 0 and _rel(x2, xj) <= 1e-10


def test_walled_levels_raise_and_name_the_roadmap():
    """Walled 3D levels smooth and solve (they raised until the wall
    forms were ported), and since ROADMAP A8 a walled 2D level does too,
    swept in incflo_tpu's own arithmetic: its V-cycle CG ends on
    incflo_tpu's iteration and within 1e-10 of its solution."""
    sigma = torch.ones(N, dtype=torch.float64)
    ns = tmg.NodalSolver(DX, (True, True, False), (0, 0, 1), (0, 0, 1),
                         sigma * (1 + torch.rand(N, dtype=torch.float64)))
    x = ns.solve(torch.rand(16, 16, 9, dtype=torch.float64))
    assert x.shape == (16, 16, 9) and bool(torch.isfinite(x).all())
    rng = np.random.default_rng(13)
    bco = [torch.as_tensor(b) for b in _faces(rng)]
    cs = tmg.CellSolver(DX, (0, 0, 1), (0, 0, 1), alpha=0.0, beta=1.0,
                        acoef=None, bcoef=tuple(bco))
    x = cs.solve(torch.rand(N, dtype=torch.float64))
    assert x.shape == N and bool(torch.isfinite(x).all())
    bx = 1.0 + rng.random((9, 8))
    by = 1.0 + rng.random((8, 9))
    rhs = rng.standard_normal((8, 8))
    cs2 = tmg.CellSolver(DX[:2], (0, 1), (0, 1), alpha=1.0, beta=1.0,
                         acoef=torch.ones((8, 8), dtype=torch.float64),
                         bcoef=(torch.as_tensor(bx), torch.as_tensor(by)),
                         direct=False)
    x2, _, it2 = cs2.solve_info(torch.as_tensor(rhs), rtol=1e-11, atol=1e-14)
    js2 = jmg.CellSolver(DX[:2], (0, 1), (0, 1), alpha=1.0, beta=1.0,
                         acoef=jnp.ones((8, 8)),
                         bcoef=(jnp.asarray(bx), jnp.asarray(by)))
    xj, _, itj = js2.solve(jnp.asarray(rhs), rtol=1e-11, atol=1e-14)
    assert it2 == int(itj) > 0
    assert _rel(x2, xj) <= 1e-10


# ---------------------------------------------------------------------
# walls: Neumann and Dirichlet sides on the cell and nodal hierarchies
# ---------------------------------------------------------------------

NEU, DIR = 1, 2

WALL_CASES = {
    # rt's MAC projection: singular Poisson, periodic x/y, Neumann z
    "mac_neumann_z": dict(alpha=0.0, beta=1.0, acoef=False,
                          lo=(0, 0, NEU), hi=(0, 0, NEU)),
    # rt's normal-velocity Helmholtz solve: Dirichlet z (its tangential
    # and tracer solves, Helmholtz with Neumann z, run in the rt step of
    # tests/test_torch_step.py)
    "helmholtz_dirichlet_z": dict(alpha=1.0, beta=0.02, acoef=True,
                                  lo=(0, 0, DIR), hi=(0, 0, DIR)),
    # a non-periodic x and a different kind on each side
    "poisson_mixed_sides": dict(alpha=0.0, beta=1.0, acoef=False,
                                lo=(NEU, 0, DIR), hi=(DIR, 0, NEU)),
}


def _walled_faces(rng, lo):
    out = []
    for ax in range(3):
        shape = tuple(n + (1 if a == ax else 0) for a, n in enumerate(N))
        f = 0.5 + rng.random(shape)
        if lo[ax] == 0:
            f = np.concatenate([f.take(range(N[ax]), axis=ax),
                                f.take([0], axis=ax)], axis=ax)
        out.append(f)
    return out


@pytest.fixture(scope="module", params=sorted(WALL_CASES))
def walled_cell_pair(request):
    c = WALL_CASES[request.param]
    rng = np.random.default_rng(30)
    bco = _walled_faces(rng, c["lo"])
    ac = (0.6 + rng.random(N)) if c["acoef"] else None
    kw = dict(alpha=c["alpha"], beta=c["beta"])
    js = jmg.CellSolver(DX, c["lo"], c["hi"], acoef=None if ac is None
                        else jnp.asarray(ac),
                        bcoef=tuple(jnp.asarray(b) for b in bco), **kw)
    ts = tmg.CellSolver(DX, c["lo"], c["hi"], acoef=None if ac is None
                        else torch.as_tensor(ac),
                        bcoef=tuple(torch.as_tensor(b) for b in bco), **kw)
    return js, ts, rng.standard_normal(N), c


def test_walled_cell_hierarchy_matches(walled_cell_pair):
    """Diagonals (factor 0 on a Neumann wall face, 3 on a Dirichlet one)
    and the wall planes of every coarsened level."""
    js, ts, _, c = walled_cell_pair
    assert len(ts.levels) == len(js.levels) == 3
    assert ts.symbol is None and js.symbol is None
    assert ts.singular == js.singular
    _, fhis, fwalls = ts.smoother_coefs()
    for li, jl in enumerate(js.levels):
        assert _rel(ts.diags[li], js.diags[li]) <= 1e-13
        for ax in range(3):
            jb = np.asarray(jl.bcoef[ax]) * (jl.beta / jl.dx[ax] ** 2)
            assert _rel(fhis[li][ax],
                        jb.take(range(1, jb.shape[ax]), axis=ax)) <= 1e-13
            if c["lo"][ax] == 0:
                assert fwalls[li][ax] is None
            else:
                assert _rel(fwalls[li][ax], jb.take([0], axis=ax)) <= 1e-13


def test_walled_cell_vcycle_matches(walled_cell_pair):
    js, ts, rhs, _ = walled_cell_pair
    xj, rj = jax.jit(lambda b: js._vcycle(jnp.zeros_like(b), b,
                                          want_residual=True))(
        jnp.asarray(rhs))
    xt, rt = ts._vcycle(torch.zeros(N, dtype=torch.float64),
                        torch.as_tensor(rhs), want_residual=True)
    assert _rel(xt, xj) <= 1e-12
    assert _rel(rt, rj) <= 1e-12


def test_walled_cell_solve_matches(walled_cell_pair):
    js, ts, rhs, _ = walled_cell_pair
    xj, resj, itj = js.solve(jnp.asarray(rhs))
    xt, rest, itt = ts.solve_info(torch.as_tensor(rhs))
    assert itt == int(itj) and itt > 1
    assert _rel(xt, xj) <= 1e-10
    r = rhs - rhs.mean() if ts.singular else rhs
    assert float(rest) <= max(1e-11 * np.abs(r).max(), 1e-14)
    true_res = r - tmg.cell_apply(xt, ts.levels[0]).numpy()
    assert np.abs(true_res).max() <= 1e-10 * np.abs(r).max()


def test_walled_cell_solve_inhom_matches(walled_cell_pair):
    """Inhomogeneous Dirichlet face values (a scalar on one side, a
    plane on the other), folded into the right-hand side.  A plane has
    the ghosts of the axes padded before its own, as the slabs of
    diffusion.velocity_bvals have.  A case without a Dirichlet side
    takes no values and solves the homogeneous system."""
    js, ts, rhs, c = walled_cell_pair
    rng = np.random.default_rng(31)
    jb, tb = {}, {}
    for ax in range(3):
        plane = tuple(1 if a == ax else n + (2 if a < ax else 0)
                      for a, n in enumerate(N))
        for side, code in ((0, c["lo"][ax]), (1, c["hi"][ax])):
            if code != DIR:
                continue
            v = 0.7 if side == 0 else rng.standard_normal(plane)
            jb[(ax, side)] = v if side == 0 else jnp.asarray(v)
            tb[(ax, side)] = v if side == 0 else torch.as_tensor(v)
    xj, _, itj = js.solve_inhom(jnp.asarray(rhs), jb)
    before = tmg.COUNTS["cell_iters"]
    xt = ts.solve_inhom(torch.as_tensor(rhs), tb)
    assert tmg.COUNTS["cell_iters"] - before == int(itj) > 1
    assert _rel(xt, xj) <= 1e-10
    lev = ts.levels[0]
    rhs_t = torch.as_tensor(rhs)
    folded = rhs_t - tmg.cell_apply_inhom(torch.zeros_like(rhs_t), lev, tb)
    r = rhs_t - tmg.cell_apply_inhom(xt, lev, tb)
    if ts.singular:
        folded, r = folded - folded.mean(), r - r.mean()
    assert float(r.abs().max()) <= 1e-10 * float(folded.abs().max())


def test_walled_cell_solve_through_rb_kernel(monkeypatch):
    """The same solve with incflo_tpu's opt-in Pallas smoother switched
    on in interpret mode, so that the JAX side really smooths its fine
    level through pallas_smoother._rb_kernel (the coarser levels, whose
    ny*nz is no multiple of 128, stay on the jnp loop)."""
    from incflo_tpu.ops import pallas_guard
    from incflo_tpu.ops import pallas_smoother as psm
    monkeypatch.setattr(psm, "ENABLED", True)
    monkeypatch.setattr(psm, "INTERPRET", True)
    monkeypatch.setattr(pallas_guard, "_sharded", False)
    calls = []
    real = psm.rb_sweep_3d

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(psm, "rb_sweep_3d", counted)
    c = WALL_CASES["helmholtz_dirichlet_z"]
    rng = np.random.default_rng(32)
    bco = _walled_faces(rng, c["lo"])
    ac = 0.6 + rng.random(N)
    kw = dict(alpha=c["alpha"], beta=c["beta"])
    js = jmg.CellSolver(DX, c["lo"], c["hi"], acoef=jnp.asarray(ac),
                        bcoef=tuple(jnp.asarray(b) for b in bco), **kw)
    ts = tmg.CellSolver(DX, c["lo"], c["hi"], acoef=torch.as_tensor(ac),
                        bcoef=tuple(torch.as_tensor(b) for b in bco), **kw)
    rhs = rng.standard_normal(N)
    xj, rj = jax.jit(lambda b: js._vcycle(jnp.zeros_like(b), b,
                                          want_residual=True))(
        jnp.asarray(rhs))
    assert calls and all(shape == N for shape in calls)
    xt, rt = ts._vcycle(torch.zeros(N, dtype=torch.float64),
                        torch.as_tensor(rhs), want_residual=True)
    assert _rel(xt, xj) <= 1e-12
    assert _rel(rt, rj) <= 1e-12
    xj, _, itj = js.solve(jnp.asarray(rhs))
    xt, _, itt = ts.solve_info(torch.as_tensor(rhs))
    assert itt == int(itj) and itt > 1
    assert _rel(xt, xj) <= 1e-10


WALLED_NODAL = {
    # rt's nodal projection: 16x16x9 nodes, singular
    "rt_neumann_z": ((True, True, False), (0, 0, NEU), (0, 0, NEU)),
    # a Dirichlet side (identity rows) and a non-periodic x
    "dirichlet_side": ((False, True, False), (NEU, 0, NEU), (DIR, 0, NEU)),
}


@pytest.fixture(scope="module", params=sorted(WALLED_NODAL))
def walled_nodal_pair(request):
    periodic, lo, hi = WALLED_NODAL[request.param]
    rng = np.random.default_rng(33)
    sigma = 0.6 + 0.8 * rng.random(N)
    js = jmg.NodalSolver(DX, periodic, lo, hi, jnp.asarray(sigma))
    ts = tmg.NodalSolver(DX, periodic, lo, hi, torch.as_tensor(sigma))
    nodes = tuple(n + (0 if p else 1) for n, p in zip(N, periodic))
    return js, ts, rng.standard_normal(nodes)


def test_walled_nodal_hierarchy_matches(walled_nodal_pair):
    js, ts, rhs = walled_nodal_pair
    assert len(ts.levels) == len(js.levels) == 3
    assert ts.symbol is None and js.symbol is None
    assert ts.singular == js.singular
    assert ts.diags[0].shape == rhs.shape != ts.sigmas[0].shape
    for li in range(3):
        assert _rel(ts.diags[li], js.diags[li]) <= 1e-13
        assert _rel(ts.dinvs[li], js.dinvs[li]) <= 1e-13
    x = np.random.default_rng(34).standard_normal(rhs.shape)
    assert _rel(tmg.nodal_apply(torch.as_tensor(x), ts.levels[0]),
                jmg.nodal_apply(jnp.asarray(x), js.levels[0])) <= 1e-13


def test_walled_nodal_vcycle_matches(walled_nodal_pair):
    js, ts, rhs = walled_nodal_pair
    rhs_t = tmg._zero_dirichlet(torch.as_tensor(rhs), ts.levels[0])
    xj, rj = jax.jit(lambda b: js._vcycle(jnp.zeros_like(b), b,
                                          want_residual=True))(
        jnp.asarray(rhs_t.numpy()))
    xt, rt = ts._vcycle(torch.zeros_like(rhs_t), rhs_t, want_residual=True)
    assert _rel(xt, xj) <= 1e-12
    assert _rel(rt, rj) <= 1e-12


def test_walled_nodal_solve_matches(walled_nodal_pair):
    js, ts, rhs = walled_nodal_pair
    xj, resj, itj = js.solve(jnp.asarray(rhs))
    xt, rest, itt = ts.solve_info(torch.as_tensor(rhs))
    assert itt == int(itj) and itt > 1
    assert _rel(xt, xj) <= 1e-10
    r = torch.as_tensor(rhs - rhs.mean() if ts.singular else rhs)
    r = tmg._zero_dirichlet(r, ts.levels[0])
    assert float(rest) <= max(1e-11 * float(r.abs().max()), 1e-14)
    true_res = r - tmg.nodal_apply(xt, ts.levels[0])
    assert float(true_res.abs().max()) <= 1e-10 * float(r.abs().max())


def test_walled_nodal_levels_smooth_through_the_kernel_wrapper(monkeypatch):
    """NodalSolver._smooth_res sends every 3D level, walled or periodic,
    through smoother_kernels.nodal_smooth with the level's sides (plain on
    the CPU, the kernel on the card): a V-cycle of a walled hierarchy
    calls it on each level, and it still matches incflo_tpu."""
    from incflo_torch.ops import smoother_kernels as sk
    calls = []
    real = sk.nodal_smooth

    def counted(x, *a, bc=None, **k):
        calls.append((tuple(x.shape), bc))
        return real(x, *a, bc=bc, **k)
    monkeypatch.setattr(sk, "nodal_smooth", counted)
    periodic, lo, hi = WALLED_NODAL["rt_neumann_z"]
    rng = np.random.default_rng(35)
    sigma = 0.6 + 0.8 * rng.random(N)
    js = jmg.NodalSolver(DX, periodic, lo, hi, jnp.asarray(sigma))
    ts = tmg.NodalSolver(DX, periodic, lo, hi, torch.as_tensor(sigma))
    rhs = tmg._zero_dirichlet(torch.as_tensor(
        rng.standard_normal((16, 16, 9))), ts.levels[0])
    xt, rt = ts._vcycle(torch.zeros_like(rhs), rhs, want_residual=True)
    nlev = len(ts.levels)
    assert len(calls) == 2 * nlev - 1
    assert {shape for shape, _ in calls} == {
        tuple(d.shape) for d in ts.diags}
    assert all(bc == (lo, hi) for _, bc in calls)
    xj, rj = jax.jit(lambda b: js._vcycle(jnp.zeros_like(b), b,
                                          want_residual=True))(
        jnp.asarray(rhs.numpy()))
    assert _rel(xt, xj) <= 1e-12 and _rel(rt, rj) <= 1e-12


# ---------------------------------------------------------------------
# the step's three variable-coefficient solves, module by module
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def vd_cfgs():
    text = bench._deck("shear3d", 16, "float64")[0] + (
        "incflo.constant_density = false\nincflo.advect_tracer = true\n"
        "incflo.mu_s = 0.05\nincflo.mu = 0.5\n")
    return JConfig.from_text(text), TConfig.from_text(text)


def _rho(rng, grow=0):
    """Smooth periodic density in [0.6, 1.4] on the 16x16x8 grid, grown
    by `grow` periodic ghosts."""
    c = [(np.arange(-grow, n + grow) + 0.5) / n for n in N]
    x, y, z = np.meshgrid(*c, indexing="ij")
    return 1.0 + 0.4 * (np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)
                        * np.cos(4 * np.pi * z))


def test_mac_projection_variable_density_matches(vd_cfgs):
    jcfg, tcfg = vd_cfgs
    rng = np.random.default_rng(20)
    umac = []
    for d in range(3):
        a = rng.standard_normal(N)
        umac.append(np.concatenate([a, a.take([0], axis=d)], axis=d))
    rho_g1 = _rho(rng, 1)
    phi0 = 1e-3 * rng.standard_normal(N)
    bc_kind = np.zeros((3, 2), np.int32)
    jbeta = jmac.inv_rho_on_faces(jnp.asarray(rho_g1), jcfg.grid)
    tbeta = tmac.inv_rho_on_faces(torch.as_tensor(rho_g1), tcfg.grid)
    ju, jphi, _, jit = jmac.project_mac_velocities(
        [jnp.asarray(u) for u in umac], jbeta, jcfg.grid, bc_kind,
        phi0=jnp.asarray(phi0))
    before = tmg.COUNTS["cell_iters"]
    tu, tphi = tmac.project_mac_velocities(
        [torch.as_tensor(u) for u in umac], tbeta, tcfg.grid, bc_kind,
        phi0=torch.as_tensor(phi0))
    assert tmg.COUNTS["cell_iters"] - before == int(jit) > 1
    assert _rel(tphi, jphi) <= 1e-10
    for a, b in zip(tu, ju):
        assert _rel(a, b) <= 1e-10
    div = tmac.mac_divergence(tu, tcfg.grid).abs().max()
    assert float(div) <= 1e-10 * 16.0


def test_diffusion_variable_density_matches(vd_cfgs):
    """diffuse_velocity (mu = 0.5: the tensor CG iterates, preconditioned
    by the V-cycle of the anisotropic solver) and diffuse_scalar with a
    variable rho."""
    jcfg, tcfg = vd_cfgs
    jg, tg = jcfg.grid, tcfg.grid
    ng = 3
    rng = np.random.default_rng(21)
    vel = rng.standard_normal(N + (3,))
    tra = rng.random(N + (1,))
    rho = _rho(rng)
    eta_g1 = np.full(tuple(n + 2 for n in N), 0.5)
    dt_diff = 0.5 * 0.05
    jrec, trec = jcfg.velocity_bcrecs(), tcfg.velocity_bcrecs()
    jev, tev = jcfg.velocity_ext_values(), tcfg.velocity_ext_values()
    jeta = jdiff.eta_to_faces(jnp.asarray(eta_g1), jg)
    teta = tdiff.eta_to_faces(torch.as_tensor(eta_g1), tg)
    jout, jres, jtol = jdiff.diffuse_velocity(
        jnp.asarray(vel), jnp.asarray(rho), jeta, dt_diff, jcfg, jg,
        eta_g1=jnp.asarray(eta_g1), ng=ng,
        grow_fn=lambda v: jbcs.grow(v, ng, jg, jrec, jev),
        grow_hom_fn=lambda v: jbcs.grow(v, ng, jg, jrec),
        return_tensor_res=True)
    syncs = tmg.COUNTS["host_syncs"]
    tout, tres, ttol = tdiff.diffuse_velocity(
        torch.as_tensor(vel), torch.as_tensor(rho), teta,
        torch.tensor(dt_diff, dtype=torch.float64), tcfg, tg,
        eta_g1=torch.as_tensor(eta_g1), ng=ng,
        grow_fn=lambda v: tbcs.grow(v, ng, tg, trec, tev),
        grow_hom_fn=lambda v: tbcs.grow(v, ng, tg, trec),
        return_tensor_res=True)
    assert tmg.COUNTS["host_syncs"] - syncs >= 6     # the tensor CG looped
    assert float(tres) <= float(ttol)
    assert _rel(ttol, jtol) <= 1e-12
    assert _rel(tout, jout) <= 1e-10

    mu_faces = [[np.full(tuple(n + (a == d) for a, n in enumerate(N)), 0.05)
                 for d in range(3)]]
    js = jdiff.diffuse_scalar(
        jnp.asarray(tra), jnp.asarray(rho),
        [[jnp.asarray(f) for f in mu_faces[0]]], dt_diff, jcfg, jg)
    ts = tdiff.diffuse_scalar(
        torch.as_tensor(tra), torch.as_tensor(rho),
        [[torch.as_tensor(f) for f in mu_faces[0]]],
        torch.tensor(dt_diff, dtype=torch.float64), tcfg, tg)
    assert _rel(ts, js) <= 1e-10
    jl = jdiff.compute_laps(jnp.asarray(tra),
                            [[jnp.asarray(f) for f in mu_faces[0]]], jcfg, jg)
    tl = tdiff.compute_laps(torch.as_tensor(tra),
                            [[torch.as_tensor(f) for f in mu_faces[0]]],
                            tcfg, tg)
    assert _rel(tl, jl) <= 1e-13
