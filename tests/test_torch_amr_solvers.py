"""The coarse-fine closures of incflo_torch's solvers against incflo_tpu's
(ROADMAP A13), float64, on a 2D patch (the RT2D band: periodic x,
coarse-fine faces on both y sides) and a 3D one (a z slab of a walled
RT deck: periodic x and y, coarse-fine faces on both z sides).  Each
patch's context comes from the same seeded parent states, and each
solve takes the patch's own hook values: NodalSolver.solve with
dirichlet_vals (inhomogeneous identity rows, V-cycles where the spectral
path would otherwise be taken), project_mac_velocities with
bc_override / phi_bvals, and diffuse_velocity / diffuse_scalar with the
coarse-fine face values.  Solutions within 1e-10 relative, iteration
counts equal (incflo_tpu's counted as torch_parity.counted_loops counts
them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import mac_projection as jmac
from incflo_tpu.ops import multigrid as jmg
from incflo_tpu.state import LevelState as JLevel

from incflo_torch import bcs as tbcs
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import mac_projection as tmac
from incflo_torch.ops import multigrid as tmg
from incflo_torch.state import LevelState as TLevel

import torch_parity as tp

RT3D = """
amr.n_cell = 8 8 16
amr.max_level = 1
amr.patch_mode = slab
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 0.5 0.5 1.0
geometry.is_periodic = 1 1 0
zlo.type = "sw"
zhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. 0. -0.1
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.01
incflo.mu_s = 0.01
incflo.do_initial_proj = 0
incflo.initial_iterations = 0
"""
CASES = {"2d": (tp.rt2d_amr_deck(), ((0, 8), (16, 24))),
         "3d": (RT3D, ((0, 0, 4), (8, 8, 12)))}


def _level(grid, ntrac, seed):
    rng = np.random.default_rng(seed)
    cs, nd = grid.cell_shape, grid.ndim
    return {"velocity": rng.standard_normal(cs + (nd,)),
            "density": 1.0 + rng.random(cs),
            "tracer": rng.standard_normal(cs + (ntrac,)),
            "gp": rng.standard_normal(cs + (nd,)),
            "p": rng.standard_normal(grid.node_shape),
            "mac_phi": rng.standard_normal(cs)}


@pytest.fixture(scope="module", params=sorted(CASES))
def patches(request):
    """(incflo_tpu's PatchSim, the port's) with one context."""
    text, box = CASES[request.param]
    jamr = JAMR(JConfig.from_text(text))
    amr = tp.port_amr(text)
    jps, tps = jamr._build_patch(0, box), amr._build_patch(0, box)
    parent = _level(amr.sim0.grid, amr.cfg.ntrac, 7)
    jps.set_context(JLevel(**{k: jnp.asarray(v) for k, v in parent.items()}))
    tps.set_context(TLevel(**{k: torch.as_tensor(v)
                              for k, v in parent.items()}))
    return jps, tps


def _run_both(jfn, tfn):
    """(incflo_tpu's result, the port's, their per-kind iterations)."""
    import jax
    tally = dict.fromkeys(tp.KINDS, 0)
    with tp.counted_loops(tally):
        jout = jfn()
        jax.effects_barrier()
    before = dict(tmg.COUNTS)
    tout = tfn()
    got = {k: tmg.COUNTS[k] - before[k] for k in tp.KINDS}
    assert got == tally, (got, tally)
    return jout, tout, got


def _periodic_faces(b, d, grid):
    """Face coefficients of axis d whose last face, on a periodic axis,
    is its first (the same face), as a step's coefficients are."""
    if grid.periodic[d]:
        b = b.copy()
        b[(slice(None),) * d + (-1,)] = b[(slice(None),) * d + (0,)]
    return b


def _close(a, b, tol=1e-10):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert a.shape == np.shape(b)
    assert tp.rel(a, np.asarray(b)) <= tol


def test_nodal_solve_with_dirichlet_values(patches):
    jps, tps = patches
    grid = tps.grid
    rng = np.random.default_rng(3)
    sigma = 0.5 + rng.random(grid.cell_shape)
    rhs = rng.standard_normal(grid.node_shape)
    bc_lo, bc_hi = tmac.projection_solver_bc(tps.cfg.bc_kind, grid)
    jov, jvals = jps._nodal_bc_args()
    tov, tvals = tps._nodal_bc_args()
    assert set(jov) == set(tov) == set(tps.cf_interior)
    for (ax, side), bc in tov.items():
        (bc_lo if side == 0 else bc_hi)[ax] = bc
    # the start holds the Dirichlet values (as the step's warm start, the
    # last p, nearly does): from zero, the first V-cycle's jump of the
    # boundary rows raises the max-norm residual and the stagnation test
    # ends the solve, in both packages
    x0 = torch.zeros(grid.node_shape, dtype=torch.float64)
    for (ax, side), val in tvals.items():
        x0 = tmg._set_slab(x0, ax, 0 if side == 0 else -1, val)
    kw = dict(rtol=1e-11, atol=1e-14, maxiter=100)
    jsol = jmg.NodalSolver(grid.dx, grid.periodic, bc_lo, bc_hi,
                           jnp.asarray(sigma))
    tsol = tmg.NodalSolver(grid.dx, grid.periodic, bc_lo, bc_hi,
                           torch.as_tensor(sigma), direct=False)
    (jx, _, jit), (tx, _, tit), it = _run_both(
        lambda: jsol.solve(jnp.asarray(rhs), x0=jnp.asarray(x0.numpy()),
                           dirichlet_vals=jvals, **kw),
        lambda: tsol.solve_info(torch.as_tensor(rhs), x0=x0,
                                dirichlet_vals=tvals, **kw))
    assert int(jit) == tit == it["nodal_cycles"] > 1
    _close(tx, jx)
    # the Dirichlet rows hold the parent's prolonged p
    ax, side = min(tps.cf_interior)
    row = tx.narrow(ax, 0 if side == 0 else tx.shape[ax] - 1, 1)
    assert torch.equal(row, tvals[(ax, side)])


def test_mac_projection_with_phi_bvals(patches):
    jps, tps = patches
    grid = tps.grid
    rng = np.random.default_rng(4)
    nd = grid.ndim
    shapes = [tuple(n + (a == d) for a, n in enumerate(grid.cell_shape))
              for d in range(nd)]
    umac = [rng.standard_normal(s) for s in shapes]
    beta = [_periodic_faces(0.5 + rng.random(s), d, grid)
            for d, s in enumerate(shapes)]
    phi0 = rng.standard_normal(grid.cell_shape)
    kw = dict(rtol=1e-11, atol=1e-14, maxiter=200)
    (ju, jphi, _, jit), (tu, tphi), it = _run_both(
        lambda: jmac.project_mac_velocities(
            [jnp.asarray(u) for u in umac], [jnp.asarray(b) for b in beta],
            grid, tps.cfg.bc_kind, phi0=jnp.asarray(phi0),
            **jps._mac_bc_args(), **kw),
        lambda: tmac.project_mac_velocities(
            [torch.as_tensor(u) for u in umac],
            [torch.as_tensor(b) for b in beta], grid, tps.cfg.bc_kind,
            phi0=torch.as_tensor(phi0), direct=False,
            **tps._mac_bc_args(), **kw))
    assert int(jit) == it["cell_iters"] > 0
    _close(tphi, jphi)
    for a, b in zip(tu, ju):
        _close(a, b)


def test_diffusion_with_coarse_fine_values(patches):
    jps, tps = patches
    grid, cfg = tps.grid, tps.cfg
    rng = np.random.default_rng(5)
    nd, ng = grid.ndim, cfg.nghost_state()
    vel = rng.standard_normal(grid.cell_shape + (nd,))
    tra = rng.standard_normal(grid.cell_shape + (cfg.ntrac,))
    rho = 1.0 + rng.random(grid.cell_shape)
    # eta grown by one cell as a step grows it (periodic axes wrap)
    rec = tbcs.make_bcrecs(1, nd) * 0 + int(tbcs.BCType.foextrap)
    eta = tbcs.grow_scalar(
        torch.as_tensor(0.01 * (1.0 + rng.random(grid.cell_shape))), 1,
        grid, rec).numpy()
    mu_s = [[np.full(tuple(n + (a == d) for a, n in enumerate(grid.n_cell)),
                     cfg.mu_s[0]) for d in range(nd)]]
    dt = 0.05

    def jrun():
        e = jnp.asarray(eta)
        vbc, vbv = jps._diff_bc_args("vel")
        sbc, sbv = jps._diff_bc_args("tra")
        v = jdiff.diffuse_velocity(
            jnp.asarray(vel), jnp.asarray(rho), jdiff.eta_to_faces(e, grid),
            dt, jps.cfg, grid, eta_g1=e, ng=ng,
            grow_fn=lambda u: jps.grow_vel(u, ng),
            grow_hom_fn=lambda u: jps.grow_vel_hom(u, ng),
            solver_bc_override=vbc, bvals_override=vbv)
        s = jdiff.diffuse_scalar(
            jnp.asarray(tra), jnp.asarray(rho),
            [[jnp.asarray(f) for f in c] for c in mu_s], dt, jps.cfg, grid,
            solver_bc_override=sbc, bvals_override=sbv)
        return v, s

    def trun():
        e = torch.as_tensor(eta)
        vbc, vbv = tps._diff_bc_args("vel")
        sbc, sbv = tps._diff_bc_args("tra")
        v = tdiff.diffuse_velocity(
            torch.as_tensor(vel), torch.as_tensor(rho),
            tdiff.eta_to_faces(e, grid), dt, cfg, grid, eta_g1=e, ng=ng,
            grow_fn=lambda u: tps.grow_vel(u, ng),
            grow_hom_fn=lambda u: tps.grow_vel_hom(u, ng), direct=False,
            solver_bc_override=vbc, bvals_override=vbv)
        s = tdiff.diffuse_scalar(
            torch.as_tensor(tra), torch.as_tensor(rho),
            [[torch.as_tensor(f) for f in c] for c in mu_s], dt, cfg, grid,
            solver_bc_override=sbc, bvals_override=sbv)
        return v, s

    (jv, js), (tv, ts), it = _run_both(jrun, trun)
    assert it["cell_iters"] > 0 and it["tensor_cg_iters"] > 0
    _close(tv, jv)
    _close(ts, js)
