"""Mass inflow and pressure inflow/outflow boundaries in incflo_torch
against incflo_tpu (ROADMAP A9c): the channel deck -- channel_cyl of
bench.py without its cylinder, 16 x 8 x 8 cells, mass inflow (1, 0, 0)
with tracer 1 at x-lo, pressure outflow at x-hi, no-slip y walls, a
periodic z, probtype 31, 3D MOL, constant density, one advected tracer
-- and the same channel with pressure inflow (p = 1) at x-lo, with
Godunov advection, which takes the walled Godunov forms, and with cubic
cells (a domain of 0.8 x 0.4 x 0.4): there the nodal V-cycles converge,
which they do not on the deck's own cells of aspect up to 6 (ROADMAP C),
so the inflow/outflow projection is also held on converged solves.

Each runs init + 3 steps in float64, from the port's own init_state and
from incflo_tpu's carried state: velocity, density, tracer, p, gp,
mac_phi and dt agree to 1e-10 relative to each field's max, and every
iterative solve of every step ends on the same iteration in both
packages (CG iterations, V-cycles, tensor-CG iterations; measured
differences about 1e-14).  The pressure-inflow channel starts from its
init plus a smooth velocity perturbation from a seed: its own flow is
the channel profile, whose pressure is rounding noise (|p| ~ 1e-15) and
no test of agreement.

The pieces are also held alone: the divergence pad with the inflow
bands, the solver BC maps and Dirichlet values, the ghost fill with the
inflow profiles of every channel probtype (bit-equal), and the mass
balance of the channel after the steps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu import bcs as jbcs
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import mac_projection as jmac

from incflo_torch import bcs as tbcs
from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import mac_projection as tmac
from incflo_torch.ops import mol
from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops.stencil import inner

import torch_parity as tp

STEPS = 3
N = 16
SEED = 7
GODUNOV = "incflo.use_godunov = true\nincflo.cfl = 0.9\n"
CUBIC = ("geometry.prob_hi = 1.2 0.4 0.1", "geometry.prob_hi = 0.8 0.4 0.4")


def _deck(case):
    if case == "mi_po":
        return tp.channel_deck(N)
    if case == "mi_po_cubic":
        return tp.channel_deck(N).replace(*CUBIC)
    if case == "pi_po":
        return tp.channel_deck(N, inflow="pi")
    return tp.channel_deck(N) + GODUNOV


def _perturb(case, grid):
    return tp.smooth_perturbation(grid, SEED) if case == "pi_po" else None


@pytest.fixture(scope="module",
                params=["mi_po", "mi_po_cubic", "pi_po", "godunov"])
def channel(request):
    case = request.param
    text = _deck(case)
    grid = TConfig.from_text(text).grid
    jsim, runs = tp.reference_run(text, STEPS, (_perturb(case, grid),))
    return case, text, jsim, runs[0]


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_channel_matches(channel, start):
    case, text, _, (states, iters) = channel
    sim = tp.port_sim(text)
    assert sim.grid.n_cell == (16, 8, 8)
    s = tp.own_start(sim, _perturb(case, sim.grid)) if start == "own_init" \
        else tp.carried(states[0])
    tmg.NODAL_LOG = []
    try:
        s, worst, got = tp.compare_run(sim, s, states, iters)
        log = [(float(res), float(tol)) for res, tol, _, _ in tmg.NODAL_LOG]
    finally:
        tmg.NODAL_LOG = None
    # the nodal projection iterated V-cycles every step (walled grid)
    assert all(it["nodal_cycles"] > 0 for it in got)
    if case == "mi_po_cubic":
        # on cubic cells every nodal solve met its tolerance, in the same
        # V-cycles as incflo_tpu's (compare_run)
        assert len(log) == 2 * STEPS
        assert all(res <= tol for res, tol in log), log
    assert bool(torch.isfinite(s.level.velocity).all())


def mac_velocities(sim, s):
    """The MOL face velocities of a state after the MAC projection (the
    velocities that advect mass and tracer)."""
    grid, cfg = sim.grid, sim.cfg
    ng = cfg.nghost_state()
    umac = mol.predict_vels_on_faces(sim.grow_vel(s.level.velocity, ng),
                                     grid, ng, sim.vel_bcrec)
    rho_g1 = inner(sim.grow_rho(s.level.density, ng), ng - 1, grid.ndim)
    umac, _ = tmac.project_mac_velocities(
        umac, tmac.inv_rho_on_faces(rho_g1, grid), grid, cfg.bc_kind,
        prebuilt_solver=sim._mac_solver, direct=False)
    return umac


def test_channel_mass_balance(channel):
    """The final state's MAC-projected face velocities carry through the
    outflow face the flux that enters through the inflow face, to 1e-9
    of it (the MAC projection is exact up to its solve), and nothing
    through the walls."""
    case, text, _, (states, _) = channel
    sim = tp.port_sim(text)
    umac = mac_velocities(sim, tp.carried(states[-1]))
    dy, dz = sim.grid.dx[1], sim.grid.dx[2]
    flux_in = float(umac[0][0].sum()) * dy * dz
    flux_out = float(umac[0][-1].sum()) * dy * dz
    assert flux_in > 0.03
    assert abs(flux_out - flux_in) <= 1e-9 * flux_in, (flux_in, flux_out)
    assert float(umac[1][:, (0, -1)].abs().max()) == 0.0
    if case != "pi_po":
        # mass inflow: the inflow face carries the profile 6 s (1 - s)
        s = (np.arange(8) + 0.5) / 8
        want = (6 * s * (1 - s)).sum() * 8 * dy * dz
        assert abs(flux_in - want) <= 1e-12 * want


@pytest.mark.parametrize("scale", [0.0, 0.5, 1.0])
def test_divergence_pad_matches(channel, scale):
    """_pad_vel_for_divergence: zero ghosts beyond the walls and the
    outflow, the inflow profile times inflow_scale in the normal
    component's x-lo band; bit-equal to incflo_tpu's."""
    case, text, jsim, _ = channel
    sim = tp.port_sim(text)
    vel = np.random.default_rng(3).standard_normal(
        sim.grid.cell_shape + (3,))
    want = jsim._pad_vel_for_divergence(jnp.asarray(vel), scale)
    got = sim._pad_vel_for_divergence(torch.as_tensor(vel), scale)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    band = got[0][0, 1:-1, 1:-1]
    if case == "pi_po" or scale == 0.0:
        assert float(band.abs().max()) == 0.0
    else:
        assert float(band.max()) > 0.9 * scale


@pytest.mark.parametrize("case", ["mi_po", "pi_po"])
def test_solver_bcs_match(case):
    """The BC maps of the projections (pi/po Dirichlet) and of the
    diffusion solves (mi Dirichlet, po Neumann), and the Dirichlet face
    values with the probtype-31 inflow profile."""
    text = _deck(case)
    j, t = JConfig.from_text(text), TConfig.from_text(text)
    assert [list(map(int, b)) for b in jmac.projection_solver_bc(
        j.bc_kind, j.grid)] == [list(map(int, b)) for b in
                                tmac.projection_solver_bc(t.bc_kind, t.grid)]
    assert [list(map(int, b)) for b in jdiff.scalar_solver_bc(j)] == \
        [list(map(int, b)) for b in tdiff.scalar_solver_bc(t)]
    for c in range(3):
        assert [list(map(int, b)) for b in jdiff.velocity_solver_bc(j, c)] \
            == [list(map(int, b)) for b in tdiff.velocity_solver_bc(t, c)]
        jv = jdiff.velocity_bvals(j, c, jnp.float64)
        tv = tdiff.velocity_bvals(t, c, torch.float64)
        assert jv.keys() == tv.keys()
        for k in jv:
            assert np.array_equal(np.asarray(jv[k]), tv[k].numpy()), (c, k)
    jt = jdiff.tracer_bvals(j, 0, jnp.float64)
    tt = tdiff.tracer_bvals(t, 0, torch.float64)
    for k in jt:
        assert float(jt[k]) == float(tt[k]), k
    lo, hi = tmac.projection_solver_bc(t.bc_kind, t.grid)
    assert int(hi[0]) == 2 and int(lo[0]) == (2 if case == "pi_po" else 1)


@pytest.mark.parametrize("probtype", [31, 311, 32, 322, 33, 333, 41])
def test_inflow_ghost_fill_bit_equal(probtype):
    """bcs.grow of the velocity with the inflow profile of each channel
    probtype on a mass-inflow face (pressure outflow opposite, the other
    axes periodic): bit-equal to incflo_tpu's."""
    axis = {31: 0, 311: 0, 41: 0, 32: 1, 322: 1, 33: 2, 333: 2}[probtype]
    flags = " ".join("0" if a == axis else "1" for a in range(3))
    name = "xyz"[axis]
    text = tp.shear3d_deck(N) + f"""
geometry.is_periodic = {flags}
{name}lo.type = "mi"
{name}lo.velocity = 0.5 0.7 0.9
{name}hi.type = "po"
{name}hi.pressure = 0.
incflo.probtype = {probtype}
"""
    j, t = JConfig.from_text(text), TConfig.from_text(text)
    field = np.random.default_rng(probtype).standard_normal(
        t.grid.cell_shape + (3,))
    for ng in (1, 2, 3):
        a = np.asarray(jbcs.grow(jnp.asarray(field), ng, j.grid,
                                 j.velocity_bcrecs(),
                                 j.velocity_ext_values()))
        b = tbcs.grow(torch.as_tensor(field), ng, t.grid,
                      t.velocity_bcrecs(), t.velocity_ext_values()).numpy()
        assert np.array_equal(a, b), ng
    # the profile reaches the ghost cells of the inflow face
    lo = b.take(0, axis=axis)[..., axis]
    assert float(np.abs(lo).max()) > 0.0
