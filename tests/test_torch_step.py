"""The whole shear3d step of incflo_torch against incflo_tpu: the deck of
bench.py at 16x16x8, float64, the initial projection and 5 steps.

Tolerance: 1e-10 relative to each field's max, in velocity, p, gp and
dt.  Both packages run the same algorithm in float64; the differences
are rounding, carried through five projections and the tensor CG
(measured about 1e-14).  The port is run twice: from its own
init_state, and from incflo_tpu's initial state carried across with
state.sim_from_numpy.  The solver symbols the port builds for itself
are held against incflo_tpu's.

shear3d_vd: the same deck with variable density, tracer advection and
mu_s = 0.0002, where both packages rebuild the MAC, Helmholtz and nodal
operators from the density every step and solve them by multigrid
V-cycles (rtol 1e-11).  Init and 3 steps from two starts: init_state
(uniform density), and that state with the density replaced by
1 + 0.4 sin(2 pi x) sin(2 pi y) cos(8 pi z).  All of velocity, density,
tracer, p, gp, mac_phi and dt agree to 1e-10 relative to each field's max
(measured about 3e-14: the iterative solves end on the same iteration in
both packages, so only rounding differs; a solve that ended one
iteration apart would show as about 100 * rtol = 1e-9 and fail here).

rt: the Rayleigh-Taylor deck of bench.py at 8x8x16 (periodic x and y,
slip walls on z, gravity, variable density, one tracer): init and 3 steps
from the port's own init and from incflo_tpu's carried state, every field
to 1e-10 relative to its max.  The velocity starts at rest and stays
under 1e-4, the small difference of the buoyancy and the pressure
gradient (both about 0.1), so its relative error (measured 2e-11) is an
absolute error of 1e-16.  shear3d_nsw: shear3d between no-slip walls on
z with constant density, where the prebuilt cell solvers solve directly
with walls and the prebuilt nodal operator iterates V-cycles.
"""

import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.simulation import Simulation as JSim

import incflo_torch
from incflo_torch import state as tstate

STEPS = 5
FIELDS = ("velocity", "p", "gp")


def _np_state(s):
    out = {f: np.asarray(getattr(s.level, f))
           for f in tstate.LevelState._fields}
    for k in ("t", "dt", "prev_dt", "prev_prev_dt", "step"):
        out[k] = np.asarray(getattr(s, k))
    return out


@pytest.fixture(scope="module")
def deck():
    text, _ = bench._deck("shear3d", 16, "float64")
    return text


@pytest.fixture(scope="module")
def reference(deck):
    sim = JSim(JConfig.from_text(deck))
    s = sim.init_state()
    states = [_np_state(s)]
    for _ in range(STEPS):
        s = sim.advance(s)
        states.append(_np_state(s))
    return sim, states


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _compare(sim, s, ref_states):
    for i, ref in enumerate(ref_states):
        if i > 0:
            s = sim.advance(s)
        got = tstate.sim_to_numpy(s)
        for f in FIELDS + ("dt",):
            assert got[f].shape == ref[f].shape, (i, f)
            assert _rel(got[f], ref[f]) <= 1e-10, (i, f, _rel(got[f],
                                                            ref[f]))
        assert int(got["step"]) == int(ref["step"]) == i
    return s


def test_step_from_own_init_matches(deck, reference):
    _, ref = reference
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    s = _compare(sim, sim.init_state(), ref)
    assert bool(torch.isfinite(s.level.velocity).all())


def test_step_from_carried_state_matches(deck, reference):
    _, ref = reference
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    s0 = tstate.sim_from_numpy(ref[0], "cpu", torch.float64)
    _compare(sim, s0, ref)


def test_prebuilt_symbols_match(deck, reference):
    jsim, _ = reference
    tsim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(deck), device="cpu")
    pairs = [(jsim._mac_solver, tsim._mac_solver),
             (jsim._nodal_hat, tsim._nodal_hat),
             (jsim._diff_proto, tsim._diff_proto)]
    for js, ts in pairs:
        j, t = js.symbol, ts.symbol
        assert j.cells == t.cells and j.batched == t.batched
        assert _rel(t.sym_face.numpy(), np.asarray(j.sym_face)) <= 1e-12
        for a, b in zip(t.fwd + t.inv, j.fwd + j.inv):
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-12


def test_initial_iterations_match(deck):
    """init_state with one pressure iteration (the predictor in
    incremental mode) -- decks that keep the default
    initial_iterations take this path."""
    text = deck + "\nincflo.initial_iterations = 1\n"
    jsim = JSim(JConfig.from_text(text))
    ref = _np_state(jsim.init_state())
    tsim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                   device="cpu")
    got = tstate.sim_to_numpy(tsim.init_state())
    for f in FIELDS + ("mac_phi", "dt"):
        assert _rel(got[f], ref[f]) <= 1e-10, f


def test_evolve_stops_at_max_steps(deck):
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    seen = []
    s = sim.evolve(max_steps=2, callback=lambda st: seen.append(int(st.step)))
    assert seen == [1, 2] and int(s.step) == 2


# ---------------------------------------------------------------------
# shear3d_vd: variable density + tracer through the multigrid V-cycles
# ---------------------------------------------------------------------

VD_STEPS = 3
VD_FIELDS = ("velocity", "density", "tracer", "p", "gp", "mac_phi")
VD_KEYS = """
incflo.constant_density = false
incflo.advect_tracer = true
incflo.mu_s = 0.0002
"""


def _perturbed_density(n_cell, prob_hi):
    c = [(np.arange(n) + 0.5) * (h / n) for n, h in zip(n_cell, prob_hi)]
    x, y, z = np.meshgrid(*c, indexing="ij")
    return 1.0 + 0.4 * (np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)
                        * np.cos(8 * np.pi * z))


@pytest.fixture(scope="module")
def vd_reference(deck):
    """incflo_tpu's states from both starts: {start: [state0..state3]}."""
    import jax.numpy as jnp
    sim = JSim(JConfig.from_text(deck + VD_KEYS))
    s_own = sim.init_state()
    rho = _perturbed_density(sim.grid.n_cell, (1.0, 1.0, 0.25))
    s_pert = s_own._replace(level=s_own.level._replace(
        density=jnp.asarray(rho)))
    out = {}
    for start, s in (("init_state", s_own), ("perturbed_density", s_pert)):
        states = [_np_state(s)]
        for _ in range(VD_STEPS):
            s = sim.advance(s)
            states.append(_np_state(s))
        out[start] = states
    return out


@pytest.mark.parametrize("start", ["init_state", "perturbed_density"])
def test_shear3d_vd_matches(deck, vd_reference, start):
    from incflo_torch.ops import multigrid as tmg
    ref = vd_reference[start]
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(deck + VD_KEYS), device="cpu")
    assert sim._mac_solver is None and sim._nodal_hat is None
    if start == "init_state":
        s = sim.init_state()
    else:
        s = tstate.sim_from_numpy(ref[0], "cpu", torch.float64)
        assert 0.6 <= float(s.level.density.min()) < 0.7
        assert 1.3 < float(s.level.density.max()) <= 1.4
    tmg.reset_counts()
    for i, want in enumerate(ref):
        if i > 0:
            s = sim.advance(s)
        got = tstate.sim_to_numpy(s)
        for f in VD_FIELDS + ("dt",):
            assert got[f].shape == want[f].shape, (i, f)
            assert _rel(got[f], want[f]) <= 1e-10, (i, f, _rel(got[f],
                                                               want[f]))
    # every step iterated: the MAC solve by CG, the nodal one by V-cycles
    assert tmg.COUNTS["cell_solves"] >= VD_STEPS
    assert tmg.COUNTS["nodal_solves"] == VD_STEPS
    assert bool(torch.isfinite(s.level.velocity).all())
    assert float(s.level.density.min()) > 0.5


@pytest.mark.parametrize("with_gp", [True, False])
def test_vel_forces_match(deck, with_gp):
    """compute_vel_forces with variable density and gravity (which sets
    the background pressure gradient gp0 = rho_0 g), with and without the
    lagged pressure gradient."""
    import jax.numpy as jnp
    text = deck + VD_KEYS + "incflo.gravity = 0. 0. -0.3\n"
    jsim = JSim(JConfig.from_text(text))
    tsim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                   device="cpu")
    rng = np.random.default_rng(5)
    cs = jsim.grid.cell_shape
    rho = 0.6 + rng.random(cs)
    tra = rng.random(cs + (1,))
    gp = rng.standard_normal(cs + (3,))
    want = jsim.compute_vel_forces(jnp.asarray(rho), jnp.asarray(tra),
                                   jnp.asarray(tra), jnp.asarray(gp),
                                   include_pressure_gradient=with_gp)
    got = tsim.compute_vel_forces(torch.as_tensor(rho), torch.as_tensor(tra),
                                  torch.as_tensor(tra), torch.as_tensor(gp),
                                  include_pressure_gradient=with_gp)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-14


# ---------------------------------------------------------------------
# walls: the rt deck (slip walls, variable density, gravity) and
# shear3d between no-slip walls (constant density)
# ---------------------------------------------------------------------

WALL_STEPS = 3
NSW_KEYS = """
geometry.is_periodic = 1 1 0
zlo.type = "nsw"
zhi.type = "nsw"
"""


def _wall_deck(name):
    if name == "rt":
        return bench._deck("rt", 16, "float64")[0]         # 8 x 8 x 16
    return bench._deck("shear3d", 16, "float64")[0] + NSW_KEYS


@pytest.fixture(scope="module", params=["rt", "shear3d_nsw"])
def wall_reference(request):
    text = _wall_deck(request.param)
    sim = JSim(JConfig.from_text(text))
    s = sim.init_state()
    states = [_np_state(s)]
    for _ in range(WALL_STEPS if request.param == "rt" else 2):
        s = sim.advance(s)
        states.append(_np_state(s))
    return request.param, text, states


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_walled_deck_matches(wall_reference, start):
    from incflo_torch.ops import multigrid as tmg
    name, text, ref = wall_reference
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                  device="cpu")
    if start == "own_init":
        s = sim.init_state()
    else:
        s = tstate.sim_from_numpy(ref[0], "cpu", torch.float64)
    tmg.reset_counts()
    for i, want in enumerate(ref):
        if i > 0:
            s = sim.advance(s)
        got = tstate.sim_to_numpy(s)
        for f in VD_FIELDS + ("dt",):
            assert got[f].shape == want[f].shape, (i, f)
            assert _rel(got[f], want[f]) <= 1e-10, (i, f, _rel(got[f],
                                                               want[f]))
    steps = len(ref) - 1
    assert tmg.COUNTS["nodal_solves"] == steps
    assert bool(torch.isfinite(s.level.velocity).all())
    # no flow through the walls
    assert float(s.level.velocity[:, :, (0, -1), 2].abs().max()) < 0.1
    if name == "rt":
        assert s.level.p.shape == (8, 8, 17)        # nodes: n+1 on z only
        assert sim._mac_solver is None and sim._diff_proto is None
        # the MAC solve and the Helmholtz solves iterated on walled levels
        assert tmg.COUNTS["cell_solves"] >= steps
        assert 0.49 < float(s.level.density.min()) < 0.51
        assert 1.99 < float(s.level.density.max()) < 2.01
    else:
        # constant density: direct cell solves with walls, no CG
        assert sim._mac_solver.symbol is not None
        assert tmg.COUNTS["cell_solves"] == 0


def test_rt_init_matches_reference_profile():
    """probtype 5 alone: density, tracer and the zero velocity."""
    from incflo_tpu import probs as jprobs
    import jax.numpy as jnp
    text = _wall_deck("rt")
    jcfg = JConfig.from_text(text)
    tcfg = incflo_torch.IncfloConfig.from_text(text)
    want = jprobs.init_fluid(jcfg, jcfg.grid, jnp.float64)
    got = incflo_torch.probs.init_fluid(tcfg, tcfg.grid, torch.float64, "cpu")
    for f in ("density", "tracer"):
        assert _rel(getattr(got, f).numpy(),
                    np.asarray(getattr(want, f))) <= 1e-14
    assert float(np.abs(np.asarray(want.velocity)).max()) == 0.0
    assert float(got.velocity.abs().max()) == 0.0
    assert float(got.density.min()) < 0.51 and float(got.density.max()) > 1.99


def test_unsupported_walled_decks_name_the_roadmap():
    """Walled decks once outside the slice, which raised naming their
    item, build: since A8 and A11 the 2D inflow channel and channel_cyl
    with its cylinder run (tests/test_torch_channel2d.py,
    tests/test_torch_eb_step.py); since A13 the channel's AMR form builds
    its base level, and since A13b channel_cyl's (AMR with embedded
    boundaries) builds its base with its cut cells
    (tests/test_torch_amr_eb.py)."""
    amr = "amr.max_level = 1\n"
    text = bench._deck("tgv2d", 16, "float64")[0] + """
geometry.is_periodic = 0 1
xlo.type = "mi"
xlo.velocity = 1. 0.
xhi.type = "po"
xhi.pressure = 0.
"""
    incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                            device="cpu")
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(text + amr), device="cpu")
    assert sim.cfg.max_level == 1 and sim.grid.n_cell == (16, 16)
    text = bench._deck("channel_cyl", 16, "float64")[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # MOL-EB dispatch
        sim = incflo_torch.Simulation(
            incflo_torch.IncfloConfig.from_text(text + amr), device="cpu")
    assert sim.cfg.max_level == 1 and sim.eb is not None
