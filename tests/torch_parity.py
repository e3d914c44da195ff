"""Helpers of the incflo_torch parity tests: run a deck in incflo_tpu
and in the port, and hold the port's states and solver iterations to the
reference's.

`reference_run` advances incflo_tpu from its own init_state (or a given
start) and records, per step, the iterations of every iterative solve
that ran: the cell solvers' CG iterations, the nodal V-cycles and the
tensor CG's iterations.  incflo_tpu runs those loops as lax.while_loop
inside jit and keeps their counts to itself, so while the reference is
traced `jax.lax.while_loop` is wrapped: a loop whose condition is one of
those three solvers' reports its final count through
jax.debug.callback.  `compare_run` advances the port from a state and
holds every field and dt to the reference, step by step, and the same
three sums of iterations (multigrid.COUNTS) to the digit.
"""

import contextlib

import numpy as np
import torch

import bench
import torch_threads  # noqa: F401  (caps torch's CPU threads)
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.probs import smooth_perturbation  # noqa: F401 (tp.)
from incflo_torch.ops import multigrid as tmg

FIELDS = ("velocity", "density", "tracer", "p", "gp", "mac_phi")
# the condition functions of incflo_tpu's iterative solves -> the port's
# COUNTS key of the same iterations
LOOPS = {"CellSolver.solve.<locals>.run_pcg.<locals>.cond": "cell_iters",
         "NodalSolver.solve.<locals>.cond": "nodal_cycles",
         "EBNodalSolver.solve.<locals>.cond": "nodal_cycles",
         "_tensor_pcg.<locals>.run.<locals>.cond": "tensor_cg_iters"}
KINDS = tuple(LOOPS.values())


# ---------------------------------------------------------------------
# decks, built inline from bench._deck
# ---------------------------------------------------------------------

_CYLINDER = ("incflo.geometry", "cylinder.")
NSW_XY = """geometry.is_periodic = 0 0 1
xlo.type = "nsw"
xhi.type = "nsw"
ylo.type = "nsw"
yhi.type = "nsw"
"""


def _without(text, prefixes):
    return "\n".join(l for l in text.splitlines()
                     if not l.strip().startswith(prefixes)) + "\n"


def channel_deck(n, dtype="float64", inflow="mi"):
    """channel_cyl without its cylinder: n x n/2 x max(n/8, 8) cells,
    mass inflow (1, 0, 0) with tracer 1 at x-lo (inflow="pi": pressure
    inflow at p = 1), pressure outflow at x-hi, no-slip y walls, periodic
    z, probtype 31, MOL, one advected tracer."""
    text = _without(bench._deck("channel_cyl", n, dtype)[0], _CYLINDER)
    if inflow == "pi":
        text = text.replace('xlo.type = "mi"',
                            'xlo.type = "pi"\nxlo.pressure = 1.0')
    return text


def bingham_deck(n, dtype="float64"):
    """poiseuille_cyl_bingham without its cylinder, between no-slip walls
    on x and y (periodic z): n x n x max(n/4, 8) cells, MOL, Bingham
    (mu 1, tau_0 1, papa_reg 0.001), delp (0, 0, 2), fixed_dt 0.01."""
    text = _without(bench._deck("poiseuille_cyl_bingham", n, dtype)[0],
                    _CYLINDER + ("geometry.is_periodic",))
    return text + NSW_XY


def bubble_deck(n, dtype="float64"):
    """probtype 111, the Boussinesq bubble: n^3 cells in the unit cube,
    periodic x and y, slip walls on z, gravity (0, 0, -1), Godunov, one
    advected tracer, mu = mu_s = 0.001."""
    head = bench._deck("shear3d", n, dtype)[0].split("amr.n_cell")[0]
    return head + f"""
amr.n_cell = {n} {n} {n}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
geometry.is_periodic = 1 1 0
zlo.type = "sw"
zhi.type = "sw"
incflo.probtype = 111
incflo.gravity = 0. 0. -1.
incflo.use_godunov = true
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.001
incflo.mu_s = 0.001
"""


def rt2d_deck(extra=""):
    """The one-level form of tests/test_amr_patch.py's RT2D deck
    (:15-37) with amr.max_level = 0: 16 x 32 cells on 0.5 x 1, periodic
    x, slip y walls, probtype 5, gravity -0.1, variable density, one
    advected tracer, Godunov, one initial iteration."""
    return """
amr.n_cell = 16 32
amr.max_level = 0
geometry.prob_lo = 0. 0.
geometry.prob_hi = 0.5 1.0
geometry.is_periodic = 1 0
ylo.type = "sw"
yhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. -0.1
incflo.use_godunov = true
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.cfl = 0.9
incflo.init_shrink = 1.0
incflo.initial_iterations = 1
""" + extra


def channel2d_deck(dtype="float64"):
    """A 2D mass-inflow channel: the x-y section of channel_cyl without
    its cylinder, 32 x 16 cells on 1.2 x 0.4, mass inflow (1, 0) with
    tracer 1 at x-lo, pressure outflow at x-hi, no-slip y walls,
    probtype 31, MOL, one advected tracer."""
    head = bench._deck("tgv2d", 16, dtype)[0].split("amr.n_cell")[0]
    return head + """
amr.n_cell = 32 16
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1.2 0.4
geometry.is_periodic = 0 0
ylo.type = "nsw"
yhi.type = "nsw"
xlo.type = "mi"
xlo.velocity = 1. 0.
xlo.tracer = 1.
xhi.type = "po"
xhi.pressure = 0.0
incflo.probtype = 31
incflo.ic_u = 1.0
incflo.mu = 0.001
incflo.ntrac = 1
incflo.advect_tracer = true
incflo.mu_s = 0.001
incflo.cfl = 0.45
"""


MOL2D_RT = "incflo.use_godunov = false\nincflo.cfl = 0.5\n"
EXPLICIT = "incflo.diffusion_type = 0\n"
MOL = "incflo.use_godunov = false\nincflo.cfl = 0.5\n"


def shear3d_deck(n, dtype="float64", extra=""):
    """bench's shear3d; with EXPLICIT shear3d_explicit, with MOL
    shear3d_mol."""
    return bench._deck("shear3d", n, dtype)[0] + extra


# ---------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------

def np_state(s):
    out = {f: np.asarray(getattr(s.level, f)) for f in FIELDS}
    for k in ("t", "dt", "prev_dt", "prev_prev_dt", "step"):
        out[k] = np.asarray(getattr(s, k))
    return out


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@contextlib.contextmanager
def counted_loops(tally):
    """While active, the iterative solves that jax traces add their final
    iteration counts to tally[kind] when they run."""
    import jax
    orig = jax.lax.while_loop

    def record(kind):
        def cb(it):
            tally[kind] += int(it)
        return cb

    def while_loop(cond_fun, body_fun, init_val):
        out = orig(cond_fun, body_fun, init_val)
        kind = LOOPS.get(getattr(cond_fun, "__qualname__", ""))
        if kind is not None:
            jax.debug.callback(record(kind), out[-1])
        return out

    jax.lax.while_loop = while_loop
    try:
        yield
    finally:
        jax.lax.while_loop = orig


def reference_run(text, steps, perturbs=(None,)):
    """incflo_tpu's states from init_state and after each of `steps`
    steps, and the per-step iterations of its solves, once per entry of
    `perturbs` (None, or an array added to the initial velocity), all
    through one incflo_tpu Simulation so that it compiles once: that
    Simulation and a list of (states, [{kind: iterations} per step])."""
    import jax
    import jax.numpy as jnp
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.simulation import Simulation as JSim
    tally = dict.fromkeys(KINDS, 0)
    out = []
    with counted_loops(tally):
        sim = JSim(JConfig.from_text(text))
        for perturb in perturbs:
            s = sim.init_state()
            if perturb is not None:
                s = s._replace(level=s.level._replace(
                    velocity=s.level.velocity + jnp.asarray(perturb)))
            states, iters = [np_state(s)], []
            for _ in range(steps):
                jax.effects_barrier()
                before = dict(tally)
                s = sim.advance(s)
                states.append(np_state(s))
                jax.effects_barrier()
                iters.append({k: tally[k] - before[k] for k in KINDS})
            out.append((states, iters))
    return sim, out


def port_sim(text, **kw):
    return incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                   device="cpu", **kw)


def carried(ref_state):
    """The reference's state carried across into the port."""
    return tstate.sim_from_numpy(ref_state, "cpu", torch.float64)


def own_start(sim, perturb=None):
    """The port's own init_state, with `perturb` added to its velocity."""
    s = sim.init_state()
    if perturb is not None:
        s = s._replace(level=s.level._replace(
            velocity=s.level.velocity + torch.as_tensor(perturb)))
    return s


def compare_run(sim, s, states, iters, tol=1e-10, fields=FIELDS,
                floors=None):
    """Advance the port from `s` (the counterpart of states[0]) and hold
    every field and dt to the reference after each step, relative to
    the reference field's max (or to floors[field] where that is
    larger), and each step's solver iterations to the reference's.
    Returns (final state, worst relative error, the port's per-step
    iterations)."""
    floors = floors or {}
    worst = 0.0
    got_iters = []
    for i, want in enumerate(states):
        if i > 0:
            before = dict(tmg.COUNTS)
            s = sim.advance(s)
            got_iters.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        got = tstate.sim_to_numpy(s)
        for f in fields + ("dt",):
            assert got[f].shape == want[f].shape, (i, f)
            e = float(np.abs(got[f] - want[f]).max()
                      / max(np.abs(want[f]).max(), floors.get(f, 0.0),
                            1e-300))
            assert e <= tol, (i, f, e)
            worst = max(worst, e)
        assert int(got["step"]) == int(want["step"]) == i
    assert got_iters == iters, (got_iters, iters)
    return s, worst, got_iters


# ---------------------------------------------------------------------
# embedded boundaries: the bench.py EB decks and both packages' geometry
# ---------------------------------------------------------------------

# a 2D circle: a cylinder along the absent z axis, fluid outside
CIRCLE2D = """
amr.n_cell = 24 16
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1.2 0.8
geometry.is_periodic = 1 1
incflo.geometry = "cylinder"
cylinder.internal_flow = false
cylinder.radius = 0.2
cylinder.direction = 2
cylinder.center = 0.5 0.41 0.
"""


def eb_deck(name, n=16, dtype="float64"):
    """channel_cyl or poiseuille_cyl_bingham as bench._deck builds them,
    or "circle2d"."""
    return CIRCLE2D if name == "circle2d" else bench._deck(name, n, dtype)[0]


def channel_cyl_cubic_deck(n=32):
    """channel_cyl (bench.py's deck at n: n x n/2 x max(n/8, 8) cells)
    in a 0.8 x 0.4 x 0.2 box, whose cells are cubes, where bench.py's
    1.2 x 0.4 x 0.1 box gives cells of aspect 3 on which the nodal
    V-cycles do not converge (ROADMAP C)."""
    text = eb_deck("channel_cyl", n)
    old = "geometry.prob_hi = 1.2 0.4 0.1"
    assert old in text
    return text.replace(old, "geometry.prob_hi = 0.8 0.4 0.2")


@contextlib.contextmanager
def logged_solves():
    """While active, the port's iterated nodal and cell solves, as
    {"nodal": [...], "cell": [...]} lists of (residual / tolerance,
    iterations, maxiter) that fill as the solves run."""
    tmg.NODAL_LOG, tmg.CELL_LOG = [], []
    out = {"nodal": [], "cell": []}
    try:
        yield out
    finally:
        for kind, log in (("nodal", tmg.NODAL_LOG), ("cell", tmg.CELL_LOG)):
            out[kind].extend((float(res) / float(tol), it, maxiter)
                             for res, tol, it, maxiter in log)
        tmg.NODAL_LOG = tmg.CELL_LOG = None


def eb_geometry(text):
    """(incflo_tpu's EBData, the port's, incflo_tpu's grid, the port's)."""
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.eb import geometry as jgeom
    from incflo_torch.eb import geometry as tgeom
    jc = JConfig.from_text(text)
    tc = incflo_torch.IncfloConfig.from_text(text)
    jd = jgeom.compute_eb_data(
        jgeom.make_eb_geometry(jc.eb_geometry, jc.pp, jc.grid), jc.grid)
    td = tgeom.compute_eb_data(
        tgeom.make_eb_geometry(tc.eb_geometry, tc.pp, tc.grid), tc.grid)
    return jd, td, jc.grid, tc.grid


def eb_arrays(text):
    """(incflo_tpu's EBArrays, the port's on the CPU, both grids)."""
    import jax.numpy as jnp
    from incflo_tpu.eb import ops as jops
    from incflo_torch.eb import ops as tops
    jd, td, jg, tg = eb_geometry(text)
    return (jops.build_eb_arrays(jd, jg, jnp.float64),
            tops.build_eb_arrays(td, tg, torch.float64, "cpu"), jg, tg)


def masked_random(shape, fluid, seed, scale=1.0):
    """A seeded field, zero in covered cells."""
    a = scale * np.random.default_rng(seed).standard_normal(shape)
    f = np.asarray(fluid)
    return a * f.reshape(f.shape + (1,) * (len(shape) - f.ndim))


def fluid_perturbation(sim, seed):
    """smooth_perturbation of the port's grid, zero in covered cells."""
    p = smooth_perturbation(sim.grid, seed)
    return p * sim.eb.fluid[..., None].numpy()


def eb_vd_deck(n=16):
    """A variable-density EB deck, whose nodal projection takes the
    octant lattice: poiseuille_cyl_bingham's geometry (fluid inside a
    periodic cylinder, delp (0, 0, 2)) with a Newtonian fluid (mu 0.01),
    incflo.constant_density = false and one advected tracer."""
    text = _without(bench._deck("poiseuille_cyl_bingham", n, "float64")[0],
                    ("incflo.fluid_model", "incflo.tau_0", "incflo.papa_reg",
                     "incflo.mu"))
    return text + """incflo.mu = 0.01
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu_s = 0.01
"""


def probtype6_deck():
    """Probtype 6, the slanted EB channel: a z cylinder (radius 0.3, the
    fluid inside) whose centre the rotation of 30 degrees about z moves
    to (0.5, 0.5), the velocity (cos 30, sin 30, 0) and two tracer bands
    along x from the probtype, 16 x 16 x 8 cells, fully periodic, MOL."""
    head = bench._deck("shear3d", 16, "float64")[0].split("amr.n_cell")[0]
    return head + """
amr.n_cell = 16 16 8
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 0.5
geometry.is_periodic = 1 1 1
incflo.geometry = "cylinder"
cylinder.internal_flow = true
cylinder.radius = 0.3
cylinder.direction = 2
cylinder.center = 0.6830127 0.1830127 0.
cylinder.rotation = 30
cylinder.rotation_axe = 2
incflo.probtype = 6
incflo.ic_u = 1.0
incflo.ntrac = 2
incflo.advect_tracer = true
incflo.mu = 0.01
incflo.mu_s = 0.01
incflo.cfl = 0.45
"""


# ---------------------------------------------------------------------
# patch AMR: both packages' trees and per-level states
# ---------------------------------------------------------------------

def tree_meta(amr):
    """A SlabAMRSimulation's tree (either package), as a patch checkpoint
    records it."""
    return {"axis": int(amr.axis),
            "bounds": [[list(b[0]), list(b[1])] for b in amr.bounds],
            "parents": list(amr.parent), "levels": list(amr.level_of),
            "nlevels": len(amr.sims)}


def np_levels(ps):
    """Per-level numpy states of a PatchState (either package)."""
    if hasattr(ps.levels[0].level.velocity, "detach"):
        return [tstate.sim_to_numpy(s) for s in ps.levels]
    return [np_state(s) for s in ps.levels]


def amr_reference_run(text, steps, before_step=None):
    """incflo_tpu's SlabAMRSimulation from its init_state over `steps`
    steps: (the driver, [(tree, per-level states)] after init and each
    step, [{kind: iterations} per step]).  The solver loops are counted
    while its jitted advance traces (counted_loops)."""
    import jax
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    tally = dict.fromkeys(KINDS, 0)
    with counted_loops(tally):
        amr = JAMR(JConfig.from_text(text))
        s = amr.init_state()
        states, iters = [(tree_meta(amr), np_levels(s))], []
        for _ in range(steps):
            jax.effects_barrier()
            before = dict(tally)
            s = amr.advance(s)
            jax.effects_barrier()
            iters.append({k: tally[k] - before[k] for k in KINDS})
            states.append((tree_meta(amr), np_levels(s)))
    return amr, s, states, iters


def rt2d_amr_deck(max_level=1, extra=""):
    """tests/test_amr_patch.py's RT2D deck (:15-37): rt2d_deck with
    amr.max_level, slab patches and incflo.gradrhoerr = 0.1."""
    return rt2d_deck(extra).replace(
        "amr.max_level = 0",
        f"amr.max_level = {max_level}\namr.patch_mode = slab") \
        + "incflo.gradrhoerr = 0.1\n"


def tgv_amr_deck(n=32):
    """The two-level decaying Taylor vortex of tests/test_amr_patch.py
    (:354-380): n x n on [0, 2]^2, probtype 2, MOL, explicit diffusion,
    a static tagged x-band [0.75, 1.25] refined 2x, fixed dt 0.256 / n."""
    return f"""
amr.n_cell = {n} {n}
amr.max_level = 1
amr.patch_mode = slab
amr.regrid_int = -1
geometry.prob_lo = 0. 0.
geometry.prob_hi = 2. 2.
geometry.is_periodic = 1 1
incflo.probtype = 2
incflo.mu = 0.001
incflo.ro_0 = 1.
incflo.fixed_dt = {0.256 / n}
max_step = {n // 4}
incflo.diffusion_type = 0
incflo.initial_iterations = 3
incflo.tag_region = true
incflo.tag_region_lo = 0.75 0.0
incflo.tag_region_hi = 1.25 2.0
incflo.use_godunov = false
"""


# tests/test_amr_patch.py:451-467: a box patch of probtype 21 with CF
# faces on all four sides
BOX_DECK = """
amr.n_cell = 32 32
amr.max_level = 1
amr.patch_mode = box
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1. 1.
geometry.is_periodic = 1 1
incflo.probtype = 21
incflo.tag_region = true
incflo.tag_region_lo = 0.3 0.4
incflo.tag_region_hi = 0.6 0.7
incflo.fixed_dt = 0.002
"""


def port_amr(text):
    from incflo_torch.amr_patch import SlabAMRSimulation
    return SlabAMRSimulation(incflo_torch.IncfloConfig.from_text(text),
                             device="cpu")


def assert_levels_close(got, want, tol, where=""):
    """Per-level numpy states (np_levels) equal in count and shape, every
    field and dt within tol relative to the reference field's max."""
    assert len(got) == len(want), where
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS + ("dt",):
            assert g[f].shape == w[f].shape, (where, i, f)
            e = float(np.abs(g[f] - w[f]).max()
                      / max(np.abs(w[f]).max(), 1e-300))
            assert e <= tol, (where, i, f, e)
            worst = max(worst, e)
        assert int(g["step"]) == int(w["step"]), (where, i)
    return worst


def compare_amr_run(amr, s, states, iters, tol=1e-10):
    """Advance the port's tree from `s` (the counterpart of states[0]) and
    hold its tree, every level's fields and dt, and each step's solver
    iterations to the reference's.  Returns (final state, worst error)."""
    assert tree_meta(amr) == states[0][0]
    worst = assert_levels_close(np_levels(s), states[0][1], tol, "start")
    got_iters = []
    for i, (tree, want) in enumerate(states[1:], 1):
        before = dict(tmg.COUNTS)
        s = amr.advance(s)
        got_iters.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        assert tree_meta(amr) == tree, (i, tree_meta(amr), tree)
        worst = max(worst, assert_levels_close(np_levels(s), want, tol,
                                               f"step {i}"))
    assert got_iters == iters, (got_iters, iters)
    return s, worst
