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
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.probs import smooth_perturbation  # noqa: F401 (tp.)
from incflo_torch.ops import multigrid as tmg

FIELDS = ("velocity", "density", "tracer", "p", "gp", "mac_phi")
# the condition functions of incflo_tpu's iterative solves -> the port's
# COUNTS key of the same iterations
LOOPS = {"CellSolver.solve.<locals>.run_pcg.<locals>.cond": "cell_iters",
         "NodalSolver.solve.<locals>.cond": "nodal_cycles",
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
