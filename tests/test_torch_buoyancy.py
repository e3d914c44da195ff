"""Boussinesq buoyancy in incflo_torch against incflo_tpu (ROADMAP A9c):
the forcing g * (tra_o + tra_n)[..., 0] / 2 - gp / rho with no
background pressure gradient, switched on by probtypes 11 and 111-113.

Decks (float64, init + 3 steps, from the port's own init_state and from
incflo_tpu's carried state; every field and dt to 1e-10 relative to its
max, every iterative solve ending on the same iteration):
  * bubble: probtype 111 in the unit cube at 16^3, periodic x and y,
    slip walls on z, gravity (0, 0, -1), Godunov (the walled forms), an
    advected tracer, mu = mu_s = 0.001;
  * bubble2d: bench.py's tgv2d at 16^2 with probtype 111 and gravity
    (0, -1): 2D periodic MOL with a buoyancy that the tracer, not
    advected, holds fixed -- a deck the port now accepts, on the card
    through the plain step (the fused kernel computes no buoyancy).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from incflo_tpu.config import IncfloConfig as JConfig

from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.ops import step2d_kernels as s2

import torch_parity as tp

STEPS = 3
BUBBLE2D = "incflo.probtype = 111\nincflo.gravity = 0. -1.\n"
DECKS = {
    "bubble": lambda: tp.bubble_deck(16),
    "bubble2d": lambda: bench._deck("tgv2d", 16, "float64")[0] + BUBBLE2D,
}


@pytest.fixture(scope="module", params=list(DECKS))
def deck(request):
    text = DECKS[request.param]()
    jsim, runs = tp.reference_run(text, STEPS)
    return request.param, text, jsim, runs[0]


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_boussinesq_deck_matches(deck, start):
    name, text, _, (states, iters) = deck
    sim = tp.port_sim(text)
    assert sim.cfg.use_boussinesq and sim.cfg.gp0 == (0.0,) * sim.grid.ndim
    s = sim.init_state() if start == "own_init" else tp.carried(states[0])
    s, _, got = tp.compare_run(sim, s, states, iters)
    # the bubble (tracer 0 inside, 0.01 outside) is lighter: it moves
    # up, against gravity, relative to the fluid around it
    up = sim.grid.ndim - 1
    inside = torch.as_tensor(states[0]["tracer"][..., 0] < 0.005)
    w = s.level.velocity[..., up]
    assert bool(inside.any())
    assert float(w[inside].mean()) > float(w[~inside].mean())
    if name == "bubble":
        assert all(it["nodal_cycles"] > 0 for it in got)   # walled nodal
    else:
        assert s2.out_of_scope(sim) == "Boussinesq buoyancy"


@pytest.mark.parametrize("with_gp", [True, False])
def test_boussinesq_forces_match(deck, with_gp):
    """compute_vel_forces of seeded fields, with and without the lagged
    pressure gradient."""
    name, text, jsim, _ = deck
    sim = tp.port_sim(text)
    rng = np.random.default_rng(5)
    cs = sim.grid.cell_shape
    nd = sim.grid.ndim
    rho = 0.6 + rng.random(cs)
    tra_o, tra_n = rng.random(cs + (1,)), rng.random(cs + (1,))
    gp = rng.standard_normal(cs + (nd,))
    want = jsim.compute_vel_forces(jnp.asarray(rho), jnp.asarray(tra_o),
                                   jnp.asarray(tra_n), jnp.asarray(gp),
                                   include_pressure_gradient=with_gp)
    got = sim.compute_vel_forces(torch.as_tensor(rho),
                                 torch.as_tensor(tra_o),
                                 torch.as_tensor(tra_n), torch.as_tensor(gp),
                                 include_pressure_gradient=with_gp)
    assert tp.rel(got.numpy(), np.asarray(want)) <= 1e-15
    g = np.asarray(sim.cfg.gravity[:nd])
    plain = g * (0.5 * (tra_o + tra_n)) - (gp / rho[..., None] if with_gp
                                           else 0.0)
    assert tp.rel(got.numpy(), plain) <= 1e-15


@pytest.mark.parametrize("probtype,on", [(11, True), (111, True),
                                         (112, True), (113, True),
                                         (21, False)])
def test_probtypes_switch_boussinesq_on(probtype, on):
    """IncfloConfig switches Boussinesq buoyancy on for probtypes 11 and
    111-113, with a zero gp0 despite gravity, as incflo_tpu's does."""
    text = tp.bubble_deck(8).replace("incflo.probtype = 111",
                                     f"incflo.probtype = {probtype}")
    j, t = JConfig.from_text(text), TConfig.from_text(text)
    assert t.use_boussinesq is j.use_boussinesq is on
    assert t.gp0 == j.gp0
    assert (t.gp0[2] == 0.0) is on
