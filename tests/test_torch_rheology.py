"""Non-Newtonian fluids in incflo_torch against incflo_tpu (ROADMAP
A9c): the viscosity of every model of ops/rheology.py, the velocity
solve built every step from the current viscosity, and whole steps.

Decks (float64, init + 3 steps):
  * bingham: poiseuille_cyl_bingham of bench.py without its cylinder,
    between no-slip walls on x and y, 16 x 16 x 8 cells, 3D MOL, Bingham
    (mu 1, tau_0 1, papa_reg 0.001), delp (0, 0, 2), fixed_dt 0.01.  From
    rest the flow is a channel profile in z, whose pressure is rounding
    noise (|p| ~ 1e-8 against delp = 2): there p, gp and mac_phi are held
    to 1e-10 of delp, every other field to 1e-10 of its own max.  From
    rest plus a smooth velocity perturbation from a seed every field is
    held to 1e-10 of its own max.
  * herschel_bulkley: shear3d with MOL and a Herschel-Bulkley fluid (n
    0.5, tau_0 0.001, papa_reg 0.1), fully periodic.
Each from the port's own init_state and from incflo_tpu's carried state;
every iterative solve of every step (the per-step cell solves of the
velocity, the tensor CG, the V-cycles of the projections) ends on the
same iteration in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.grid import Grid as JGrid
from incflo_tpu.ops import rheology as jrheo

import incflo_torch
from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.grid import Grid as TGrid
from incflo_torch.ops import rheology as trheo

import torch_parity as tp

STEPS = 3
SEED = 11
MODELS = {
    "newtonian": "",
    "powerlaw": "incflo.fluid_model = powerlaw\nincflo.n = 0.5\n",
    "bingham": ("incflo.fluid_model = bingham\nincflo.tau_0 = 1.\n"
                "incflo.papa_reg = 0.001\n"),
    "herschel_bulkley": ("incflo.fluid_model = hb\nincflo.n = 0.5\n"
                         "incflo.tau_0 = 0.001\nincflo.papa_reg = 0.1\n"),
    "smd": ("incflo.fluid_model = smd\nincflo.n = 0.5\nincflo.tau_0 = 0.5\n"
            "incflo.eta_0 = 2.\n"),
}
HB = MODELS["herschel_bulkley"]


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("out_ng", [0, 1])
def test_viscosity_matches(model, out_ng):
    """compute_viscosity of a seeded velocity grown by 3, every model."""
    text = tp.shear3d_deck(8) + MODELS[model]
    j, t = JConfig.from_text(text), TConfig.from_text(text)
    kw = dict(n_cell=(8, 6, 5), prob_lo=(0.0,) * 3, prob_hi=(1.0, 0.7, 0.4),
              periodic=(True,) * 3)
    vel_g = np.random.default_rng(4).standard_normal((14, 12, 11, 3))
    want = np.asarray(jrheo.compute_viscosity(jnp.asarray(vel_g), JGrid(**kw),
                                              3, j, out_ng=out_ng))
    got = trheo.compute_viscosity(torch.as_tensor(vel_g), TGrid(**kw), 3, t,
                                  out_ng=out_ng).numpy()
    assert got.shape == want.shape == tuple(n + 2 * out_ng
                                            for n in (8, 6, 5))
    assert tp.rel(got, want) <= 1e-14
    assert np.isfinite(got).all() and got.min() > 0.0


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("diffusion", ["implicit", "explicit"])
def test_constant_mu_solver_only_for_newtonian(model, diffusion):
    """The prebuilt velocity solver (constant mu) is built only for a
    Newtonian fluid with implicit or Crank-Nicolson diffusion, as in
    incflo_tpu: a non-Newtonian fluid's operator is built every step from
    its viscosity, and explicit diffusion solves nothing."""
    text = tp.shear3d_deck(8) + MODELS[model] + (
        tp.EXPLICIT if diffusion == "explicit" else "")
    from incflo_tpu.simulation import Simulation as JSim
    want = model == "newtonian" and diffusion == "implicit"
    sim = tp.port_sim(text)
    assert (sim._diff_proto is not None) is want
    assert (JSim(JConfig.from_text(text))._diff_proto is not None) is want
    # the projections' prebuilt solvers stay (constant density)
    assert sim._mac_solver is not None and sim._nodal_hat is not None


def _bingham_perturbation():
    grid = TConfig.from_text(tp.bingham_deck(16)).grid
    return tp.smooth_perturbation(grid, SEED)


@pytest.fixture(scope="module")
def bingham():
    text = tp.bingham_deck(16)
    _, runs = tp.reference_run(text, STEPS,
                               (None, _bingham_perturbation()))
    return text, runs


# p, gp and mac_phi of the channel profile from rest are rounding noise:
# held to 1e-10 of the deck's pressure scale delp = 2
REST_FLOORS = {"p": 2.0, "gp": 2.0 / 0.5, "mac_phi": 2.0}


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
@pytest.mark.parametrize("perturbed", [False, True])
def test_bingham_matches(bingham, start, perturbed):
    text, runs = bingham
    states, iters = runs[int(perturbed)]
    sim = tp.port_sim(text)
    assert sim.cfg.fluid_model == incflo_torch.config.FluidModel.Bingham
    assert sim._diff_proto is None
    pert = _bingham_perturbation() if perturbed else None
    s = tp.own_start(sim, pert) if start == "own_init" \
        else tp.carried(states[0])
    s, _, got = tp.compare_run(sim, s, states, iters,
                               floors=None if perturbed else REST_FLOORS)
    # every step iterated the velocity solve (CG) and the tensor CG
    assert all(it["cell_iters"] > 0 and it["tensor_cg_iters"] > 0
               for it in got)
    assert bool(torch.isfinite(s.level.velocity).all())


def test_bingham_from_rest_is_mirror_symmetric(bingham):
    """From rest the Bingham channel flow stays mirror-symmetric about
    both centre planes of the walled cross-section, to 1e-5 of its max
    in both packages.  Not to rounding: the red-black smoothing and the
    CG iterates are not mirror-symmetric, and this stiff operator
    (dt eta / dx^2 up to about 160) carries that into the solution at
    about 1e-6 of the velocity's max."""
    text, runs = bingham
    states, _ = runs[0]
    w = states[-1]["velocity"][..., 2]
    scale = np.abs(w).max()
    assert scale > 1e-3
    assert np.abs(w - w[::-1]).max() <= 1e-5 * scale
    assert np.abs(w - w[:, ::-1]).max() <= 1e-5 * scale
    sim = tp.port_sim(text)
    s = sim.advance_n(sim.init_state(), STEPS)
    wt = s.level.velocity[..., 2]
    assert float((wt - wt.flip(0)).abs().max()) <= 1e-5 * scale
    assert float((wt - wt.flip(1)).abs().max()) <= 1e-5 * scale


@pytest.fixture(scope="module")
def herschel_bulkley():
    text = tp.shear3d_deck(16, extra=tp.MOL + HB)
    _, runs = tp.reference_run(text, STEPS)
    return text, runs[0]


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_herschel_bulkley_matches(herschel_bulkley, start):
    text, (states, iters) = herschel_bulkley
    sim = tp.port_sim(text)
    assert sim._diff_proto is None
    s = sim.init_state() if start == "own_init" else tp.carried(states[0])
    s, _, got = tp.compare_run(sim, s, states, iters)
    assert all(it["tensor_cg_iters"] > 0 for it in got)
