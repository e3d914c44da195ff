"""3D MOL advection in incflo_torch against incflo_tpu (the 3D part of
ROADMAP A8): ops/mol.py's face prediction and upwind fluxes, the MAC
projection of their face velocities and the MOL corrector, on 3D grids.

Decks (float64, init + 3 steps, from the port's own init_state and from
incflo_tpu's carried state; velocity, density, tracer, p, gp, mac_phi
and dt to 1e-10 relative to each field's max, every iterative solve
ending on the same iteration):
  * shear3d_mol: bench.py's shear3d at 16 x 16 x 8 with use_godunov =
    false and cfl = 0.5: fully periodic, constant density, the direct
    solves and the tensor CG;
  * rt_mol: bench.py's rt at 8 x 8 x 16 with use_godunov = false and
    cfl = 0.5: slip walls on z, gravity, variable density and an
    advected tracer with Crank-Nicolson diffusion, every solve by
    multigrid on walled levels; from rest plus a smooth velocity
    perturbation from a seed.  From rest the flow is the small
    difference of buoyancy and pressure gradient (|u| ~ 1e-5, mac_phi ~
    4e-8), whose relative differences (measured 1.05e-10 in mac_phi) are
    rounding of near-zero fields, an absolute 4e-18; perturbed, every
    field agrees to about 4e-14.
The walled (Bingham) and inflow/outflow (channel) MOL decks are in
tests/test_torch_rheology.py and tests/test_torch_inflow.py.  The face
velocities and fluxes of ops/mol.py are also held alone on a walled grid
with inflow, against incflo_tpu's, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import mol as jmol

from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.ops import mol as tmol

import torch_parity as tp

STEPS = 3
SEED = 17
DECKS = {
    "shear3d_mol": lambda: tp.shear3d_deck(16, extra=tp.MOL),
    "rt_mol": lambda: bench._deck("rt", 16, "float64")[0] + tp.MOL,
}


def _perturb(name, grid):
    return tp.smooth_perturbation(grid, SEED) if name == "rt_mol" else None


@pytest.fixture(scope="module", params=list(DECKS))
def deck(request):
    name = request.param
    text = DECKS[name]()
    grid = TConfig.from_text(text).grid
    _, runs = tp.reference_run(text, STEPS, (_perturb(name, grid),))
    return name, text, runs[0]


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_mol3d_deck_matches(deck, start):
    name, text, (states, iters) = deck
    sim = tp.port_sim(text)
    assert sim.grid.ndim == 3 and not sim.cfg.use_godunov
    s = tp.own_start(sim, _perturb(name, sim.grid)) if start == "own_init" \
        else tp.carried(states[0])
    s, _, got = tp.compare_run(sim, s, states, iters)
    if name == "rt_mol":
        # the MAC, tracer and velocity solves and the nodal projection
        # iterate on walled levels, predictor and corrector
        assert all(it["cell_iters"] > 0 and it["nodal_cycles"] > 0
                   for it in got)
        assert 0.45 < float(s.level.density.min()) < 0.55
    else:
        assert all(it["tensor_cg_iters"] > 0 for it in got)


@pytest.mark.parametrize("case", ["channel", "bingham", "rt"])
def test_mol_faces_and_fluxes_bit_equal(case):
    """predict_vels_on_faces and compute_convective_fluxes of a seeded
    grown velocity and tracer with each deck's BC tables (ext_dir inflow
    faces, foextrap outflow, walls): bit-equal to incflo_tpu's."""
    text = {"channel": tp.channel_deck(16), "bingham": tp.bingham_deck(16),
            "rt": bench._deck("rt", 16, "float64")[0]}[case]
    j, t = JConfig.from_text(text), TConfig.from_text(text)
    ng = 2
    rng = np.random.default_rng(21)
    vel_g = rng.standard_normal(tuple(n + 2 * ng for n in t.grid.n_cell)
                                + (3,))
    tra_g = rng.standard_normal(vel_g.shape[:3] + (1,))
    jv = jmol.predict_vels_on_faces(jnp.asarray(vel_g), j.grid, ng,
                                    j.velocity_bcrecs())
    tv = tmol.predict_vels_on_faces(torch.as_tensor(vel_g), t.grid, ng,
                                    t.velocity_bcrecs())
    for a, b in zip(tv, jv):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for q, rec in ((vel_g, "velocity_bcrecs"), (tra_g, "tracer_bcrecs")):
        jf = jmol.compute_convective_fluxes(jnp.asarray(q), jv, j.grid, ng,
                                            getattr(j, rec)())
        tf = tmol.compute_convective_fluxes(torch.as_tensor(q), tv, t.grid,
                                            ng, getattr(t, rec)())
        for a, b in zip(tf, jf):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(
            tmol.convective_rate(tf, t.grid).numpy(),
            np.asarray(jmol.convective_rate(jf, j.grid)))
