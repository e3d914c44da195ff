"""A variable-density EB deck in incflo_torch against incflo_tpu (ROADMAP
A11): poiseuille_cyl_bingham's geometry at 16 x 16 x 8 with a Newtonian
fluid, incflo.constant_density = false and an advected tracer, whose
nodal projection is the regular NodalSolver on the 2x octant lattice
(sigma times the octant fluid fractions; the walled `nodal_smooth`
kernel's plain version on the CPU), from the deck's init plus a smooth
velocity perturbation from a seed.  Init + 3 steps in float64: every
field and dt within 1e-10 of incflo_tpu's, every iterative solve ending
on the same iteration.
"""

import pytest

import torch_parity as tp

SEED = 5


@pytest.fixture(scope="module")
def eb_vd():
    text = tp.eb_vd_deck()
    sim = tp.port_sim(text)
    pert = tp.fluid_perturbation(sim, SEED)
    _, runs = tp.reference_run(text, 3, (pert,))
    return text, pert, runs[0]


def test_variable_density_eb_matches_incflo_tpu(eb_vd):
    text, pert, (states, iters) = eb_vd
    sim = tp.port_sim(text)
    assert sim.eb is not None and sim._nodal_eb_hat is None
    assert not sim.cfg.constant_density
    _, worst, got = tp.compare_run(sim, tp.own_start(sim, pert), states,
                                   iters)
    assert worst <= 1e-10
    assert all(it["nodal_cycles"] > 0 for it in got)
