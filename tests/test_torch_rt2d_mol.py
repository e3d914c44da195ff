"""The 2D Rayleigh-Taylor deck with MOL advection (use_godunov = false,
cfl 0.5) in incflo_torch against incflo_tpu (ROADMAP A8): the 2D walled
MOL predictor and corrector with the 2D multigrid solves.  The deck of
tests/test_torch_rt2d.py otherwise; its hydrostatic start makes mac_phi
rounding noise, so both packages start from the deck's init plus a
smooth velocity perturbation from a seed.  Init + 3 steps in float64:
every field and dt within 1e-10 of incflo_tpu's, every iterative solve
ending on the same iteration.
"""

import pytest

import torch_parity as tp

SEED = 3


@pytest.fixture(scope="module")
def rt2d_mol():
    text = tp.rt2d_deck(tp.MOL2D_RT)
    grid = tp.port_sim(text).grid
    pert = tp.smooth_perturbation(grid, SEED)
    _, runs = tp.reference_run(text, 3, (pert,))
    return text, pert, runs[0]


def test_rt2d_mol_matches_incflo_tpu(rt2d_mol):
    text, pert, (states, iters) = rt2d_mol
    sim = tp.port_sim(text)
    assert sim.grid.ndim == 2 and not sim.cfg.use_godunov
    _, worst, got = tp.compare_run(sim, tp.own_start(sim, pert), states,
                                   iters)
    assert worst <= 1e-10
    assert all(it["nodal_cycles"] > 0 for it in got)
