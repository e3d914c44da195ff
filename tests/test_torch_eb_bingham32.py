"""poiseuille_cyl_bingham with its cylinder at 32 x 32 x 8 in
incflo_torch against incflo_tpu (ROADMAP A11): bench.py's deck at n =
32, init + 3 steps in float64 from the deck's init plus a smooth
velocity perturbation (zero in covered cells) from a seed.  At this size
every nodal projection converges, where at 16 x 16 x 8
(tests/test_torch_eb_bingham.py) the 27-point EB V-cycles diverge
(ROADMAP C); the cut-cell velocity solves, smoothed by the `cell_smooth`
kernel's form with the EB wall term in its diagonal (the plain version
here), stop on stagnation after the first step in both packages alike.
Every field and dt within 1e-10 of incflo_tpu's, every iterative solve
ending on the same iteration, every nodal solve within its tolerance.
"""

import pytest

import torch_parity as tp

SEED = 7
STEPS = 3


@pytest.fixture(scope="module")
def bingham_cyl32():
    text = tp.eb_deck("poiseuille_cyl_bingham", 32)
    sim = tp.port_sim(text)
    pert = tp.fluid_perturbation(sim, SEED)
    _, runs = tp.reference_run(text, STEPS, (pert,))
    return text, pert, runs[0]


def test_poiseuille_cyl_bingham_32_matches_incflo_tpu(bingham_cyl32):
    text, pert, (states, iters) = bingham_cyl32
    sim = tp.port_sim(text)
    assert sim.grid.n_cell == (32, 32, 8) and sim.eb is not None
    s = tp.own_start(sim, pert)
    with tp.logged_solves() as log:
        _, worst, got = tp.compare_run(sim, s, states, iters)
    assert worst <= 1e-10
    assert all(it["cell_iters"] > 0 and it["tensor_cg_iters"] > 0
               for it in got)
    # two projections a step (predictor, corrector), each converged
    assert len(log["nodal"]) == 2 * STEPS
    assert all(r <= 1.0 and it < m for r, it, m in log["nodal"]), log
