"""poiseuille_cyl_bingham with its cylinder in incflo_torch against
incflo_tpu (ROADMAP A11): bench.py's deck at n = 16 (16 x 16 x 8 cells,
fully periodic, the fluid inside the cylinder, Bingham mu 1, tau_0 1,
papa_reg 0.001, delp (0, 0, 2), fixed_dt 0.01), init + 1 step in
float64, from the deck's init plus a smooth velocity perturbation (zero
in covered cells) from a seed.  At this size the 27-point EB nodal
V-cycles diverge in both packages (ROADMAP C): each projection stops
after one V-cycle that raised its residual, so the fields of later
steps carry mostly that growth, and the converged form of this deck is
tests/test_torch_eb_bingham32.py (32 x 32 x 8, 3 steps).  Here the
per-step variable-viscosity velocity solve with the EB wall term stops
its CG on stagnation: the step's every iterative solve ends on the same
iteration as incflo_tpu's, and every field and dt is within 1e-10 of
its.
"""

import pytest

import torch_parity as tp

SEED = 7


@pytest.fixture(scope="module")
def bingham_cyl():
    text = tp.eb_deck("poiseuille_cyl_bingham", 16)
    sim = tp.port_sim(text)
    pert = tp.fluid_perturbation(sim, SEED)
    _, runs = tp.reference_run(text, 1, (pert,))
    return text, pert, runs[0]


def test_poiseuille_cyl_bingham_matches_incflo_tpu(bingham_cyl):
    text, pert, (states, iters) = bingham_cyl
    sim = tp.port_sim(text)
    assert sim.eb is not None and sim._nodal_eb_hat is not None
    _, worst, got = tp.compare_run(sim, tp.own_start(sim, pert), states,
                                   iters)
    assert worst <= 1e-10
    assert all(it["cell_iters"] > 0 and it["tensor_cg_iters"] > 0
               for it in got)
