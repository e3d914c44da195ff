"""2D decks on a 4-rank x-slab mesh, on the CPU: the 2D cell and nodal
sweeps and the EB cylinder's slab forms of each rank's slab against the
whole level's rows (the middle ranks open on both x sides), and tgv2d
with Godunov and the EB cylinder of incflo_tpu's tests/test_sharding.py
a 2D channel whose x ends in mass inflow and pressure outflow (the end
ranks hold the level's x faces; torch_parity.channel2d_deck, 32 x 16,
MOL, no-slip y walls, a tracer, from its developed profile plus
torch_parity.smooth_perturbation, as tests/test_torch_channel2d.py
starts it, so that its p, gp and mac_phi are not rounding noise) and the EB cylinder with a Bingham fluid
(tau_0 1, papa_reg 0.001: the 2D non-Newtonian viscosity with the
cut-cell strain rate on the slabs) stepped on 4 ranks.

One spawn of 4 gloo ranks (incflo_torch.parallel.workers.several), in
float64; the decks, inputs and checks are those of
tests/test_torch_sharded_2d.py (its 2-rank spawn holds the same forms on
2 ranks), at 4 slabs: nxl 8 on the 32-cell x axes.

Tolerances: the slab forms exact (the same operations on the same
values); the decks 1e-11 relative to each field's max against 1 rank,
with equal CG iterations, V-cycles and tensor-CG iterations in every
step on every rank.
"""

import pytest

import torch_parity as tp
from incflo_torch.parallel import launch
from test_torch_sharded_2d import DECKS, STEPS, check_sweeps, sweep_cases
from test_torch_sharded_eb import (JOB, TIMEOUT, check_forms,
                                   form_inputs, one_rank, with_calls)
from test_torch_sharded_xwalls import check_run

RANKS = 4
BINGHAM = """incflo.fluid_model = "bingham"
incflo.tau_0 = 1.
incflo.papa_reg = 0.001
"""
DECKS = dict(DECKS, channel2d=tp.channel2d_deck(),
             eb_bingham=DECKS["eb_cylinder"] + BINGHAM)
STEPPED = ("tgv2d_godunov", "eb_cylinder", "channel2d", "eb_bingham")
SEED = 3


def perturbation(name):
    """The channel's start: smooth_perturbation of its grid."""
    if name != "channel2d":
        return None
    return tp.smooth_perturbation(tp.port_sim(DECKS[name]).grid, SEED)


@pytest.fixture(scope="module")
def sweeps():
    return sweep_cases(RANKS)


@pytest.fixture(scope="module")
def forms():
    return with_calls(form_inputs("eb_cylinder", 400, DECKS), RANKS)


@pytest.fixture(scope="module")
def four_ranks(sweeps, forms):
    """One spawn of 4 gloo ranks: the 2D slab sweeps, the EB cylinder's
    slab forms and init + STEPS steps of the STEPPED decks."""
    jobs = [("sweeps", "solver_sweeps", dict(cases=sweeps)),
            ("forms", "eb_forms", dict(deck=DECKS["eb_cylinder"], **forms))]
    jobs += [(name, "steps", dict(deck=DECKS[name], nsteps=STEPS,
                                  perturb=perturbation(name)))
             for name in STEPPED]
    return launch.run(JOB, RANKS, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


def test_2d_slab_sweeps_on_four_slabs_equal_whole_level_rows(four_ranks,
                                                              sweeps):
    """The 2D sweeps of test_torch_sharded_2d on 4 ranks (nxl 8 on the
    fine level): every slab level's rows bit for bit, one halo exchange
    a call."""
    n_slabs = check_sweeps(four_ranks, "sweeps", sweeps)
    assert min(n_slabs) >= 1, n_slabs


def test_2d_eb_forms_on_four_slabs_equal_whole_level_rows(four_ranks,
                                                          forms):
    """The EB cylinder's slab arrays, MOL-EB forms and 9-point sweeps on
    4 ranks."""
    check_forms(four_ranks, "forms", "eb_cylinder", forms, DECKS)


@pytest.mark.parametrize("name", STEPPED)
def test_2d_deck_on_four_ranks_matches_one(four_ranks, name):
    """Init + 2 steps on 4 ranks against 1 rank, equal tallies in every
    step on every rank."""
    states, tallies = one_rank(name, STEPS, perturbation(name), DECKS)
    check_run(four_ranks, name, states, 1e-11, tallies=tallies)
