"""Embedded boundaries on a 4-rank x-slab mesh, on the CPU: the cut-cell
arrays and operators of each rank's slab against the whole level's rows
(the middle ranks open on both x sides), cell_smooth_slab with the EB
wall term and an x wrap plane, and channel_cyl on cubic cells stepped on
4 ranks, its cylinder (x cells 4-8) across the face of ranks 0 and 1.

One spawn of 4 gloo ranks (incflo_torch.parallel.workers.several), in
float64; the decks, inputs and checks are those of
tests/test_torch_sharded_eb.py (its 2-rank spawn holds the same forms on
2 ranks), at 4 slabs: nxl 8 on the decks' fine level.

Tolerances: the slab forms exact (the same operations on the same
values); the channel 1e-11 relative to each field's max against 1 rank,
with equal CG iterations, V-cycles and tensor-CG iterations in every
step on every rank.
"""

import pytest

from incflo_torch.parallel import launch
from test_torch_sharded_eb import (DECKS, JOB, TIMEOUT, check_forms,
                                   check_wrap, form_inputs, one_rank,
                                   with_calls, wrap_cases)
from test_torch_sharded_xwalls import check_run

RANKS = 4
STEPS = 2


@pytest.fixture(scope="module")
def forms():
    return {name: with_calls(form_inputs(name, 200 + 10 * k), RANKS)
            for k, name in enumerate(("bingham", "channel"))}


@pytest.fixture(scope="module")
def wraps():
    return wrap_cases(RANKS)


@pytest.fixture(scope="module")
def four_ranks(forms, wraps):
    """One spawn of 4 gloo ranks: the slab forms of both decks, the x
    wrap cases and init + STEPS steps of the channel."""
    jobs = [(f"forms {name}", "eb_forms", dict(deck=DECKS[name], **kw))
            for name, kw in forms.items()]
    jobs += [("wrap", "slab_smoothers", dict(cases=wraps)),
             ("channel", "steps", dict(deck=DECKS["channel"],
                                       nsteps=STEPS))]
    return launch.run(JOB, RANKS, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


@pytest.mark.parametrize("name", ["bingham", "channel"])
def test_eb_arrays_and_operators_on_four_slabs_equal_whole_level_rows(
        four_ranks, forms, name):
    """The slab forms of test_torch_sharded_eb on 4 ranks (nxl 8; the 27-
    point nodal hierarchy's first level on the slabs, the rest whole on
    every rank)."""
    check_forms(four_ranks, f"forms {name}", name, forms[name])


def test_cell_smooth_slab_takes_the_x_wrap_plane_on_four_ranks(four_ranks,
                                                               wraps):
    """The x wrap plane on rank 0 (plane lo) and on rank 3 (its halo copy
    of the level's cell 0, plane lo + nxl), none on the middle ranks: the
    rows equal the whole level's; without the plane they do not."""
    assert {c["nxl"] for c in wraps} == {8, 4, 2}
    check_wrap(four_ranks, "wrap", wraps)


def test_eb_channel_on_four_ranks_matches_one(four_ranks):
    """channel_cyl on cubic cells, init + 2 steps on 4 ranks against 1
    rank, equal tallies in every step on every rank."""
    states, tallies = one_rank("channel", STEPS)
    assert sum(t["nodal_cycles"] for t in tallies) > 0
    check_run(four_ranks, "channel", states, 1e-11, tallies=tallies)
