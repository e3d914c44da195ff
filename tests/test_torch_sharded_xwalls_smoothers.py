"""The slab forms of the smoother kernels with the level's x wall on an
end rank (ops/smoother_kernels.cell_smooth_slab / nodal_smooth_slab), on
4 gloo ranks on the CPU: the first and last ranks hold the level's x
faces, the middle ranks are open on both sides.  Beside them the node
layout of an x that ends in boundaries (the last rank holds node nx),
the ghost fill of a slab, and the cubic channel stepped on 4 ranks.

One spawn of 4 gloo ranks (incflo_torch.parallel.workers.several), in
float64; the cases and decks are those of
tests/test_torch_sharded_xwalls.py (its 2-rank spawn holds the slab
forms on 2 ranks), at 4 slabs: nxl 4 and 2.

Tolerances: the slab forms, the node layout and the ghost fill exact
(the same operations on the same values; copies); the channel 1e-11
relative to each field's max against 1 rank, with equal CG iterations,
V-cycles and tensor-CG iterations in every step on every rank.
"""

import numpy as np
import pytest

from incflo_torch.parallel import launch
from test_torch_sharded_xwalls import (CHANNEL, DECKS, JOB, STEPS, TIMEOUT,
                                       check_ghost_fill, check_run,
                                       check_slab_forms, ghost_inputs,
                                       one_rank, slab_form_cases)

RANKS = 4
NODES = (17, 3, 2)          # a node field of 16 cells along x


@pytest.fixture(scope="module")
def cases():
    return slab_form_cases(RANKS)


@pytest.fixture(scope="module")
def ghosts():
    return {name: ghost_inputs(DECKS[name], 60 + k)
            for k, name in enumerate(("channel", "bingham"))}


@pytest.fixture(scope="module")
def node_field():
    return np.arange(np.prod(NODES), dtype=np.float64).reshape(NODES)


@pytest.fixture(scope="module")
def four_ranks(cases, ghosts, node_field):
    """One spawn of 4 gloo ranks: the slab forms, the node layout, the
    ghost fills and init + STEPS steps of the channel."""
    jobs = [("slab_forms", "slab_smoothers",
             dict(cases=cases["cell"] + cases["nodal"])),
            ("nodes", "node_rows", dict(field=node_field, lo=2, hi=1)),
            ("channel", "steps", dict(deck=CHANNEL, nsteps=STEPS))]
    jobs += [(f"ghost {name}", "ghost_fill", dict(deck=DECKS[name], **kw))
             for name, kw in ghosts.items()]
    return launch.run(JOB, RANKS, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


@pytest.mark.parametrize("kind", ["cell", "nodal"])
def test_slab_forms_on_four_ranks_equal_whole_level_rows(four_ranks, cases,
                                                         kind):
    """Each kind at every level with even 4-rank slabs (nxl 4 and 2):
    rank 0 with the level's low x wall, ranks 1 and 2 open on both
    sides, rank 3 with the high wall (and, for nodes, node nx); bit for
    bit the whole level's rows."""
    assert {c["nxl"] for c in cases[kind]} == {4, 2}
    check_slab_forms(four_ranks, cases, kind)


def test_node_rows_halo_and_gathers(four_ranks, node_field):
    """The owner layout of nx + 1 nodes: rank r holds nodes [4r, 4r + 4)
    and the last rank also node 16; a halo of (2, 1) rows takes none
    across the level's x faces; gather and all_gather_x give the whole
    field back on every rank."""
    for r, res in enumerate(four_ranks):
        got = res["nodes"]
        hi = 4 * r + 4 + (r == RANKS - 1)
        assert np.array_equal(got["slab"], node_field[4 * r:hi]), r
        lo = max(4 * r - 2, 0)
        hi_h = hi if r == RANKS - 1 else hi + 1
        assert np.array_equal(got["halo"], node_field[lo:hi_h]), r
        assert np.array_equal(got["gather"], node_field), r
        assert np.array_equal(got["all_gather"], node_field), r


def test_ghost_fill_on_four_ranks_equals_whole_level(four_ranks, ghosts):
    """bcs.grow on slabs of 4 cells: the level's x fill on ranks 0 and 3,
    neighbours' rows on both sides of ranks 1 and 2."""
    for name, inputs in ghosts.items():
        check_ghost_fill(four_ranks, DECKS[name], inputs, f"ghost {name}")


def test_channel_on_four_ranks_matches_one(four_ranks):
    """The cubic channel on 4 ranks: middle ranks open on both sides;
    its nodal hierarchy, too narrow for the smoothers' halos at slabs of
    4, runs whole on every rank, the x walls kept."""
    states, tallies = one_rank(CHANNEL)
    assert all(r["channel"]["comm"]["all_gather"] > 0 for r in four_ranks)
    check_run(four_ranks, "channel", states, 1e-11, tallies=tallies)
