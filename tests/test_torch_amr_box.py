"""Box-mode patch AMR in incflo_torch against incflo_tpu (ROADMAP A13):
the probtype-21 deck of tests/test_amr_patch.py (:451-467), a compact
tagged region clustered into one nd box with coarse-fine faces on all
four sides of a fully periodic 32^2 domain; init + 2 steps in float64,
every level's fields and dt within 1e-10 relative and every step's
solver iterations equal, from incflo_tpu's initial tree and from the
port's own.  Then both packages regrid the same post-step state with
the tag region moved (as :486-497): the same new box, parents and axis,
and the rebuilt patch state (interpolated from the parent, the old fine
data copied over the overlap) within 1e-12.
"""

import dataclasses

import pytest

from incflo_torch import state as tstate

import torch_parity as tp

TEXT = tp.BOX_DECK
MOVED = dict(tag_region_lo=(0.55, 0.1), tag_region_hi=(0.85, 0.4))


@pytest.fixture(scope="module")
def ref():
    jamr, js, states, iters = tp.amr_reference_run(TEXT, 2)
    jamr.cfg = dataclasses.replace(jamr.cfg, **MOVED)
    jamr.sim0.cfg = jamr.cfg
    regridded = jamr.regrid(js)
    return states, iters, (tp.tree_meta(jamr), tp.np_levels(regridded))


def test_box_patch_from_carried_init(ref):
    states, iters, _ = ref
    amr = tp.port_amr(TEXT)
    s = tstate.patch_from_numpy(amr, *states[0])
    _, worst = tp.compare_amr_run(amr, s, states, iters)
    assert worst <= 1e-10
    assert len(amr.sims[1].cf_interior) == 4
    assert amr.sims[1].grid.periodic == (False, False)


def test_box_patch_from_own_init(ref):
    states, iters, _ = ref
    amr = tp.port_amr(TEXT)
    _, worst = tp.compare_amr_run(amr, amr.init_state(), states, iters)
    assert worst <= 1e-10


def test_box_regrid_of_a_moved_region(ref):
    states, _, (tree, want) = ref
    amr = tp.port_amr(TEXT)
    s = tstate.patch_from_numpy(amr, *states[-1])
    amr.cfg = dataclasses.replace(amr.cfg, **MOVED)
    amr.sim0.cfg = amr.cfg
    s = amr.regrid(s)
    assert tp.tree_meta(amr) == tree
    assert tree["bounds"][1] != states[-1][0]["bounds"][1]
    assert tp.assert_levels_close(tp.np_levels(s), want, 1e-12) <= 1e-12
