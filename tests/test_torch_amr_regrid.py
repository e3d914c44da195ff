"""Patch AMR regrids and a three-level tree in incflo_torch against
incflo_tpu (ROADMAP A13), float64.

Both packages regrid the same state -- incflo_tpu's initial tree carried
across into the port -- after the same change of the tag region, as
tests/test_amr_patch.py does it (:181-210, :639-668): a one-cell nudge
that the hysteresis absorbs (the bounds stay), a move that shifts the
slab (the old fine data copied over the overlap, the rest interpolated
from the parent), and a move to another axis (the slab axis re-picked).
The new axis, bounds, parents and levels are equal and every rebuilt
state is within 1e-12.  And the three-level RT2D tree (max_level = 2)
initializes identically: the same tree, every entry's fields within
1e-10.  These decks skip the initial projection, so that incflo_tpu
compiles nothing for them (the three-level deck compiles its init).
"""

import dataclasses

from incflo_torch import state as tstate

import torch_parity as tp

# tests/test_amr_patch.py:639-657 on a 16 x 16 x 32 box, so that the
# padded slab covers part of z
BAND = """
amr.n_cell = 16 16 32
amr.max_level = 1
amr.patch_mode = slab
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
geometry.is_periodic = 1 1 1
incflo.probtype = 21
incflo.tag_region = true
incflo.tag_region_lo = 0.0 0.0 0.45
incflo.tag_region_hi = 1.0 1.0 0.55
incflo.fixed_dt = 0.005
incflo.initial_iterations = 0
incflo.do_initial_proj = 0
"""


def _regrid_both(text, **change):
    """(port tree, incflo_tpu tree, both states after the regrid, the
    tree before) with the tag region changed in both drivers."""
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    jamr = JAMR(JConfig.from_text(text))
    js = jamr.init_state()
    before = tp.tree_meta(jamr)
    amr = tp.port_amr(text)
    s = tstate.patch_from_numpy(amr, before, tp.np_levels(js))
    for a in (jamr, amr):
        a.cfg = dataclasses.replace(a.cfg, **change)
        a.sim0.cfg = a.cfg
    js, s = jamr.regrid(js), amr.regrid(s)
    assert tp.tree_meta(amr) == tp.tree_meta(jamr)
    assert tp.assert_levels_close(tp.np_levels(s), tp.np_levels(js),
                                  1e-12) <= 1e-12
    return tp.tree_meta(amr), before


def test_regrid_hysteresis_keeps_bounds():
    tree, before = _regrid_both(
        BAND, tag_region_lo=(0.0, 0.0, 0.45 + 1.0 / 32),
        tag_region_hi=(1.0, 1.0, 0.55 + 1.0 / 32))
    assert tree == before
    assert tree["bounds"][1] == [[0, 0, 8], [16, 16, 24]]


def test_regrid_moves_the_slab_and_keeps_the_overlap():
    tree, before = _regrid_both(BAND, tag_region_lo=(0.0, 0.0, 0.55),
                                tag_region_hi=(1.0, 1.0, 0.65))
    assert tree["bounds"][1] == [[0, 0, 12], [16, 16, 28]]
    assert tree["axis"] == before["axis"] == 2


def test_regrid_repicks_the_slab_axis():
    tree, before = _regrid_both(BAND, tag_region_lo=(0.4, 0.0, 0.0),
                                tag_region_hi=(0.6, 1.0, 1.0))
    assert before["axis"] == 2 and tree["axis"] == 0


def test_three_level_rt2d_tree_initializes_identically():
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    text = tp.rt2d_amr_deck(max_level=2)
    jamr = JAMR(JConfig.from_text(text))
    want = tp.np_levels(jamr.init_state())
    amr = tp.port_amr(text)
    got = tp.np_levels(amr.init_state())
    assert tp.tree_meta(amr) == tp.tree_meta(jamr)
    assert max(amr.level_of) == 2
    for i in range(1, len(amr.sims)):
        assert amr.sims[i]._parent is amr.sims[amr.parent[i]]
    assert tp.assert_levels_close(got, want, 1e-10) <= 1e-10
