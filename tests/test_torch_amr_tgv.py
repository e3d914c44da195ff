"""Patch AMR in incflo_torch against incflo_tpu (ROADMAP A13): the
two-level decaying Taylor vortex of tests/test_amr_patch.py (:354-380)
at n = 32: a static tagged x-band refined 2x on a fully periodic 2D
domain, MOL, explicit diffusion, three initial iterations, fixed dt;
init + 2 steps in float64.  The patch covers the periodic y axis whole
and ends in coarse-fine faces along x.  From incflo_tpu's initial tree
carried across and from the port's own init_state, every level's fields
and dt are within 1e-10 relative of incflo_tpu's and every step's solver
iterations equal.
"""

import pytest

from incflo_torch import state as tstate

import torch_parity as tp

TEXT = tp.tgv_amr_deck(32)


@pytest.fixture(scope="module")
def ref():
    _, _, states, iters = tp.amr_reference_run(TEXT, 2)
    return states, iters


def test_tgv_slab_from_carried_init(ref):
    states, iters = ref
    amr = tp.port_amr(TEXT)
    s = tstate.patch_from_numpy(amr, *states[0])
    _, worst = tp.compare_amr_run(amr, s, states, iters)
    assert worst <= 1e-10
    ps = amr.sims[1]
    assert amr.axis == 0 and ps.cf_interior == {(0, 0), (0, 1)}
    assert ps.grid.periodic == (False, True) and not ps.cfg.use_godunov


def test_tgv_slab_from_own_init(ref):
    states, iters = ref
    amr = tp.port_amr(TEXT)
    _, worst = tp.compare_amr_run(amr, amr.init_state(), states, iters)
    assert worst <= 1e-10
