"""Patch AMR in 3D in incflo_torch against incflo_tpu (ROADMAP A13):
bench.py's rt deck at n = 32 (16 x 16 x 32, slip z walls, variable
density, a tracer, Godunov, cfl 0.9) with one refined level
(`incflo.gradrhoerr = 0.1`, a regrid every 2 steps), init + 2 steps in
float64: a 32 x 32 x 32 patch between coarse-fine faces on both z sides,
whose levels the walled smoothers sweep (plain versions on the CPU) with
Dirichlet values at those faces.  From incflo_tpu's initial tree carried
across, every level's fields and dt within 1e-10 relative, the trees
equal after each step and the regrid, every step's solver iterations
equal.
"""

import pytest

import bench
from incflo_torch import state as tstate

import torch_parity as tp

TEXT = bench._deck("rt", 32, "float64")[0] + (
    "amr.max_level = 1\nincflo.gradrhoerr = 0.1\namr.regrid_int = 2\n")


@pytest.fixture(scope="module")
def ref():
    _, _, states, iters = tp.amr_reference_run(TEXT, 2)
    return states, iters


def test_rt3d_slab_from_carried_init(ref):
    states, iters = ref
    amr = tp.port_amr(TEXT)
    s = tstate.patch_from_numpy(amr, *states[0])
    _, worst = tp.compare_amr_run(amr, s, states, iters)
    assert worst <= 1e-10
    assert amr.tree_meta()["bounds"][1] == [[0, 0, 8], [16, 16, 24]]
    assert amr.sims[1].cf_interior == {(2, 0), (2, 1)}
