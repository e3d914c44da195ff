"""Patch AMR in incflo_torch against incflo_tpu (ROADMAP A13): the
two-level RT2D slab deck of tests/test_amr_patch.py (:15-37; 16 x 32
base, a refined band along y, Godunov, variable density, a tracer) with
incflo.fixed_dt, init + 2 steps in float64.  The port starts from
incflo_tpu's initial tree and states carried across
(state.patch_from_numpy) and from its own init_state; every level's
fields and dt stay within 1e-10 relative of incflo_tpu's and every
step's CG iterations, V-cycles and tensor-CG iterations are equal.  The
patch checkpoint of either package restarts in the other, the port's
restart is bit-equal to its unbroken run, and both packages write the
same patch plotfile.  One jitted incflo_tpu run serves every test.
"""

import json
import os

import numpy as np
import pytest

from incflo_torch import state as tstate
from incflo_torch.ops import godunov_kernels as gk
from incflo_torch.ops import smoother_kernels as sk
from incflo_torch.utils import io as tio

import torch_parity as tp

TEXT = tp.rt2d_amr_deck(extra="incflo.fixed_dt = 0.2\n")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """incflo_tpu's run, with its patch checkpoint after step 1."""
    import jax
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.utils import io as jio
    chk = str(tmp_path_factory.mktemp("amr_rt2d") / "chk_jax")
    tally = dict.fromkeys(tp.KINDS, 0)
    with tp.counted_loops(tally):
        jamr = JAMR(JConfig.from_text(TEXT))
        s = jamr.init_state()
        states, iters = [(tp.tree_meta(jamr), tp.np_levels(s))], []
        for step in range(2):
            jax.effects_barrier()
            before = dict(tally)
            s = jamr.advance(s)
            jax.effects_barrier()
            iters.append({k: tally[k] - before[k] for k in tp.KINDS})
            states.append((tp.tree_meta(jamr), tp.np_levels(s)))
            if step == 0:
                jio.write_checkpoint_patch(chk, s, jamr, jamr.cfg)
    return jamr, s, states, iters, chk


def test_rt2d_slab_from_carried_init(ref):
    _, _, states, iters, _ = ref
    amr = tp.port_amr(TEXT)
    s = tstate.patch_from_numpy(amr, *states[0])
    g0, s0 = dict(gk.LAUNCHES), dict(sk.LAUNCHES)
    _, worst = tp.compare_amr_run(amr, s, states, iters)
    assert worst <= 1e-10
    assert len(amr.sims) == 2 and amr.axis == 1
    assert amr.sims[1].cf_interior == {(1, 0), (1, 1)}
    # the V-cycles ran on both levels, and 2D levels launch no kernel
    assert all(it["cell_iters"] > 0 and it["nodal_cycles"] > 0
               for it in iters)
    assert gk.LAUNCHES == g0 and sk.LAUNCHES == s0


def test_rt2d_slab_from_own_init(ref):
    _, _, states, iters, _ = ref
    amr = tp.port_amr(TEXT)
    _, worst = tp.compare_amr_run(amr, amr.init_state(), states, iters)
    assert worst <= 1e-10


def test_incflo_tpu_patch_checkpoint_restarts_in_port(ref):
    _, _, states, iters, chk = ref
    amr = tp.port_amr(TEXT)
    s = tio.read_checkpoint_patch(chk, amr, amr.cfg)
    _, worst = tp.compare_amr_run(amr, s, states[1:], iters[1:])
    assert worst <= 1e-10


def test_port_patch_checkpoint_restarts_in_incflo_tpu(ref, tmp_path):
    """The port writes its step-1 state; incflo_tpu reads it into its
    driver (same tree: the compiled advance is reused) and steps to the
    state of its own unbroken run."""
    from incflo_tpu.utils import io as jio
    jamr, _, states, _, _ = ref
    amr = tp.port_amr(TEXT)
    s = amr.advance(tstate.patch_from_numpy(amr, *states[0]))
    path = str(tmp_path / "chk_port")
    tio.write_checkpoint_patch(path, s, amr, amr.cfg)
    meta = json.load(open(os.path.join(path, "Patch.json")))
    assert meta == tp.tree_meta(amr) == states[1][0]
    js = jio.read_checkpoint_patch(path, jamr, jamr.cfg)
    assert tp.tree_meta(jamr) == states[1][0]
    tp.assert_levels_close(tp.np_levels(js), states[1][1], 1e-10, "read")
    js = jamr.advance(js)
    tp.assert_levels_close(tp.np_levels(js), states[2][1], 1e-10, "step")


def test_port_patch_restart_is_bit_exact(ref, tmp_path):
    _, _, states, _, _ = ref
    amr = tp.port_amr(TEXT)
    s = amr.advance(tstate.patch_from_numpy(amr, *states[0]))
    tio.write_checkpoint_patch(str(tmp_path / "chk"), s, amr, amr.cfg)
    unbroken = tp.np_levels(amr.advance(s))
    amr2 = tp.port_amr(TEXT)
    s2 = tio.read_checkpoint_patch(str(tmp_path / "chk"), amr2, amr2.cfg)
    restarted = tp.np_levels(amr2.advance(s2))
    for a, b in zip(unbroken, restarted):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_patch_plotfiles_agree(ref, tmp_path):
    """write_plotfile_patch of both packages from the same tree and
    states (incflo_tpu's read from the port's checkpoint): the same
    Header and the same fields, the vorticity included, to 1e-10 (the
    ghost fills of the derived fields read each patch's context)."""
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.utils import io as jio
    _, _, states, _, _ = ref
    text = TEXT + "amr.plt_vort = 1\n"
    amr = tp.port_amr(text)
    s = tstate.patch_from_numpy(amr, *states[-1])
    tio.write_checkpoint_patch(str(tmp_path / "chk"), s, amr, amr.cfg)
    jamr = JAMR(JConfig.from_text(text))
    js = jio.read_checkpoint_patch(str(tmp_path / "chk"), jamr, jamr.cfg)
    tio.write_plotfile_patch(str(tmp_path / "t"), s, amr, amr.cfg)
    jio.write_plotfile_patch(str(tmp_path / "j"), js, jamr, jamr.cfg)
    ht = json.load(open(tmp_path / "t" / "Header"))
    hj = json.load(open(tmp_path / "j" / "Header"))
    assert ht == hj and ht["patch_parents"] == [-1, 0]
    for i in range(len(amr.sims)):
        zt = np.load(tmp_path / "t" / f"Level_{i}.npz")
        zj = np.load(tmp_path / "j" / f"Level_{i}.npz")
        assert sorted(zt.files) == sorted(zj.files) and "vort" in zt.files
        for k in zj.files:
            if zj[k].dtype.kind in "bi":      # refine_mask, patch_lo/hi
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
            else:
                assert tp.rel(zt[k], zj[k]) <= 1e-10, (i, k)
