"""A patch's coarse-fine context and the dense mode in incflo_torch
against incflo_tpu (ROADMAP A13), on seeded inputs, float64:
PatchSim.set_context -- the parent's new- and old-time states
interpolated into the patch's ghost data, the MAC, velocity, tracer and
nodal Dirichlet values of its coarse-fine faces -- and init_from_parent,
on a box in the middle of a 2D periodic domain, a box across its
periodic wrap and a 3D slab between walls, within 1e-13 relative; the
dense mode's refinement masks (equal) and level views.  The decks are
variable-density forms, so that neither package prebuilds solvers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu import amr as jamr_dense
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.state import LevelState as JLevel
from incflo_tpu.state import SimState as JState

import incflo_torch
from incflo_torch import amr as tamr_dense
from incflo_torch import probs
from incflo_torch import state as tstate
from incflo_torch.state import LevelState as TLevel

import torch_parity as tp

RT3D = """
amr.n_cell = 8 8 16
amr.max_level = 1
amr.patch_mode = slab
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 0.5 0.5 1.0
geometry.is_periodic = 1 1 0
zlo.type = "sw"
zhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. 0. -0.1
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.gradrhoerr = 0.1
incflo.do_initial_proj = 0
incflo.initial_iterations = 0
"""

BOX_VD = tp.BOX_DECK + "incflo.constant_density = false\n"


def _close(a, b, tol=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert tp.rel(a, b) <= tol


def _random_level(grid, ntrac, seed):
    rng = np.random.default_rng(seed)
    nd = grid.ndim
    cs, ns = grid.cell_shape, grid.node_shape
    return {"velocity": rng.standard_normal(cs + (nd,)),
            "density": 1.0 + rng.random(cs),
            "tracer": rng.standard_normal(cs + (ntrac,)),
            "gp": rng.standard_normal(cs + (nd,)),
            "p": rng.standard_normal(ns),
            "mac_phi": rng.standard_normal(cs)}


@pytest.mark.parametrize("text,box", [
    (BOX_VD, ((8, 12), (20, 24))),
    (BOX_VD, ((24, 0), (32, 8))),        # across the periodic wrap
    (RT3D, ((0, 0, 4), (8, 8, 12))),          # a slab between the walls
], ids=["box2d", "box2d_wrap", "slab3d"])
def test_patch_context_matches(text, box):
    """The same parent states (new and old time) in both packages: the
    patch's ghost data, solver boundary values and interpolated state."""
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    jamr = JAMR(JConfig.from_text(text))
    amr = tp.port_amr(text)
    jps, tps = jamr._build_patch(0, box), amr._build_patch(0, box)
    assert tps.cf_interior == jps.cf_interior
    assert dataclasses.astuple(tps.grid) == dataclasses.astuple(jps.grid)
    assert tps.face_domain == jps.face_domain
    ntrac = amr.cfg.ntrac
    new = _random_level(amr.sim0.grid, ntrac, 1)
    old = _random_level(amr.sim0.grid, ntrac, 2)
    jps.set_context(JLevel(**{k: jnp.asarray(v) for k, v in new.items()}),
                    JLevel(**{k: jnp.asarray(v) for k, v in old.items()}))
    tps.set_context(TLevel(**{k: torch.as_tensor(v) for k, v in new.items()}),
                    TLevel(**{k: torch.as_tensor(v) for k, v in old.items()}))
    for ev in ("vel_ev", "den_ev", "tra_ev"):
        _close(getattr(tps, ev).full, getattr(jps, ev).full)
    for name in ("_mac_bvals", "_vel_bvals", "_tra_bvals", "_nodal_dvals"):
        got, want = getattr(tps, name), getattr(jps, name)
        assert set(got) == set(want) == set(jps.cf_interior)
        for k in want:
            _close(got[k], want[k])
    # init_from_parent reads the context (state) and the parent's fields
    got = tstate.sim_to_numpy(tps.init_from_parent(tp.carried(
        {**SCALARS, **new})))
    want = tp.np_state(jps.init_from_parent(_jstate(new)))
    for f in tp.FIELDS:
        _close(got[f], want[f])


SCALARS = {"t": 0.25, "dt": 0.01, "prev_dt": 0.01, "prev_prev_dt": 0.0,
           "step": 3}


def _jstate(level):
    sc = {k: jnp.asarray(v) for k, v in SCALARS.items()}
    return JState(level=JLevel(**{k: jnp.asarray(v)
                                  for k, v in level.items()}), **sc)


# ---------------------------------------------------------------------
# dense mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    tp.rt2d_amr_deck(max_level=2).replace("amr.patch_mode = slab", ""),
    RT3D.replace("amr.patch_mode = slab", "incflo.tag_region = true\n"
                 "incflo.tag_region_lo = 0.1 0.0 0.2\n"
                 "incflo.tag_region_hi = 0.2 0.5 0.3\n"),
], ids=["rt2d_three_levels", "rt3d_region"])
def test_dense_masks_and_level_views(text):
    """AMRSimulation's masks from one fine density (the initial one plus
    seeded noise), against incflo_tpu's _tag_impl, and every level view
    of a seeded fine state."""
    jd = jamr_dense.AMRSimulation(JConfig.from_text(text))
    td = tamr_dense.AMRSimulation(incflo_torch.IncfloConfig.from_text(text),
                                  device="cpu")
    grid = td.sim.grid
    lvl = _random_level(grid, td.cfg.ntrac, 3)
    rho = probs.init_fluid(td.fine_cfg, grid, torch.float64, "cpu").density
    lvl["density"] = rho.numpy() + 0.01 * lvl["density"]
    want = jd._tag_impl(jnp.asarray(lvl["density"]))
    got = td._tag_impl(torch.as_tensor(lvl["density"]))
    assert len(got) == len(want) == td.max_level
    for g, w in zip(got, want):
        assert np.asarray(w).any()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ts, js = tp.carried({**SCALARS, **lvl}), _jstate(lvl)
    for lev in range(td.max_level + 1):
        g, w = td.level_view(ts, lev), jd.level_view(js, lev)
        for f in tp.FIELDS:
            _close(getattr(g, f).numpy(), np.asarray(getattr(w, f)))
