"""AMR with embedded boundaries in incflo_torch against incflo_tpu
(ROADMAP A13b), on one device: both drivers, on the CPU, in float64.

The patch tree: incflo_tpu's own EB deck of tests/test_amr_patch.py
(:502-538; 32 x 16 x 8, periodic, probtype 21 around a cylinder along z,
a box patch from the forced cut-cell tags: x in [4, 16) over the whole
of y and z, with cut cells of its own), init + 2 steps.  The base takes
the exact octant nodal projection (its prebuilt 27-point stencils), the
patch, whose coarse-fine faces take Dirichlet values, the vfrac-weighted
weak form (incflo_tpu/simulation.py:518-527).  One jitted incflo_tpu
run serves every test (about 160 s on an 8-core CPU), and so does one
unbroken run of the port (about 13 s).  The dense fine level: tgv2d at
16^2 around a cylinder, refined once (32^2 fine cells), init + 1 step
with a regrid after it (incflo_tpu about 45 s).

Tolerances:
  steps       every level's fields and dt within 1e-10 relative of
              incflo_tpu's (the bound of tests/test_torch_step.py), equal
              trees, equal CG iterations, V-cycles and tensor-CG
              iterations in every step
  geometry    the patch's cut-cell arrays within 1e-12 of incflo_tpu's
              (the C++ box integrator in both packages)
  tags        the cut-cell tags and the dense driver's masks equal
  restarts    the port's restart bit-equal to its unbroken run; either
              package's checkpoint read by the other, then stepped, within
              1e-10 of the unbroken run
"""

import json
import os
import warnings

import numpy as np
import pytest

import bench
import torch_parity as tp
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.amr import AMRSimulation
from incflo_torch.simulation import Simulation
from incflo_torch.utils import io as tio

# tests/test_amr_patch.py:508-524
BOX = """
amr.n_cell = 32 16 8
amr.max_level = 1
amr.patch_mode = box
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 2. 1. 0.5
geometry.is_periodic = 1 1 1
incflo.probtype = 21
incflo.geometry = "cylinder"
cylinder.internal_flow = false
cylinder.radius = 0.1
cylinder.direction = 2
cylinder.center = 0.6 0.5 0.
incflo.fixed_dt = 0.002
"""
STEPS = 2
CYLINDER_2D = ('incflo.geometry = "cylinder"\n'
               "cylinder.internal_flow = false\n"
               "cylinder.radius = 0.2\n"
               "cylinder.direction = 2\n"
               "cylinder.center = 0.5 0.5 0.\n")
DENSE = (bench._deck("tgv2d", 16, "float64")[0] + CYLINDER_2D
         + "amr.max_level = 1\namr.regrid_int = 1\n")


def _quiet(fn, *args, **kw):
    """fn(*args, **kw) without the MOL-EB dispatch warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """incflo_tpu's box tree over STEPS steps, with its patch checkpoint
    after step 1: (driver, [(tree, per-level states)], [iterations per
    step], checkpoint path)."""
    import jax
    from incflo_tpu.amr_patch import SlabAMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.utils import io as jio
    chk = str(tmp_path_factory.mktemp("amr_eb") / "chk_jax")
    tally = dict.fromkeys(tp.KINDS, 0)
    with tp.counted_loops(tally), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jamr = JAMR(JConfig.from_text(BOX))
        s = jamr.init_state()
        states, iters = [(tp.tree_meta(jamr), tp.np_levels(s))], []
        for step in range(STEPS):
            jax.effects_barrier()
            before = dict(tally)
            s = jamr.advance(s)
            jax.effects_barrier()
            iters.append({k: tally[k] - before[k] for k in tp.KINDS})
            states.append((tp.tree_meta(jamr), tp.np_levels(s)))
            if step == 0:
                jio.write_checkpoint_patch(chk, s, jamr, jamr.cfg)
    return jamr, states, iters, chk


@pytest.fixture(scope="module")
def port_run(ref):
    """The port's box tree from its own init over STEPS steps, held to
    incflo_tpu's run as it goes, with each Simulation's nodal projection
    forms counted: (driver, final state, worst error, {entry: the
    calls of apply_projection and of its exact octant form})."""
    _, states, iters, _ = ref
    amr = _quiet(tp.port_amr, BOX)
    forms = {}
    saved = {name: getattr(Simulation, name)
             for name in ("apply_projection", "_eb_exact_projection")}

    def counted(name, fn):
        def wrapped(sim, *a, **kw):
            got = forms.setdefault(amr.sims.index(sim), dict.fromkeys(saved,
                                                                      0))
            got[name] += 1
            return fn(sim, *a, **kw)
        return wrapped
    try:
        for name, fn in saved.items():
            setattr(Simulation, name, counted(name, fn))
        s, worst = _quiet(tp.compare_amr_run, amr, amr.init_state(),
                          states, iters)
    finally:
        for name, fn in saved.items():
            setattr(Simulation, name, fn)
    return amr, s, worst, forms


# ---------------------------------------------------------------------
# the patch tree
# ---------------------------------------------------------------------

def test_eb_box_patch_matches_incflo_tpu(port_run, ref):
    """incflo_tpu's EB box deck from the port's own init: the same tree
    (a box x in [4, 16) over the whole of y and z) and every level's
    fields and dt within 1e-10 over 2 steps, with equal iterations."""
    amr, _, worst, _ = port_run
    assert worst <= 1e-10
    assert ref[1][0][0]["bounds"][1] == [[4, 0, 0], [16, 16, 8]]
    assert all(it["nodal_cycles"] > 0 and it["cell_iters"] > 0
               for it in ref[2])


def test_eb_box_patch_from_carried_init(ref):
    """The same run from incflo_tpu's initial tree carried across."""
    _, states, iters, _ = ref
    amr = _quiet(tp.port_amr, BOX)
    s = tstate.patch_from_numpy(amr, *states[0])
    _, worst = _quiet(tp.compare_amr_run, amr, s, states, iters)
    assert worst <= 1e-10


def test_patch_builds_its_cut_cells_and_takes_the_weak_form(port_run, ref):
    """The patch builds its own cut-cell geometry on its grid (within
    1e-12 of incflo_tpu's), starts at rest in its covered cells, and its
    nodal projections take the vfrac-weighted weak form with its
    Dirichlet coarse-fine values, while the base takes the exact octant
    operator in every projection (the step's and the composite sync's)."""
    jamr = ref[0]
    amr, s, _, forms = port_run
    patch, jpatch = amr.sims[1], jamr.sims[1]
    assert patch.eb is not None and jpatch.eb is not None
    for f in ("vfrac", "cut", "covered", "eb_area", "vfrac_oct"):
        a = getattr(patch.eb, f).numpy()
        b = np.asarray(getattr(jpatch.eb, f))
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-12, f
    assert int(patch.eb.cut.sum()) > 0
    assert amr.sim0._nodal_eb_hat is not None
    assert patch._nodal_eb_hat is None and patch.eb.vfrac_oct is not None
    # init's projections, each step's and the composite sync's: the
    # base's all exact, the patch's all weak
    assert forms[0]["apply_projection"] \
        == forms[0]["_eb_exact_projection"] > 2 * STEPS
    assert forms[1]["apply_projection"] >= 2 * STEPS
    assert forms[1]["_eb_exact_projection"] == 0
    init = _quiet(tp.port_amr, BOX).init_state()
    covered = patch.eb.covered.numpy() > 0.5
    assert covered.any()
    assert not init.levels[1].level.velocity.numpy()[covered].any()
    final = s.levels[1].level.velocity.numpy()
    assert not final[covered].any() and np.isfinite(final).all()


def test_cut_cells_are_tagged_as_incflo_tpu_tags_them(port_run, ref):
    """The forced cut-cell tags (incflo_tagging.cpp:133-140) of the
    base level, the patch mode both packages pick for the deck without
    amr.patch_mode, and the tags of a level refined once more (the patch
    as a parent), equal in both packages."""
    from incflo_torch import amr_patch
    from incflo_tpu import amr_patch as jap
    from incflo_tpu.config import IncfloConfig as JConfig
    jamr = ref[0]
    amr, s, _, _ = port_run
    for i in (0, 1):
        rho = s.levels[i].level.density.numpy()
        got = amr._tag_level(s.levels[i].level.density, amr.sims[i], lev=i)
        want = jamr._tag_level(rho, jamr.sims[i], lev=i)
        assert np.array_equal(got, want), i
        assert got.sum() == amr.sims[i].eb.cut.numpy().sum() > 0
    text = BOX.replace("amr.patch_mode = box\n", "")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mode = amr_patch.choose_patch_mode(
            incflo_torch.IncfloConfig.from_text(text))
        assert mode == jap.choose_patch_mode(JConfig.from_text(text))


def test_eb_patch_restart_is_bit_exact(port_run, tmp_path):
    """The port's EB patch checkpoint after step 1 (its geometry rebuilt
    from the deck on the read) restarts bit-equal to the unbroken
    run."""
    amr, final, _, _ = port_run
    one = _quiet(tp.port_amr, BOX)
    s = one.advance(one.init_state())
    tio.write_checkpoint_patch(str(tmp_path / "chk"), s, one, one.cfg)
    again = _quiet(tp.port_amr, BOX)
    r = tio.read_checkpoint_patch(str(tmp_path / "chk"), again, again.cfg)
    assert again.tree_meta() == one.tree_meta()
    got = tp.np_levels(again.advance(r))
    want = tp.np_levels(final)
    for a, b in zip(got, want):
        for k in tp.FIELDS + ("dt", "t", "step"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_incflo_tpu_eb_checkpoint_restarts_in_port(ref):
    """incflo_tpu's EB patch checkpoint after step 1, read by the port,
    steps to incflo_tpu's step 2 within 1e-10, with its iterations."""
    _, states, iters, chk = ref
    amr = _quiet(tp.port_amr, BOX)
    s = tio.read_checkpoint_patch(chk, amr, amr.cfg)
    _, worst = _quiet(tp.compare_amr_run, amr, s, states[1:], iters[1:])
    assert worst <= 1e-10


def test_port_eb_checkpoint_restarts_in_incflo_tpu(port_run, ref, tmp_path):
    """The port's step-1 checkpoint read by incflo_tpu's driver (the same
    tree: its compiled advance is reused) steps to its own step 2 within
    1e-10."""
    from incflo_tpu.utils import io as jio
    jamr, states, _, _ = ref
    amr = _quiet(tp.port_amr, BOX)
    s = amr.advance(tstate.patch_from_numpy(amr, *states[0]))
    path = str(tmp_path / "chk_port")
    tio.write_checkpoint_patch(path, s, amr, amr.cfg)
    assert json.load(open(os.path.join(path, "Patch.json"))) \
        == states[1][0]
    js = jio.read_checkpoint_patch(path, jamr, jamr.cfg)
    tp.assert_levels_close(tp.np_levels(js), states[1][1], 1e-10, "read")
    js = _quiet(jamr.advance, js)
    tp.assert_levels_close(tp.np_levels(js), states[2][1], 1e-10, "step")


# ---------------------------------------------------------------------
# the dense fine level
# ---------------------------------------------------------------------

def test_dense_driver_tags_cut_cells_as_incflo_tpu():
    """TagCutCells on the dense fine level (incflo_tpu/amr.py:175-180):
    the fine level's cut cells averaged down OR'ed into the mask before
    the error buffer.  The masks after init and after the step's regrid
    equal incflo_tpu's, and the fine level's fields and dt within
    1e-10."""
    from incflo_tpu.amr import AMRSimulation as JAMR
    from incflo_tpu.config import IncfloConfig as JConfig
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jamr = JAMR(JConfig.from_text(DENSE))
        js = jamr.init_state()
        jmasks = [np.asarray(jamr.masks[0])]
        js = jamr.advance(js)
        jmasks.append(np.asarray(jamr.masks[0]))
        amr = AMRSimulation(incflo_torch.IncfloConfig.from_text(DENSE),
                            device="cpu")
        s = amr.init_state()
        masks = [amr.masks[0].numpy()]
        s = amr.advance(s)
        masks.append(amr.masks[0].numpy())
    cut = amr.sim.eb.cut.numpy().reshape(16, 2, 16, 2).max(axis=(1, 3))
    for got, want in zip(masks, jmasks):
        assert np.array_equal(got, want)
        assert got[cut > 0.5].all()
    tp.assert_levels_close([tstate.sim_to_numpy(s)], [tp.np_state(js)],
                           1e-10, "dense")


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["slab", "dense"])
def test_cli_runs_an_eb_amr_deck_and_restarts_bit_exact(tmp_path,
                                                        monkeypatch, mode):
    """python -m incflo_torch.main on an EB AMR deck on the CPU: the box
    deck without amr.patch_mode (auto-selected: a slab patch tree along
    x, regridded every step) and the dense 2D deck (amr.patch_mode =
    dense), 2 steps with a checkpoint every step and a plotfile every 2,
    then a restart from chk00001 (the geometry rebuilt from the deck)
    whose chk00002 is bit-equal to the unbroken one."""
    from incflo_torch import main as tmain
    deck = tmp_path / "inputs"
    if mode == "slab":
        deck.write_text(BOX.replace("amr.patch_mode = box\n", "")
                        + "amr.regrid_int = 1\n")
    else:
        deck.write_text(DENSE + "amr.patch_mode = dense\n")
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    args = [str(deck), "max_step=2", "amr.plot_int=2", "amr.check_int=1",
            "amr.plt_vfrac=1"]
    for d, extra in (("a", []),
                     ("b", [f"amr.restart={tmp_path / 'a' / 'chk00001'}"])):
        (tmp_path / d).mkdir()
        monkeypatch.chdir(tmp_path / d)
        assert _quiet(tmain.run, args + extra) == 0
    a, b = tmp_path / "a" / "chk00002", tmp_path / "b" / "chk00002"
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    assert ("Patch.json" in files) == (mode == "slab")
    for f in files:
        if f.endswith(".npz"):
            x, y = np.load(a / f), np.load(b / f)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f + k)
        else:
            assert open(a / f).read() == open(b / f).read(), f
    plt = tmp_path / "a" / "plt00002"
    levels = sorted(p for p in os.listdir(plt) if p.startswith("Level_"))
    assert levels == ["Level_0.npz", "Level_1.npz"]
    for lv in levels:
        z = np.load(plt / lv)
        assert "vfrac" in z.files and z["vfrac"].min() < 1.0, lv
        assert all(np.isfinite(z[k]).all() for k in z.files), lv
