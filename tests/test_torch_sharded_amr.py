"""AMR on an x-slab mesh (incflo_torch/parallel, ROADMAP A14): the patch
tree (amr_patch.SlabAMRSimulation) and the dense fine level
(amr.AMRSimulation) split over 2 gloo ranks against the port on 1 rank
and against incflo_tpu, a split patch's coarse-fine context against the
whole patch's rows, per-rank AMR checkpoints and the CLI, on the CPU.

One spawn of 2 gloo ranks (incflo_torch.parallel.workers.several) runs
every job, in float64, while this process runs incflo_tpu's reference
and the 1-rank runs.  The decks, built inline:
  rt2d       tests/test_sharding.py:208-258 (incflo_tpu's sharded
             patch-AMR deck): 16 x 32, periodic x, slip y walls,
             probtype 5, a slab patch along y over the whole x range
             (split: 32 patch rows, 16 a rank)
  rt3d       tests/test_torch_amr_rt3d.py's deck at bench's rt n = 16
             (8 x 8 x 16 base, slip z walls, a z slab patch of 16 x 16 x
             16, regridded every 2 steps), 3 steps: a regrid inside
  rt3d_xw    rt3d with slip x walls, 1 step: the end ranks hold the
             level's x faces, the last rank the patch's node nx
  box        torch_parity.BOX_DECK: a box patch with coarse-fine faces on
             all four sides, held whole on every rank (replicated), then
             two regrids of moved tag regions: the box moves (replicated
             to replicated, the old fine data copied over the overlap),
             then spans the x range (replicated to split)
  mixed3     torch_parity.rt2d_amr_deck(max_level=2) in box mode, level
             0 tagged by its density gradient (a box over the whole x
             range: split), level 1 by a small tag region alone (a box
             held whole under a split parent: its context from the
             parent's fields and ghost-value windows gathered whole), 1
             step and the regrid after it
  dense      torch_parity.rt2d_amr_deck(max_level=2) on the dense fine
             level (64 x 128 fine cells, three levels of masks), 1 step
             and the regrid after it

Tolerances:
  context    exact: a split patch's interpolated windows, solver face
             values, nodal Dirichlet values, init_from_parent and the
             parent after _sync_down are the whole patch's rows; a
             replicated patch's the whole patch's
  steps      rtol 1e-11, atol 1e-13 against the port on 1 rank
             (tests/test_sharding.py:254-258), equal trees, CG
             iterations, V-cycles and tensor-CG iterations in every step
             on every rank, the same dt bits on every rank
  incflo_tpu 1e-10 of incflo_tpu's unsharded tree (rt2d, init + 2 steps)
  checkpoint the restart on 2 ranks bit-equal to the unbroken run, the
             state read on 1 rank bit-equal to the one written, its step
             within 1e-11
  CLI        1e-11 relative against the unsharded driver's files
"""

import concurrent.futures
import dataclasses
import json
import os

import numpy as np
import pytest

import bench
import torch_parity as tp
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.amr import AMRSimulation
from incflo_torch.amr_patch import PatchState
from incflo_torch.ops import multigrid as tmg
from incflo_torch.parallel import launch, workers
from incflo_torch.utils import io as tio
from test_torch_sharded_eb import _whole_rows

JOB = "incflo_torch.parallel.workers:several"
TIMEOUT = 600.0
RANKS = 2
KINDS = workers.ITER_KINDS

# tests/test_sharding.py:211-233
RT2D = """
amr.n_cell = 16 32
amr.max_level = 1
amr.patch_mode = slab
geometry.prob_lo = 0. 0.
geometry.prob_hi = 0.5 1.0
geometry.is_periodic = 1 0
ylo.type = "sw"
yhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. -0.1
incflo.use_godunov = true
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.cfl = 0.9
incflo.init_shrink = 1.0
incflo.initial_iterations = 0
incflo.do_initial_proj = 0
incflo.gradrhoerr = 0.1
"""
RT3D = bench._deck("rt", 16, "float64")[0] + (
    "amr.max_level = 1\nincflo.gradrhoerr = 0.1\namr.regrid_int = 2\n")
RT3D_XW = RT3D.replace("geometry.is_periodic = 1 1 0",
                       'geometry.is_periodic = 0 1 0\nxlo.type = "sw"\n'
                       'xhi.type = "sw"')
DENSE = tp.rt2d_amr_deck(max_level=2).replace("amr.patch_mode = slab", "") \
    + "amr.regrid_int = 1\n"
MIXED3 = tp.rt2d_amr_deck(max_level=2).replace(
    "amr.patch_mode = slab", "amr.patch_mode = box").replace(
    "incflo.gradrhoerr = 0.1\n",
    "incflo.gradrhoerr = 0.1 100.\nincflo.tag_region = true\n"
    "incflo.tag_region_lo = 0.1 0.45\nincflo.tag_region_hi = 0.25 0.55\n") \
    + "amr.regrid_int = 1\n"
DECKS = {"rt2d": RT2D, "rt3d": RT3D, "rt3d_xw": RT3D_XW,
         "box": tp.BOX_DECK, "mixed3": MIXED3, "dense": DENSE}
STEPS = {"rt2d": 2, "rt3d": 3, "rt3d_xw": 1, "box": 2, "mixed3": 1,
         "dense": 1}
# the box deck's regrids after its steps: the region of
# tests/test_torch_amr_box.py, then a band over the whole x range that
# overlaps the moved box
MOVED = [dict(tag_region_lo=(0.55, 0.1), tag_region_hi=(0.85, 0.4)),
         dict(tag_region_lo=(0.0, 0.2), tag_region_hi=(1.0, 0.45))]
CLI_ARGS = ["max_step=2", "amr.check_int=2", "amr.plot_int=2",
            "amr.regrid_int=2"]
EB_AMR = tp.shear3d_deck(16) + ("amr.max_level = 1\n"
                                'incflo.geometry = "cylinder"\n'
                                "cylinder.internal_flow = false\n"
                                "cylinder.radius = 0.2\n"
                                "cylinder.direction = 2\n"
                                "cylinder.center = 0.5 0.5 0.\n")
SCOPE = {"AMR with embedded boundaries": EB_AMR,
         "dense AMR with embedded boundaries": EB_AMR,
         "dense nx % R": bench._deck("tgv2d", 8, "float64")[0].replace(
             "amr.n_cell = 8 8", "amr.n_cell = 9 8") + "amr.max_level = 1\n"}


# ---------------------------------------------------------------------
# the port on one rank
# ---------------------------------------------------------------------

def amr_of(name):
    cfg = incflo_torch.IncfloConfig.from_text(DECKS[name])
    if name == "dense":
        return AMRSimulation(cfg, device="cpu")
    return tp.port_amr(DECKS[name])


def record(amr, s):
    """(tree record, per-entry dicts) of a tree, or (None, [the fine
    level, its masks]) of the dense driver (workers.amr_steps)."""
    if isinstance(amr, AMRSimulation):
        return None, [tstate.sim_to_numpy(s),
                      [None if m is None else m.numpy() for m in amr.masks]]
    return amr.tree_meta(), tstate.patch_to_numpy(amr, s)


def one_rank(name):
    """The port on one rank from init through STEPS[name] steps (and the
    box deck's regrids): the trees after each and each step's
    tallies."""
    amr = amr_of(name)
    tmg.reset_counts()
    s = amr.init_state()
    states = [record(amr, s)]
    tallies = [{k: tmg.COUNTS[k] for k in KINDS}]
    for _ in range(STEPS[name]):
        before = dict(tmg.COUNTS)
        s = amr.advance(s)
        tallies.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        states.append(record(amr, s))
    for moved in MOVED if name == "box" else ():
        amr.cfg = amr.sim0.cfg = dataclasses.replace(amr.cfg, **moved)
        s = amr.regrid(s)
        states.append(record(amr, s))
    return states, tallies


def levels_of(rec):
    """The per-entry dicts of a record (the dense driver's fine level)."""
    tree, levels = rec
    return levels if tree is not None else levels[:1]


def check_steps(results, key, states, tallies):
    """Rank 0's trees against the 1-rank ones (rtol 1e-11, atol 1e-13 on
    every field of every level; the dense driver's masks equal), every
    rank's tallies equal to the 1-rank ones and every rank's dts the
    same bits."""
    got = results[0][key]["states"]
    assert len(got) == len(states)
    for i, (g, w) in enumerate(zip(got, states)):
        assert g[0] == w[0], (key, i, g[0], w[0])
        for j, (a, b) in enumerate(zip(levels_of(g), levels_of(w))):
            for f in tp.FIELDS + ("dt",):
                np.testing.assert_allclose(
                    a[f], b[f], rtol=1e-11, atol=1e-13,
                    err_msg=f"{key} state {i} level {j} field {f}")
            assert int(a["step"]) == int(b["step"])
        if g[0] is None:
            for m, n in zip(g[1][1], w[1][1]):
                assert (m is None) == (n is None)
                assert m is None or np.array_equal(m, n), (key, i)
    for r in results:
        assert r[key]["tallies"] == tallies, (key, r[key]["tallies"],
                                              tallies)
        assert r[key]["dts"] == results[0][key]["dts"], key


# ---------------------------------------------------------------------
# the spawn, and what runs here meanwhile
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_amr")
    (root / "inputs").write_text(RT2D.replace("amr.patch_mode = slab", ""))
    for d in ("cli", "cli1", "sharded"):
        (root / d).mkdir()
    amr = tp.port_amr(RT2D)
    s = amr.advance(amr.init_state())
    tio.write_checkpoint_patch(str(root / "whole"), s, amr, amr.cfg)
    return root


@pytest.fixture(scope="module")
def contexts():
    """rt3d's and rt3d_xw's and the box deck's trees after init and one
    step on 1 rank (the context's old and new parent states)."""
    out = {}
    for name in ("rt3d", "rt3d_xw", "box"):
        amr = tp.port_amr(DECKS[name])
        s0 = amr.init_state()
        s1 = PatchState(amr._advance_impl(list(s0.levels)))
        out[name] = (record(amr, s0), record(amr, s1))
    return out


@pytest.fixture(scope="module")
def spawn(io_dir, contexts):
    """One spawn of 2 gloo ranks, started in a thread: every deck's steps
    (workers.amr_steps), the patch contexts, rt2d's per-rank checkpoint
    with its restarts, the CLI on rt2d, the decks that once raised."""
    jobs = [(name, "amr_steps", dict(deck=DECKS[name], nsteps=STEPS[name],
                                     dense=name == "dense",
                                     moved=MOVED if name == "box" else None))
            for name in DECKS]
    jobs += [(f"context {name}", "patch_context",
              dict(deck=DECKS[name], old=old, new=new))
             for name, (old, new) in contexts.items()]
    jobs += [("checkpoint", "amr_checkpoint",
              dict(deck=RT2D, nsteps=1, path=str(io_dir / "sharded"),
                   whole=str(io_dir / "whole"))),
             ("cli", "cli", dict(argv=[str(io_dir / "inputs")] + CLI_ARGS,
                                 cwd=str(io_dir / "cli"))),
             ("scope", "scope_errors",
              dict(decks=SCOPE, dense=[k for k in SCOPE if "dense" in k]))]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.run, JOB, RANKS, dict(jobs=jobs),
                         device="cpu", timeout=TIMEOUT)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def reference(spawn):
    """incflo_tpu's unsharded rt2d tree through 2 steps, while the ranks
    run."""
    _, _, states, iters = tp.amr_reference_run(RT2D, STEPS["rt2d"])
    return states, iters


@pytest.fixture(scope="module")
def ones(spawn, reference):
    """Every deck on 1 rank, while the ranks run."""
    return {name: one_rank(name) for name in DECKS}


@pytest.fixture(scope="module")
def two_ranks(spawn, reference, ones):
    return spawn.result()


# ---------------------------------------------------------------------
# whole decks
# ---------------------------------------------------------------------

def test_rt2d_tree_on_two_ranks_matches_one_and_incflo_tpu(
        two_ranks, ones, reference):
    """incflo_tpu's sharded patch-AMR deck (tests/test_sharding.py:
    208-258): init + 2 steps on 2 ranks, the slab patch split, against
    the port on 1 rank and against incflo_tpu's unsharded tree with its
    iterations."""
    states, tallies = ones["rt2d"]
    check_steps(two_ranks, "rt2d", states, tallies)
    assert all(all(f) for f in two_ranks[0]["rt2d"]["split"])
    want, iters = reference
    got = two_ranks[0]["rt2d"]["states"]
    for i, ((tg, lg), (tw, lw)) in enumerate(zip(got, want)):
        assert tg == tw, (i, tg, tw)
        assert tp.assert_levels_close(lg, lw, 1e-10, f"step {i}") <= 1e-10
    assert two_ranks[0]["rt2d"]["tallies"][1:] == iters
    calls = [r["rt2d"]["per_level"] for r in two_ranks]
    assert all(c[lev]["slab_2d"]["nodal"] > 0 for c in calls
               for lev in (0, 1)), calls


@pytest.mark.parametrize("name", ["rt3d", "rt3d_xw", "replicated",
                                  "dense"])
def test_amr_deck_on_two_ranks_matches_one(two_ranks, ones, name):
    """A 3D slab tree with a regrid inside its 3 steps (rt3d), the same
    with x walls, the replicated patches -- the box patch with its two
    moved regrids (to a moved box, then to a band over the whole x
    range: the patch becomes split) and mixed3's level-2 box held whole
    under a split level-1 box -- and the dense driver's three levels, on
    2 ranks against 1."""
    for deck in ("box", "mixed3") if name == "replicated" else (name,):
        states, tallies = ones[deck]
        check_steps(two_ranks, deck, states, tallies)
        split = two_ranks[0][deck]["split"]
        if deck == "box":
            assert split[:-1] == [[True, False]] * (len(split) - 1), split
            assert split[-1] == [True, True], split
            assert states[-2][0]["bounds"][1] != states[-3][0]["bounds"][1]
        elif deck == "mixed3":
            assert all(f == [True, True, False] for f in split), split
        else:
            assert all(all(f) for f in split), split


# ---------------------------------------------------------------------
# the coarse-fine context of a split and a replicated patch
# ---------------------------------------------------------------------

LAYOUT = {"full": "ghost 4", "mac_bvals": "ghost 1", "vel_bvals": "ghost 1",
          "tra_bvals": "ghost 1", "nodal_dvals": "node"}


@pytest.mark.parametrize("form", ["split", "replicated"])
def test_patch_context_on_a_slab_equals_whole_patch_rows(two_ranks,
                                                         contexts, form):
    """Each patch's interpolated windows (velocity, density, tracer), the
    Dirichlet face values of its MAC, velocity and tracer solves, its
    nodal Dirichlet values, its init_from_parent and its parent after
    _sync_down, from the same two parent states: a split patch's (rt3d,
    rt3d_xw) on each rank bit-equal to the whole patch's rows (the
    parent's ghost rows from the neighbours' interior, the last rank's
    node nx on an x that ends in walls), a replicated patch's (box) to
    the whole patch's."""
    for name in ("rt3d", "rt3d_xw") if form == "split" else ("box",):
        check_context(two_ranks, contexts, name)


def check_context(two_ranks, contexts, name):
    old, new = contexts[name]
    amr = tp.port_amr(DECKS[name])
    whole = workers.context_of(amr, old, new)
    per = amr.sims[1].grid.periodic[0]
    pper = amr.sim0.grid.periodic[0]
    for r, res in enumerate(two_ranks):
        got = res[f"context {name}"]
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            assert g["split"] == (name != "box")

            def same(a, b, layout, periodic, what):
                b = _whole_rows(b, layout, r, RANKS, periodic) \
                    if g["split"] else b
                assert a.shape == b.shape, (name, r, what)
                assert np.array_equal(a, b), (name, r, what)
            for key, layout in LAYOUT.items():
                for k, a in g[key].items():
                    same(a, w[key][k], layout, per, (key, k))
            for f, a in g["init"].items():
                same(a, w["init"][f], "node" if f == "p" else "cell",
                     per, ("init", f))
            for f, a in g["synced"].items():     # the base: split
                b = _whole_rows(w["synced"][f], "node" if f == "p"
                                else "cell", r, RANKS, pper)
                assert np.array_equal(a, b), (name, r, "synced", f)


# ---------------------------------------------------------------------
# checkpoints, the CLI, scope
# ---------------------------------------------------------------------

def _tree_equal(a, b, what):
    assert a[0] == b[0], what
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        for f in tp.FIELDS + ("dt", "t", "step"):
            assert np.array_equal(x[f], y[f]), (what, i, f)


def test_amr_checkpoint_on_two_ranks_restarts_on_one_and_two(
        two_ranks, io_dir):
    """rt2d's tree written on 2 ranks after one step (the split levels one
    shard a rank, Shards.json and Shards.p1.json): read back on 2 ranks
    it is the tree written and its next step the unbroken run's bit for
    bit; read on 1 rank it is the tree written, its step within 1e-11;
    a 1-rank checkpoint of the same tree read on 2 ranks is the tree
    that rank wrote, its step within 1e-11 of the 1-rank run's."""
    got = two_ranks[0]["checkpoint"]
    _tree_equal(got["restarted_read"], got["written"], "2-rank read")
    _tree_equal(got["restarted"], got["unbroken"], "2-rank restart")
    path = io_dir / "sharded"
    assert "Shards.p1.json" in os.listdir(path / "patch_level_1")
    amr = tp.port_amr(RT2D)
    s = tio.read_checkpoint_patch(str(path), amr, amr.cfg)
    _tree_equal((amr.tree_meta(), tstate.patch_to_numpy(amr, s)),
                got["written"], "1-rank read")
    one = amr.advance(s)
    assert amr.tree_meta() == got["unbroken"][0]
    tp.assert_levels_close(tstate.patch_to_numpy(amr, one),
                           got["unbroken"][1], 1e-11, "1-rank restart")
    amr = tp.port_amr(RT2D)
    s = tio.read_checkpoint_patch(str(io_dir / "whole"), amr, amr.cfg)
    _tree_equal(got["whole_restarted_read"],
                (amr.tree_meta(), tstate.patch_to_numpy(amr, s)),
                "2-rank read of a 1-rank checkpoint")
    s = amr.advance(s)
    assert got["whole_restarted"][0] == amr.tree_meta()
    tp.assert_levels_close(got["whole_restarted"][1],
                           tstate.patch_to_numpy(amr, s), 1e-11,
                           "2-rank restart of a 1-rank checkpoint")


def test_cli_runs_an_amr_deck_on_two_ranks(two_ranks, io_dir, tmp_path,
                                           monkeypatch):
    """python -m incflo_torch.main on rt2d without amr.patch_mode on the
    2-rank mesh: both ranks pick the slab mode, rank 0 alone prints, and
    the plotfiles and checkpoints hold what the 1-rank driver writes, to
    1e-11 of each field's (a vector's) largest value."""
    from incflo_torch import main as tmain
    res = [r["cli"] for r in two_ranks]
    assert [r["rc"] for r in res] == [0, 0]
    assert "amr.patch_mode auto-selected: slab" in res[0]["stdout"]
    assert res[1]["stdout"] == ""
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert tmain.run([str(io_dir / "inputs")] + CLI_ARGS) == 0
    d = io_dir / "cli"
    assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path))
    assert "Shards.p1.json" in os.listdir(d / "chk00002" / "patch_level_1")
    hg = json.load(open(d / "plt00002" / "Header"))
    hw = json.load(open(tmp_path / "plt00002" / "Header"))
    for k in ("time", "dt"):
        assert abs(hg.pop(k) - hw[k]) <= 1e-11 * abs(hw.pop(k)), k
    assert hg == hw
    group = lambda k: k[:-1] if k[:-1] in ("vel", "gp") else k
    for lev in ("Level_0.npz", "Level_1.npz"):
        got = np.load(d / "plt00002" / lev)
        ref = np.load(tmp_path / "plt00002" / lev)
        assert sorted(got.files) == sorted(ref.files)
        scale = {}
        for k in ref.files:
            scale[group(k)] = max(scale.get(group(k), 0.0),
                                  float(np.abs(ref[k]).max()))
        for k in ref.files:
            if ref[k].dtype == bool:
                assert np.array_equal(got[k], ref[k]), (lev, k)
                continue
            err = float(np.abs(got[k] - ref[k]).max())
            assert err <= 1e-11 * max(scale[group(k)], 1e-300), (lev, k)
    amr = tp.port_amr(RT2D)
    a = tio.read_checkpoint_patch(str(d / "chk00002"), amr, amr.cfg)
    a = tstate.patch_to_numpy(amr, a)
    b = tio.read_checkpoint_patch(str(tmp_path / "chk00002"), amr, amr.cfg)
    tp.assert_levels_close(a, tstate.patch_to_numpy(amr, b), 1e-11, "chk")


def test_amr_with_eb_on_a_mesh_still_raises(two_ranks):
    """AMR with embedded boundaries split over the mesh, which once
    raised naming ROADMAP A13b, builds in both drivers, and so does the
    dense driver on a base nx that does not split over the ranks, which
    once raised naming A14 (its fine level held whole); they run in
    tests/test_torch_sharded_amr_eb.py."""
    for res in two_ranks:
        errs = res["scope"]
        for name in ("AMR with embedded boundaries",
                     "dense AMR with embedded boundaries", "dense nx % R"):
            assert errs[name] is None, (name, errs[name])
