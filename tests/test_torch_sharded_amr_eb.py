"""AMR with embedded boundaries on an x-slab mesh (ROADMAP A13b), the
levels a mesh holds whole, and the rfftn direct solve under a mesh
(ROADMAP A14), on gloo ranks on the CPU, in float64.

A spawn of 2 ranks (incflo_torch.parallel.workers.several), started in
a thread while this process runs the 1-rank references and incflo_tpu's:
  box        the EB box deck of tests/test_amr_patch.py:502-538 (32 x 16
             x 8 around a cylinder along z): the base split (slabs of
             16), the box patch x in [4, 16) held whole on every rank
             with its whole cut-cell geometry, 2 steps
  xcyl       shear3d 16 x 32 x 8 around a cylinder along x: the cut cells
             tag a band along y, so the slab patch (y in [8, 24)) spans
             the whole x range and is split with its parent, its cut-cell
             arrays cut to the slab; a regrid after each of 2 steps
  dense      tgv2d 16^2 around a cylinder on the dense fine level (32^2,
             slabs of 16): its cut cells tagged from the slabs, 1 step
  rfftn      shear3d 264 x 8 x 8 (isotropic cells): an axis above 256
             cells, whose direct solves take rfftn on one device; under
             the mesh its cell, nodal and tensor solves run V-cycles on
             the slabs, as incflo_tpu's spectral.usable makes them under
             its mesh; 1 step
  checkpoint xcyl's per-rank checkpoint after 1 step, restarted on 2
             ranks and read on 1
Then spawns that hold a level whole on every rank (no exchange): shear3d
24 x 16 x 8 on 5 ranks (24 does not split into 5 slabs), and on 8 ranks
shear3d 16 x 16 x 8 (slabs of 2, narrower than the 4-cell halo), the
patch tree and the dense driver on bases that do not split, and the CLI
with a checkpoint and a restart; and one rank: the rfftn deck's V-cycle
form on a 1-rank mesh.

Tolerances:
  EB AMR     every level's fields and dt within 1e-11 relative to the
             field's largest value of the port on 1 rank (a cut-cell
             level's rounding noise, gp's z on the box patch, differs by
             rounding of the ranks' dots), equal trees and masks, tallies
             on every rank and dt bits
  whole      bit-equal to the port on 1 rank, equal tallies, no exchange
  rfftn      2 ranks within 1e-11 relative of the 1-rank mesh with equal
             tallies; the 1-rank V-cycle form within 1e-10 of incflo_tpu
             run with INCFLO_SPECTRAL=0 (the path its spectral.usable
             takes under a mesh) with equal iterations
  checkpoint the restart on 2 ranks bit-equal to the unbroken run; read
             on 1 rank, the tree written
"""

import concurrent.futures
import os
import warnings

import numpy as np
import pytest

import bench
import torch_parity as tp
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.amr import AMRSimulation
from incflo_torch.ops import multigrid as tmg
from incflo_torch.parallel import launch, workers
from incflo_torch.utils import io as tio
from test_torch_amr_eb import BOX, DENSE
from test_torch_sharded_amr import _tree_equal, levels_of, record

JOB = "incflo_torch.parallel.workers:several"
TIMEOUT = 600.0
KINDS = workers.ITER_KINDS


def shear3d(n_cell, extra=""):
    """bench's shear3d at n_cell with isotropic cells."""
    text = bench._deck("shear3d", 16, "float64")[0]
    nx, ny, nz = n_cell
    text = text.replace("amr.n_cell = 16 16 8", f"amr.n_cell = {nx} {ny} {nz}")
    return text.replace("geometry.prob_hi = 1. 1. 0.25",
                        f"geometry.prob_hi = {nx / 16} {ny / 16} {nz / 16}"
                        ) + extra


XCYL = shear3d((16, 32, 8), "amr.max_level = 1\namr.regrid_int = 1\n"
               'incflo.geometry = "cylinder"\n'
               "cylinder.internal_flow = false\n"
               "cylinder.radius = 0.1\n"
               "cylinder.direction = 0\n"
               "cylinder.center = 0. 1. 0.25\n")
RFFTN = shear3d((264, 8, 8))
AMR_DECKS = {"box": BOX, "xcyl": XCYL, "dense": DENSE}
STEPS = {"box": 2, "xcyl": 2, "dense": 1}
# levels held whole: (ranks, kind, deck)
WHOLE = {"nx 24 on 5": (5, "steps", shear3d((24, 16, 8))),
         "slabs of 2 on 8": (8, "steps", shear3d((16, 16, 8))),
         "patch tree": (8, "amr", tp.rt2d_amr_deck()),
         "dense base": (8, "dense", bench._deck(
             "tgv2d", 8, "float64")[0].replace(
             "amr.n_cell = 8 8", "amr.n_cell = 12 8")
             + "amr.max_level = 1\namr.regrid_int = 1\n")}
CLI_ARGS = ["max_step=2", "amr.check_int=1", "amr.plot_int=2", "amr.KE_int=1"]


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kw)


def amr_of(name, text=None):
    cfg = incflo_torch.IncfloConfig.from_text(text or AMR_DECKS[name])
    if name == "dense":
        return _quiet(AMRSimulation, cfg, device="cpu")
    return _quiet(tp.port_amr, text or AMR_DECKS[name])


def one_rank(name, nsteps, text=None):
    """The port on one rank from init through nsteps steps: the trees
    after each ((tree, per-entry dicts); the dense driver's (None,
    [fine level, masks])) and each step's tallies."""
    amr = amr_of(name, text)
    tmg.reset_counts()
    s = _quiet(amr.init_state)
    states = [record(amr, s)]
    tallies = [{k: tmg.COUNTS[k] for k in KINDS}]
    for _ in range(nsteps):
        before = dict(tmg.COUNTS)
        s = _quiet(amr.advance, s)
        tallies.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        states.append(record(amr, s))
    return states, tallies


def one_level(text, nsteps):
    """The port's one-level run on one device: the whole states after
    init and each step, and each step's tallies."""
    sim = tp.port_sim(text)
    tmg.reset_counts()
    s = sim.init_state()
    states = [tstate.sim_to_numpy(s)]
    tallies = [{k: tmg.COUNTS[k] for k in KINDS}]
    for _ in range(nsteps):
        before = dict(tmg.COUNTS)
        s = sim.advance(s)
        tallies.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        states.append(tstate.sim_to_numpy(s))
    return states, tallies


def check_steps(results, key, states, tallies):
    """Rank 0's trees against the 1-rank ones (every field and dt of
    every level within 1e-11 relative to its largest value, the dense
    driver's masks equal), every rank's tallies equal to the 1-rank ones
    and every rank's dts the same bits."""
    got = results[0][key]["states"]
    assert len(got) == len(states)
    for i, (g, w) in enumerate(zip(got, states)):
        assert g[0] == w[0], (key, i, g[0], w[0])
        tp.assert_levels_close(levels_of(g), levels_of(w), 1e-11,
                               f"{key} state {i}")
        if g[0] is None:
            for m, n in zip(g[1][1], w[1][1]):
                assert np.array_equal(m, n), (key, i)
    for r in results:
        assert r[key]["tallies"] == tallies, (key, r[key]["tallies"])
        assert r[key]["dts"] == results[0][key]["dts"], key


# ---------------------------------------------------------------------
# the spawns, and what runs here meanwhile
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_amr_eb")
    (root / "inputs").write_text(WHOLE["slabs of 2 on 8"][2])
    for d in ("chk", "cli", "cli1"):
        (root / d).mkdir()
    return root


@pytest.fixture(scope="module")
def spawns(io_dir):
    """The 2-rank spawn, started in a thread, then (in the same thread)
    the 5-, 8- and 1-rank ones."""
    two = [(name, "amr_steps", dict(deck=deck, nsteps=STEPS[name],
                                    dense=name == "dense"))
           for name, deck in AMR_DECKS.items()]
    two += [("rfftn", "steps", dict(deck=RFFTN, nsteps=1)),
            ("checkpoint", "amr_checkpoint",
             dict(deck=XCYL, nsteps=1, path=str(io_dir / "chk")))]
    by_ranks = {}
    for name, (ranks, kind, deck) in WHOLE.items():
        job = ("steps", dict(deck=deck, nsteps=1)) if kind == "steps" else \
            ("amr_steps", dict(deck=deck, nsteps=1, dense=kind == "dense"))
        by_ranks.setdefault(ranks, []).append((name,) + job)
    cli = [str(io_dir / "inputs")] + CLI_ARGS
    # the restart waits for every rank to be done with the first run: a
    # level held whole makes no collective call, and rank 0 alone writes
    by_ranks[8] += [("cli", "cli", dict(argv=cli, cwd=str(io_dir / "cli"))),
                    ("barrier", "wait_for", dict(path=cli[0])),
                    ("cli restart", "cli", dict(argv=cli + [
                        f"amr.restart={io_dir / 'cli' / 'chk00001'}"],
                        cwd=str(io_dir / "cli1")))]
    by_ranks[1] = [("rfftn", "steps", dict(deck=RFFTN, nsteps=1))]

    def run_all():
        out = {2: launch.run(JOB, 2, dict(jobs=two), device="cpu",
                             timeout=TIMEOUT)}
        for ranks, jobs in by_ranks.items():
            out[ranks] = launch.run(JOB, ranks, dict(jobs=jobs),
                                    device="cpu", timeout=TIMEOUT)
        return out
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_all)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def reference(spawns):
    """incflo_tpu's unsharded rfftn deck with INCFLO_SPECTRAL=0, init + 1
    step, while the ranks run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INCFLO_SPECTRAL", "0")
        _, runs = tp.reference_run(RFFTN, 1)
    return runs[0]


@pytest.fixture(scope="module")
def ones(spawns, reference):
    """The EB AMR decks and the decks held whole on 1 rank, while the
    ranks run."""
    out = {name: one_rank(name, STEPS[name]) for name in AMR_DECKS}
    for name, (_, kind, deck) in WHOLE.items():
        out[name] = one_level(deck, 1) if kind == "steps" else \
            one_rank("dense" if kind == "dense" else "patch", 1, deck)
    return out


@pytest.fixture(scope="module")
def ranks(spawns, reference, ones):
    return spawns.result()


# ---------------------------------------------------------------------
# AMR with embedded boundaries on 2 ranks
# ---------------------------------------------------------------------

def test_eb_box_tree_on_two_ranks_matches_one(ranks, ones):
    """The EB box deck on 2 ranks: the base split, the box patch held
    whole on every rank with its own whole cut-cell geometry, against
    the port on 1 rank over 2 steps."""
    states, tallies = ones["box"]
    check_steps(ranks[2], "box", states, tallies)
    assert all(f == [True, False] for f in ranks[2][0]["box"]["split"])
    assert ranks[2][0]["box"]["comm"]["halo"] > 0


def test_eb_slab_patch_is_split_with_its_parent(ranks, ones):
    """The cut cells of a cylinder along x tag a band along y: its slab
    patch spans the whole x range and is split with its parent (its
    cut-cell arrays cut to the slab), regridded after each step, against
    the port on 1 rank."""
    states, tallies = ones["xcyl"]
    check_steps(ranks[2], "xcyl", states, tallies)
    assert all(f == [True, True] for f in ranks[2][0]["xcyl"]["split"])
    tree = states[-1][0]
    assert tree["axis"] == 1 and tree["bounds"][1] == [[0, 8, 0],
                                                       [16, 24, 8]]
    assert all(t["nodal_cycles"] > 0 for t in tallies[1:])


def test_dense_eb_on_two_ranks_matches_one(ranks, ones):
    """The dense fine level around a cylinder on 2 ranks: its masks,
    the cut cells tagged from the slabs, equal the 1-rank masks, its
    fields within 1e-11."""
    states, tallies = ones["dense"]
    check_steps(ranks[2], "dense", states, tallies)
    assert ranks[2][0]["dense"]["split"] == [[True], [True]]
    assert states[-1][1][1][0].any()


def test_eb_amr_checkpoint_on_two_ranks_restarts_on_one_and_two(ranks,
                                                                io_dir):
    """xcyl's tree written on 2 ranks after one step (the split levels
    one shard a rank): read back on 2 ranks it is the tree written and
    its next step the unbroken run's bit for bit; read on 1 rank, with
    the geometry rebuilt from the deck, it is the tree written."""
    got = ranks[2][0]["checkpoint"]
    _tree_equal(got["restarted_read"], got["written"], "2-rank read")
    _tree_equal(got["restarted"], got["unbroken"], "2-rank restart")
    path = io_dir / "chk"
    assert "Shards.p1.json" in os.listdir(path / "patch_level_1")
    amr = amr_of("xcyl")
    s = tio.read_checkpoint_patch(str(path), amr, amr.cfg)
    _tree_equal((amr.tree_meta(), tstate.patch_to_numpy(amr, s)),
                got["written"], "1-rank read")


# ---------------------------------------------------------------------
# levels held whole
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["nx 24 on 5", "slabs of 2 on 8"])
def test_level_that_does_not_split_is_held_whole(ranks, ones, name):
    """A level whose nx does not split into equal slabs (24 on 5 ranks)
    or whose slabs would be narrower than the 4-cell halo (2 on 8 ranks)
    is held whole on every rank: it runs as on one device, bit-equal to
    the port on 1 rank, with equal tallies and no exchange."""
    nranks = WHOLE[name][0]
    states, tallies = ones[name]
    res = ranks[nranks]
    assert len(res) == nranks
    for r in res:
        assert r[name]["split"] is False
        assert r[name]["tallies"] == tallies
        assert not any(r[name]["comm"].values()), r[name]["comm"]
    for g, w in zip(res[0][name]["states"], states):
        for f in tp.FIELDS + ("dt",):
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)


@pytest.mark.parametrize("name", ["patch tree", "dense base"])
def test_amr_base_that_does_not_split_runs_whole(ranks, ones, name):
    """An AMR deck whose base nx does not split over 8 ranks (16 into
    slabs of 2; 12 unevenly): the patch tree held whole on every rank
    (its slab patch over the whole x range with it), the dense fine
    level held whole, bit-equal to 1 rank with equal tallies."""
    states, tallies = ones[name]
    for r in ranks[8]:
        got = r[name]
        assert all(not any(f) for f in got["split"]), got["split"]
        assert got["tallies"] == tallies
        assert not any(got["comm"].values()), got["comm"]
    got = ranks[8][0][name]["states"]
    for g, w in zip(got, states):
        assert g[0] == w[0]
        for a, b in zip(g[1] if g[0] is not None else g[1][:1],
                        w[1] if w[0] is not None else w[1][:1]):
            for f in tp.FIELDS + ("dt",):
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        if g[0] is None:
            for m, n in zip(g[1][1], w[1][1]):
                assert np.array_equal(m, n)


def test_cli_on_a_level_held_whole(ranks, io_dir, tmp_path, monkeypatch):
    """The CLI on 8 ranks with a level held whole: rank 0 alone prints
    and writes the checkpoints, whole (Level_0.npz, no shard); a restart
    from chk00001 on 8 ranks gives chk00002 bit-equal to the unbroken
    one, and both equal the 1-rank driver's."""
    from incflo_torch import main as tmain
    res = [r["cli"] for r in ranks[8]] + [r["cli restart"] for r in ranks[8]]
    assert [r["rc"] for r in res] == [0] * 16
    assert all(r["stdout"] == "" for r in res[1:8] + res[9:])
    assert "Kinetic Energy" in res[0]["stdout"]
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert tmain.run([str(io_dir / "inputs")] + CLI_ARGS) == 0
    for d in (io_dir / "cli", io_dir / "cli1"):
        files = sorted(os.listdir(d / "chk00002"))
        assert files == ["Header", "Level_0.npz"], files
        for f in files:
            a, b = d / "chk00002" / f, tmp_path / "chk00002" / f
            if f.endswith(".npz"):
                x, y = np.load(a), np.load(b)
                for k in y.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert a.read_text() == b.read_text()


# ---------------------------------------------------------------------
# the rfftn direct solve under a mesh
# ---------------------------------------------------------------------

def test_rfftn_deck_on_two_ranks_runs_v_cycles_as_one_rank(ranks):
    """An axis of 264 cells under a mesh: the solves run V-cycles on the
    slabs (iterations in every kind), and 2 ranks match the 1-rank mesh
    within 1e-11 with equal tallies on every rank."""
    one = ranks[1][0]["rfftn"]
    assert all(one["tallies"][1][k] > 0 for k in KINDS), one["tallies"]
    for r in ranks[2]:
        assert r["rfftn"]["split"] and r["rfftn"]["tallies"] == \
            one["tallies"]
    for g, w in zip(ranks[2][0]["rfftn"]["states"], one["states"]):
        for f in tp.FIELDS + ("dt",):
            assert tp.rel(g[f], w[f]) <= 1e-11 if np.abs(w[f]).max() \
                else np.array_equal(g[f], w[f]), f


def test_rfftn_v_cycle_form_matches_incflo_tpu_without_spectral(
        ranks, reference):
    """The 1-rank mesh's V-cycle form against incflo_tpu with
    INCFLO_SPECTRAL=0, the path its spectral.usable takes for an rfftn
    symbol under its mesh: within 1e-10, with equal iterations."""
    states, iters = reference
    one = ranks[1][0]["rfftn"]
    assert one["tallies"][1:] == iters
    for g, w in zip(one["states"], states):
        for f in tp.FIELDS + ("dt",):
            assert tp.rel(g[f], w[f]) <= 1e-10 if np.abs(w[f]).max() \
                else np.array_equal(g[f], w[f]), f
