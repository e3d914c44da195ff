"""x-slab meshes whose x axis ends in walls, mass inflow or outflow, and
3D MOL under a mesh (incflo_torch/parallel, ROADMAP A14), on 2 gloo
ranks on the CPU: whole decks against 1 rank and against incflo_tpu,
the slab smoother forms with the level's x wall on an end rank, the
ghost fill of a slab, per-rank checkpoints and the CLI.

One spawn of 2 gloo ranks (incflo_torch.parallel.workers.several) runs
every job, in float64.  The decks, built inline from
tests/torch_parity.py and bench._deck:
  inflow       incflo_tpu's sharded inflow deck (tests/test_sharding.py
               :36-58): 16x16x8, mass inflow on x-lo, pressure outflow
               on x-hi, no-slip y walls, Godunov (the plain walled chain)
  channel      bench's channel without its cylinder on cubic cells
               (16x8x8 on 0.8x0.4x0.4, tests/test_torch_inflow.py's
               CUBIC; on its own cells the nodal V-cycles stall, ROADMAP
               C): MOL, tracer 1 through the inflow face, the MAC and
               tensor solves direct, the nodal one by V-cycles
  bingham      bingham_deck(16): no-slip x and y walls, a Bingham fluid,
               MOL, the velocity solve by V-cycle CG
  shear3d_mol  shear3d at 16 with MOL, x periodic

Tolerances:
  slab forms     exact: on a rank's rows the plain slab form makes the
                 operations of the whole-level plain call on the same
                 values
  ghost fill     exact: a copy of the neighbours' rows, the level's fill
                 beyond its own x faces
  steps          1e-11 relative to each field's max against the port on
                 1 rank, equal CG iterations, V-cycles and tensor-CG
                 iterations in every step on every rank (the dots and
                 means sum rank by rank, in another order); bingham
                 starts from rest, and its p, gp and mac_phi, rounding
                 noise, are held to 1e-11 of the deck's pressure scale
                 delp = 2 (tests/test_torch_rheology.py's floors)
  incflo_tpu     1e-10 of incflo_tpu's unsharded run of the inflow deck,
                 with its iterations
  checkpoint     the restart on 2 ranks bit-equal to the unbroken 2-rank
                 run, on 1 rank 1e-11; incflo_tpu's reader exact
  CLI            1e-11 relative against the unsharded driver's files
"""

import os

import numpy as np
import pytest
import torch

import torch_parity as tp
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops import smoother_kernels as sk
from incflo_torch.parallel import launch
from incflo_torch.utils import io as tio

JOB = "incflo_torch.parallel.workers:several"
TIMEOUT = 600.0
RANKS = 2
STEPS = 2
FIELDS = tp.FIELDS + ("dt",)
KINDS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")
CUBIC = ("geometry.prob_hi = 1.2 0.4 0.1", "geometry.prob_hi = 0.8 0.4 0.4")
PER, NEU, DIR = (int(tmg.SolverBC.PERIODIC), int(tmg.SolverBC.NEUMANN),
                 int(tmg.SolverBC.DIRICHLET))
INFLOW = """
amr.n_cell = 16 16 8
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 2. 1. 0.5
geometry.is_periodic = 0 0 1
xlo.type = "mi"
xlo.velocity = 1. 0. 0.
xhi.type = "po"
xhi.pressure = 0.0
ylo.type = "nsw"
yhi.type = "nsw"
incflo.probtype = 31
incflo.ic_u = 1.0
incflo.mu = 0.01
incflo.cfl = 0.45
incflo.use_godunov = true
incflo.diffusion_type = 1
incflo.initial_iterations = 0
incflo.do_initial_proj = 0
"""
CHANNEL = tp.channel_deck(16).replace(*CUBIC)
DECKS = {"inflow": INFLOW, "channel": CHANNEL,
         "bingham": tp.bingham_deck(16),
         "shear3d_mol": tp.shear3d_deck(16, extra=tp.MOL)}
REST_FLOORS = {"p": 2.0, "gp": 2.0 / 0.5, "mac_phi": 2.0}
FLOORS = {"bingham": REST_FLOORS}
CLI_ARGS = ["max_step=2", "amr.check_int=2", "amr.plot_int=2",
            "amr.plt_vort=1"]


def _random(shape, seed, scale=1.0, offset=0.0):
    return offset + scale * np.random.default_rng(seed).random(shape)


def _faces(cells, seed):
    """Face coefficients 0.5-1.5, the z faces periodic (face nz equals
    face 0)."""
    out = []
    for ax in range(3):
        shape = tuple(n + (ax == a) for a, n in enumerate(cells))
        b = _random(shape, seed + ax, 1.0, 0.5)
        if ax == 2:
            b[:, :, -1] = b[:, :, 0]
        out.append(b)
    return out


def slab_form_cases(nranks):
    """Per kind, every level of its hierarchies whose nranks-rank slabs
    are even, with a seeded x and b, the level's smoother coefficients
    and the calls whose halo fits: the cell forms on bingham_deck(16)'s
    velocity operator (Dirichlet x walls), its MAC operator (Neumann)
    and the channel's tracer operator (Dirichlet inflow, Neumann
    outflow); the nodal forms on the cubic channel's nodal hierarchy
    (Neumann inflow, the Dirichlet outflow plane) and bingham's
    (Neumann)."""
    bingham = tp.port_sim(DECKS["bingham"])
    channel = tp.port_sim(CHANNEL)
    cells_b, cells_c = bingham.grid.n_cell, channel.grid.n_cell
    t = torch.as_tensor
    solvers = {
        "cell": [
            tmg.CellSolver(bingham.grid.dx, (DIR, DIR, PER), (DIR, DIR, PER),
                           1.0, 2e-3, t(_random(cells_b, 11, 1.0, 1.0)),
                           [t(b) for b in _faces(cells_b, 3)], direct=False),
            tmg.CellSolver(bingham.grid.dx, (NEU, NEU, PER), (NEU, NEU, PER),
                           0.0, 1.0, None, [t(b) for b in _faces(cells_b, 5)],
                           direct=False),
            tmg.CellSolver(channel.grid.dx, (DIR, NEU, PER), (NEU, NEU, PER),
                           1.0, 2e-3, t(_random(cells_c, 13, 1.0, 1.0)),
                           [t(b) for b in _faces(cells_c, 7)],
                           direct=False)],
        "nodal": [
            tmg.NodalSolver(channel.grid.dx, (False, False, True),
                            (NEU, NEU, PER), (DIR, NEU, PER),
                            t(_random(cells_c, 21, 1.0, 0.5)), direct=False),
            tmg.NodalSolver(bingham.grid.dx, (False, False, True),
                            (NEU, NEU, PER), (NEU, NEU, PER),
                            t(_random(cells_b, 23, 1.0, 0.5)),
                            direct=False)]}
    cases = {}
    for kind, group in solvers.items():
        out = []
        for k, solver in enumerate(group):
            for li, lev in enumerate(solver.levels):
                shape = tuple(solver.diags[li].shape)
                cells = shape[0] - (kind == "nodal")
                nxl = cells // nranks
                if nxl % 2 or nxl == 0:
                    continue
                with_res = (nxl - 2) // 2
                c = {"kind": kind, "x": _random(shape, 100 + 10 * k + li),
                     "b": _random(shape, 200 + 10 * k + li, 2.0, -1.0),
                     "nxl": nxl,
                     "calls": ([(with_res, True)] if with_res else [])
                     + [(nxl // 2, False), (0, True)]}
                if kind == "cell":
                    dinvs, fhis, fwalls = solver.smoother_coefs()
                    c.update(diag=solver.diags[li].numpy(),
                             dinv=dinvs[li].numpy(),
                             F=[f.numpy() for f in fhis[li]],
                             Fwall=[None if w is None else w.numpy()
                                    for w in fwalls[li]],
                             bc=(lev.bc_lo, lev.bc_hi))
                else:
                    c.update(sigma=solver.sigmas[li].numpy(),
                             dinv=solver.dinvs[li].numpy(), dx=lev.dx,
                             bc=(lev.bc_lo, lev.bc_hi))
                out.append(c)
        cases[kind] = out
    return cases


def check_slab_forms(results, cases, kind):
    """Every rank's rows of every call bit-equal to the whole-level plain
    call's (SlabMesh.rows: the last rank's extra node row)."""
    t = torch.as_tensor
    first = 0 if kind == "cell" else len(cases["cell"])
    nranks = len(results)
    walled_ranks = set()
    for k, c in enumerate(cases[kind]):
        for j, (n, want) in enumerate(c["calls"]):
            if kind == "cell":
                ref = sk.cell_smooth_plain(
                    t(c["x"]), t(c["b"]), t(c["diag"]), t(c["dinv"]),
                    [t(f) for f in c["F"]], n, want, c["bc"],
                    [None if w is None else t(w) for w in c["Fwall"]])
            else:
                ref = sk.nodal_smooth_plain(
                    t(c["x"]), t(c["b"]), t(c["sigma"]), t(c["dinv"]),
                    c["dx"], n, want, c["bc"])
            for r, res in enumerate(results):
                x, rr = res["slab_forms"][first + k][j]
                lo = r * c["nxl"]
                rows = slice(lo, lo + x.shape[0])
                assert x.shape[0] == c["nxl"] + (
                    kind == "nodal" and r == nranks - 1), (k, r, x.shape)
                assert np.array_equal(x, ref[0].numpy()[rows]), (k, j, r)
                assert (rr is None) == (not want)
                if want:
                    assert np.array_equal(rr, ref[1].numpy()[rows]), \
                        (k, j, r)
                walled_ranks.add(r)
    assert walled_ranks == set(range(nranks))


def ghost_inputs(deck, seed):
    sim = tp.port_sim(deck)
    cells = sim.grid.cell_shape
    return dict(vel=_random(cells + (3,), seed, 2.0, -1.0),
                rho=_random(cells, seed + 1, 0.5, 1.0),
                tra=_random(cells + (sim.cfg.ntrac,), seed + 2),
                ng=sim.cfg.nghost_state())


def check_ghost_fill(results, deck, inputs, key):
    """Each rank's grown slab equals the whole level's grown rows."""
    sim = tp.port_sim(deck)
    t = torch.as_tensor
    ng = inputs["ng"]
    whole = {"velocity": sim.grow_vel(t(inputs["vel"]), ng),
             "density": sim.grow_rho(t(inputs["rho"]), ng),
             "tracer": sim.grow_tra(t(inputs["tra"]), ng)}
    nxl = sim.grid.n_cell[0] // len(results)
    for r, res in enumerate(results):
        for f, w in whole.items():
            got = res[key][f]
            assert np.array_equal(got, w.numpy()[r * nxl:
                                                 r * nxl + nxl + 2 * ng]), \
                (key, r, f)


def one_rank(deck, steps=STEPS):
    """The port on one rank: states after init and each step, and the
    tallies of each step (the first init's)."""
    sim = tp.port_sim(deck)
    tmg.reset_counts()
    s = sim.init_state()
    states = [tstate.sim_to_numpy(s)]
    tallies = [{k: tmg.COUNTS[k] for k in KINDS}]
    for _ in range(steps):
        before = dict(tmg.COUNTS)
        s = sim.advance(s)
        tallies.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        states.append(tstate.sim_to_numpy(s))
    return states, tallies


def check_run(results, key, states, tol, floors=None, tallies=None):
    """Rank 0's whole-level states against `states`, each field relative
    to the reference's max (or floors[field]); every rank's tallies
    equal and, given, equal to `tallies`."""
    floors = floors or {}
    got = results[0][key]["states"]
    assert len(got) == len(states)
    for i, (a, b) in enumerate(zip(got, states)):
        for f in FIELDS:
            assert a[f].shape == np.asarray(b[f]).shape, (i, f)
            scale = max(float(np.abs(b[f]).max()), floors.get(f, 0.0),
                        1e-300)
            err = float(np.abs(a[f] - b[f]).max()) / scale
            assert err <= tol, (key, i, f, err)
        assert int(a["step"]) == i
    ranks = [r[key]["tallies"] for r in results]
    assert all(t == ranks[0] for t in ranks), ranks
    if tallies is not None:
        assert ranks[0] == tallies, (ranks[0], tallies)


def _rel_fields(got, want, fields=FIELDS):
    return {f: float(np.abs(got[f] - want[f]).max()
                     / max(float(np.abs(want[f]).max()), 1e-300))
            for f in fields}


@pytest.fixture(scope="module")
def cases():
    return slab_form_cases(RANKS)


@pytest.fixture(scope="module")
def ghosts():
    return {name: ghost_inputs(DECKS[name], 40 + k)
            for k, name in enumerate(("channel", "bingham"))}


@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("xwalls")
    (root / "inputs").write_text(CHANNEL)
    (root / "cli").mkdir()
    return root


@pytest.fixture(scope="module")
def two_ranks(cases, ghosts, io_dir):
    """One spawn of 2 gloo ranks: the slab forms, the ghost fills, init +
    STEPS steps of every deck, the channel's per-rank checkpoint after
    one step with its restarts, and the CLI on the channel."""
    jobs = [("slab_forms", "slab_smoothers",
             dict(cases=cases["cell"] + cases["nodal"]))]
    jobs += [(f"ghost {name}", "ghost_fill", dict(deck=DECKS[name], **kw))
             for name, kw in ghosts.items()]
    jobs += [(name, "steps", dict(deck=deck, nsteps=STEPS))
             for name, deck in DECKS.items()]
    jobs += [("checkpoint", "checkpoint",
              dict(deck=CHANNEL, nsteps=1, path=str(io_dir / "sharded"))),
             ("cli", "cli", dict(argv=[str(io_dir / "inputs")] + CLI_ARGS,
                                 cwd=str(io_dir / "cli")))]
    return launch.run(JOB, RANKS, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


# ---------------------------------------------------------------------
# the slab forms and the ghost fill
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cell", "nodal"])
def test_slab_forms_with_x_walls_equal_whole_level_rows(two_ranks, cases,
                                                        kind):
    """Each kind at every level of its hierarchies with even 2-rank slabs
    (nxl 8, 4 and 2): rank 0 holds the level's low x wall, rank 1 its
    high one (and, for nodes, node nx); bit for bit the whole level's
    rows."""
    assert {c["nxl"] for c in cases[kind]} == {8, 4, 2}
    check_slab_forms(two_ranks, cases, kind)


def test_ghost_fill_on_a_slab_equals_whole_level(two_ranks, ghosts):
    """bcs.grow on each rank's slab: the channel's inflow profile and
    tracer value at x-lo, its outflow extrapolation at x-hi, bingham's
    no-slip x walls, y walls and the periodic z after them."""
    for name, inputs in ghosts.items():
        check_ghost_fill(two_ranks, DECKS[name], inputs, f"ghost {name}")


# ---------------------------------------------------------------------
# whole decks
# ---------------------------------------------------------------------

@pytest.mark.parametrize("deck", list(DECKS))
def test_deck_on_two_ranks_matches_one(two_ranks, deck):
    """Init + 2 steps on 2 ranks against 1 rank, equal tallies in every
    step on every rank."""
    states, tallies = one_rank(DECKS[deck])
    if deck != "shear3d_mol":
        assert sum(t["nodal_cycles"] for t in tallies) > 0
    check_run(two_ranks, deck, states, 1e-11, FLOORS.get(deck), tallies)


def test_inflow_deck_on_two_ranks_matches_incflo_tpu(two_ranks):
    """incflo_tpu's sharded inflow deck: the 2-rank run against
    incflo_tpu's unsharded one and its solver iterations."""
    _, runs = tp.reference_run(INFLOW, STEPS)
    states, iters = runs[0]
    check_run(two_ranks, "inflow", states, 1e-10)
    assert two_ranks[0]["inflow"]["tallies"][1:] == iters


# ---------------------------------------------------------------------
# per-rank checkpoints and the CLI
# ---------------------------------------------------------------------

def test_channel_checkpoint_restarts(two_ranks, io_dir):
    """The channel written on 2 ranks after one step (rank 1's block of p
    holds node nx): incflo_tpu's reader returns the state written, bit
    for bit; the next step after a restart on 2 ranks is the unbroken
    2-rank run's step 2 bit for bit, on 1 rank within 1e-11."""
    import jax.numpy as jnp
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.utils import io as jio
    path = io_dir / "sharded"
    nx = tp.port_sim(CHANNEL).grid.n_cell[0]
    shard = np.load(path / "Level_0.shard1.npz")
    assert shard["p"].shape[0] == nx // 2 + 1
    chk = two_ranks[0]["checkpoint"]
    unbroken = two_ranks[0]["channel"]["states"]
    for f in FIELDS + ("step",):
        assert np.array_equal(chk["written"][f], unbroken[1][f]), f
        assert np.array_equal(chk["restarted"][f], unbroken[2][f]), f
    s = jio.read_checkpoint(str(path), JConfig.from_text(CHANNEL),
                            jnp.float64)
    for f in tp.FIELDS:
        assert np.array_equal(np.asarray(getattr(s.level, f)),
                              chk["written"][f]), f
    sim = tp.port_sim(CHANNEL)
    r = tio.read_checkpoint(str(path), sim.cfg, torch.float64, "cpu")
    errs = _rel_fields(tstate.sim_to_numpy(sim.advance(r)), unbroken[2])
    assert max(errs.values()) <= 1e-11, errs


def test_cli_runs_the_channel_on_two_ranks(two_ranks, io_dir, tmp_path,
                                           monkeypatch):
    """python -m incflo_torch.main on the 2-rank mesh (workers.cli) runs
    the channel deck: rank 0 prints and writes the plotfiles, each rank
    its checkpoint shard, and the files hold what the unsharded driver
    writes, to 1e-11 of each field's (a vector's) largest value."""
    from incflo_torch import main as tmain
    res = [r["cli"] for r in two_ranks]
    assert [r["rc"] for r in res] == [0, 0]
    assert res[1]["stdout"] == ""
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert tmain.run([str(io_dir / "inputs")] + CLI_ARGS) == 0
    d = io_dir / "cli"
    assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path))
    assert "Shards.p1.json" in os.listdir(d / "chk00002")
    got = np.load(d / "plt00002" / "Level_0.npz")
    ref = np.load(tmp_path / "plt00002" / "Level_0.npz")
    assert sorted(got.files) == sorted(ref.files) and "vort" in ref.files
    group = lambda k: k[:-1] if k[:-1] in ("vel", "gp") else k
    scale = {}
    for k in ref.files:
        scale[group(k)] = max(scale.get(group(k), 0.0),
                              float(np.abs(ref[k]).max()))
    for k in ref.files:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-11 * max(scale[group(k)], 1e-300), (k, err)
    cfg = incflo_torch.IncfloConfig.from_text(CHANNEL)
    s = tio.read_checkpoint(str(d / "chk00002"), cfg, torch.float64, "cpu")
    r = tio.read_checkpoint(str(tmp_path / "chk00002"), cfg, torch.float64,
                            "cpu")
    for f in ("velocity", "tracer", "p", "gp", "mac_phi"):
        a, b = getattr(s.level, f).numpy(), getattr(r.level, f).numpy()
        assert a.shape == b.shape, f
        assert float(np.abs(a - b).max()) <= 1e-11 * max(
            float(np.abs(b).max()), 1e-300), f
