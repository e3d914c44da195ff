"""2D decks and the two Godunov options on an x-slab mesh
(incflo_torch/parallel, ROADMAP A14): the 2D slab sweeps and EB forms of
a rank's slab against the whole level's rows, incflo_tpu's two sharded
2D decks (tests/test_sharding.py), rt2d with multigrid and walls, and 3D
decks with godunov_use_forces_in_trans or use_mac_phi_in_godunov on 2
gloo ranks against 1 rank and against incflo_tpu, a 2D per-rank
checkpoint and the CLI on 2 ranks, on the CPU.

One spawn of 2 gloo ranks (incflo_torch.parallel.workers.several) runs
every job, in float64.  The decks, built inline:
  tgv2d_godunov  tests/test_sharding.py:20-33 with Godunov: 32^2 fully
                 periodic, probtype 1, direct solves
  tgv2d_mol      the same deck with MOL
  eb_cylinder    tests/test_sharding.py:172-205: 32^2 fully periodic,
                 flow inside a cylinder of radius 1 in a 4 x 4 box driven
                 by delp (2, 0), fixed_dt 0.01, MOL-EB, the cut-cell
                 velocity solve, the 9-point EB nodal solver; the
                 cylinder spans both slabs
  rt2d           chip_smoke.py's rt2d_deck at 16 x 32: periodic x, slip y
                 walls, variable density, 2D V-cycles on the slabs
  shear3d_uft    shear3d 16x16x8 with godunov_use_forces_in_trans: the
                 plain Godunov chain for predict and advect
  shear3d_mac_phi  shear3d 16x16x8 with use_mac_phi_in_godunov: predict
                 by the plain chain, advect by advect_sharded
  rt_mac_phi     bench's rt at 16x16x32 with use_mac_phi_in_godunov: the
                 walled chain, multigrid on the slabs; its MAC-phi face
                 gradient crosses the slab faces (Simulation.
                 convective_term_godunov builds that operator on the
                 mesh)

Tolerances:
  slab forms   exact: the same operations on the same values (the 2D
               cell and nodal sweeps at every slab level, with one halo
               exchange of x and b a call; the 2D EB arrays, MOL-EB
               faces and fluxes, redistribution, the 9-point sweeps)
  steps        1e-11 relative to each field's max against the port on 1
               rank, equal CG iterations, V-cycles and tensor-CG
               iterations in every step on every rank
  incflo_tpu   1e-10 of incflo_tpu's unsharded run (init + 2 steps),
               with its iterations
  checkpoint   the restart on 2 ranks bit-equal to the unbroken 2-rank
               run, on 1 rank 1e-11
  CLI          1e-11 relative against the unsharded driver's files
"""

import os

import numpy as np
import pytest
import torch

import bench
import torch_parity as tp
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.ops import multigrid as tmg
from incflo_torch.parallel import launch, workers
from incflo_torch.utils import io as tio
from test_torch_sharded_eb import (FIELDS, JOB, TIMEOUT, check_forms,
                                   form_inputs, one_rank, with_calls)
from test_torch_sharded_xwalls import check_run

RANKS = 2
PER = int(tmg.SolverBC.PERIODIC)
NEU = int(tmg.SolverBC.NEUMANN)
DIR = int(tmg.SolverBC.DIRICHLET)
STEPS = 2
MAC_PHI = "incflo.use_mac_phi_in_godunov = true\n"
UFT = "incflo.godunov_use_forces_in_trans = true\n"


def tgv2d_deck(godunov):
    """tests/test_sharding.py:20-33 (n = 32)."""
    return f"""
amr.n_cell = 32 32
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1. 1.
geometry.is_periodic = 1 1
incflo.probtype = 1
incflo.mu = 0.01
incflo.cfl = 0.45
incflo.use_godunov = {"true" if godunov else "false"}
incflo.diffusion_type = 1
incflo.initial_iterations = 0
incflo.do_initial_proj = 0
"""


EB_CYLINDER = """
amr.n_cell = 32 32
geometry.prob_lo = 0. 0.
geometry.prob_hi = 4. 4.
geometry.is_periodic = 1 1
incflo.delp = 2. 0.
incflo.geometry = "cylinder"
cylinder.internal_flow = true
cylinder.radius = 1.
cylinder.direction = 2
cylinder.center = 2. 2. 0.
incflo.mu = 1.
incflo.fixed_dt = 0.01
incflo.use_godunov = false
incflo.diffusion_type = 1
incflo.initial_iterations = 0
incflo.do_initial_proj = 0
"""

# chip_smoke.rt2d_deck(32, "float64")
RT2D = """
incflo.initial_iterations = 0
incflo.dtype = float64
mac_proj.mg_rtol = 1e-11
mac_proj.mg_atol = 1e-14
nodal_proj.mg_rtol = 1e-11
nodal_proj.mg_atol = 1e-14
scalar_diffusion.mg_rtol = 1e-11
scalar_diffusion.mg_atol = 1e-14
tensor_diffusion.mg_rtol = 1e-11
tensor_diffusion.mg_atol = 1e-14
stop_time = -1
max_step = 1000000
amr.n_cell = 16 32
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
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.diffusion_type = 1
incflo.cfl = 0.9
incflo.init_shrink = 1.0
"""

DECKS = {"tgv2d_godunov": tgv2d_deck(True),
         "tgv2d_mol": tgv2d_deck(False),
         "eb_cylinder": EB_CYLINDER,
         "rt2d": RT2D,
         "shear3d_uft": tp.shear3d_deck(16, extra=UFT),
         "shear3d_mac_phi": tp.shear3d_deck(16, extra=MAC_PHI),
         "rt_mac_phi": bench._deck("rt", 32, "float64")[0] + MAC_PHI}
TWO_D = ("tgv2d_godunov", "tgv2d_mol", "eb_cylinder", "rt2d")
OPTIONS = ("shear3d_uft", "shear3d_mac_phi", "rt_mac_phi")
# the Godunov functions whose calls the ranks count (workers.
# counted_steps): the kernel wrappers of a fully periodic 3D deck and the
# plain chains
GODUNOV_CALLS = ("predict", "predict_sharded", "advect", "advect_sharded",
                 "predict_plain", "advect_plain")
CLI_ARGS = ["max_step=2", "amr.check_int=2", "amr.plot_int=2",
            "amr.plt_vort=1"]


def _random(shape, seed, scale=1.0, offset=0.0):
    return offset + scale * np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------
# the 2D slab sweeps: seeded operators on 32 x 16 levels
# ---------------------------------------------------------------------

def cell_case(bc_lo, bc_hi, seed, ebc=False, comps=None):
    """A CellSolver case of workers._solver: seeded Helmholtz
    coefficients on 32 x 16 cells (x face 0 differs from face n), with
    the EB wall term and a component axis where asked."""
    cells = (32, 16)
    tail = () if comps is None else (comps,)
    bcoef = [_random(tuple(n + (a == ax) for a, n in enumerate(cells))
                     + tail, seed + ax, 1.0, 0.5) for ax in range(2)]
    return dict(kind="cell", dx=(1.0 / 32, 0.7 / 16), bc_lo=bc_lo,
                bc_hi=bc_hi, alpha=1.0, beta=0.3,
                acoef=_random(cells + tail, seed + 5, 1.0, 1.0),
                bcoef=bcoef,
                ebc=_random(cells + tail, seed + 6, 2.0) if ebc else None)


def nodal_case(bc_lo, bc_hi, seed):
    """A NodalSolver case of workers._solver: seeded sigma on 32 x 16
    cells."""
    return dict(kind="nodal", dx=(1.0 / 32, 0.7 / 16),
                periodic=tuple(b == PER for b in bc_lo), bc_lo=bc_lo,
                bc_hi=bc_hi, sigma=_random((32, 16), seed, 1.0, 0.5))


def sweep_cases(nranks):
    """Cell and nodal cases -- periodic x with y walls, x walls (the end
    ranks hold the level's x faces, Neumann and Dirichlet), the EB wall
    term with two components -- each with a seeded x and b at every
    level of its hierarchy and the calls whose halo fits the nranks-rank
    slabs (workers.sweep_levels)."""
    cases = [cell_case((PER, NEU), (PER, DIR), 1),
             cell_case((NEU, PER), (DIR, PER), 2),
             cell_case((PER, PER), (PER, PER), 3, ebc=True, comps=2),
             nodal_case((PER, NEU), (PER, DIR), 4),
             nodal_case((DIR, PER), (NEU, PER), 5),
             nodal_case((NEU, NEU), (DIR, NEU), 6)]
    return [workers.sweep_levels(c, nranks, 100 * k)
            for k, c in enumerate(cases)]


def check_sweeps(results, key, cases):
    """Every rank's rows of x and of the residual after each call equal
    the whole level's bit for bit at every slab level (the levels below
    run whole on every rank: equal to the whole level); a repeated call
    on a slab level makes one halo exchange and one 2D slab sweep call
    (workers.sweep_mismatches).  Returns the slab levels of each case."""
    bad, n_slabs = workers.sweep_mismatches(
        results, key, cases, workers.solver_sweeps(None, cases))
    assert not bad, bad[:10]
    return n_slabs


# ---------------------------------------------------------------------
# the spawn
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps():
    return sweep_cases(RANKS)


@pytest.fixture(scope="module")
def forms():
    return with_calls(form_inputs("eb_cylinder", 300, DECKS), RANKS)


@pytest.fixture(scope="module")
def references():
    """incflo_tpu's unsharded runs (init + STEPS steps, with their solver
    iterations) of tgv2d_godunov and eb_cylinder."""
    return {name: tp.reference_run(DECKS[name], STEPS)[1][0]
            for name in ("tgv2d_godunov", "eb_cylinder")}


@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_2d")
    (root / "inputs").write_text(DECKS["tgv2d_godunov"])
    (root / "cli").mkdir()
    return root


@pytest.fixture(scope="module")
def two_ranks(sweeps, forms, references, io_dir):
    """One spawn of 2 gloo ranks: the 2D slab sweeps, the EB cylinder's
    slab forms, init + STEPS steps of every deck (the Godunov calls
    counted), tgv2d_godunov from incflo_tpu's initial state, its per-rank
    checkpoint after one step with the restart, and the CLI on it."""
    jobs = [("sweeps", "solver_sweeps", dict(cases=sweeps)),
            ("forms", "eb_forms", dict(deck=DECKS["eb_cylinder"], **forms))]
    jobs += [(name, "counted_steps", dict(deck=deck, nsteps=STEPS,
                                          count=GODUNOV_CALLS))
             for name, deck in DECKS.items()]
    jobs += [("carried", "steps",
              dict(deck=DECKS["tgv2d_godunov"], nsteps=STEPS,
                   start=references["tgv2d_godunov"][0][0])),
             ("checkpoint", "checkpoint",
              dict(deck=DECKS["tgv2d_godunov"], nsteps=1,
                   path=str(io_dir / "sharded"))),
             ("cli", "cli", dict(argv=[str(io_dir / "inputs")] + CLI_ARGS,
                                 cwd=str(io_dir / "cli")))]
    return launch.run(JOB, RANKS, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


# ---------------------------------------------------------------------
# the slab forms
# ---------------------------------------------------------------------

def test_2d_slab_sweeps_equal_whole_level_rows(two_ranks, sweeps):
    """The 2D cell and nodal sweeps (+ residual) on 2 ranks, periodic and
    with walls on y and on x, the EB wall term with x face 0 unlike face
    n: every slab level's rows are the whole level's bit for bit, each
    call one halo exchange of x and b."""
    n_slabs = check_sweeps(two_ranks, "sweeps", sweeps)
    assert min(n_slabs) >= 2, n_slabs


def test_2d_eb_forms_on_a_slab_equal_whole_level_rows(two_ranks, forms):
    """The EB cylinder's slab EBArrays, MOL-EB face velocities and
    fluxes, cut-cell rate and redistribution, small-cell correction,
    strain rate and viscosity, and the 9-point EB nodal sweeps at every
    level, on 2 ranks (the cylinder spans both slabs)."""
    check_forms(two_ranks, "forms", "eb_cylinder", forms, DECKS)


# ---------------------------------------------------------------------
# whole decks
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", TWO_D)
def test_2d_deck_on_two_ranks_matches_one(two_ranks, name):
    """Init + 2 steps of a 2D deck on 2 ranks against 1 rank, equal
    tallies in every step on every rank; the 2D multigrid decks sweep
    their slab levels (multigrid.SLAB_2D)."""
    states, tallies = one_rank(name, STEPS, decks=DECKS)
    check_run(two_ranks, name, states, 1e-11, tallies=tallies)
    slab_2d = [r[name]["slab_2d_calls"] for r in two_ranks]
    if name in ("eb_cylinder", "rt2d"):
        assert sum(t["cell_iters"] for t in tallies) > 0
        assert sum(t["nodal_cycles"] for t in tallies) > 0
        assert all(c["cell"] > 0 for c in slab_2d), slab_2d
    if name == "rt2d":
        assert all(c["nodal"] > 0 for c in slab_2d), slab_2d
    if name == "eb_cylinder":
        assert all(r[name]["stencil_slab_calls"] > 0 for r in two_ranks)


@pytest.mark.parametrize("name", OPTIONS)
def test_godunov_option_on_two_ranks_matches_one(two_ranks, name):
    """Init + 2 steps of a 3D deck with a Godunov option on 2 ranks
    against 1 rank, equal tallies; the dispatch of one rank: forces in
    the traces take the plain chain for predict and advect, the MAC-phi
    warm start of a periodic deck predicts by the plain chain and
    advects by advect_sharded (no predict kernel wrapper called)."""
    states, tallies = one_rank(name, STEPS, decks=DECKS)
    check_run(two_ranks, name, states, 1e-11, tallies=tallies)
    for r in two_ranks:
        calls = r[name]["calls"]
        assert calls["predict"] == calls["predict_sharded"] == 0, calls
        assert calls["advect"] == 0, calls
        assert calls["predict_plain"] > 0, calls
        if name == "shear3d_mac_phi":
            assert calls["advect_sharded"] > 0, calls
            assert calls["advect_plain"] == 0, calls
        else:
            assert calls["advect_sharded"] == 0, calls
            assert calls["advect_plain"] > 0, calls
    if name == "rt_mac_phi":
        assert float(np.abs(states[-1]["mac_phi"]).max()) > 0.0
        assert sum(t["cell_iters"] for t in tallies) > 0


def test_2d_decks_on_two_ranks_match_incflo_tpu(two_ranks, references):
    """tgv2d_godunov and eb_cylinder on 2 ranks from the port's own init
    against incflo_tpu's unsharded run, with its iterations, and
    tgv2d_godunov from incflo_tpu's initial state (carried over through
    state.sim_from_numpy) likewise."""
    for key, name in (("tgv2d_godunov", "tgv2d_godunov"),
                      ("eb_cylinder", "eb_cylinder"),
                      ("carried", "tgv2d_godunov")):
        states, iters = references[name]
        check_run(two_ranks, key, states, 1e-10)
        assert two_ranks[0][key]["tallies"][1:] == iters, key
    assert sum(t["cell_iters"] for t in references["eb_cylinder"][1]) > 0


# ---------------------------------------------------------------------
# the per-rank checkpoint and the CLI
# ---------------------------------------------------------------------

def test_2d_checkpoint_and_cli_on_two_ranks(two_ranks, io_dir, tmp_path,
                                            monkeypatch):
    """tgv2d_godunov written on 2 ranks after one step: the next step
    after a restart on 2 ranks is the unbroken run's step 2 bit for bit,
    on 1 rank within 1e-11.  python -m incflo_torch.main on the 2-rank
    mesh runs the deck: rank 0 prints and writes the plotfiles (vort
    computed on the slabs and gathered), each rank its checkpoint shard,
    and the files hold what the unsharded driver writes to 1e-11 of each
    field's (a vector's) largest value."""
    from incflo_torch import main as tmain
    path = io_dir / "sharded"
    shard = np.load(path / "Level_0.shard1.npz")
    assert shard["velocity"].shape == (16, 32, 2)
    chk = two_ranks[0]["checkpoint"]
    unbroken = two_ranks[0]["tgv2d_godunov"]["states"]
    for f in FIELDS + ("step",):
        assert np.array_equal(chk["written"][f], unbroken[1][f]), f
        assert np.array_equal(chk["restarted"][f], unbroken[2][f]), f
    sim = tp.port_sim(DECKS["tgv2d_godunov"])
    r = tio.read_checkpoint(str(path), sim.cfg, torch.float64, "cpu")
    got = tstate.sim_to_numpy(sim.advance(r))
    for f in FIELDS:
        err = float(np.abs(got[f] - unbroken[2][f]).max()
                    / max(float(np.abs(unbroken[2][f]).max()), 1e-300))
        assert err <= 1e-11, (f, err)

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
    assert sorted(got.files) == sorted(ref.files)
    assert "vort" in ref.files
    group = lambda k: k[:-1] if k[:-1] in ("vel", "gp") else k
    scale = {}
    for k in ref.files:
        scale[group(k)] = max(scale.get(group(k), 0.0),
                              float(np.abs(ref[k]).max()))
    for k in ref.files:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-11 * max(scale[group(k)], 1e-300), (k, err)
    cfg = incflo_torch.IncfloConfig.from_text(DECKS["tgv2d_godunov"])
    s = tio.read_checkpoint(str(d / "chk00002"), cfg, torch.float64, "cpu")
    r = tio.read_checkpoint(str(tmp_path / "chk00002"), cfg, torch.float64,
                            "cpu")
    for f in ("velocity", "p", "gp", "mac_phi"):
        a, b = getattr(s.level, f).numpy(), getattr(r.level, f).numpy()
        assert a.shape == b.shape, f
        assert float(np.abs(a - b).max()) <= 1e-11 * max(
            float(np.abs(b).max()), 1e-300), f
