"""Multigrid on an x-slab mesh (incflo_torch/parallel, ops/multigrid.py,
the slab forms of ops/smoother_kernels.py) and the decks it lets run
split over ranks, on the CPU.

One spawn of 2 gloo ranks runs every 2-rank job
(incflo_torch.parallel.workers.several), one of 4 ranks the rt deck with
slabs of 4 cells, whose nodal hierarchy is too narrow for its smoothers'
halos and runs whole on every rank.  All in float64, inputs from seeded
numpy, decks built inline.

Tolerances:
  slab smoothers       exact: on a rank's rows, the plain slab form makes
                       the operations of the whole-level plain call on
                       the same values
  slab solves          1e-12 relative to the solution's max, equal
                       iterations: the V-cycles are the whole level's bit
                       for bit; the CG's dots and the singular means sum
                       rank by rank, in another order
  steps, 2 or 4 ranks  1e-11 relative to each field's max against the
                       port on 1 rank, equal CG iterations, V-cycles and
                       tensor-CG iterations in every step on every rank;
                       rt also within 1e-10 of incflo_tpu's unsharded
                       step with its iterations.  The Bingham deck starts
                       from rest: its p, gp and mac_phi are rounding
                       noise, held to 1e-11 of the deck's pressure scale
                       delp = 2 (tests/test_torch_rheology.py's floors)
"""

import numpy as np
import pytest
import torch

import bench
import torch_parity as tp
from incflo_torch import state as tstate
from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops import smoother_kernels as sk
from incflo_torch.parallel import launch
from incflo_torch.utils import io as tio

JOB = "incflo_torch.parallel.workers:several"
TIMEOUT = 300.0
STEPS = 2
FIELDS = tp.FIELDS + ("dt",)
KINDS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")
CELLS = (16, 16, 32)
DX = (0.5 / 16, 0.5 / 16, 1.0 / 32)
PER, NEU = int(tmg.SolverBC.PERIODIC), int(tmg.SolverBC.NEUMANN)
# the y and z solver BCs of the operators: fully periodic, and slip z
# walls (Neumann, as rt's projections)
BCS = {"periodic": ((PER,) * 3, (PER,) * 3),
       "slip z": ((PER, PER, NEU), (PER, PER, NEU))}
VD = ("incflo.constant_density = false\nincflo.advect_tracer = true\n"
      "incflo.mu_s = 0.0002\n")
REST_FLOORS = {"p": 2.0, "gp": 2.0 / 0.5, "mac_phi": 2.0}


def _bingham_y(n):
    """poiseuille_cyl_bingham without its cylinder, periodic x and z,
    no-slip y walls, Godunov."""
    text = tp._without(bench._deck("poiseuille_cyl_bingham", n,
                                   "float64")[0],
                       tp._CYLINDER + ("geometry.is_periodic",))
    return text + ('geometry.is_periodic = 1 0 1\nylo.type = "nsw"\n'
                   'yhi.type = "nsw"\nincflo.use_godunov = true\n')


RT = bench._deck("rt", 32, "float64")[0]            # 16 x 16 x 32
DECKS = {"shear3d_vd": bench._deck("shear3d", 16, "float64")[0] + VD,
         "bubble": tp.bubble_deck(16),
         "bingham_y": _bingham_y(16),
         "explicit": bench._deck("shear3d", 16, "float64")[0] + VD
         + tp.EXPLICIT}
FLOORS = {"bingham_y": REST_FLOORS}


def _random(shape, seed, scale=1.0, offset=0.0):
    return offset + scale * np.random.default_rng(seed).random(shape)


def _faces(seed):
    """Face coefficients of a variable-coefficient level, 0.5-1.5, the
    x faces periodic (face nx equals face 0)."""
    out = []
    for ax in range(3):
        shape = tuple(n + (ax == a) for a, n in enumerate(CELLS))
        b = _random(shape, seed + ax, 1.0, 0.5)
        if ax == 0:
            b[-1] = b[0]
        out.append(b)
    return out


def _cell_solver(bc, helmholtz):
    """The whole level's cell solver: the MAC form (alpha 0) or the
    Helmholtz form (alpha 1, a = rho, beta = dt)."""
    acoef = torch.as_tensor(_random(CELLS, 11, 1.0, 1.0)) if helmholtz \
        else None
    return tmg.CellSolver(DX, *bc, 1.0 if helmholtz else 0.0,
                          2e-3 if helmholtz else 1.0, acoef,
                          [torch.as_tensor(b) for b in _faces(3)],
                          direct=False)


def _nodal_solver(bc):
    return tmg.NodalSolver(DX, tuple(lo == PER for lo in bc[0]), *bc,
                           torch.as_tensor(_random(CELLS, 21, 1.0, 0.5)),
                           direct=False)


def _calls(nxl):
    """The deepest sweeps with and without the residual whose halo fits
    slabs of nxl rows, and the residual alone."""
    with_res = (nxl - 2) // 2
    return ([(with_res, True)] if with_res else []) + [(nxl // 2, False),
                                                       (0, True)]


@pytest.fixture(scope="module")
def smoother_cases():
    """Per operator (cell and nodal, periodic and slip z): every level of
    its 16 x 16 x 32 hierarchy whose 2-rank slabs are even, its
    coefficients, a seeded x and b, and the calls that fit."""
    cases = {}
    for kind in ("cell", "nodal"):
        for name, bc in BCS.items():
            solver = _cell_solver(bc, False) if kind == "cell" \
                else _nodal_solver(bc)
            out = []
            for li, lev in enumerate(solver.levels):
                shape = tuple(solver.diags[li].shape)
                if (shape[0] // 2) % 2:
                    continue
                c = {"kind": kind, "x": _random(shape, 100 + li),
                     "b": _random(shape, 200 + li, 2.0, -1.0),
                     "calls": _calls(shape[0] // 2)}
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
                             bc=bc)
                out.append(c)
            cases[(kind, name)] = out
    return cases


@pytest.fixture(scope="module")
def solve_cases():
    """Seeded right-hand sides for the slab solves: the MAC form
    (singular) and the Helmholtz form from a warm start with presmooth,
    periodic and slip z; the nodal solve periodic and slip z."""
    cases = {"cell": [], "nodal": []}
    for name, bc in BCS.items():
        for helm in (False, True):
            solver = _cell_solver(bc, helm)
            lev = solver.levels[0]
            c = {"kind": "cell", "dx": DX, "bc_lo": bc[0], "bc_hi": bc[1],
                 "alpha": lev.alpha, "beta": lev.beta,
                 "acoef": None if lev.acoef is None else lev.acoef.numpy(),
                 "bcoef": [b.numpy() for b in lev.bcoef],
                 "rhs": _random(CELLS, 31, 2.0, -1.0),
                 "x0": _random(CELLS, 32) if helm else None,
                 "kw": dict(presmooth=4) if helm else {}}
            cases["cell"].append((solver, c))
        solver = _nodal_solver(bc)
        nodes = tuple(solver.diags[0].shape)
        c = {"kind": "nodal", "dx": DX,
             "periodic": tuple(lo == PER for lo in bc[0]), "bc_lo": bc[0],
             "bc_hi": bc[1], "sigma": solver.sigmas[0].numpy(),
             "rhs": _random(nodes, 41, 2.0, -1.0)}
        cases["nodal"].append((solver, c))
    return cases


@pytest.fixture(scope="module")
def rt_checkpoint(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_mg") / "rt"


@pytest.fixture(scope="module")
def two_ranks(smoother_cases, solve_cases, rt_checkpoint):
    """One spawn of 2 gloo ranks: the slab smoothers, the slab solves,
    init + STEPS steps of rt and of each deck of DECKS, and rt's
    per-rank checkpoint after STEPS steps."""
    jobs = [("smoothers", "slab_smoothers",
             dict(cases=[c for cs in smoother_cases.values() for c in cs])),
            ("solves", "slab_solves",
             dict(cases=[c for cs in solve_cases.values()
                         for _, c in cs])),
            ("rt", "steps", dict(deck=RT, nsteps=STEPS)),
            ("rt_chk", "checkpoint", dict(deck=RT, nsteps=STEPS,
                                          path=str(rt_checkpoint)))]
    jobs += [(name, "steps", dict(deck=deck, nsteps=STEPS))
             for name, deck in DECKS.items()]
    return launch.run(JOB, 2, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


def _one_rank(deck, steps=STEPS):
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


def _check_run(results, key, states, tol, floors=None, tallies=None):
    """Rank 0's whole-level states against `states`, field by field
    relative to the reference's max (or floors[field]); every rank's
    tallies equal and, given, equal to `tallies` step by step."""
    floors = floors or {}
    got = results[0][key]["states"]
    assert len(got) == len(states) == STEPS + 1
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


# ---------------------------------------------------------------------
# the slab smoothers and the slab solves
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cell", "nodal"])
def test_slab_smoothers_equal_whole_level_rows(two_ranks, smoother_cases,
                                               kind):
    """Periodic and slip z, every level with even 2-rank slabs (8, 4 and
    2 rows; the 16 x 16 x 32 hierarchy's last level, slabs of 1, runs
    whole): bit for bit the whole-level plain call's rows."""
    order = [k for k in smoother_cases]
    first = sum(len(smoother_cases[k]) for k in order[:order.index(
        (kind, "periodic"))])
    cases = smoother_cases[(kind, "periodic")] \
        + smoother_cases[(kind, "slip z")]
    assert len(cases) >= 6 and {c["x"].shape[0] // 2 for c in cases} \
        >= {8, 4, 2}
    t = torch.as_tensor
    for k, c in enumerate(cases):
        nxl = c["x"].shape[0] // 2
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
            for r, res in enumerate(two_ranks):
                x, rr = res["smoothers"][first + k][j]
                rows = slice(r * nxl, (r + 1) * nxl)
                assert np.array_equal(x, ref[0].numpy()[rows]), (k, j, r)
                assert (rr is None) == (not want)
                if want:
                    assert np.array_equal(rr, ref[1].numpy()[rows]), \
                        (k, j, r)


@pytest.mark.parametrize("kind", ["cell", "nodal"])
def test_slab_solves_match_whole_level(two_ranks, solve_cases, kind):
    """Multigrid on the slab against the whole level's solver: 1e-12 of
    the solution's max, the same iterations, the one-rank depth; the
    slab levels run the slab smoothers, the narrower ones whole."""
    first = 0 if kind == "cell" else len(solve_cases["cell"])
    for k, (solver, c) in enumerate(solve_cases[kind]):
        t = torch.as_tensor
        x0 = None if c.get("x0") is None else t(c["x0"])
        x, _, it = solver.solve_info(t(c["rhs"]), x0=x0, **c.get("kw", {}))
        assert it > 0
        ref = x.numpy()
        for r, res in enumerate(two_ranks):
            got = res["solves"][first + k]
            assert got["iters"] == it, (k, r, got["iters"], it)
            assert got["depth"] == len(solver.levels) \
                and 0 < got["n_slab"] < got["depth"], (k, got)
            nxl = ref.shape[0] // 2
            err = float(np.abs(got["x"] - ref[r * nxl:(r + 1) * nxl]).max())
            assert err <= 1e-12 * float(np.abs(ref).max()), (k, r, err)


# ---------------------------------------------------------------------
# whole decks
# ---------------------------------------------------------------------

def _rel_fields(got, want, fields=FIELDS):
    return {f: float(np.abs(got[f] - want[f]).max()
                     / max(float(np.abs(want[f]).max()), 1e-300))
            for f in fields}


@pytest.mark.parametrize("against", ["port", "incflo_tpu"])
def test_rt_on_two_ranks(two_ranks, rt_checkpoint, against):
    """bench's rt deck at 16 x 16 x 32 (slip z walls, variable density, a
    tracer): init + 2 steps on 2 ranks, the V-cycles on slabs of 8 cells
    and the coarser levels gathered.  Against the port also its per-rank
    checkpoint: density and tracer written, and a restart on 1 rank
    whose next step is the unbroken run's."""
    assert all(r["rt"]["comm"]["all_gather"] > 0 for r in two_ranks)
    if against == "port":
        states, tallies = _one_rank(RT, STEPS + 1)
        assert sum(t["cell_iters"] for t in tallies) > 0
        _check_run(two_ranks, "rt", states[:-1], 1e-11,
                   tallies=tallies[:-1])
        chk = two_ranks[0]["rt_chk"]
        errs = _rel_fields(chk["written"], states[STEPS])
        assert max(errs.values()) <= 1e-11, errs
        sim = tp.port_sim(RT)
        s = tio.read_checkpoint(str(rt_checkpoint), sim.cfg, torch.float64,
                                "cpu")
        errs = _rel_fields(tstate.sim_to_numpy(sim.advance(s)), states[-1])
        assert max(errs.values()) <= 1e-11, errs
        errs = _rel_fields(chk["restarted"], states[-1])
        assert max(errs.values()) <= 1e-11, errs
    else:
        _, runs = tp.reference_run(RT, STEPS)
        states, iters = runs[0]
        _check_run(two_ranks, "rt", states, 1e-10)
        assert two_ranks[0]["rt"]["tallies"][1:] == iters


@pytest.mark.parametrize("deck", list(DECKS))
def test_deck_on_two_ranks_matches_one(two_ranks, deck):
    """shear3d_vd (16 x 16 x 8, fully periodic: the halo-slab Godunov
    kernels), the Boussinesq bubble (probtype 111, slip z walls), a
    Bingham fluid between no-slip y walls, and shear3d_vd with explicit
    diffusion: init + 2 steps on 2 ranks against 1 rank."""
    states, tallies = _one_rank(DECKS[deck])
    assert sum(t["nodal_cycles"] for t in tallies) > 0
    _check_run(two_ranks, deck, states, 1e-11, FLOORS.get(deck), tallies)


def test_rt_on_four_ranks_gathers_the_coarse_levels():
    """rt on 4 ranks (slabs of 4 cells): the nodal hierarchy and the
    cell levels below the finest run whole on every rank, gathered in
    rank order; the step still matches 1 rank."""
    res = launch.run(JOB, 4, dict(jobs=[("rt", "steps", dict(
        deck=RT, nsteps=STEPS))]), device="cpu", timeout=TIMEOUT)
    assert all(r["rt"]["comm"]["all_gather"] > 0 for r in res)
    states, tallies = _one_rank(RT)
    _check_run(res, "rt", states, 1e-11, tallies=tallies)
