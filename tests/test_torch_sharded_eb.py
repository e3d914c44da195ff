"""Embedded boundaries on an x-slab mesh (incflo_torch/parallel, ROADMAP
A14): the cut-cell arrays, operators and smoothers of a rank's slab
against the whole level's rows, 3D one-level EB decks on 2 gloo ranks
against 1 rank and against incflo_tpu, per-rank checkpoints and the CLI
of an EB deck, on the CPU.

One spawn of 2 gloo ranks (incflo_torch.parallel.workers.several) runs
every job, in float64.  The decks, built inline from
tests/torch_parity.py:
  bingham   poiseuille_cyl_bingham at 32x32x8 (fully periodic, a Bingham
            fluid inside a cylinder along z that straddles the slab face
            at x = 2), from its init plus a seeded perturbation
            (torch_parity.fluid_perturbation), MOL-EB, the cut-cell
            velocity solve with its wall term, the 27-point EB nodal
            solver
  channel   channel_cyl on cubic cells at 32x16x8 (mass inflow x-lo,
            pressure outflow x-hi, no-slip y walls, a cylinder on rank
            0), the constant-density EB path with the level's x faces on
            the end ranks
  eb_vd     the variable-density EB deck at 16x16x8 (its nodal
            projection on the 2x octant lattice), from its init plus a
            seeded perturbation

Tolerances:
  slab forms      exact: on a rank's rows the slab arrays are the whole
                  level's and the operators make the same operations on
                  the same values (the EB arrays, MOL-EB face velocities
                  and fluxes, redistribution, the small-cell correction,
                  the cut-cell strain rate and viscosity, the 27-point
                  nodal sweeps at every level, cell_smooth_slab with the
                  EB wall term and an x wrap plane)
  steps           1e-11 relative to each field's max against the port on
                  1 rank, equal CG iterations, V-cycles and tensor-CG
                  iterations in every step on every rank (the dots and
                  means sum rank by rank, in another order)
  incflo_tpu      1e-10 of incflo_tpu's unsharded run of eb_vd (init + 1
                  step), with its iterations
  checkpoint      the restart on 2 ranks bit-equal to the unbroken 2-rank
                  run, on 1 rank 1e-11
  CLI             1e-11 relative against the unsharded driver's files
"""

import os

import numpy as np
import pytest
import torch

import torch_parity as tp
import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.ops import multigrid as tmg
from incflo_torch.parallel import launch
from incflo_torch.parallel import workers
from incflo_torch.utils import io as tio
from test_torch_sharded_xwalls import check_run

JOB = "incflo_torch.parallel.workers:several"
TIMEOUT = 600.0
RANKS = 2
FIELDS = tp.FIELDS + ("dt",)
KINDS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")
PER = int(tmg.SolverBC.PERIODIC)
SEED = 5
DECKS = {"bingham": tp.eb_deck("poiseuille_cyl_bingham", 32),
         "channel": tp.channel_cyl_cubic_deck(32),
         "eb_vd": tp.eb_vd_deck(16)}
STEPS = {"bingham": 2, "eb_vd": 1, "channel": 2}
PERTURBED = ("bingham", "eb_vd")
CLI_ARGS = ["max_step=2", "amr.check_int=2", "amr.plot_int=2",
            "amr.plt_vort=1", "amr.plt_vfrac=1"]
# the layout of each EBArrays field on a slab: (kind, axis) -- "cell"
# rows, "face" (nxl + 1 x faces), "ghost g" (g ghost rows a side from
# the whole level), "octant" (2 nxl rows); x faces of axis 0 only
LAYOUT = {"nbr_conn": ("cell", 1), "ccent_g2": ("ghost 2", 0),
          "conn_g1": ("ghost 1", 1), "lsq_minv_g1": ("ghost 1", 0),
          "near_g1": ("ghost 1", 0), "vfrac_oct": ("octant", 0)}


def _random(shape, seed, scale=1.0, offset=0.0):
    return offset + scale * np.random.default_rng(seed).random(shape)


def form_inputs(name, seed, decks=DECKS):
    """Seeded whole-level inputs of eb_operators on deck `name` of
    `decks` (vel zero in covered cells, umac on n + 1 faces of each
    axis) and, per level of its 27-point (9-point in 2D) nodal
    hierarchy, a seeded x and b with the calls whose halo fits the
    nranks-rank slabs (every call on a level that runs whole)."""
    sim = tp.port_sim(decks[name])
    cells = sim.grid.cell_shape
    nd = sim.grid.ndim
    vel = tp.masked_random(cells + (nd,), sim.eb.fluid, seed)
    dudt = _random(cells + (nd,), seed + 1, 2.0, -1.0)
    umac = [_random(tuple(n + (a == d) for a, n in enumerate(cells)),
                    seed + 2 + d, 2.0, -1.0) for d in range(nd)]
    nodal = []
    for li, st in enumerate(sim._nodal_eb_hat.levels):
        shape = tuple(st.coefs.shape[1:])
        nodal.append({"level": li,
                      "x": _random(shape, seed + 10 + li, 2.0, -1.0),
                      "b": _random(shape, seed + 20 + li, 2.0, -1.0)})
    return dict(vel=vel, dudt=dudt, umac=umac, nodal_cases=nodal)


def with_calls(inputs, nranks):
    """inputs with each nodal case's calls on nranks ranks: k sweeps +
    the residual and k' sweeps without, as deep as the slab allows."""
    out = dict(inputs, nodal_cases=[])
    for c in inputs["nodal_cases"]:
        nxl = c["x"].shape[0] // nranks
        with_res = max((nxl - 2) // 2, 1)
        out["nodal_cases"].append(dict(
            c, calls=[(with_res, True), (max(nxl // 2, 1), False),
                      (0, True)]))
    return out


def _whole_rows(a, layout, r, nranks, periodic, axis=0):
    """Rank r's rows of a whole-level array along axis: "cell", "face",
    "node" (the last rank's node nx where x ends in boundaries),
    "octant", "ghost g" (an array that carries g ghost rows a side)."""
    kind = layout.split()[0]
    if kind == "ghost":
        g = int(layout.split()[1])
        nxl = (a.shape[axis] - 2 * g) // nranks
        return np.take(a, range(r * nxl, r * nxl + nxl + 2 * g), axis=axis)
    n = a.shape[axis]
    if kind == "octant":
        m = n // nranks
        return np.take(a, range(r * m, (r + 1) * m), axis=axis)
    extra = kind == "face" or (kind == "node" and not periodic)
    nxl = (n - extra) // nranks
    last = r == nranks - 1
    count = nxl + (1 if kind == "face" or (extra and last) else 0)
    return np.take(a, range(r * nxl, r * nxl + count), axis=axis)


def _assert_rows_equal(got, want, what):
    """got bit-equal to want; else the message names `what` (the case,
    the rank, the field), the largest absolute difference and its
    index."""
    if np.array_equal(got, want):
        return
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape}, whole level's "
                             f"rows {want.shape}")
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    diff[np.isnan(got) != np.isnan(want)] = np.inf
    i = np.unravel_index(int(np.nanargmax(diff)), diff.shape)
    raise AssertionError(f"{what}: largest absolute difference "
                         f"{diff[i]!r} at index {i} (rank's {got[i]!r}, "
                         f"whole level's {want[i]!r})")


def check_forms(results, key, name, inputs, decks=DECKS):
    """Every rank's slab arrays and operators bit-equal to the whole
    level's rows (eb_operators on a 1-rank Simulation of decks[name],
    2D or 3D)."""
    sim = tp.port_sim(decks[name])
    nd = sim.grid.ndim
    # a row vector along x, broadcast over the other axes of a cell
    # array (lead: the axes before x)
    along_x = lambda v, lead=0: v.reshape((1,) * lead + (-1,)
                                          + (1,) * (nd - 1))
    t = torch.as_tensor
    cases = [dict(c, x=t(c["x"]), b=t(c["b"]))
             for c in inputs["nodal_cases"]]
    whole = workers.eb_operators(sim, t(inputs["vel"]), t(inputs["dudt"]),
                                 [t(u) for u in inputs["umac"]], cases)
    per = sim.grid.periodic[0]
    nranks = len(results)
    for r, res in enumerate(results):
        got = res[key]
        for k in ("rate", "rate_redistributed", "redistributed", "small",
                  "strainrate"):
            _assert_rows_equal(got[k], _whole_rows(whole[k], "cell", r,
                                                   nranks, per),
                               (key, f"rank {r}", k))
        assert np.array_equal(got["eta_g1"], _whole_rows(
            whole["eta_g1"], "ghost 1", r, nranks, per)), (key, r)
        for k in ("umac", "fluxes"):
            for d in range(nd):
                lay = "face" if d == 0 else "cell"
                assert np.array_equal(got[k][d], _whole_rows(
                    whole[k][d], lay, r, nranks, per)), (key, r, k, d)
        arrays = got["arrays"]
        for f, w in whole["arrays"].items():
            if f.startswith("probe_"):
                assert arrays[f] is None, f
                continue
            if f in ("vfrac_x1", "conn_cut_x1", "vfrac_oct_x1"):
                continue
            if f in ("afrac", "face_cent"):
                for d in range(nd):
                    assert np.array_equal(arrays[f][d], _whole_rows(
                        w[d], "face" if d == 0 else "cell", r, nranks,
                        per)), (key, r, f, d)
                continue
            lay, axis = LAYOUT.get(f, ("cell", 0))
            assert np.array_equal(arrays[f], _whole_rows(
                w, lay, r, nranks, per, axis)), (key, r, f)
        # the static x neighbours of redistribution: one row a side
        nxl = sim.grid.n_cell[0] // nranks
        idx = np.arange(r * nxl - 1, (r + 1) * nxl + 1)
        nx = sim.grid.n_cell[0]
        keep = np.ones(idx.shape) if per else ((idx >= 0) & (idx < nx))
        idx = idx % nx
        vf = whole["arrays"]["vfrac"][idx] * along_x(keep)
        assert np.array_equal(arrays["vfrac_x1"], vf), (key, r)
        mc = (whole["arrays"]["nbr_conn"] * whole["arrays"]["cut"])[:, idx] \
            * along_x(keep, 1)
        assert np.array_equal(arrays["conn_cut_x1"], mc), (key, r)
        oct_ = whole["arrays"]["vfrac_oct"]
        m = 2 * nxl
        o = np.arange(r * m - 1, (r + 1) * m + 1)
        o = o % oct_.shape[0] if per else np.clip(o, 0, oct_.shape[0] - 1)
        assert np.array_equal(arrays["vfrac_oct_x1"], oct_[o]), (key, r)
        # the 27-point sweeps: the slab levels' rows, the whole levels'
        n_slab = got["n_slab"]
        assert n_slab >= 1
        for c, g, w in zip(inputs["nodal_cases"], got["nodal_sweeps"],
                           whole["nodal_sweeps"]):
            for (xg, rg), (xw, rw) in zip(g, w):
                if c["level"] >= n_slab:
                    assert np.array_equal(xg, xw), (key, r, c["level"])
                    continue
                assert np.array_equal(xg, _whole_rows(
                    xw, "node", r, nranks, per)), (key, r, c["level"])
                assert (rg is None) == (rw is None)
                if rw is not None:
                    assert np.array_equal(rg, _whole_rows(
                        rw, "node", r, nranks, per)), (key, r, c["level"])


def wrap_cases(nranks):
    """Seeded operators with the EB wall term on a fully periodic level
    of poiseuille_cyl_bingham's 32x32x8 grid, whose x face 0 differs from
    face n (so the smoother coefficients carry an x wrap plane), at every
    level whose nranks-rank slabs are even: the calls whose halo fits,
    once with the x wrap plane and once without it."""
    grid = tp.port_sim(DECKS["bingham"]).grid
    cells = grid.n_cell
    t = torch.as_tensor
    faces = []
    for ax in range(3):
        shape = tuple(n + (ax == a) for a, n in enumerate(cells))
        b = _random(shape, 60 + ax, 1.0, 0.5)
        if ax == 2:
            b[:, :, -1] = b[:, :, 0]
        faces.append(t(b))
    solver = tmg.CellSolver(grid.dx, (PER,) * 3, (PER,) * 3, 1.0, 2e-3,
                            t(_random(cells + (3,), 63, 1.0, 1.0)),
                            [f[..., None].expand(f.shape + (3,))
                             for f in faces],
                            ebc=t(_random(cells + (3,), 64, 5.0, 0.0)),
                            direct=False)
    dinvs, fhis, fwalls = solver.smoother_coefs()
    out = []
    for li, lev in enumerate(solver.levels):
        shape = tuple(solver.diags[li].shape)
        nxl = shape[0] // nranks
        if nxl % 2:
            continue
        w0 = fwalls[li][0]
        gap = float((w0 - fhis[li][0].narrow(0, shape[0] - 1, 1)).abs()
                    .max())
        assert gap > 1e-3 * float(w0.abs().max())
        with_res = (nxl - 2) // 2
        base = {"kind": "cell", "x": _random(shape, 70 + li),
                "b": _random(shape, 80 + li, 2.0, -1.0), "nxl": nxl,
                "calls": ([(with_res, True)] if with_res else [])
                + [(nxl // 2, False), (0, True)],
                "diag": solver.diags[li].numpy(), "dinv": dinvs[li].numpy(),
                "F": [f.numpy() for f in fhis[li]],
                "Fwall": [w.numpy() for w in fwalls[li]],
                "bc": (lev.bc_lo, lev.bc_hi)}
        out += [base, dict(base, xwrap=False)]
    return out


def check_wrap(results, key, cases):
    """With the x wrap plane every rank's rows equal the whole level's
    bit for bit; without it, the rows next to the level's wrap differ."""
    from incflo_torch.ops import smoother_kernels as sk
    t = torch.as_tensor
    worst_without = 0.0
    for k, c in enumerate(cases):
        for j, (n, want) in enumerate(c["calls"]):
            ref = sk.cell_smooth_plain(
                t(c["x"]), t(c["b"]), t(c["diag"]), t(c["dinv"]),
                [t(f) for f in c["F"]], n, want, c["bc"],
                [t(w) for w in c["Fwall"]])
            for r, res in enumerate(results):
                x, rr = res[key][k][j]
                rows = slice(r * c["nxl"], (r + 1) * c["nxl"])
                pairs = [(x, ref[0])] + ([(rr, ref[1])] if want else [])
                if c.get("xwrap", True):
                    for a, w in pairs:
                        assert np.array_equal(a, w.numpy()[rows]), (k, j, r)
                else:
                    for a, w in pairs:
                        worst_without = max(worst_without, float(
                            np.abs(a - w.numpy()[rows]).max()))
    assert worst_without > 1e-3, worst_without
    return worst_without


def one_rank(name, steps, perturb=None, decks=DECKS):
    """The port on one rank from init (+ perturb) of decks[name]: states
    after init and each step, and the tallies of each step (the first
    init's)."""
    sim = tp.port_sim(decks[name])
    tmg.reset_counts()
    s = tp.own_start(sim, perturb)
    states = [tstate.sim_to_numpy(s)]
    tallies = [{k: tmg.COUNTS[k] for k in KINDS}]
    for _ in range(steps):
        before = dict(tmg.COUNTS)
        s = sim.advance(s)
        tallies.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        states.append(tstate.sim_to_numpy(s))
    return states, tallies


def perturbation(name):
    if name not in PERTURBED:
        return None
    return tp.fluid_perturbation(tp.port_sim(DECKS[name]), SEED)


@pytest.fixture(scope="module")
def forms():
    return {name: with_calls(form_inputs(name, 100 + 10 * k), RANKS)
            for k, name in enumerate(("bingham", "channel"))}


@pytest.fixture(scope="module")
def wraps():
    return wrap_cases(RANKS)


@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_eb")
    (root / "inputs").write_text(DECKS["channel"])
    (root / "cli").mkdir()
    return root


@pytest.fixture(scope="module")
def two_ranks(forms, wraps, io_dir):
    """One spawn of 2 gloo ranks: the slab forms of two decks, the x
    wrap cases, init + STEPS steps of each deck, the channel's per-rank
    checkpoint after one step with its restart, and the CLI on the
    channel."""
    jobs = [(f"forms {name}", "eb_forms", dict(deck=DECKS[name], **kw))
            for name, kw in forms.items()]
    jobs += [("wrap", "slab_smoothers", dict(cases=wraps))]
    jobs += [(name, "steps", dict(deck=DECKS[name], nsteps=n,
                                  perturb=perturbation(name)))
             for name, n in STEPS.items()]
    jobs += [("checkpoint", "checkpoint",
              dict(deck=DECKS["channel"], nsteps=1,
                   path=str(io_dir / "sharded"))),
             ("cli", "cli", dict(argv=[str(io_dir / "inputs")] + CLI_ARGS,
                                 cwd=str(io_dir / "cli")))]
    return launch.run(JOB, RANKS, dict(jobs=jobs), device="cpu",
                      timeout=TIMEOUT)


# ---------------------------------------------------------------------
# the slab forms
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bingham", "channel"])
def test_eb_arrays_and_operators_on_a_slab_equal_whole_level_rows(
        two_ranks, forms, name):
    """The slab EBArrays, the MOL-EB face velocities and fluxes, the
    cut-cell rate and its redistribution, the small-cell correction, the
    cut-cell strain rate and viscosity, and the 27-point EB nodal sweeps
    at every level, on 2 ranks (bingham's cylinder crosses the slab face
    at x = 2; the channel's lies on rank 0, whose low x face is the
    inflow)."""
    check_forms(two_ranks, f"forms {name}", name, forms[name])


def test_cell_smooth_slab_takes_the_x_wrap_plane(two_ranks, wraps):
    """cell_smooth_slab on operators with the EB wall term whose x face 0
    differs from face n: with the x wrap plane at the level's cell 0
    inside the extended slabs (rank 0's plane lo, rank 1's halo copy at
    lo + nxl) the rows equal the whole level's; without it they do
    not."""
    assert {c["nxl"] for c in wraps} == {16, 8, 4}
    check_wrap(two_ranks, "wrap", wraps)


# ---------------------------------------------------------------------
# whole decks
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEPS))
def test_eb_deck_on_two_ranks_matches_one(two_ranks, name):
    """Init + perturbation and STEPS[name] steps on 2 ranks against 1
    rank, equal tallies in every step on every rank."""
    states, tallies = one_rank(name, STEPS[name], perturbation(name))
    assert sum(t["nodal_cycles"] for t in tallies) > 0
    assert sum(t["cell_iters"] for t in tallies) > 0
    check_run(two_ranks, name, states, 1e-11, tallies=tallies)


def test_eb_vd_on_two_ranks_matches_incflo_tpu(two_ranks):
    """The variable-density EB deck (the octant-lattice nodal solve) on 2
    ranks against incflo_tpu's unsharded run from the same
    perturbation, with its solver iterations."""
    _, runs = tp.reference_run(DECKS["eb_vd"], STEPS["eb_vd"],
                               (perturbation("eb_vd"),))
    states, iters = runs[0]
    check_run(two_ranks, "eb_vd", states, 1e-10)
    assert two_ranks[0]["eb_vd"]["tallies"][1:] == iters


# ---------------------------------------------------------------------
# per-rank checkpoints and the CLI
# ---------------------------------------------------------------------

def test_channel_checkpoint_restarts(two_ranks, io_dir):
    """The EB channel written on 2 ranks after one step (rank 1's block
    of p holds node nx): the next step after a restart on 2 ranks is the
    unbroken 2-rank run's step 2 bit for bit, on 1 rank within 1e-11."""
    path = io_dir / "sharded"
    nx = tp.port_sim(DECKS["channel"]).grid.n_cell[0]
    shard = np.load(path / "Level_0.shard1.npz")
    assert shard["p"].shape[0] == nx // 2 + 1
    chk = two_ranks[0]["checkpoint"]
    unbroken = two_ranks[0]["channel"]["states"]
    for f in FIELDS + ("step",):
        assert np.array_equal(chk["written"][f], unbroken[1][f]), f
        assert np.array_equal(chk["restarted"][f], unbroken[2][f]), f
    sim = tp.port_sim(DECKS["channel"])
    r = tio.read_checkpoint(str(path), sim.cfg, torch.float64, "cpu")
    got = tstate.sim_to_numpy(sim.advance(r))
    for f in FIELDS:
        err = float(np.abs(got[f] - unbroken[2][f]).max()
                    / max(float(np.abs(unbroken[2][f]).max()), 1e-300))
        assert err <= 1e-11, (f, err)


def test_cli_runs_the_eb_channel_on_two_ranks(two_ranks, io_dir, tmp_path,
                                              monkeypatch):
    """python -m incflo_torch.main on the 2-rank mesh (workers.cli) runs
    the EB channel: rank 0 prints and writes the plotfiles (vfrac and the
    cut-cell vorticity computed on the slabs and gathered), each rank its
    checkpoint shard, and the files hold what the unsharded driver
    writes, to 1e-11 of each field's (a vector's) largest value; a
    checkpoint holds the unsharded driver's state to 1e-11."""
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
    assert sorted(got.files) == sorted(ref.files)
    assert {"vort", "vfrac"} <= set(ref.files)
    assert np.array_equal(got["vfrac"], ref["vfrac"])
    group = lambda k: k[:-1] if k[:-1] in ("vel", "gp") else k
    scale = {}
    for k in ref.files:
        scale[group(k)] = max(scale.get(group(k), 0.0),
                              float(np.abs(ref[k]).max()))
    for k in ref.files:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-11 * max(scale[group(k)], 1e-300), (k, err)
    cfg = incflo_torch.IncfloConfig.from_text(DECKS["channel"])
    s = tio.read_checkpoint(str(d / "chk00002"), cfg, torch.float64, "cpu")
    r = tio.read_checkpoint(str(tmp_path / "chk00002"), cfg, torch.float64,
                            "cpu")
    for f in ("velocity", "tracer", "p", "gp", "mac_phi"):
        a, b = getattr(s.level, f).numpy(), getattr(r.level, f).numpy()
        assert a.shape == b.shape, f
        assert float(np.abs(a - b).max()) <= 1e-11 * max(
            float(np.abs(b).max()), 1e-300), f
