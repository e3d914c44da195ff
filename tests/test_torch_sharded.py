"""The x-slab sharded shear3d step of incflo_torch (incflo_torch/parallel)
against its unsharded step and against incflo_tpu, on the CPU.

The module's fixtures spawn gloo ranks three times
(incflo_torch.parallel.launch: fresh processes that import incflo_torch
alone, joined through a FileStore, each spawn with a join timeout), run
several jobs of incflo_torch.parallel.workers in each, and the tests read
the results.  All in float64 at 16x16x8 (2 ranks, nxl 8) and 32x16x8 (4
ranks, nxl 8).

Tolerances:
  halo_x                 exact (a copy)
  Godunov, against the   exact: the halo-slab plain versions run the
  unsharded port         same operations on the same values
  Godunov, against       1e-12 relative to the field's max: the same
  incflo_tpu             algorithm, rounding (incflo_tpu's sharded
                         wrappers, Pallas in interpret mode, on a 2x1
                         CPU mesh with an explicit info tuple)
  direct solves          1e-12 relative: the sharded x contraction sums
                         over the ranks by a reduce-scatter, in another
                         order than one matrix product
  whole step             1e-11 relative to each field's max against the
                         port's unsharded step, with equal tensor-CG
                         iterations in every step; 1e-10 against
                         incflo_tpu's unsharded step (the bound of
                         tests/test_torch_step.py), on 2 and 4 ranks
  per-rank checkpoint    exact: incflo_tpu's reader returns the state
                         the 2 ranks wrote; the step after a restart on
                         1 or 2 ranks (on 2 also from a whole-level
                         checkpoint) 1e-11 relative against the
                         unsharded port's
  the CLI on 2 ranks     1e-11 relative against the unsharded driver's
                         checkpoint and plotfile (a vector's components
                         relative to the largest of them)
"""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.grid import Grid as JGrid
from incflo_tpu.simulation import Simulation as JSim

import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.grid import Grid
from incflo_torch.ops import godunov_kernels as gk
from incflo_torch.ops import multigrid as tmg
from incflo_torch.parallel import launch
from incflo_torch.utils import io as tio

STEPS = 3
FIELDS = ("velocity", "p", "gp", "mac_phi", "dt")
N_CELL, PROB_HI = (16, 16, 8), (1.0, 1.0, 0.5)
JOB = "incflo_torch.parallel.workers:several"
TIMEOUT = 120.0
CLI_ARGS = ["max_step=2", "amr.check_int=2", "amr.plot_int=2",
            "amr.plt_vort=1", "amr.KE_int=1"]
# decks that once ran on one device but not over a mesh (ROADMAP A14):
# the reason the refusal names -> what the shear3d deck adds (a key it
# sets replaces the deck's own line); variable density, tracers,
# non-Newtonian fluids, Boussinesq buoyancy and explicit diffusion run
# split since multigrid runs on the slab (tests/test_torch_sharded_mg.py),
# MOL, walls and inflow or outflow on x since the mesh takes an x that
# ends in boundaries (tests/test_torch_sharded_xwalls.py), embedded
# boundaries in 3D since the cut-cell arrays are cut to the slab
# (tests/test_torch_sharded_eb.py), and the two Godunov options and 2D
# decks with or without embedded boundaries since the 2D levels and the
# MAC-phi operator run on the slab (tests/test_torch_sharded_2d.py),
# AMR since both AMR drivers split their levels
# (tests/test_torch_sharded_amr.py), and AMR with embedded boundaries,
# a level that does not split into equal slabs at least 4 cells wide
# (held whole on every rank) and the rfftn direct solve (V-cycles on the
# slabs) since the last slice of A13b and A14
# (tests/test_torch_sharded_amr_eb.py): the IN_SCOPE decks, every one
X_WALLS = "geometry.is_periodic = 0 1 1\n"
SCOPE_DECKS = {
    "MOL advection": "incflo.use_godunov = false\nincflo.cfl = 0.5\n",
    "walls on x": X_WALLS + 'xlo.type = "nsw"\nxhi.type = "nsw"\n',
    "inflow or outflow on x": X_WALLS + 'xlo.type = "mi"\n'
                              "xlo.velocity = 1. 0. 0.\n"
                              'xhi.type = "po"\nxhi.pressure = 0.\n',
    "AMR": "amr.max_level = 1\n",
    "embedded boundaries": ('incflo.geometry = "cylinder"\n'
                            "cylinder.internal_flow = false\n"
                            "cylinder.radius = 0.2\n"
                            "cylinder.direction = 2\n"
                            "cylinder.center = 0.5 0.5 0.\n"),
    "godunov_use_forces_in_trans":
        "incflo.godunov_use_forces_in_trans = true\n",
    "use_mac_phi_in_godunov": "incflo.use_mac_phi_in_godunov = true\n",
}
SCOPE_DECKS["AMR with embedded boundaries"] = \
    SCOPE_DECKS["AMR"] + SCOPE_DECKS["embedded boundaries"]
IN_SCOPE = ("MOL advection", "walls on x", "inflow or outflow on x",
            "AMR", "embedded boundaries", "godunov_use_forces_in_trans",
            "use_mac_phi_in_godunov", "2D decks",
            "2D decks with embedded boundaries", "nx % R", "nxl < 4",
            "rfftn", "AMR with embedded boundaries")


# decks of their own: a 2D deck and a 2D deck with embedded boundaries
# (16 cells along x, slabs of 4 on 4 ranks), and a periodic axis above
# 256 cells, whose direct solves take rfftn on one device and V-cycles
# on the slabs under the mesh
SCOPE_TEXTS = {
    "2D decks": bench._deck("tgv2d", 16, "float64")[0],
    "2D decks with embedded boundaries":
        bench._deck("tgv2d", 16, "float64")[0]
        + SCOPE_DECKS["embedded boundaries"],
    "rfftn": None,          # _deck((16, 16, 264)), built in four_ranks
}


def _deck(n_cell=(16, 16, 8), extra=""):
    text, _ = bench._deck("shear3d", 16, "float64")
    nx, ny, nz = n_cell
    text = text.replace("amr.n_cell = 16 16 8",
                        f"amr.n_cell = {nx} {ny} {nz}")
    text = text.replace("geometry.prob_hi = 1. 1. 0.25",
                        f"geometry.prob_hi = {nx / 16} 1. {nz / 32}")
    keys = {l.split("=")[0].strip() for l in extra.splitlines() if "=" in l}
    text = "\n".join(l for l in text.splitlines()
                     if l.split("=")[0].strip() not in keys)
    return text + "\n" + extra


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _fields(n_cell, ncomp, seed):
    rng = np.random.default_rng(seed)
    xs = [np.linspace(0, 2 * np.pi, n, endpoint=False) for n in n_cell]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    out = [rng.normal() * np.sin(X + c) + rng.normal() * np.cos(2 * Y - c)
           + rng.normal() * np.sin(Z + 0.3 * c)
           + 0.1 * rng.standard_normal(X.shape) for c in range(ncomp)]
    return np.stack(out, -1)


def _np_state(s):
    out = {f: np.asarray(getattr(s.level, f))
           for f in tstate.LevelState._fields}
    for k in ("t", "dt", "prev_dt", "prev_prev_dt", "step"):
        out[k] = np.asarray(getattr(s, k))
    return out


def _port_steps(deck, start=None):
    """The unsharded port: states after init and each step, and the
    tensor CG's iterations in each step."""
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    s = sim.init_state() if start is None else tstate.sim_from_numpy(
        start, "cpu", torch.float64)
    states, trips = [tstate.sim_to_numpy(s)], []
    for _ in range(STEPS):
        before = tmg.COUNTS["tensor_cg_iters"]
        s = sim.advance(s)
        trips.append(tmg.COUNTS["tensor_cg_iters"] - before)
        states.append(tstate.sim_to_numpy(s))
    return states, trips


def _jax_steps(deck):
    """incflo_tpu's unsharded step: states after init and each step."""
    sim = JSim(JConfig.from_text(deck))
    s = sim.init_state()
    states = [_np_state(s)]
    for _ in range(STEPS):
        s = sim.advance(s)
        states.append(_np_state(s))
    return states


@pytest.fixture(scope="module")
def jax_reference():
    """incflo_tpu's unsharded shear3d step at 16x16x8: init + STEPS."""
    return _jax_steps(_deck())


@pytest.fixture(scope="module")
def godunov_inputs():
    vel = _fields(N_CELL, 3, 1)
    forces = 0.3 * _fields(N_CELL, 3, 2)
    q = _fields(N_CELL, 3, 3)
    dx = min(h / n for h, n in zip(PROB_HI, N_CELL))
    dt = 0.9 * dx / float(np.abs(vel).max())
    grid = Grid(N_CELL, (0.0,) * 3, PROB_HI, (True,) * 3)
    umac = [u.numpy() for u in gk.predict_plain(
        grid, torch.as_tensor(vel), torch.as_tensor(forces), dt, True)]
    return dict(vel=vel, forces=forces, q=q, dt=dt, umac=umac, grid=grid)


@pytest.fixture(scope="module")
def solve_inputs():
    rng = np.random.default_rng(7)
    return dict(rhs_cell=rng.standard_normal(N_CELL),
                rhs_node=rng.standard_normal(N_CELL),
                rhs_vec=rng.standard_normal(N_CELL + (3,)), beta=0.003)


@pytest.fixture(scope="module")
def io_dirs(tmp_path_factory):
    """Directories of the 2-rank spawn's I/O jobs: its per-rank
    checkpoint, a whole-level checkpoint of the unsharded port after
    STEPS steps (for the 2-rank restart), and the sharded CLI run with
    its deck."""
    root = tmp_path_factory.mktemp("sharded_io")
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(
        _deck()), device="cpu")
    tio.write_checkpoint(str(root / "dense"),
                         sim.advance_n(sim.init_state(), STEPS), sim.cfg)
    (root / "cli").mkdir()
    (root / "inputs").write_text(_deck())
    return root


@pytest.fixture(scope="module")
def two_ranks(jax_reference, godunov_inputs, solve_inputs, io_dirs):
    """One spawn of 2 gloo ranks: the halo exchange, the sharded Godunov
    wrappers, the sharded direct solves, the sharded step from the
    port's own init and from incflo_tpu's carried initial state, the
    per-rank checkpoint and its restarts, and the CLI on both ranks."""
    g = godunov_inputs
    field = np.arange(16 * 3 * 2, dtype=np.float64).reshape(16, 3, 2)
    jobs = [
        ("halo", dict(field=field, lo=4, hi=1)),
        ("godunov", dict(n_cell=N_CELL, prob_hi=PROB_HI, vel=g["vel"],
                         forces=g["forces"], q=g["q"], umac=g["umac"],
                         dt=g["dt"], use_ppm=True, iconserv=(0, 1, 0))),
        ("solves", dict(deck=_deck(), **solve_inputs)),
        ("steps", dict(deck=_deck(), nsteps=STEPS)),
        ("checkpoint", dict(deck=_deck(), nsteps=STEPS,
                            path=str(io_dirs / "sharded"),
                            dense=str(io_dirs / "dense"))),
        ("cli", dict(argv=[str(io_dirs / "inputs")] + CLI_ARGS,
                     cwd=str(io_dirs / "cli"))),
    ]
    own = launch.run(JOB, 2, dict(jobs=jobs), device="cpu", timeout=TIMEOUT)
    carried = launch.run(JOB, 2, dict(jobs=[("steps", dict(
        deck=_deck(), nsteps=STEPS, start=jax_reference[0]))]),
        device="cpu", timeout=TIMEOUT)
    return own, carried, field


@pytest.fixture(scope="module")
def four_ranks():
    """One spawn of 4 gloo ranks: the halo exchange, the sharded step at
    32x16x8, and the decks a 4-rank mesh refuses."""
    field = np.arange(16 * 3 * 2, dtype=np.float64).reshape(16, 3, 2)
    decks = {"nx % R": _deck((18, 16, 8)), "nxl < 4": _deck((12, 16, 8)),
             **SCOPE_TEXTS, "rfftn": _deck((16, 16, 264))}
    decks.update({what: _deck((16, 16, 8), extra)
                  for what, extra in SCOPE_DECKS.items()})
    jobs = [("halo", dict(field=field, lo=4, hi=4)),
            ("steps", dict(deck=_deck((32, 16, 8)), nsteps=STEPS)),
            ("scope_errors", dict(decks={**decks, "no card": _deck()},
                                  on_default_device=("no card",)))]
    return (launch.run(JOB, 4, dict(jobs=jobs), device="cpu",
                       timeout=TIMEOUT), field)


# ---------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------

@pytest.mark.parametrize("nranks", [2, 4])
def test_halo_x_equals_wrapped_slices(two_ranks, four_ranks, nranks):
    results, field, lo, hi = ((two_ranks[0], two_ranks[2], 4, 1)
                              if nranks == 2 else
                              (four_ranks[0], four_ranks[1], 4, 4))
    nxl = field.shape[0] // nranks
    assert len(results) == nranks
    for r, res in enumerate(results):
        idx = np.arange(r * nxl - lo, (r + 1) * nxl + hi) % field.shape[0]
        assert np.array_equal(res["halo"], field[idx]), r


# ---------------------------------------------------------------------
# the sharded Godunov wrappers (B8)
# ---------------------------------------------------------------------

def test_sharded_godunov_matches_unsharded_port_bit_for_bit(
        two_ranks, godunov_inputs):
    g = godunov_inputs
    t = torch.as_tensor
    ref_p = gk.predict_plain(g["grid"], t(g["vel"]), t(g["forces"]), g["dt"],
                             True)
    ref_a = gk.advect_plain(g["grid"], t(g["q"]),
                            [t(u) for u in g["umac"]], t(g["forces"]),
                            g["dt"], (0, 1, 0), True)
    nxl = N_CELL[0] // 2
    for r, res in enumerate(two_ranks[0]):
        got = res["godunov"]
        x0 = r * nxl
        assert np.array_equal(got["predict"][0],
                              ref_p[0].numpy()[x0:x0 + nxl + 1])
        for d in (1, 2):
            assert np.array_equal(got["predict"][d],
                                  ref_p[d].numpy()[x0:x0 + nxl])
        assert np.array_equal(got["advect"], ref_a.numpy()[x0:x0 + nxl])


def test_sharded_godunov_matches_incflo_tpu(two_ranks, godunov_inputs,
                                            monkeypatch):
    from incflo_tpu.ops import pallas_godunov as pg
    devices = jax.devices()
    if len(devices) < 2:
        pytest.skip("needs 2 virtual JAX devices (tests/conftest.py)")
    monkeypatch.setattr(pg, "INTERPRET", True)
    mesh = Mesh(np.asarray(devices[:2]).reshape(2, 1), ("dx", "dy"))
    info = (mesh, 2, N_CELL[0] // 2)
    g = godunov_inputs
    jgrid = JGrid(N_CELL, (0.0,) * 3, PROB_HI, (True,) * 3)
    # called with an explicit info tuple: no pallas_guard state is read
    # or set
    umac = pg.predict_sharded(jgrid, jnp.asarray(g["vel"]),
                              jnp.asarray(g["forces"]), g["dt"], True, info)
    rate = pg.advect_sharded(jgrid, jnp.asarray(g["q"]),
                             [jnp.asarray(u) for u in g["umac"]],
                             jnp.asarray(g["forces"]), g["dt"], (0, 1, 0),
                             True, info)
    umac = [np.asarray(u) for u in umac]
    rate = np.asarray(rate)
    nxl = N_CELL[0] // 2
    for r, res in enumerate(two_ranks[0]):
        got = res["godunov"]
        x0 = r * nxl
        assert _rel(got["predict"][0], umac[0][x0:x0 + nxl + 1]) <= 1e-12
        for d in (1, 2):
            assert _rel(got["predict"][d], umac[d][x0:x0 + nxl]) <= 1e-12
        assert _rel(got["advect"], rate[x0:x0 + nxl]) <= 1e-12


# ---------------------------------------------------------------------
# the sharded direct solves
# ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["mac", "nodal", "helmholtz"])
def test_sharded_direct_solves_match(two_ranks, solve_inputs, which):
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_deck()), device="cpu")
    t = torch.as_tensor
    ref = {"mac": lambda: sim._mac_solver.solve(t(solve_inputs["rhs_cell"])),
           "nodal": lambda: sim._nodal_hat.solve(t(solve_inputs["rhs_node"])),
           "helmholtz": lambda: sim._diff_proto.with_beta(
               solve_inputs["beta"]).solve(t(solve_inputs["rhs_vec"]))
           }[which]().numpy()
    got = np.concatenate([res["solves"][which] for res in two_ranks[0]])
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-12


def test_sharded_operators_equal_unsharded_rows(two_ranks, solve_inputs):
    """cell_apply, nodal_apply and the MAC fluxes on a slab level, whose
    periodic x pads come from the neighbouring rank: bit for bit the
    unsharded operators' rows (x faces: the slab's nxl + 1)."""
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_deck()), device="cpu")
    t = torch.as_tensor
    cell, node = t(solve_inputs["rhs_cell"]), t(solve_inputs["rhs_node"])
    mac_lev = sim._mac_solver.levels[0]
    helm = sim._diff_proto.with_beta(solve_inputs["beta"])
    ref = {"mac_apply": tmg.cell_apply(cell, mac_lev),
           "nodal_apply": tmg.nodal_apply(node, sim._nodal_hat.levels[0]),
           "helmholtz_apply": tmg.cell_apply(t(solve_inputs["rhs_vec"]),
                                             helm.levels[0]),
           "mac_flux_x": tmg.cell_fluxes(cell, mac_lev)[0]}
    nxl = N_CELL[0] // 2
    for r, res in enumerate(two_ranks[0]):
        for k, v in ref.items():
            n = nxl + (1 if k == "mac_flux_x" else 0)
            assert np.array_equal(res["solves"][k],
                                  v.numpy()[r * nxl:r * nxl + n]), (r, k)


# ---------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------

def _check_steps(res, ref_states, ref_trips, tol):
    got = res[0]["steps"]["states"]
    assert len(got) == len(ref_states) == STEPS + 1
    for i, (a, b) in enumerate(zip(got, ref_states)):
        for f in FIELDS:
            assert a[f].shape == np.asarray(b[f]).shape, (i, f)
            assert _rel(a[f], b[f]) <= tol, (i, f, _rel(a[f], b[f]))
        assert int(a["step"]) == int(b["step"]) == i
    if ref_trips is not None:
        for r in res:
            assert r["steps"]["cg_trips"] == ref_trips


def test_sharded_step_matches_unsharded_port(two_ranks):
    ref, trips = _port_steps(_deck())
    assert sum(trips) > 0            # the tensor CG iterated
    _check_steps(two_ranks[0], ref, trips, 1e-11)


def test_sharded_step_matches_incflo_tpu(two_ranks, jax_reference):
    _check_steps(two_ranks[0], jax_reference, None, 1e-10)


def test_sharded_step_from_carried_jax_state(two_ranks, jax_reference):
    ref, trips = _port_steps(_deck(), start=jax_reference[0])
    _check_steps(two_ranks[1], ref, trips, 1e-11)
    _check_steps(two_ranks[1], jax_reference, None, 1e-10)


def test_sharded_step_over_four_ranks(four_ranks):
    ref, trips = _port_steps(_deck((32, 16, 8)))
    _check_steps(four_ranks[0], ref, trips, 1e-11)
    _check_steps(four_ranks[0], _jax_steps(_deck((32, 16, 8))), None,
                 1e-10)


# ---------------------------------------------------------------------
# per-rank checkpoints and the CLI on a mesh
# ---------------------------------------------------------------------

def test_sharded_checkpoint_writes_one_shard_per_rank(two_ranks, io_dirs):
    assert sorted(os.listdir(io_dirs / "sharded")) == [
        "Header", "Level_0.shard0.npz", "Level_0.shard1.npz",
        "Shards.json", "Shards.p1.json"]
    shard = np.load(io_dirs / "sharded" / "Level_0.shard1.npz")
    assert shard["velocity"].shape == (N_CELL[0] // 2,) + N_CELL[1:] + (3,)
    assert shard["p"].shape == (N_CELL[0] // 2,) + N_CELL[1:]


def test_incflo_tpu_reads_the_sharded_checkpoint(two_ranks, io_dirs):
    """incflo_tpu's dense reader merges the per-rank manifests into the
    state the ranks wrote, bit for bit."""
    from incflo_tpu.utils import io as jio
    written = two_ranks[0][0]["checkpoint"]["written"]
    s = jio.read_checkpoint(str(io_dirs / "sharded"),
                            JConfig.from_text(_deck()), jnp.float64)
    got = _np_state(s)
    for k in tstate.LevelState._fields + ("t", "dt", "prev_dt",
                                          "prev_prev_dt", "step"):
        assert np.array_equal(got[k], written[k]), k


@pytest.mark.parametrize("case", ["sharded on 1 rank", "sharded on 2 ranks",
                                  "dense on 2 ranks"])
def test_checkpoint_restarts_on_any_rank_count(two_ranks, io_dirs, case):
    """The step after a restart agrees with the unsharded port's step
    STEPS + 1 to the tolerance of the sharded step."""
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(
        _deck()), device="cpu")
    ref = tstate.sim_to_numpy(sim.advance_n(sim.init_state(), STEPS + 1))
    res = two_ranks[0][0]["checkpoint"]
    if case == "sharded on 1 rank":
        s = tio.read_checkpoint(str(io_dirs / "sharded"), sim.cfg,
                                torch.float64, "cpu")
        got = tstate.sim_to_numpy(sim.advance(s))
    else:
        got = res["restarted" if case == "sharded on 2 ranks"
                  else "dense_restarted"]
    assert int(got["step"]) == STEPS + 1
    for f in FIELDS:
        assert _rel(got[f], ref[f]) <= 1e-11, f


def test_cli_on_two_ranks_matches_one(two_ranks, io_dirs, tmp_path,
                                      monkeypatch):
    """main.run on both ranks: rank 0 alone prints and writes the
    plotfiles, each rank its checkpoint shard; the files hold what the
    unsharded driver writes, to the tolerance of the sharded step."""
    from incflo_torch import main as tmain
    res = [r["cli"] for r in two_ranks[0]]
    assert [r["rc"] for r in res] == [0, 0]
    assert "Time, Kinetic Energy" in res[0]["stdout"]
    assert res[1]["stdout"] == ""
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert tmain.run([str(io_dirs / "inputs")] + CLI_ARGS) == 0
    d = io_dirs / "cli"
    assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path)) == [
        "chk00000", "chk00002", "plt00000", "plt00002"]
    assert "Shards.p1.json" in os.listdir(d / "chk00002")
    assert sorted(os.listdir(d / "plt00002")) == [
        "Header", "Level_0.npz", "incflo_job_info"]
    got = np.load(d / "plt00002" / "Level_0.npz")
    ref = np.load(tmp_path / "plt00002" / "Level_0.npz")
    assert sorted(got.files) == sorted(ref.files) and "vort" in ref.files
    # a vector's components relative to the largest of them (shear3d's
    # w is rounding noise)
    group = lambda k: k[:-1] if k[:-1] in ("vel", "gp") else k
    scale = {}
    for k in ref.files:
        scale[group(k)] = max(scale.get(group(k), 0.0),
                              float(np.abs(ref[k]).max()))
    for k in ref.files:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-11 * scale[group(k)], (k, err)
    s = tio.read_checkpoint(str(d / "chk00002"),
                            incflo_torch.IncfloConfig.from_text(_deck()),
                            torch.float64, "cpu")
    r = tio.read_checkpoint(str(tmp_path / "chk00002"),
                            incflo_torch.IncfloConfig.from_text(_deck()),
                            torch.float64, "cpu")
    for f in ("velocity", "p", "gp", "mac_phi"):
        assert _rel(getattr(s.level, f).numpy(),
                    getattr(r.level, f).numpy()) <= 1e-11, f


# ---------------------------------------------------------------------
# scope
# ---------------------------------------------------------------------

@pytest.mark.parametrize("deck", ["nx % R", "nxl < 4", *SCOPE_TEXTS,
                                  *SCOPE_DECKS])
def test_out_of_scope_decks_raise_and_name_the_item(four_ranks, deck):
    """The decks the mesh once refused, naming ROADMAP A14 (AMR with
    embedded boundaries A13b) and what they lacked, build over the
    4-rank mesh: every deck is IN_SCOPE now (an AMR deck its patch tree;
    18 and 12 cells along x, which do not split into 4 slabs at least 4
    cells wide, held whole on every rank)."""
    assert deck in IN_SCOPE
    for res in four_ranks[0]:
        err = res["scope_errors"][deck]
        assert err is None, err


def test_sharded_simulation_needs_a_card_unless_cpu_is_asked(four_ranks):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for res in four_ranks[0]:
        err = res["scope_errors"]["no card"]
        assert err is not None and err[0] == "RuntimeError", err
        assert "CUDA" in err[1], err


def test_slab_mesh_needs_a_card_unless_a_device_is_given(four_ranks):
    """SlabMesh() without a device runs on the card (cuda:{rank %
    count}), and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for res in four_ranks[0]:
        err = res["scope_errors"]["SlabMesh()"]
        assert err is not None and err[0] == "RuntimeError", err
        assert "torch.cuda is not available" in err[1], err


def test_launch_without_a_device_raises_without_a_card():
    """launch.run's ranks run on the card unless device="cpu" is passed:
    with no card it raises before it spawns a rank."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        launch.run(JOB, 2, dict(jobs=[]), timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        launch.run(JOB, 2, dict(jobs=[]), device="cuda", timeout=TIMEOUT)


def test_launch_gate_opens_and_cancel_kills_the_ranks(tmp_path):
    """workers.wait_for holds every rank until its file exists; setting
    launch.run's cancel event kills ranks that wait and run() raises."""
    import concurrent.futures
    import threading
    import time
    go = tmp_path / "go"
    jobs = [("gate", "wait_for", dict(path=str(go)))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ran = pool.submit(launch.run, JOB, 2, dict(jobs=jobs), device="cpu",
                          timeout=TIMEOUT)
        time.sleep(0.5)
        go.touch()
        waited = [r["gate"] for r in ran.result()]
    assert len(waited) == 2 and all(w >= 0.0 for w in waited), waited
    cancel = threading.Event()
    jobs = [("gate", "wait_for", dict(path=str(tmp_path / "never")))]
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ran = pool.submit(launch.run, JOB, 2, dict(jobs=jobs), device="cpu",
                          timeout=TIMEOUT, cancel=cancel)
        time.sleep(1.0)
        cancel.set()
        with pytest.raises(RuntimeError, match="cancelled"):
            ran.result()
    assert time.monotonic() - t0 < TIMEOUT


def test_oversize_level_raises_value_error():
    """The Godunov kernels index with 32-bit integers: a level past that
    raises ValueError naming its shape, periodic and halo-slab alike."""
    with pytest.raises(ValueError, match=r"\(1024, 1024, 1024\) x 3"):
        gk._check_index_range((1024, 1024, 1024), 3)
    slab = (1024 + 2 * gk.HALO, 1024, 1024)
    with pytest.raises(ValueError, match="32-bit indices"):
        gk._check_index_range(slab, 3)
    gk._check_index_range((128 + 2 * gk.HALO, 128, 32), 3)
