"""The walled pieces of a 3D step on an x slab of a mesh, on the CPU:
the ghost fill of walls and inflow on y and z after the x halo
(bcs.grow), the inflow profile's x coordinate on a slab
(bcs.ExtDirValues), and the plain walled Godunov chain on the slab's
windows with the MAC faces beyond the slab from the neighbours
(ops/godunov_walls.py); and a deck with mass inflow on z whose profile
varies along x, stepped on 2 ranks.

One spawn of 2 gloo ranks (incflo_torch.parallel.workers.several), in
float64.  Tolerances: the Godunov chain exact against the whole level's
rows (the same operations on the same values); the steps 1e-11 relative
to each field's max against 1 rank, equal CG iterations, V-cycles and
tensor-CG iterations in every step on every rank.
"""

import numpy as np
import pytest
import torch

import bench
import torch_parity as tp
from incflo_torch import state as tstate
from incflo_torch.ops import multigrid as tmg

from incflo_torch.parallel import launch

JOB = "incflo_torch.parallel.workers:several"
STEPS = 2
KINDS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")
# rt's slip z walls, and mass inflow through z-lo with probtype 33's
# profile 6 x (1 - x) (pressure outflow at z-hi), no-slip y walls
DECKS = {
    "slip z": bench._deck("rt", 32, "float64")[0],
    "inflow z": tp._without(bench._deck("shear3d", 16, "float64")[0],
                            ("geometry.is_periodic", "incflo.probtype"))
    + """geometry.is_periodic = 1 0 0
ylo.type = "nsw"
yhi.type = "nsw"
zlo.type = "mi"
zlo.velocity = 0. 0. 1.
zhi.type = "po"
zhi.pressure = 0.
incflo.probtype = 33
incflo.constant_density = false
incflo.advect_tracer = true
incflo.mu_s = 0.001
""",
}


def _fields(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _inputs(deck):
    sim = tp.port_sim(deck)
    cells = sim.grid.cell_shape
    vel = 0.5 + 0.1 * _fields(cells + (3,), 1)
    dt = 0.5 * min(sim.grid.dx) / float(np.abs(vel).max())
    return dict(vel=vel, forces=_fields(cells + (3,), 2, 0.1),
                q=_fields(cells + (sim.cfg.ntrac,), 3), dt=dt)


@pytest.fixture(scope="module")
def inputs():
    return {name: _inputs(deck) for name, deck in DECKS.items()}


@pytest.fixture(scope="module")
def two_ranks(inputs):
    jobs = [(f"godunov {k}", "godunov_walls", dict(deck=d, **inputs[k]))
            for k, d in DECKS.items()]
    jobs.append(("steps", "steps", dict(deck=DECKS["inflow z"],
                                        nsteps=STEPS)))
    return launch.run(JOB, 2, dict(jobs=jobs), device="cpu", timeout=300.0)


@pytest.mark.parametrize("deck", list(DECKS))
def test_walled_godunov_on_a_slab_equals_whole_level_rows(two_ranks, inputs,
                                                          deck):
    """Ghost fill, MAC prediction and advection of velocity, density and
    rho*tracer on each rank's slab: bit for bit the whole level's rows
    (x faces: the slab's nxl + 1)."""
    from incflo_torch.parallel.workers import walled_godunov_chain
    sim = tp.port_sim(DECKS[deck])
    t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in inputs[deck].items()}
    ref = walled_godunov_chain(sim, t["vel"], t["forces"], t["q"], t["dt"])
    nxl = sim.grid.n_cell[0] // 2
    for r, res in enumerate(two_ranks):
        got = res[f"godunov {deck}"]
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            n = nxl + (1 if k == "umac0" else 0)
            assert np.array_equal(got[k], v.numpy()[r * nxl:r * nxl + n]), \
                (r, k)


def test_inflow_deck_on_two_ranks_matches_one(two_ranks):
    """Mass inflow on z with an x profile, pressure outflow, no-slip y
    walls, variable density and a tracer: init + 2 steps."""
    sim = tp.port_sim(DECKS["inflow z"])
    tmg.reset_counts()
    s = sim.init_state()
    states = [tstate.sim_to_numpy(s)]
    tallies = [{k: tmg.COUNTS[k] for k in KINDS}]
    for _ in range(STEPS):
        before = dict(tmg.COUNTS)
        s = sim.advance(s)
        tallies.append({k: tmg.COUNTS[k] - before[k] for k in KINDS})
        states.append(tstate.sim_to_numpy(s))
    assert sum(t["nodal_cycles"] for t in tallies) > 0
    got = two_ranks[0]["steps"]["states"]
    for i, (a, b) in enumerate(zip(got, states)):
        for f in tp.FIELDS + ("dt",):
            err = float(np.abs(a[f] - b[f]).max()
                        / max(float(np.abs(b[f]).max()), 1e-300))
            assert err <= 1e-11, (i, f, err)
    for r in two_ranks:
        assert r["steps"]["tallies"] == tallies
