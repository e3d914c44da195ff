"""A 2D mass-inflow channel in incflo_torch against incflo_tpu (ROADMAP
A8): the x-y section of channel_cyl without its cylinder (32 x 16 cells,
mass inflow with a tracer at x-lo, pressure outflow at x-hi, no-slip y
walls, probtype 31, MOL, one advected tracer), from its init plus a
smooth velocity perturbation from a seed (its own channel profile has a
pressure of rounding noise).  Init + 3 steps in float64: every field and
dt within 1e-10 of incflo_tpu's, and the nodal V-cycles and tensor-CG
iterations equal step by step; the outflow carries what the inflow
brings.
"""

import numpy as np
import pytest

import torch_parity as tp

SEED = 3


@pytest.fixture(scope="module")
def channel2d():
    text = tp.channel2d_deck()
    grid = tp.port_sim(text).grid
    pert = tp.smooth_perturbation(grid, SEED)
    _, runs = tp.reference_run(text, 3, (pert,))
    return text, pert, runs[0]


def test_channel2d_matches_incflo_tpu(channel2d):
    text, pert, (states, iters) = channel2d
    sim = tp.port_sim(text)
    assert sim.grid.ndim == 2 and not any(sim.grid.periodic)
    s, worst, got = tp.compare_run(sim, tp.own_start(sim, pert), states,
                                   iters)
    assert worst <= 1e-10
    assert all(it["nodal_cycles"] > 0 and it["tensor_cg_iters"] > 0
               for it in got)
    # the inflow face holds the inflow velocity, and the mean x velocity
    # of the last column stays near it
    u = s.level.velocity[..., 0].numpy()
    assert np.isfinite(u).all()
    assert abs(u[-1].mean() - 1.0) < 0.2
