"""channel_cyl with its cylinder on cubic cells in incflo_torch against
incflo_tpu (ROADMAP A11): bench.py's deck at n = 32 (32 x 16 x 8 cells,
mass inflow with a tracer at x-lo, pressure outflow at x-hi, no-slip y
walls, the cylinder a body in the flow) in a 0.8 x 0.4 x 0.2 box, init
+ 3 steps in float64.  On bench.py's own box the cells have aspect 3 and
the nodal V-cycles run to maxiter (tests/test_torch_eb_step.py, ROADMAP
C); here every iterative solve -- the area-fraction MAC CG, the
cut-cell velocity and tracer solves, the prebuilt 27-point EBNodalSolver
-- meets its tolerance.  Every field and dt within 1e-10 of
incflo_tpu's, every iterative solve ending on the same iteration.
"""

import pytest

import torch_parity as tp

STEPS = 3


@pytest.fixture(scope="module")
def channel_cyl_cubic():
    text = tp.channel_cyl_cubic_deck(32)
    _, runs = tp.reference_run(text, STEPS)
    return text, runs[0]


def test_channel_cyl_cubic_matches_incflo_tpu(channel_cyl_cubic):
    text, (states, iters) = channel_cyl_cubic
    sim = tp.port_sim(text)
    assert sim.eb is not None and sim._nodal_eb_hat is not None
    assert len(set(sim.grid.dx)) == 1
    s = sim.init_state()
    with tp.logged_solves() as log:
        s, worst, got = tp.compare_run(sim, s, states, iters)
    assert worst <= 1e-10
    assert len(log["nodal"]) == 2 * STEPS and log["cell"]
    for kind in ("nodal", "cell"):
        assert all(r <= 1.0 and it < m for r, it, m in log[kind]), log
    cov = sim.eb.covered.numpy() > 0.5
    assert float(abs(s.level.velocity.numpy()[cov]).max()) == 0.0
