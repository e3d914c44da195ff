"""channel_cyl with its cylinder in incflo_torch against incflo_tpu
(ROADMAP A11): bench.py's deck at n = 32 (32 x 16 x 8 cells, mass inflow
with a tracer at x-lo, pressure outflow at x-hi, no-slip y walls, the
cylinder a body in the flow), init + 1 step in float64.  It runs MOL-EB
(centroid face states, the cut-cell rate and its redistribution), the
area-fraction MAC projection, the cut-cell velocity solve with its wall
term and second-order corrections, the tracer's no-flux EB walls, the
prebuilt 27-point EBNodalSolver and the small-cell fix.  Every field and
dt within 1e-10 of incflo_tpu's, every iterative solve ending on the
same iteration.  On this box the cells have aspect 3 and the channel's
nodal V-cycles reach maxiter in both packages alike (ROADMAP C), already
in the first step; the converged form of this deck, over 3 steps, is
tests/test_torch_eb_channel_cubic.py.  The other EB decks are
tests/test_torch_eb_bingham.py, tests/test_torch_eb_vd.py and
tests/test_torch_eb_probtype6.py.
"""

import pytest

import torch_parity as tp


@pytest.fixture(scope="module")
def channel_cyl():
    text = tp.eb_deck("channel_cyl", 32)
    _, runs = tp.reference_run(text, 1)
    return text, runs[0]


def test_channel_cyl_matches_incflo_tpu(channel_cyl):
    text, (states, iters) = channel_cyl
    sim = tp.port_sim(text)
    assert sim.eb is not None and sim._nodal_eb_hat is not None
    s, worst, got = tp.compare_run(sim, sim.init_state(), states, iters)
    assert worst <= 1e-10
    # covered cells carry no velocity
    cov = sim.eb.covered.numpy() > 0.5
    assert float(abs(s.level.velocity.numpy()[cov]).max()) == 0.0
