"""The 2D Rayleigh-Taylor deck in incflo_torch against incflo_tpu
(ROADMAP A8): the one-level form of tests/test_amr_patch.py's RT2D deck
(16 x 32 cells, periodic x, slip y walls, probtype 5, variable density,
one advected tracer, Godunov), init + 3 steps in float64.  It runs the
walled 2D Godunov chain, the 2D multigrid V-cycles of the variable
density MAC, tracer and velocity solves and the nodal projection, each
level smoothed in incflo_tpu's own arithmetic.  Every field and dt is
within 1e-10 of incflo_tpu's, and every iterative solve (CG iterations,
V-cycles, tensor-CG iterations) ends on the same iteration.  The MOL form
of the deck is tests/test_torch_rt2d_mol.py.
"""

import pytest

from incflo_torch.ops import godunov_kernels as gk
from incflo_torch.ops import smoother_kernels as sk

import torch_parity as tp


@pytest.fixture(scope="module")
def rt2d():
    text = tp.rt2d_deck()
    _, runs = tp.reference_run(text, 3)
    return text, runs[0]


def test_rt2d_godunov_matches_incflo_tpu(rt2d):
    text, (states, iters) = rt2d
    sim = tp.port_sim(text)
    assert sim.grid.ndim == 2 and sim.cfg.use_godunov
    g0, s0 = dict(gk.LAUNCHES), dict(sk.LAUNCHES)
    _, worst, got = tp.compare_run(sim, sim.init_state(), states, iters)
    assert worst <= 1e-10
    # the V-cycles ran, and no 3D kernel path was taken
    assert all(it["cell_iters"] > 0 and it["nodal_cycles"] > 0
               for it in got)
    assert gk.LAUNCHES == g0 and sk.LAUNCHES == s0


class _KernelCalled(Exception):
    pass


def test_2d_levels_never_reach_the_smoother_kernels(monkeypatch):
    """A step of the 2D deck, its V-cycles included, calls neither
    smoother kernel wrapper: 2D levels are swept in plain PyTorch."""
    def refuse(*args, **kwargs):
        raise _KernelCalled()
    for name in ("cell_smooth", "nodal_smooth", "cell_smooth_plain",
                 "nodal_smooth_plain"):
        monkeypatch.setattr(sk, name, refuse)
    sim = tp.port_sim(tp.rt2d_deck())
    from incflo_torch.ops import multigrid as tmg
    tmg.reset_counts()
    s = sim.advance(sim.init_state())
    assert tmg.COUNTS["cell_iters"] > 0 and tmg.COUNTS["nodal_cycles"] > 0
    assert bool(s.level.velocity.isfinite().all())
