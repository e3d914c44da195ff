"""Explicit diffusion in incflo_torch against incflo_tpu (ROADMAP A9c):
the diffusive CFL of compute_dt, divtau and the tracer Laplacian added
in full in the predictor (tracer weight 1) and averaged with the
predicted state's in the MOL corrector, and no diffusion solve.

Decks (float64, init + 3 steps, from the port's own init_state and from
incflo_tpu's carried state; every field and dt to 1e-10 relative to its
max, every iterative solve ending on the same iteration):
  * shear3d_explicit: bench.py's shear3d at 16 x 16 x 8 with
    diffusion_type = 0 (Godunov, periodic, direct projections);
  * bingham_explicit: the walled Bingham channel of
    tests/test_torch_rheology.py with diffusion_type = 0 and no fixed
    dt, so that dt follows the actual viscosity (eta about 1000 mu near
    zero strain rate); from rest plus a smooth velocity perturbation
    from a seed;
  * channel_explicit: the inflow/outflow channel of
    tests/test_torch_inflow.py with diffusion_type = 0 (MOL with an
    advected, explicitly diffused tracer);
  * tgv2d_explicit: bench.py's tgv2d at 16^2 with diffusion_type = 0 (2D
    MOL, which the port now accepts; on the card it takes the plain
    step, not the fused kernel).
"""

import numpy as np
import pytest
import torch

from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops import step2d_kernels as s2

import bench
import torch_parity as tp

STEPS = 3
SEED = 13


def _bingham_explicit():
    text = tp.bingham_deck(16).replace("incflo.fixed_dt = 0.01", "")
    return text + tp.EXPLICIT


DECKS = {
    "shear3d_explicit": lambda: tp.shear3d_deck(16, extra=tp.EXPLICIT),
    "bingham_explicit": _bingham_explicit,
    "channel_explicit": lambda: tp.channel_deck(16) + tp.EXPLICIT,
    "tgv2d_explicit": lambda: bench._deck("tgv2d", 16, "float64")[0]
    + tp.EXPLICIT,
}


def _perturb(name, grid):
    return tp.smooth_perturbation(grid, SEED) \
        if name == "bingham_explicit" else None


@pytest.fixture(scope="module", params=list(DECKS))
def deck(request):
    name = request.param
    text = DECKS[name]()
    grid = TConfig.from_text(text).grid
    _, runs = tp.reference_run(text, STEPS, (_perturb(name, grid),))
    return name, text, runs[0]


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_explicit_deck_matches(deck, start):
    name, text, (states, iters) = deck
    sim = tp.port_sim(text)
    assert sim._diff_proto is None
    s = tp.own_start(sim, _perturb(name, sim.grid)) if start == "own_init" \
        else tp.carried(states[0])
    s, _, got = tp.compare_run(sim, s, states, iters)
    # no velocity solve, so no tensor CG
    assert all(it["tensor_cg_iters"] == 0 for it in got)
    assert bool(torch.isfinite(s.level.velocity).all())
    if name == "tgv2d_explicit":
        assert s2.out_of_scope(sim) == "explicit diffusion"


@pytest.mark.parametrize("advection", ["godunov", "mol"])
def test_explicit_diffusion_solves_nothing(advection, monkeypatch):
    """With explicit diffusion a step (predictor and, for MOL, corrector)
    makes no velocity or tracer solve and never asks for the solves' dt;
    the tracer still diffuses (its Laplacian is added explicitly)."""
    extra = ("incflo.advect_tracer = true\nincflo.mu_s = 0.01\n"
             + tp.EXPLICIT + (tp.MOL if advection == "mol" else ""))
    sim = tp.port_sim(tp.shear3d_deck(8, extra=extra))

    def refuse(*a, **k):
        raise AssertionError("a diffusion solve ran")

    monkeypatch.setattr(tdiff, "diffuse_velocity", refuse)
    monkeypatch.setattr(tdiff, "diffuse_scalar", refuse)
    s0 = sim.init_state()
    tmg.reset_counts()
    s = sim.advance_n(s0, 2)
    assert tmg.COUNTS["cell_solves"] == 0 == tmg.COUNTS["tensor_cg_iters"]
    with pytest.raises(ValueError, match="no diffusion solve"):
        sim._dt_diff(s.dt)
    # the tracer diffused: it differs from the same steps with mu_s = 0
    still = tp.port_sim(tp.shear3d_deck(8, extra=extra.replace(
        "incflo.mu_s = 0.01", "incflo.mu_s = 0.")))
    s_still = still.advance_n(still.init_state(), 2)
    assert float((s.level.tracer - s_still.level.tracer).abs().max()) > 1e-6


def test_explicit_dt_follows_the_viscosity():
    """Bingham with explicit diffusion: eta near zero strain rate is
    about tau_0 / papa_reg = 1000 mu, and dt follows it (incflo_tpu
    tests/test_tensor_coupling.py:82): far below the Newtonian dt, and
    equal to incflo_tpu's."""
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_tpu.simulation import Simulation as JSim

    def dt_of(text, pkg):
        if pkg == "tpu":
            sim = JSim(JConfig.from_text(text))
        else:
            sim = tp.port_sim(text)
        s = sim.init_state()
        lvl = s.level
        vf = sim.compute_vel_forces(lvl.density, lvl.tracer, lvl.tracer,
                                    lvl.gp)
        return float(sim.compute_dt(lvl.velocity, lvl.density, vf, s))

    text = _bingham_explicit()
    newtonian = text.replace('incflo.fluid_model = "bingham"', "")
    dt, dt_n = dt_of(text, "torch"), dt_of(newtonian, "torch")
    assert dt < dt_n / 50, (dt, dt_n)
    assert abs(dt - dt_of(text, "tpu")) <= 1e-14 * dt
    assert abs(dt_n - dt_of(newtonian, "tpu")) <= 1e-14 * dt_n
