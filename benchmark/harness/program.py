"""The system under test: incflo_torch's Simulation of a cell's deck,
started from the benchmark's fields.  This is the only module of the
harness that imports the program."""

from __future__ import annotations

import torch


def build(deck_text: str, device):
    """The Simulation of the deck (its static solvers built)."""
    from incflo_torch import IncfloConfig, Simulation
    return Simulation(IncfloConfig.from_text(deck_text), device=device)


def initial_state(sim, velocity, density, tracer):
    """The t = 0 state of the benchmark's fields, after the deck's
    initial projection, as Simulation.init_state makes it from the
    deck's own fields (the decks ask for no initial iterations)."""
    from incflo_torch.state import LevelState, SimState
    dt, dev = velocity.dtype, velocity.device
    zero = torch.zeros((), dtype=dt, device=dev)
    level = LevelState(
        velocity=velocity, density=density, tracer=tracer,
        gp=torch.zeros_like(velocity),
        p=torch.zeros(sim.grid.node_shape, dtype=dt, device=dev),
        mac_phi=torch.zeros_like(density))
    s = SimState(level=level, t=zero, dt=zero, prev_dt=zero,
                 prev_prev_dt=zero,
                 step=torch.zeros((), dtype=torch.int32, device=dev))
    if sim.cfg.do_initial_proj:
        s = s._replace(level=sim._initial_projection(s.level))
    if sim.cfg.initial_iterations:
        raise ValueError("the benchmark's decks take no initial iterations")
    return s


def fields_of(s):
    """The compared fields of a program state, as a dict of tensors."""
    lv = s.level
    return {"velocity": lv.velocity, "density": lv.density,
            "tracer": lv.tracer, "gp": lv.gp, "p": lv.p, "t": s.t,
            "dt": s.dt}
