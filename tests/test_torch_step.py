"""The whole shear3d step of incflo_torch against incflo_tpu: the deck of
bench.py at 16x16x8, float64, the initial projection and 5 steps.

Tolerance: 1e-10 relative to each field's max, in velocity, p, gp and
dt.  Both packages run the same algorithm in float64; the differences
are rounding, carried through five projections and the tensor CG
(measured about 1e-14).  The port is run twice: from its own
init_state, and from incflo_tpu's initial state carried across with
state.sim_from_numpy.  The solver symbols the port builds for itself
are held against incflo_tpu's.
"""

import numpy as np
import pytest
import torch

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.simulation import Simulation as JSim

import incflo_torch
from incflo_torch import state as tstate

STEPS = 5
FIELDS = ("velocity", "p", "gp")


def _np_state(s):
    out = {f: np.asarray(getattr(s.level, f))
           for f in tstate.LevelState._fields}
    for k in ("t", "dt", "prev_dt", "prev_prev_dt", "step"):
        out[k] = np.asarray(getattr(s, k))
    return out


@pytest.fixture(scope="module")
def deck():
    text, _ = bench._deck("shear3d", 16, "float64")
    return text


@pytest.fixture(scope="module")
def reference(deck):
    sim = JSim(JConfig.from_text(deck))
    s = sim.init_state()
    states = [_np_state(s)]
    for _ in range(STEPS):
        s = sim.advance(s)
        states.append(_np_state(s))
    return sim, states


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _compare(sim, s, ref_states):
    for i, ref in enumerate(ref_states):
        if i > 0:
            s = sim.advance(s)
        got = tstate.sim_to_numpy(s)
        for f in FIELDS + ("dt",):
            assert got[f].shape == ref[f].shape, (i, f)
            assert _rel(got[f], ref[f]) <= 1e-10, (i, f, _rel(got[f],
                                                            ref[f]))
        assert int(got["step"]) == int(ref["step"]) == i
    return s


def test_step_from_own_init_matches(deck, reference):
    _, ref = reference
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    s = _compare(sim, sim.init_state(), ref)
    assert bool(torch.isfinite(s.level.velocity).all())


def test_step_from_carried_state_matches(deck, reference):
    _, ref = reference
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    s0 = tstate.sim_from_numpy(ref[0], "cpu", torch.float64)
    _compare(sim, s0, ref)


def test_prebuilt_symbols_match(deck, reference):
    jsim, _ = reference
    tsim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(deck), device="cpu")
    pairs = [(jsim._mac_solver, tsim._mac_solver),
             (jsim._nodal_hat, tsim._nodal_hat),
             (jsim._diff_proto, tsim._diff_proto)]
    for js, ts in pairs:
        j, t = js.symbol, ts.symbol
        assert j.cells == t.cells and j.batched == t.batched
        assert _rel(t.sym_face.numpy(), np.asarray(j.sym_face)) <= 1e-12
        for a, b in zip(t.fwd + t.inv, j.fwd + j.inv):
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-12


def test_initial_iterations_match(deck):
    """init_state with one pressure iteration (the predictor in
    incremental mode) -- decks that keep the default
    initial_iterations take this path."""
    text = deck + "\nincflo.initial_iterations = 1\n"
    jsim = JSim(JConfig.from_text(text))
    ref = _np_state(jsim.init_state())
    tsim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                   device="cpu")
    got = tstate.sim_to_numpy(tsim.init_state())
    for f in FIELDS + ("mac_phi", "dt"):
        assert _rel(got[f], ref[f]) <= 1e-10, f


def test_evolve_stops_at_max_steps(deck):
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck),
                                  device="cpu")
    seen = []
    s = sim.evolve(max_steps=2, callback=lambda st: seen.append(int(st.step)))
    assert seen == [1, 2] and int(s.step) == 2
