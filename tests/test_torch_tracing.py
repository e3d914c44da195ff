"""The step's phase spans (incflo_torch/utils/tracing.py), on the CPU:
off they cost a test and record nothing; on they leave the step's bits
alone, tile the step in the order of tracing.PHASES and share the
profiler's clock; under the CLI's profiler they are its ranges only,
and stop with it."""

import time

import pytest
import torch

import torch_parity as tp

import bench
from incflo_torch import main
from incflo_torch.simulation import Simulation
from incflo_torch.utils import tracing

PHASES = list(tracing.PHASES)
# a MOL step: the predictor's phases, then the corrector's, whose
# convective term comes before its forces
MOL_PHASES = PHASES + ["predict", "mac", "advect", "forces", "diffuse",
                       "nodal"]


def _deck(name):
    if name == "shear3d":
        return tp.shear3d_deck(16)
    if name == "shear3d_mol":
        return tp.shear3d_deck(16, extra=tp.MOL)
    return bench._deck("rt", 16, "float64")[0]


@pytest.fixture
def traced():
    """tracing.SPANS on for the test, off after it."""
    tracing.SPANS = []
    yield tracing
    tracing.SPANS = None


def _started(name):
    sim = tp.port_sim(_deck(name))
    return sim, sim.init_state()


def test_off_is_one_shared_noop():
    assert tracing.SPANS is None
    a, b = tracing.span("dt"), tracing.span("something else")
    assert a is tracing.NOOP and b is tracing.NOOP
    with a as got:
        assert got is tracing.NOOP
    assert tracing.SPANS is None


@pytest.mark.parametrize("name", ["shear3d", "rt"])
def test_step_is_bit_equal_with_tracing_on_and_off(name):
    sim, s0 = _started(name)
    off = sim.advance(s0)
    tracing.SPANS = []
    try:
        on = sim.advance(s0)
        names = [sp[0] for sp in tracing.SPANS]
    finally:
        tracing.SPANS = None
    assert names == PHASES
    for f in tp.FIELDS:
        assert torch.equal(getattr(off.level, f), getattr(on.level, f)), f
    for f in ("t", "dt", "prev_dt", "step"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f


def test_phases_tile_a_godunov_step_in_order(traced):
    sim, s = _started("shear3d")
    s = sim.advance(s)              # lazily built state out of the way
    traced.SPANS.clear()
    with traced.span("step"):
        sim.advance(s)
    spans = traced.SPANS
    assert [sp[0] for sp in spans] == ["step"] + PHASES
    assert spans[0][1] is None
    assert all(sp[1] == 0 for sp in spans[1:])
    assert all(sp[2] <= sp[3] for sp in spans)
    for a, b in zip(spans[1:], spans[2:]):
        assert a[3] <= b[2]         # one after the other, not overlapping
    step_ns = spans[0][3] - spans[0][2]
    covered = sum(t1 - t0 for _, _, t0, t1 in spans[1:])
    assert covered >= 0.95 * step_ns, covered / step_ns


def test_mol_runs_each_phase_twice(traced):
    sim, s = _started("shear3d_mol")
    traced.SPANS.clear()
    sim.advance(s)
    assert [sp[0] for sp in traced.SPANS] == MOL_PHASES


def test_static_solvers_span_only_for_prebuilt_solvers(traced):
    tp.port_sim(_deck("shear3d"))
    assert [sp[0] for sp in traced.SPANS] == ["static_solvers"]
    traced.SPANS.clear()
    tp.port_sim(_deck("rt"))        # variable density: built every step
    assert traced.SPANS == []


def test_spans_nest_and_close_on_an_exception(traced):
    with pytest.raises(ValueError):
        with traced.span("outer"):
            with traced.span("inner"):
                raise ValueError("x")
    with traced.span("after"):
        pass
    (o, op, o0, o1), (i, ip, i0, i1), (a, ap, _, a1) = traced.SPANS
    assert (o, op, i, ip, a, ap) == ("outer", None, "inner", 0, "after", None)
    assert o0 <= i0 <= i1 <= o1 and a1 is not None
    assert tracing._open == []


def test_a_span_holds_the_profiler_events_run_inside_it(traced):
    """The shared clock: an aten op run inside a span starts and ends,
    by the profiler's own event, inside the span's [t0, t1]."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand(256, 256, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with traced.span("inside"):
            time.sleep(0.002)
            torch.mm(x, x)
            time.sleep(0.002)
        time.sleep(0.002)
    _, _, t0, t1 = traced.SPANS[0]
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert t0 <= mm[0].start_ns() and mm[0].end_ns() <= t1
    assert mm[0].start_ns() - t0 < 1e9   # the same epoch, not an offset


def test_the_patch_driver_appends_each_levels_phases(traced):
    """The patch AMR driver: its dt over the levels, then each level's
    step (dt_force: the level's dt span holds small_dt alone)."""
    amr = tp.port_amr(tp.rt2d_amr_deck())
    s = amr.init_state()
    traced.SPANS.clear()
    amr.advance(s)
    levels = len(amr.sims)
    assert levels > 1
    assert [sp[0] for sp in traced.SPANS] == ["dt"] + PHASES * levels
    assert all(sp[1] is None for sp in traced.SPANS)


def test_cli_profile_takes_spans_as_ranges_and_stops_them_on_a_raise(
        tmp_path, monkeypatch):
    """Under INCFLO_PROFILE_DIR a span is a profiler range and no list
    grows; a run that raises leaves the spans and the profiler off."""
    seen = []

    def failing(self, s):
        seen.append(tracing.SPANS)
        with tracing.span("dt") as r:
            seen.append(r)
        raise RuntimeError("step failed")

    deck = tmp_path / "inputs"
    deck.write_text(_deck("shear3d"))
    monkeypatch.setattr(Simulation, "_advance_impl", failing)
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    monkeypatch.setenv("INCFLO_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="step failed"):
        main.run([str(deck), "max_step=1", "amr.plot_int=-1",
                  "amr.check_int=-1"])
    assert seen[0] is tracing.RANGES
    assert isinstance(seen[1], torch.profiler.record_function)
    assert tracing.SPANS is None and tracing._open == []
    assert not torch.autograd._profiler_enabled()
