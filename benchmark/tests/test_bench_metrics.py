"""Each metric reader on a synthetic record."""

import pytest

from benchmark.harness import core
from benchmark.roofline import kernels

F64 = "float64"
CELLS = (8, 8, 4)
UAD = ("uad", dict(cells=CELLS, dx=(0.125, 0.125, 0.0625),
                   vel=((8, 8, 4, 3), F64), ppm=True))
CELL_CALL = dict(kind="cell", x=((8, 8, 4), F64),
                 coefs=[((8, 8, 4), F64)] * 5, fwall=None, dx=None,
                 nsweeps=2, want=True, bc=None)


def _trace():
    events = [("void uad_kernel<double, 0>(UadArgs<double, 0>)", 0.0, 10.0),
              ("void predict_kernel<double, 0>(PredictArgs)", 10.0, 20.0),
              ("sm90_xmma_gemm_f64f64_f64f32_f64_tn_n_tilesize", 30.0, 5.0),
              ("void at::native::vectorized_elementwise_kernel<4>", 40.0, 5.0),
              ("Memcpy DtoD (Device -> Device)", 50.0, 5.0),
              ("void cell_kernel<double>(CellArgs<double>)", 60.0, 10.0)]
    calls = [dict(CELL_CALL, regime=1, launches=1, ms=0.01),
             dict(CELL_CALL, regime=2, launches=1, ms=0.05)]
    return {"events": events, "godunov_calls": [UAD],
            "smoother_calls": calls}


def _record(**kw):
    rec = {"cells": 10, "steps": 5, "window_s": 2.0, "step_ms": [1.0],
           "setup_s": 12.5, "sim_build_s": 3.5,
           "counts": {"cell_iters": 10, "nodal_cycles": 5,
                      "tensor_cg_iters": 5, "host_syncs": 8},
           "peak_mem_bytes": 2 ** 31}
    rec.update(kw)
    return rec


def read(name, record):
    return core.reader(name)(record)


def test_host_clock_and_counter_readers():
    rec = _record()
    assert read("cells_per_s", rec) == 25.0
    assert read("setup_s", rec) == 12.5
    assert read("sim_build_s", rec) == 3.5
    assert read("peak_mem_gib", rec) == 2.0
    assert read("peak_mem_gib", _record(peak_mem_bytes=None)) is None
    assert read("solver_iters_per_step", rec) == 4.0
    assert read("host_syncs_per_step", rec) == 1.6
    quiet = _record(counts={"cell_iters": 0, "host_syncs": 0})
    assert read("solver_iters_per_step", quiet) is None
    assert read("host_syncs_per_step", quiet) is None


def test_step_p95_needs_200_steps():
    assert read("step_ms_p95", _record(step_ms=[1.0] * 199)) is None
    steps = [float(i) for i in range(1, 201)]
    assert read("step_ms_p95", _record(step_ms=steps)) == 190.0


def test_trace_readers():
    rec = _record(steps=2, window_s=200e-6, trace=_trace())
    assert read("direct_solve_ms_per_step", rec) == pytest.approx(2.5e-3)
    assert read("torch_ops_ms_per_step", rec) == pytest.approx(5e-3)
    # five kernels (not the copy) and the cooperative launch
    assert read("launches_per_step", rec) == 3.0
    # busy: 55 us of the trace's union and 50 us of the cooperative call
    assert read("device_idle_share", rec) == pytest.approx(47.5)
    ops, nbytes, dt = kernels.godunov_call(*UAD)
    assert read("godunov_roofline", rec) == pytest.approx(
        100 * kernels.bound_s(ops, nbytes, dt) / 30e-6)
    b = kernels.bound_s(*kernels.smoother_call(CELL_CALL))
    assert read("smoother_roofline", rec) == pytest.approx(
        100 * 2 * b / 60e-6)


def test_a_visible_cooperative_launch_is_not_added():
    tr = _trace()
    tr["events"].append(("void cell_kernel<double>(CellArgs<double>)",
                         80.0, 50.0))
    rec = _record(steps=2, window_s=200e-6, trace=tr)
    assert read("launches_per_step", rec) == 3.0
    assert read("device_idle_share", rec) == pytest.approx(47.5)


def test_trace_readers_without_a_trace_or_calls():
    rec = _record()
    for name in ("launches_per_step", "direct_solve_ms_per_step",
                 "torch_ops_ms_per_step", "device_idle_share",
                 "godunov_roofline", "smoother_roofline"):
        assert read(name, rec) is None
    tr = _trace()
    tr["godunov_calls"], tr["smoother_calls"] = [], []
    rec = _record(trace=tr)
    assert read("godunov_roofline", rec) is None
    assert read("smoother_roofline", rec) is None


@pytest.mark.parametrize("base", ["cells_per_s", "launches_per_step",
                                  "solver_iters_per_step",
                                  "host_syncs_per_step", "smoother_roofline",
                                  "torch_ops_ms_per_step",
                                  "device_idle_share", "peak_mem_gib"])
def test_multigrid_variants_read_as_their_base(base):
    rec = _record(steps=2, window_s=200e-6, trace=_trace())
    assert read(base + ".multigrid", rec) == read(base, rec) is not None
