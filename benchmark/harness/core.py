"""One run of one cell: set-up, the measured window, the check, and the
result.  Driven by data: a cell is benchmark/workloads/<name>.json, its
configuration benchmark/configs/<config>.json, each metric
benchmark/metrics/<metric>.py, and which metrics a cell reports is read
from BENCHMARK.json.  Nothing here names a cell, a configuration or a
metric.

The record a metric reader gets (a dict):
  cells, steps, window_s      the level's cells, the steps launched in
                              the window, its host seconds (dispatch of
                              the first step to the synchronize after
                              the last)
  step_ms                     per-step device ms from CUDA events after
                              consecutive steps (the first from an event
                              before the window)
  setup_s, sim_build_s        host seconds from the harness's entry to
                              the window; of building the Simulation and
                              its initial state
  counts                      the program's solver tallies over the
                              window (incflo_torch.ops.multigrid.COUNTS)
  peak_mem_bytes              torch.cuda.max_memory_allocated over
                              set-up and window
  trace                       with --trace 1: events, godunov_calls,
                              smoother_calls (benchmark.harness.trace)
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import torch

from benchmark.harness import check, fields, program, trace
from benchmark.reference.deck import Deck

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# the traced window's length at most: its device events are read back
# and reduced within the run's time limit
TRACE_SECONDS = 5.0


def load_spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


class Cell:
    """A workload file, its configuration and the deck it runs."""

    def __init__(self, name: str):
        self.name = name
        self.workload = json.loads(
            (BENCH / "workloads" / f"{name}.json").read_text())
        self.config = json.loads((BENCH / "configs" /
                                  f"{self.workload['config']}.json")
                                 .read_text())
        n = self.workload["n"]
        nx, ny, nz = (int(n * f) for f in self.config["cells_of_n"])
        self.deck_text = "\n".join(self.config["deck"]).format(nx=nx, ny=ny,
                                                                nz=nz)
        self.deck = Deck.from_text(self.deck_text)
        self.cells = nx * ny * nz


def cell_metrics(spec, name, kind):
    """The entries of spec[kind] ("end_to_end" or "per_layer") that the
    cell reports: those without a workloads list, and those listing it."""
    return [m for m in spec[kind] if name in m.get("workloads", [name])]


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(state):
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def run_cell(name, seed, seconds, traced, t_entry, device="cuda",
             step=None, spec=None):
    """The result of one run (a dict, keys in the order printed) and the
    lines that end standard error.  step: for the tests of the check, a
    function of the Simulation that returns the step to run in place of
    its advance (a planted fault)."""
    spec = load_spec() if spec is None else spec
    dev = torch.device(device)
    cell = Cell(name)
    dtype = getattr(torch, cell.deck.dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    from incflo_torch.ops import multigrid as mg

    # set-up: the fields, the Simulation and its start, warm-up steps
    t_build = time.perf_counter()
    stamps = {"imports and CUDA context": t_build - t_entry}
    v0, r0, tr0 = fields.initial_fields(cell.deck, seed, dtype, dev)
    sim = program.build(cell.deck_text, dev)
    s = program.initial_state(sim, v0, r0, tr0)
    _sync(dev)
    sim_build_s = time.perf_counter() - t_build
    advance = sim.advance if step is None else step(sim)
    inputs = _host({"velocity": v0, "density": r0, "tracer": tr0})
    del v0, r0, tr0
    port = {"init": s.level.velocity.detach().cpu()}
    stamps["Simulation and initial state"] = sim_build_s
    t_warm = time.perf_counter()
    for k in range(int(cell.workload["warmup_steps"])):
        s = advance(s)
        if k == 0:
            port["first"] = _host(program.fields_of(s))
            _sync(dev)
            stamps["first step"] = time.perf_counter() - t_warm
    _sync(dev)
    stamps["warm-up"] = time.perf_counter() - t_warm

    # the window: a closed loop of steps on one stream, no added sync
    rec = trace.Recorder() if traced else None
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        rec.__enter__()
    window = min(seconds, TRACE_SECONDS) if traced else seconds
    counts0 = dict(mg.COUNTS)
    cuda = dev.type == "cuda"
    marks = [torch.cuda.Event(enable_timing=True)] if cuda else []
    host_marks = []
    t0 = time.perf_counter()
    setup_s = t0 - t_entry
    if cuda:
        marks[0].record()
    prev = s
    while True:
        prev, s = s, advance(s)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            host_marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= window:
            break
    _sync(dev)
    t1 = time.perf_counter()
    if traced:
        rec.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    steps = len(marks) - 1 if cuda else len(host_marks)
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip([t0] + host_marks,
                                                  host_marks)]
    record = {"cells": cell.cells, "steps": steps, "window_s": t1 - t0,
              "step_ms": step_ms, "setup_s": setup_s,
              "sim_build_s": sim_build_s,
              "counts": {k: mg.COUNTS[k] - counts0.get(k, 0)
                         for k in mg.COUNTS},
              "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if cuda else None)}
    if traced:
        rec.finish()
        record["trace"] = {"events": trace.device_events(prof),
                           "godunov_calls": rec.godunov,
                           "smoother_calls": rec.smoother}
        del prof, rec

    # the check, once the program's state is freed
    port["prev"] = program.fields_of(prev)
    port["last"] = program.fields_of(s)
    del sim, s, prev, advance
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values, where = check.readings(cell.deck, inputs, port, dev)
    correct, compared, failed = check.verdict(values,
                                              cell.workload["limits"])
    check_s = time.perf_counter() - t_check

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, name, kind):
        v = reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": record["peak_mem_bytes"]}
    if cuda:
        device_info["power"] = power_limit()
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced:
        tr = record["trace"]
        device_info["busy_s"] = trace.busy_s(tr)
        device_info["window_s"] = record["window_s"]
        result["breakdown"] = trace.breakdown(tr)
    result["compared"] = compared
    notes = [f"cell {name} seed {seed}: {steps} steps in "
             f"{record['window_s']:.3f} s, set-up {setup_s:.3f} s, "
             f"check {check_s:.3f} s"]
    if traced:
        tr = record["trace"]
        calls = tr["smoother_calls"]
        coop_ms, coop_n = trace.cooperative(tr)
        notes.append(
            f"smoother calls: {sum(c['regime'] != 2 for c in calls)} "
            f"resident, {sum(c['regime'] == 2 for c in calls)} grid; "
            f"smoother kernels in the trace "
            f"{sum(trace.kernel_group(e[0]) == 'smoother' for e in tr['events'])}"
            f"; added from CUDA events {coop_n} launches, {coop_ms:.3f} ms")
    notes.append("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                          stamps.items()))
    notes.append("gaps by field: " + json.dumps(where))
    notes += [f"{k} {v['value']!r} limit {v['limit']!r}"
              for k, v in compared.items()]
    return result, notes
