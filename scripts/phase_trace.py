"""Per-phase device time of a benchmark cell on the card, from the
program's phase spans (incflo_torch/utils/tracing.py) and the profiler's
launch records (benchmark/harness/phases.py).

    python scripts/phase_trace.py --workload <cell> --seeds 1 2 3 \
        [--traced 5] [--untraced 10] [--out chiprun_out/phases]
    python scripts/phase_trace.py --probe

For each seed, after the cell's warm-up steps (benchmark/harness: the
same fields, Simulation and initial state as `benchmark/run.py`), four
windows of closed-loop steps: two traced as a `--trace 1` run traces
(CUDA activity, the Recorder), with the program's spans off and on, and
two untraced, as a `--trace 0` run, with them off and on (the order of
off and on alternates by seed).  It prints one JSON line per seed: the
cell's per-layer metrics of both traced windows, each phase's device
busy and idle ms a step with the checks that they sum to the trace's
busy and idle time, the longest idle gaps with what the host did in
them, the untraced cells_per_s with the spans off and on, and the static
solvers' build seconds (the `static_solvers` span).  `--probe` prints
what the profiler records of a few launches on this machine (the event
fields, whether time.time_ns() stamps bracket the launch calls) and
what a span costs off and on.

It keeps a closed loop of its own beside benchmark/harness/core.py's,
because run_cell passes its metric readers no spans: once run_cell
records the spans and launches of a traced window, the phase metrics
read them there and this script goes.
"""

from __future__ import annotations

import time

T_ENTRY = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import core, fields, phases, program, trace  # noqa
from incflo_torch.ops import multigrid as mg  # noqa: E402
from incflo_torch.utils import tracing  # noqa: E402


def probe():
    """The profiler's records of a few launches under CUDA activity
    alone, against time.time_ns() stamps taken around them."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand(1 << 20, device="cuda", dtype=torch.float64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_a = time.time_ns()
        for _ in range(4):
            x = x * 1.0001 + 1.0
        y = float(x.sum())
        torch.cuda.synchronize()
        t_b = time.time_ns()
    from torch.autograd import DeviceType
    rows = []
    for e in prof.profiler.kineto_results.events():
        rows.append({"name": e.name()[:60],
                     "device_type": str(e.device_type()),
                     "activity_type": str(getattr(e, "activity_type",
                                                  lambda: None)()),
                     "correlation_id": e.correlation_id(),
                     "linked_correlation_id": e.linked_correlation_id(),
                     "start_ns": e.start_ns(), "duration_ns": e.duration_ns(),
                     "host": e.device_type() == DeviceType.CPU})
    cost = {}
    for on in (False, True):
        tracing.SPANS = [] if on else None
        t0 = time.perf_counter_ns()
        for _ in range(100000):
            with tracing.span("dt"):
                pass
        cost["on" if on else "off"] = (time.perf_counter_ns() - t0) / 1e5
    tracing.SPANS = None
    host = [r for r in rows if r["host"]]
    dev = [r for r in rows if not r["host"]]
    paired = phases.launches(prof)
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "span_ns": cost,
        "value": y, "t_a": t_a, "t_b": t_b, "events": rows,
        "host_calls": len(host), "device_ops": len(dev),
        "host_inside_stamps": sum(t_a <= r["start_ns"] <= t_b for r in host),
        "device_inside_stamps": sum(t_a <= r["start_ns"] <= t_b
                                    for r in dev),
        "ops_paired": sum(p[0] is not None for p in paired),
        "launch_before_start": sum(p[0] is not None and p[0] * 1e-3 <= p[2]
                                   for p in paired)}))


def _stalls(ops, gcs, top=3):
    """The longest idle gaps of the device (phases.gaps of the launch
    records), each with the host time between the launch call of the
    operation before it and that of the operation ending it, and the
    garbage collections that ran in between (generation, ms)."""
    out = []
    for gap, before, op in sorted(phases.gaps(ops),
                                  key=lambda g: -g[0])[:top]:
        t_a, t_b = before[0], op[0]
        known = t_a is not None and t_b is not None
        out.append({
            "gap_ms": gap * 1e-3, "op": op[1][:60],
            "host_between_launches_ms": (t_b - t_a) * 1e-6 if known
            else None,
            "gc": [(g, (t1 - t0) * 1e-6) for g, t0, t1 in gcs
                   if known and t_a <= t0 <= t_b]})
    return out


def _window(advance, s, seconds, traced, spans_on, cells):
    """A closed loop of steps for `seconds`, as core.run_cell times it;
    returns (state, record)."""
    rec = prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        rec = trace.Recorder()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        rec.__enter__()
    gcs, opened = [], {}

    def on_gc(phase, info):
        if phase == "start":
            opened["t"] = time.time_ns()
        else:
            gcs.append((info["generation"], opened.pop("t", 0),
                        time.time_ns()))
    if traced:
        gc.callbacks.append(on_gc)
    counts0 = dict(mg.COUNTS)
    marks = [torch.cuda.Event(enable_timing=True)]
    if spans_on:
        tracing.SPANS = []
    w0 = time.time_ns()
    t0 = time.perf_counter()
    marks[0].record()
    while True:
        s = advance(s)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w1 = time.time_ns()
    spans, tracing.SPANS = tracing.SPANS, None
    if traced:
        gc.callbacks.remove(on_gc)
        rec.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    steps = len(marks) - 1
    record = {"cells": cells, "steps": steps, "window_s": t1 - t0,
              "step_ms": [a.elapsed_time(b) for a, b in zip(marks,
                                                            marks[1:])],
              "setup_s": 0.0, "sim_build_s": 0.0,
              "counts": {k: mg.COUNTS[k] - counts0.get(k, 0)
                         for k in mg.COUNTS},
              "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    if traced:
        rec.finish()
        launches = phases.launches(prof)
        record["trace"] = {"events": trace.device_events(prof),
                           "godunov_calls": rec.godunov,
                           "smoother_calls": rec.smoother,
                           "spans": spans, "launches": launches,
                           "window_ns": (w0, w1)}
        record["stalls"] = _stalls(launches, gcs)
        record["gc_ms"] = [sum((t1 - t0) * 1e-6 for g, t0, t1 in gcs
                               if g == k) for k in range(3)]
    return s, record


def _traced_summary(record, spec, name):
    tr = record["trace"]
    steps = record["steps"]
    per_layer = {m["name"]: core.reader(m["name"])(record)
                 for m in core.cell_metrics(spec, name, "per_layer")
                 if m["name"] not in ("sim_build_s",)}
    out = {"steps": steps, "window_s": record["window_s"],
           "per_layer": per_layer, "stalls": record["stalls"],
           "gc_ms": record["gc_ms"]}
    if not tr["spans"]:
        return out
    got = phases.attribute(tr["spans"], tr["launches"], tr["window_ns"])
    ms = {k: {"busy": v["busy_us"] * 1e-3 / steps,
              "idle": v["idle_us"] * 1e-3 / steps, "ops": v["ops"] / steps}
          for k, v in got.items()}
    groups = trace.group_us(tr)
    coop_ms = trace.cooperative(tr)[0]
    busy_ms = trace.busy_s(tr) * 1e3 / steps
    window_ms = record["window_s"] * 1e3 / steps
    out.update({
        "phases": ms,
        "phase_busy_sum": sum(ms.get(p, {"busy": 0.0})["busy"]
                              for p in tracing.PHASES),
        "groups_ms": sum(groups.values()) * 1e-3 / steps
        + coop_ms / steps,
        "busy_ms": busy_ms,
        "phase_idle_sum": sum(v["idle"] for v in ms.values()),
        "idle_ms": window_ms - busy_ms,
        "unpaired_ops": sum(1 for op in tr["launches"] if op[0] is None),
        "ops": len(tr["launches"]),
        "window_ns_s": (tr["window_ns"][1] - tr["window_ns"][0]) * 1e-9,
        "spans_per_step": len(tr["spans"]) / steps,
        "longest_gaps": phases.longest_gaps(tr["spans"], tr["launches"], 5)})
    return out


def run(name, seeds, traced_s, untraced_s, out_dir, device="cuda"):
    spec = core.load_spec()
    cell = core.Cell(name)
    dev = torch.device(device)
    dtype = getattr(torch, cell.deck.dtype)
    t_build = time.perf_counter()
    tracing.SPANS = []
    sim = program.build(cell.deck_text, dev)
    torch.cuda.synchronize()
    build_spans, tracing.SPANS = tracing.SPANS, None
    sim_build_s = time.perf_counter() - t_build
    static = [t1 - t0 for n, _, t0, t1 in build_spans
              if n == "static_solvers"]
    power = core.power_limit()
    for k, seed in enumerate(seeds):
        v0, r0, tr0 = fields.initial_fields(cell.deck, seed, dtype, dev)
        s = program.initial_state(sim, v0, r0, tr0)
        del v0, r0, tr0
        for _ in range(int(cell.workload["warmup_steps"])):
            s = sim.advance(s)
        torch.cuda.synchronize()
        order = (False, True) if k % 2 == 0 else (True, False)
        res = {"cell": name, "seed": seed, "device": power,
               "setup_to_first_seed_s": time.perf_counter() - T_ENTRY
               if k == 0 else None,
               "sim_build_s": sim_build_s,
               "static_solvers_s": static[0] * 1e-9 if static else None,
               "traced": {}, "untraced": {}}
        for on in order:
            s, record = _window(sim.advance, s, traced_s, True, on,
                                cell.cells)
            res["traced"]["on" if on else "off"] = _traced_summary(
                record, spec, name)
            del record
        for on in order:
            s, record = _window(sim.advance, s, untraced_s, False, on,
                                cell.cells)
            res["untraced"]["on" if on else "off"] = {
                "steps": record["steps"], "window_s": record["window_s"],
                "cells_per_s": cell.cells * record["steps"]
                / record["window_s"]}
        line = json.dumps(res)
        print(line, flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{name}-{seed}.json"), "w") as f:
                f.write(line + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--traced", type=float, default=core.TRACE_SECONDS)
    ap.add_argument("--untraced", type=float, default=10.0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "phases"))
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_trace: no CUDA device", file=sys.stderr)
        return 2
    if args.probe:
        probe()
        return 0
    run(args.workload, args.seeds, args.traced, args.untraced, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
