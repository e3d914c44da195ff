"""Device time of a traced window put down to the program's phase spans
(incflo_torch/utils/tracing.py: SPANS, on time.time_ns()'s clock, the
clock on which the profiler's raw events carry their start).

The profiler's CUDA activity holds, beside each kernel, copy and set on
the device, the host's CUDA runtime or driver call that enqueued it,
tied to it by correlation id.  `launches` pairs them: each device
operation with the host time of its launch call.  `attribute` puts each
operation down to the innermost span whose [t0, t1] holds its launch
call, and each idle gap of the device down to the span that launched the
operation ending the gap: what the host was doing while the card waited.
What no span holds goes to OUTSIDE.

A trace record (benchmark.harness.core's record["trace"]) that carries
`spans` (tracing.SPANS of the window) and `launches` (this module's) is
read by `phase_ms` and `phase_idle_ms`; without them they return None."""

from __future__ import annotations

from bisect import bisect_right

from benchmark.harness import trace

OUTSIDE = "outside"


def launches(prof):
    """[(launch_ns or None, name, start_us, duration_us)] of the profiled
    device activity (kernels, copies, sets) in order of start, each with
    the start of the host call that launched it (None where the trace
    holds no such call), from the profiler's raw events.  The runtime
    records what a launch call did inside it (module loading, buffer
    requests) under the call's correlation id: the earliest start is the
    call's."""
    from torch.autograd import DeviceType
    host, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            c, t = e.correlation_id(), e.start_ns()
            host[c] = min(t, host.get(c, t))
        else:
            ops.append((e.correlation_id(), e.name(), e.start_ns() * 1e-3,
                        e.duration_ns() * 1e-3))
    out = [(host.get(c) if c else None, name, start, dur)
           for c, name, start, dur in ops]
    out.sort(key=lambda t: t[2])
    return out


def _finder(spans):
    """t_ns -> the name of the innermost span holding t, or OUTSIDE.  The
    spans nest (each inside its parent), so of the spans holding t the
    innermost is the last to start: take the last span to start at or
    before t and walk up its parents to the first that holds t.  A span
    still open (t1 None) holds everything after its start."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][2])
    starts = [spans[i][2] for i in order]

    def find(t):
        if t is None:
            return OUTSIDE
        k = bisect_right(starts, t) - 1
        i = order[k] if k >= 0 else None
        while i is not None:
            name, parent, t0, t1 = spans[i]
            if t0 <= t and (t1 is None or t <= t1):
                return name
            i = parent
        return OUTSIDE
    return find


def gaps(ops):
    """(gap_us, operation before, operation ending the gap) of each idle
    gap between device operations, in order of start; ops as `launches`
    gives them."""
    end = prev = None
    for op in sorted(ops, key=lambda t: t[2]):
        start, dur = op[2], op[3]
        if end is not None and start > end:
            yield start - end, prev, op
        end = start + dur if end is None else max(end, start + dur)
        prev = op


def attribute(spans, ops, window_ns=None):
    """{span name or OUTSIDE: {"busy_us", "idle_us", "ops"}} of a window:
    busy, the union of the intervals of the operations launched in the
    span; idle, the gaps that an operation launched in it ended.  ops as
    `launches` gives them.  window_ns (t0, t1), on the same clock: the
    gap from its start to the first operation goes to that operation's
    span, the gap from the last operation's end to its end to OUTSIDE,
    so that busy and idle sum to the window."""
    find = _finder(spans)
    out = {}

    def entry(name):
        return out.setdefault(name, {"busy_us": 0.0, "idle_us": 0.0,
                                     "ops": 0, "events": []})

    ops = sorted(ops, key=lambda t: t[2])
    for launch, name, start, dur in ops:
        e = entry(find(launch))
        e["ops"] += 1
        e["events"].append((name, start, dur))
    for gap, _, op in gaps(ops):
        entry(find(op[0]))["idle_us"] += gap
    if window_ns is not None and ops:
        t0, t1 = window_ns[0] * 1e-3, window_ns[1] * 1e-3
        entry(find(ops[0][0]))["idle_us"] += max(ops[0][2] - t0, 0.0)
        end = max(start + dur for _, _, start, dur in ops)
        entry(OUTSIDE)["idle_us"] += max(t1 - end, 0.0)
    for e in out.values():
        e["busy_us"] = trace.busy_us(e.pop("events"))
    return out


def longest_gaps(spans, ops, top=10):
    """The longest idle gaps between device operations, longest first:
    [span that launched the operation ending the gap, the operation's
    name, seconds]."""
    find = _finder(spans)
    longest = sorted(gaps(ops), key=lambda g: -g[0])[:top]
    return [[find(op[0]), op[1][:80], gap * 1e-6] for gap, _, op in longest]


def _per_step(record, phase, key):
    tr = record.get("trace") or {}
    spans, ops = tr.get("spans"), tr.get("launches")
    if not spans or ops is None or not record.get("steps"):
        return None
    got = attribute(spans, ops, tr.get("window_ns"))
    return got.get(phase, {}).get(key, 0.0) * 1e-3 / record["steps"]


def phase_ms(record, phase):
    """Device busy ms a step of the operations launched inside `phase`."""
    return _per_step(record, phase, "busy_us")


def phase_idle_ms(record, phase):
    """Device idle ms a step put down to `phase`."""
    return _per_step(record, phase, "idle_us")
