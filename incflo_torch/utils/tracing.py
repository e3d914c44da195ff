"""Phase spans of the step, off unless a caller turns them on (the idiom
of multigrid.NODAL_LOG).

SPANS is None (off), a list, or RANGES.  A list: each `span(name)`
appends (name, parent, t0_ns, t1_ns): parent is the index in SPANS of
the span it opened inside (None at the top), and both times come from
time.time_ns(), the Unix-epoch clock on which torch.profiler's events
carry their start, so a device operation can be tied to the span whose
interval holds its launch call.  A span's entry is written when it opens
(t1_ns None until it closes).  Spans nest; a process keeps one stack of
open spans, so spans are taken on one thread.  RANGES (main.py's
INCFLO_PROFILE_DIR): each span is a torch.profiler.record_function
range and nothing else, so a profiler's trace shows the phases above
the kernels.

The step's phases (Simulation._advance_impl, apply_predictor,
apply_corrector, convective_term_godunov / _mol) are PHASES, in the
order a Godunov step runs them; MOL runs them twice a step, the patch
AMR driver once a level.  `static_solvers` spans the build of the
constant-density solvers in Simulation.__init__.

Off, a span is one module-global test and returns the shared NOOP;
nothing here reads the clock, allocates or synchronises the device then,
and nothing here synchronises it ever."""

from __future__ import annotations

import time

PHASES = ("dt", "forces", "predict", "mac", "advect", "diffuse", "nodal")

RANGES = "ranges"
SPANS = None

_open = []      # indices in SPANS of the spans open now, innermost last


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "spans", "index")

    def __init__(self, name, spans):
        self.name = name
        self.spans = spans

    def __enter__(self):
        spans = self.spans
        self.index = len(spans)
        spans.append((self.name, _open[-1] if _open else None,
                      time.time_ns(), None))
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        name, parent, t0, _ = self.spans[self.index]
        self.spans[self.index] = (name, parent, t0, t1)
        _open.pop()
        return False


def span(name: str):
    """A context manager over one phase: NOOP when SPANS is None."""
    if SPANS is None:
        return NOOP
    if SPANS is RANGES:
        import torch
        return torch.profiler.record_function(name)
    return _Span(name, SPANS)
