"""How `correct` is decided: the program's states against the plain
reference (benchmark/reference), computed again from the benchmark's
own fields, once the window has closed.

Three numbers, each the largest over the compared fields (velocity,
density, tracer, gp, p with its mean taken out, dt) of the max-norm gap
between the program and the reference over the reference's max-norm:

  init   the initial projection of the benchmark's fields (set-up);
  first  the first step, the program's from its own start against the
         reference's from the reference's start;
  last   the window's last step: the reference's step from the
         program's state before it, against the program's.  The
         reference cannot follow a window of hundreds of steps in the
         time of a run; the first two numbers check the start and the
         steps that this one takes from the program.

The control is the reference computed in float32, the one lower
precision in which the program runs these decks, read the same way
against the float64 reference."""

from __future__ import annotations

import torch

from benchmark.reference.step import ReferenceStep

NUMBERS = ("init", "first", "last")
FIELDS = ("velocity", "density", "tracer", "gp", "p", "dt")


def rel_gap(a, b, field):
    a, b = a.to(torch.float64), b.to(torch.float64)
    if field == "p":
        a, b = a - a.mean(), b - b.mean()
    gap = float((a - b).abs().max())
    scale = float(b.abs().max())
    if scale == 0.0:
        scale = float(a.abs().max())
    return 0.0 if gap == 0.0 else gap / scale


def field_gaps(a, b):
    return {f: rel_gap(a[f], b[f], f) for f in FIELDS}


def start_state(velocity, density, tracer, nodes):
    z = torch.zeros((), dtype=velocity.dtype, device=velocity.device)
    return {"velocity": velocity, "density": density, "tracer": tracer,
            "gp": torch.zeros_like(velocity),
            "p": torch.zeros(nodes, dtype=velocity.dtype,
                             device=velocity.device), "t": z, "dt": z}


def _on(state, dtype, device):
    return {k: v.to(device=device, dtype=dtype) for k, v in state.items()}


def reference_states(deck, inputs, prev, dtype, device):
    """(init velocity, first state, last state) of the reference in
    `dtype`: inputs holds the benchmark's fields (velocity, density,
    tracer); prev the program's state before the window's last step."""
    ref = ReferenceStep(deck, dtype, device)
    v0, r0, t0 = (inputs[k].to(device=device, dtype=dtype)
                  for k in ("velocity", "density", "tracer"))
    init = ref.initial_projection(v0, r0)
    first = ref.step(start_state(init, r0, t0, deck.grid.node_shape))
    last = ref.step(_on(prev, dtype, device))
    return init, first, last


def readings(deck, inputs, port, device, dtype=torch.float64):
    """The three numbers of the program (port: its init velocity, first
    state, state before the last step and last state) against the
    reference in `dtype`; and each number's gaps by field."""
    with _exact_matmul():
        init, first, last = reference_states(deck, inputs, port["prev"],
                                             dtype, device)
    out, where = {}, {}
    out["init"] = rel_gap(port["init"].to(device), init, "velocity")
    where["init"] = {"velocity": out["init"]}
    for key, ref in (("first", first), ("last", last)):
        where[key] = field_gaps(_on(port[key], torch.float64, device), ref)
        out[key] = max(where[key].values())
    return out, where


def control_readings(deck, inputs, prev, device):
    """The three numbers of the control: the float32 reference against
    the float64 one, from the same fields and the same program state;
    and each number's gaps by field."""
    with _exact_matmul():
        hi = reference_states(deck, inputs, prev, torch.float64, device)
        lo = reference_states(deck, inputs, prev, torch.float32, device)
    out = {"init": rel_gap(lo[0], hi[0], "velocity")}
    where = {"init": {"velocity": out["init"]}}
    for i, key in ((1, "first"), (2, "last")):
        where[key] = field_gaps(lo[i], hi[i])
        out[key] = max(where[key].values())
    return out, where


class _exact_matmul:
    """float32 matrix products in float32, not TF32, for the reference's
    transforms; the settings are put back after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)


def verdict(values, limits):
    """(correct, the numbers beside their limits, how many failed): the
    numbers the cell gives a limit.  A cell leaves out a number that
    cannot separate the program from its control: rt's init, whose
    fields start at rest, so that every precision projects them to an
    exact zero (its first step takes the program's init state)."""
    compared = {k: {"value": values[k], "limit": limits[k]}
                for k in NUMBERS if k in limits}
    failed = sum(1 for k in compared if not values[k] <= limits[k])
    return failed == 0, compared, failed
