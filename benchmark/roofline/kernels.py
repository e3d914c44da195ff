"""Operations and bytes of one kernel call, from its shapes: the
yardstick of the `*_roofline` metrics.

Operations are those of the kernel's plain version at the call's shapes
(count_ops on meta tensors: nothing is computed), so they count the work
the same whatever implements it.  Bytes are each input read once and
each output written once.  A call's bound is the larger of its bytes
over the HBM rate and its operations over the peak rate of its type
(peaks.py)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from benchmark.reference import godunov_periodic as gp
from benchmark.roofline import peaks, smoothers
from benchmark.roofline.count import count_ops

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class _Grid:
    n_cell: Tuple[int, ...]
    dx: Tuple[float, ...]


def _t(spec):
    shape, dtype = spec
    return torch.empty(shape, dtype=getattr(torch, dtype), device=META)


def _numel(spec):
    n = 1
    for s in spec[0]:
        n *= s
    return n


def _itemsize(spec):
    return torch.empty((), dtype=getattr(torch, spec[1])).element_size()


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _thaw(v):
    return {k: x for k, x in v}


@functools.lru_cache(maxsize=None)
def _godunov_cost(kind, key):
    a = _thaw(key)
    grid = _Grid(a["cells"], a["dx"])
    if kind == "uad":
        vel = a["vel"]
        dt = torch.ones((), dtype=getattr(torch, vel[1]), device=META)
        ops = count_ops(lambda: gp.uad_plain(grid, _t(vel), dt, a["ppm"]))
        nbytes = 2 * _numel(vel)          # velocity in, three face arrays out
        return ops, nbytes * _itemsize(vel), vel[1]
    if kind == "predict_d":
        vel, d = a["vel"], a["d"]
        dt = torch.ones((), dtype=getattr(torch, vel[1]), device=META)
        v = _t(vel)
        uad = [_t(u) for u in a["uad"]]
        force = _t((vel[0][:3], vel[1])) if a["forces"] else None
        ops = count_ops(lambda: gp.predict_d_plain(grid, v, uad, force, dt, d,
                                                   a["ppm"]))
        cells = _numel((vel[0][:3], vel[1]))
        out = cells // a["cells"][d] * (a["cells"][d] + 1)
        nbytes = _numel(vel) + sum(_numel(u) for u in a["uad"]) \
            + (cells if a["forces"] else 0) + out
        return ops, nbytes * _itemsize(vel), vel[1]
    q = a["q"]
    cells = _numel((q[0][:3], q[1]))
    dt = torch.ones((), dtype=getattr(torch, q[1]), device=META)
    comp = _t((q[0][:3], q[1]))
    umac = [_t(u) for u in a["umac"]]
    force = comp if a["forces"] else None
    ops = count_ops(lambda: gp.advect_comp_plain(grid, comp, umac, force, dt,
                                                 a["icons"], a["ppm"]))
    nbytes = cells + sum(_numel(u) for u in a["umac"]) \
        + (cells if a["forces"] else 0) + cells
    return ops, nbytes * _itemsize(q), q[1]


def godunov_call(kind, args):
    """(operations, bytes, dtype name) of one Godunov kernel call, as
    benchmark.harness.trace.Recorder records it."""
    return _godunov_cost(kind, _freeze(args))


@functools.lru_cache(maxsize=None)
def _smoother_cost(kind, x, coefs, fwall, dx, nsweeps, want, bc):
    xs, b = _t(x), _t(x)
    c = [_t(s) for s in coefs]
    if kind == "cell":
        fw = None if fwall is None else [None if w is None else _t(w)
                                         for w in fwall]
        ops = count_ops(lambda: smoothers.cell_smooth_plain(
            xs, b, c[0], c[1], c[2:5], nsweeps, want, bc, fw))
    else:
        ops = count_ops(lambda: smoothers.nodal_smooth_plain(
            xs, b, c[0], c[1], dx, nsweeps, want, bc))
    inputs = list(coefs) + [w for w in (fwall or ()) if w is not None]
    nbytes = (3 + int(want)) * _numel(x) + sum(_numel(s) for s in inputs)
    return ops, nbytes * _itemsize(x), x[1]


def smoother_call(call):
    """(operations, bytes, dtype name) of one smoother call, as the
    Recorder records it."""
    fwall = call["fwall"]
    return _smoother_cost(call["kind"], call["x"], tuple(call["coefs"]),
                          None if fwall is None else tuple(fwall),
                          call["dx"], call["nsweeps"], call["want"],
                          call["bc"])


def bound_s(ops, nbytes, dtype):
    """The least time the chip could take for the call."""
    return max(nbytes / peaks.PEAK_BYTES, ops / peaks.PEAK_OPS[dtype])
