"""What a `--trace 1` run records, from the benchmark's side of the
program's interfaces (the program is not edited):

  * the device activity of the traced window, from the profiler's raw
    kineto events with CUDA activity only (host ops are not traced: on a
    host-bound step tracing them cost several times the step);
  * each call of the smoother kernel wrappers, with CUDA events around
    it.  The profiler records no device activity for a cooperative
    launch, which is how a smoother call above its resident size runs;
    those calls' event times are added to the device's busy time, and
    their device launches (the wrappers' DEVICE_LAUNCHES) to the trace's;
  * the shapes of each Godunov kernel call and smoother call, from which
    benchmark/roofline counts operations and bytes.

The wrappers are set on the program's modules for the traced window
only and put back after it."""

from __future__ import annotations

import re

import torch

GODUNOV = re.compile(r"\b(uad_kernel|predict_kernel|advect_kernel)\b")
SMOOTHER = re.compile(r"\b(cell_kernel|nodal_kernel)\b")
DIRECT = re.compile(r"gemm|xmma|cutlass|fft", re.IGNORECASE)


def kernel_group(name: str) -> str:
    if GODUNOV.search(name):
        return "godunov"
    if SMOOTHER.search(name):
        return "smoother"
    if DIRECT.search(name):
        return "direct"
    return "torch"


def _short(t):
    return None if t is None else (tuple(t.shape), str(t.dtype).replace(
        "torch.", ""))


class Recorder:
    """Context manager over the traced window: wraps the Godunov and
    smoother kernel wrappers of the program's modules."""

    def __init__(self):
        from incflo_torch.ops import godunov_kernels as gk
        from incflo_torch.ops import smoother_kernels as sk
        self.gk, self.sk = gk, sk
        self.godunov = []        # (kind, key)
        self.smoother = []       # dict per call
        self._saved = []

    def __enter__(self):
        gk, sk = self.gk, self.sk
        for mod, name, wrap in ((gk, "uad", self._uad),
                                (gk, "predict_d", self._predict_d),
                                (gk, "advect_comp", self._advect),
                                (sk, "cell_smooth", self._smooth("cell")),
                                (sk, "nodal_smooth", self._smooth("nodal"))):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    # -- Godunov: the shapes of each launch --------------------------------
    def _uad(self, fn):
        def wrapper(grid, vel, dt, use_ppm):
            self.godunov.append(("uad", dict(
                cells=tuple(grid.n_cell), dx=tuple(grid.dx),
                vel=_short(vel), ppm=bool(use_ppm))))
            return fn(grid, vel, dt, use_ppm)
        return wrapper

    def _predict_d(self, fn):
        def wrapper(grid, vel, uad_faces, forces, dt, d, use_ppm):
            self.godunov.append(("predict_d", dict(
                cells=tuple(grid.n_cell), dx=tuple(grid.dx),
                vel=_short(vel), uad=[_short(u) for u in uad_faces],
                forces=forces is not None, d=int(d), ppm=bool(use_ppm))))
            return fn(grid, vel, uad_faces, forces, dt, d, use_ppm)
        return wrapper

    def _advect(self, fn):
        def wrapper(grid, q, n, umac, forces, dt, icons, use_ppm, out=None):
            self.godunov.append(("advect", dict(
                cells=tuple(grid.n_cell), dx=tuple(grid.dx),
                q=_short(q), umac=[_short(u) for u in umac],
                forces=forces is not None, icons=bool(icons),
                ppm=bool(use_ppm))))
            return fn(grid, q, n, umac, forces, dt, icons, use_ppm, out=out)
        return wrapper

    # -- smoothers: shapes, regime, device launches, event time -----------
    def _smooth(self, kind):
        sk = self.sk

        def wrap(fn):
            def wrapper(*args, **kw):
                before = dict(sk.DEVICE_LAUNCHES)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args, **kw)
                e1.record()
                fam = [k for k in sk.DEVICE_LAUNCHES
                       if sk.DEVICE_LAUNCHES[k] != before[k]]
                launches = sum(sk.DEVICE_LAUNCHES[k] - before[k] for k in fam)
                regime = sk.LAST_PLAN[fam[0]][0] if fam else 0
                x, b = args[0], args[1]
                if kind == "cell":
                    diag, dinv, F = args[2], args[3], args[4]
                    fwall = kw.get("Fwall") if "Fwall" in kw else (
                        args[8] if len(args) > 8 else None)
                    coefs = [diag, dinv, *F]
                    fwall = None if fwall is None else [
                        _short(w) for w in fwall]
                    dx = None
                else:
                    coefs, fwall = [args[2], args[3]], None
                    dx = tuple(float(v) for v in args[4])
                nsweeps = args[5]
                want = kw.get("want_residual", args[6] if len(args) > 6
                              else False)
                bc = kw.get("bc", args[7] if len(args) > 7 else None)
                self.smoother.append(dict(
                    kind=kind, x=_short(x), coefs=[_short(c) for c in coefs],
                    fwall=fwall, dx=dx, nsweeps=int(nsweeps), want=bool(want),
                    bc=None if bc is None else tuple(tuple(int(v) for v in s)
                                                     for s in bc),
                    regime=int(regime), launches=int(launches),
                    events=(e0, e1)))
                return out
            return wrapper
        return wrap

    def finish(self):
        """Event times (ms) of the smoother calls, once the device is
        synchronised."""
        for c in self.smoother:
            e0, e1 = c.pop("events")
            c["ms"] = e0.elapsed_time(e1)


def device_events(prof):
    """[(name, start_us, duration_us)] of the profiled device activity
    (kernels, copies, sets), from the profiler's raw events."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        out.append((e.name(), e.start_ns() * 1e-3, e.duration_ns() * 1e-3))
    out.sort(key=lambda t: t[1])
    return out


def busy_us(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, None
    for _, start, dur in events:
        stop = start + dur
        if end is None or start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def idle_gaps(events, top=10):
    """The longest gaps between device activity, each named by the
    operation that ended it (the host was launching it)."""
    gaps, end = [], None
    for name, start, dur in events:
        if end is not None and start > end:
            gaps.append((f"before {name[:80]}", (start - end) * 1e-6))
        end = max(end or start + dur, start + dur)
    gaps.sort(key=lambda g: -g[1])
    return [list(g) for g in gaps[:top]]


def cooperative(tr):
    """(ms, device launches) of the smoother calls the trace does not
    show: the grid-regime (cooperative) calls, timed by their events.
    Where the trace holds more smoother kernels than the resident calls
    launched, it saw the cooperative ones too, and nothing is added."""
    calls = tr["smoother_calls"]
    seen = sum(1 for e in tr["events"] if kernel_group(e[0]) == "smoother")
    resident = sum(c["launches"] for c in calls if c["regime"] != 2)
    if seen > resident:
        return 0.0, 0
    coop = [c for c in calls if c["regime"] == 2]
    return sum(c["ms"] for c in coop), sum(c["launches"] for c in coop)


def group_us(tr):
    """Device us of the trace's activity by group (godunov, smoother,
    direct, torch)."""
    out = {"godunov": 0.0, "smoother": 0.0, "direct": 0.0, "torch": 0.0}
    for name, _, dur in tr["events"]:
        out[kernel_group(name)] += dur
    return out


def busy_s(tr):
    """Seconds in which an operation ran on the device: the union of the
    trace's intervals, and the cooperative launches beside them (one
    stream: they overlap nothing the trace holds)."""
    return busy_us(tr["events"]) * 1e-6 + cooperative(tr)[0] * 1e-3


def launches(tr):
    """Device launches: the trace's kernels (not its copies and sets) and
    the cooperative launches it does not show."""
    n = sum(1 for name, _, _ in tr["events"]
            if not name.startswith(("Memcpy", "Memset")))
    return n + cooperative(tr)[1]


def breakdown(tr, top=10):
    """The device operations that took most time, and the longest idle
    gaps, in seconds."""
    by_name = {}
    for name, _, dur in tr["events"]:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    coop_ms, n = cooperative(tr)
    if n:
        by_name["cooperative smoother launches (timed by CUDA events)"] = \
            coop_ms * 1e-3
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": idle_gaps(tr["events"], top)}
