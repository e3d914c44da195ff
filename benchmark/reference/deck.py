"""The part of an incflo inputs deck that the reference step reads: a
small `key = values` reader, the grid, and the ghost-fill records of the
deck's boundaries.  It covers what the benchmark's decks state (3D,
Godunov, Crank-Nicolson, Newtonian, each axis periodic or ending in slip
walls) and refuses the rest, so that a deck the reference does not
compute is never compared by it."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Tuple

import numpy as np


class BCType(enum.IntEnum):
    """Ghost fill of one component on one side of one axis."""
    int_dir = 0      # periodic wrap
    ext_dir = 1      # the wall value (zero here) in the ghosts
    foextrap = 2     # copy of the nearest interior cell
    hoextrap = 3     # quadratic extrapolation through the wall face
    reflect_even = 4
    reflect_odd = 5


def parse(text: str) -> Dict[str, List[str]]:
    """`prefix.key = v1 v2 ...` lines; `#` starts a comment; quotes are
    dropped; a later line overrides an earlier one."""
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        if "=" not in line:
            continue
        key, _, rhs = line.partition("=")
        out[key.strip()] = [t.strip("\"'") for t in rhs.split()]
    return out


@dataclasses.dataclass(frozen=True)
class Grid:
    n_cell: Tuple[int, ...]
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]

    @property
    def ndim(self) -> int:
        return len(self.n_cell)

    @property
    def dx(self) -> Tuple[float, ...]:
        return tuple((h - l) / n for l, h, n in
                     zip(self.prob_lo, self.prob_hi, self.n_cell))

    @property
    def cell_shape(self) -> Tuple[int, ...]:
        return tuple(self.n_cell)

    @property
    def node_shape(self) -> Tuple[int, ...]:
        return tuple(n if p else n + 1
                     for n, p in zip(self.n_cell, self.periodic))


def _bool(v) -> bool:
    return v.lower() in ("1", "true")


@dataclasses.dataclass(frozen=True)
class Deck:
    grid: Grid
    probtype: int
    dtype: str
    mu: float
    mu_s: float
    ro_0: float
    gravity: Tuple[float, ...]
    cfl: float
    constant_density: bool
    advect_tracer: bool
    use_ppm: bool

    @classmethod
    def from_text(cls, text: str) -> "Deck":
        kv = parse(text)

        def get(key, default=None):
            return kv.get(key, default)

        def one(key, default):
            v = kv.get(key)
            return default if v is None else v[0]

        n_cell = tuple(int(v) for v in kv["amr.n_cell"])
        periodic = tuple(bool(int(v)) for v in kv["geometry.is_periodic"])
        grid = Grid(n_cell,
                    tuple(float(v) for v in kv["geometry.prob_lo"]),
                    tuple(float(v) for v in kv["geometry.prob_hi"]),
                    periodic)
        if grid.ndim != 3:
            raise ValueError("the reference step is 3D")
        for ax, name in enumerate("xyz"):
            for side in ("lo", "hi"):
                kind = one(f"{name}{side}.type", None)
                if not periodic[ax] and kind not in ("sw", "slip_wall"):
                    raise ValueError(f"{name}{side}: the reference step "
                                     "takes periodic axes and slip walls")
        checks = {"incflo.use_godunov": ("true", _bool),
                  "incflo.diffusion_type": ("1", int),
                  "incflo.fluid_model": ("newtonian", str.lower),
                  "incflo.use_tensor_solve": ("true", _bool),
                  "incflo.godunov_include_diff_in_forcing": ("true", _bool),
                  "incflo.use_mac_phi_in_godunov": ("false", _bool),
                  "incflo.godunov_use_forces_in_trans": ("false", _bool),
                  "incflo.initial_iterations": ("0", int),
                  "incflo.init_shrink": ("1.0", float),
                  "incflo.ntrac": ("1", int),
                  "amr.max_level": ("0", int)}
        for key, (want, conv) in checks.items():
            if conv(one(key, want)) != conv(want):
                raise ValueError(f"{key}: the reference step computes "
                                 f"{want} only")
        gravity = tuple(float(v) for v in get("incflo.gravity",
                                              ["0", "0", "0"]))
        return cls(grid=grid, probtype=int(one("incflo.probtype", "0")),
                   dtype=one("incflo.dtype", "float64"),
                   mu=float(one("incflo.mu", "1.0")),
                   mu_s=float(one("incflo.mu_s", "0.0")),
                   ro_0=float(one("incflo.ro_0", "1.0")),
                   gravity=gravity, cfl=float(one("incflo.cfl", "0.5")),
                   constant_density=_bool(one("incflo.constant_density",
                                              "true")),
                   advect_tracer=_bool(one("incflo.advect_tracer", "false")),
                   use_ppm=_bool(one("incflo.use_ppm", "true")))

    # ghost-fill records (ncomp, ndim, 2): incflo's boundary_conditions.cpp
    # for periodic axes and slip walls
    def _recs(self, ncomp, wall, normal=None):
        rec = np.full((ncomp, 3, 2), int(BCType.int_dir), np.int32)
        for ax in range(3):
            if not self.grid.periodic[ax]:
                rec[:, ax, :] = int(wall)
                if normal is not None:
                    rec[ax, ax, :] = int(normal)
        return rec

    def velocity_bcrecs(self):
        return self._recs(3, BCType.hoextrap, BCType.ext_dir)

    def scalar_bcrecs(self):
        return self._recs(1, BCType.hoextrap)

    def force_bcrecs(self, ncomp):
        return self._recs(ncomp, BCType.foextrap)
