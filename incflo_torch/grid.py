"""Domain geometry: the replacement for amrex::Geometry (numpy only; a
copy of incflo_tpu/grid.py so the port does not import the JAX package).

A `Grid` describes one structured level: cell counts, physical extent,
periodicity.  Unlike AMReX there is no BoxArray/DistributionMapping --
each level is ONE dense tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static geometry of one level (cf. geometry.* inputs namespace)."""

    n_cell: Tuple[int, ...]          # cells per axis
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]
    # Root-domain extent, set on WINDOW grids (AMR patches) whose
    # prob_lo/prob_hi cover only part of the problem domain.  The
    # reference evaluates IC/BC functors at GLOBAL fine indices
    # ((i+0.5)*dx in the root frame, prob_bc.H:49); a window grid must
    # reproduce that frame, not restart coordinates at its own corner.
    # None (the default, every non-window grid) means self-rooted.
    domain_lo: Tuple[float, ...] = None
    domain_hi: Tuple[float, ...] = None

    def __post_init__(self):
        assert len(self.n_cell) in (2, 3)
        assert len(self.prob_lo) == len(self.n_cell)
        assert len(self.prob_hi) == len(self.n_cell)
        assert len(self.periodic) == len(self.n_cell)

    # -- basic metrics ------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.n_cell)

    @property
    def dx(self) -> Tuple[float, ...]:
        return tuple((hi - lo) / n for lo, hi, n in
                     zip(self.prob_lo, self.prob_hi, self.n_cell))

    @property
    def prob_length(self) -> Tuple[float, ...]:
        return tuple(hi - lo for lo, hi in zip(self.prob_lo, self.prob_hi))

    @property
    def cell_shape(self) -> Tuple[int, ...]:
        return tuple(self.n_cell)

    @property
    def node_shape(self) -> Tuple[int, ...]:
        """Unique nodes per axis: n for periodic axes (node n == node 0),
        n+1 otherwise."""
        return tuple(n if per else n + 1
                     for n, per in zip(self.n_cell, self.periodic))

    def edge(self, axis: int, side: int) -> bool:
        """True where side `side` (0 low, 1 high) of `axis` is a boundary
        of the level, not a periodic wrap; a rank's x slab of a mesh
        (parallel/mesh.SlabGrid) says so of the level's own x faces
        only."""
        return not self.periodic[axis]

    def face_shape(self, axis: int) -> Tuple[int, ...]:
        """Unique faces normal to `axis` (face n == face 0 when periodic)."""
        return tuple((n if (per and d == axis) else n) + (1 if (d == axis and not per) else 0)
                     for d, (n, per) in enumerate(zip(self.n_cell, self.periodic)))

    # -- coordinates ----------------------------------------------------------
    def cell_centers_1d(self, axis: int) -> np.ndarray:
        d = self.dx[axis]
        return self.prob_lo[axis] + (np.arange(self.n_cell[axis]) + 0.5) * d

    def cell_centers(self) -> Tuple[np.ndarray, ...]:
        """Broadcastable cell-center coordinate arrays (one per axis)."""
        out = []
        for ax in range(self.ndim):
            c = self.cell_centers_1d(ax)
            shape = [1] * self.ndim
            shape[ax] = -1
            out.append(c.reshape(shape))
        return tuple(out)

    def normalized_cell_centers_1d(self, axis: int) -> np.ndarray:
        """(i+0.5)/n_cell -- the convention the reference's IC/BC functors use
        (e.g. src/prob/prob_bc.H:49)."""
        x0 = self.origin[axis]
        length = self.domain_length[axis]
        phys = self.prob_lo[axis] \
            + (np.arange(self.n_cell[axis]) + 0.5) * self.dx[axis]
        return (phys - x0) / length

    @property
    def origin(self) -> Tuple[float, ...]:
        """Root-domain lo corner (= prob_lo unless this is a window)."""
        return self.domain_lo if self.domain_lo is not None else self.prob_lo

    @property
    def domain_length(self) -> Tuple[float, ...]:
        hi = self.domain_hi if self.domain_hi is not None else self.prob_hi
        return tuple(h - l for l, h in zip(self.origin, hi))

    # -- refinement -------------------------------------------------------
    def refine(self, ratio: int = 2) -> "Grid":
        return Grid(tuple(n * ratio for n in self.n_cell),
                    self.prob_lo, self.prob_hi, self.periodic,
                    self.domain_lo, self.domain_hi)

    def coarsen(self, ratio: int = 2) -> "Grid":
        assert all(n % ratio == 0 for n in self.n_cell)
        return Grid(tuple(n // ratio for n in self.n_cell),
                    self.prob_lo, self.prob_hi, self.periodic,
                    self.domain_lo, self.domain_hi)
