"""EB surface export (port of incflo_tpu/eb/surface.py; reference
WriteMyEBSurface,
src/embedded_boundaries/writeEBsurface.cpp): dump the cut surface as an
ASCII STL built from each cut cell's EB patch (centroid + normal + area
from the divergence theorem), one square facet per cut cell oriented by
the EB normal."""

from __future__ import annotations

import numpy as np

from incflo_torch.eb.geometry import CUT, EBData
from incflo_torch.grid import Grid


def write_eb_surface(path: str, eb: EBData, grid: Grid):
    nd = grid.ndim
    idx = np.argwhere(eb.flags == CUT)
    dx = np.asarray(grid.dx)
    lo = np.asarray(grid.prob_lo)
    with open(path, "w") as f:
        f.write("solid incflo_torch_eb\n")
        for cell in idx:
            n = eb.eb_normal[tuple(cell)]
            a = eb.eb_area[tuple(cell)]
            if a <= 0:
                continue
            center = lo + (cell + 0.5) * dx
            if nd == 2:
                n3 = np.array([n[0], n[1], 0.0])
                t = np.array([-n[1], n[0], 0.0])
                L = a * dx[0] * 0.5
                p0 = np.array([*center, 0.0]) - t * L
                p1 = np.array([*center, 0.0]) + t * L
                p2 = p1 + np.array([0, 0, dx[0]])
                _facet(f, n3, p0, p1, p2)
            else:
                n3 = n / max(np.linalg.norm(n), 1e-30)
                # orthonormal tangent frame
                h = np.array([1.0, 0, 0]) if abs(n3[0]) < 0.9 else \
                    np.array([0, 1.0, 0])
                t1 = np.cross(n3, h)
                t1 /= max(np.linalg.norm(t1), 1e-30)
                t2 = np.cross(n3, t1)
                side = np.sqrt(max(a, 0.0) * dx[0] * dx[1]) * 0.5
                c = center
                p = [c + side * (st1 * t1 + st2 * t2)
                     for st1, st2 in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
                _facet(f, n3, p[0], p[1], p[2])
                _facet(f, n3, p[0], p[2], p[3])
        f.write("endsolid incflo_torch_eb\n")


def _facet(f, n, p0, p1, p2):
    f.write(f" facet normal {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
    f.write("  outer loop\n")
    for p in (p0, p1, p2):
        f.write(f"   vertex {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
    f.write("  endloop\n endfacet\n")
