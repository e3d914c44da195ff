"""Embedded-boundary geometry: implicit functions + cut-cell data (port
of incflo_tpu/eb/geometry.py, host numpy).

The replacement for AMReX EB2 + EBFArrayBoxFactory (reference
src/embedded_boundaries/*.cpp): geometry is precomputed on the host with
numpy once at setup (it is static), moved to the device as plain
tensors (eb/ops.py), and every EB operation is a masked dense one.

The volume fractions of the refined boxes come from the C++ integrator
csrc/eb_geometry.cpp, built with g++ at first use into
incflo_torch/_build/ (a failed build raises with the compiler's
message: there is no silent fallback); _box_fraction_plain is its numpy
form, held against it in the tests.

Convention: phi(x) < 0  <=>  fluid.

Cut-cell data is computed from node samples of phi on an s-refined
lattice: each (sub)cell/face is treated as a planar cut and integrated
with the exact simplex formula

  V({phi<0} in box) = sum_corners (-1)^{#hi(corner)} max(0,-phi_c)^d
                       / (d! * prod_i |g_i| * prod_i L_i)

(g = per-axis corner differences), which is exact for linear phi and
2nd-order accurate overall.  Degenerate gradients are regularised.

Produces the EBData bundle: vfrac, area fractions per axis (apx...),
cell flags (regular/cut/covered), EB normal/area, and centroids.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import itertools
import math
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from incflo_torch.grid import Grid
from incflo_torch.parmparse import ParmParse

REGULAR, CUT, COVERED = 0, 1, 2


# =====================================================================
# implicit functions (reference EB2::*IF analogs); phi<0 = fluid
# =====================================================================

class IF:
    def __call__(self, coords: Sequence[np.ndarray]) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class AllRegularIF(IF):
    def __call__(self, c):
        return np.full(np.broadcast(*c).shape, -1.0)


@dataclasses.dataclass
class SphereIF(IF):
    radius: float
    center: Tuple[float, ...]
    inside: bool   # True: fluid inside the sphere

    def __call__(self, c):
        r2 = sum((x - cc) ** 2 for x, cc in zip(c, self.center))
        phi = r2 - self.radius ** 2
        return phi if self.inside else -phi


@dataclasses.dataclass
class CylinderIF(IF):
    """Infinite cylinder along `direction`; inside=True: fluid inside."""
    radius: float
    direction: int
    center: Tuple[float, ...]
    inside: bool
    height: float = -1.0    # finite cylinder if > 0

    def __call__(self, c):
        r2 = sum((x - cc) ** 2 for d, (x, cc) in enumerate(zip(c, self.center))
                 if d != self.direction)
        phi = r2 - self.radius ** 2
        if self.height > 0:
            ax = c[self.direction] - self.center[self.direction]
            cap = np.abs(ax) - 0.5 * self.height
            phi = np.maximum(phi, cap * np.abs(cap))  # keep ~quadratic scale
        return phi if self.inside else -phi


@dataclasses.dataclass
class PlaneIF(IF):
    """Fluid where (x - point).normal < 0 (normal points into the body)."""
    point: Tuple[float, ...]
    normal: Tuple[float, ...]

    def __call__(self, c):
        return sum((x - p) * n for x, p, n in
                   zip(c, self.point, self.normal))


@dataclasses.dataclass
class BoxIF(IF):
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    inside: bool   # True: fluid inside the box

    def __call__(self, c):
        phi = None
        for x, l, h in zip(c, self.lo, self.hi):
            d = np.maximum(l - x, x - h)
            phi = d if phi is None else np.maximum(phi, d)
        return phi if self.inside else -phi


@dataclasses.dataclass
class UnionIF(IF):
    """Union of BODIES = intersection of fluids: max of phis."""
    parts: List[IF]

    def __call__(self, c):
        phi = self.parts[0](c)
        for p in self.parts[1:]:
            phi = np.maximum(phi, p(c))
        return phi


@dataclasses.dataclass
class IntersectionIF(IF):
    """Intersection of bodies = union of fluids: min of phis."""
    parts: List[IF]

    def __call__(self, c):
        phi = self.parts[0](c)
        for p in self.parts[1:]:
            phi = np.minimum(phi, p(c))
        return phi


@dataclasses.dataclass
class RotateIF(IF):
    """Rotate the implicit function by `angle` around `axis` about the
    domain origin (EB2::rotate analog: rotates coordinates backwards)."""
    base: IF
    angle: float
    axis: int

    def __call__(self, c):
        c = list(c)
        nd = len(c)
        axes = [a for a in range(nd) if a != self.axis] if nd == 3 else [0, 1]
        i, j = axes[0], axes[1]
        ca, sa = math.cos(self.angle), math.sin(self.angle)
        xi = ca * c[i] + sa * c[j]
        xj = -sa * c[i] + ca * c[j]
        c[i], c[j] = xi, xj
        return self.base(c)


# =====================================================================
# shape registry (reference MakeEBGeometry, embedded_boundaries.cpp:8-75)
# =====================================================================

def make_eb_geometry(geom_type: str, pp: ParmParse, grid: Grid) -> IF:
    nd = grid.ndim
    if geom_type in ("", "all_regular", "null"):
        return AllRegularIF()
    if geom_type == "cylinder":
        c = pp.scoped("cylinder")
        center = tuple(float(v) for v in c.getarr("center", 3))[:nd]
        cyl = CylinderIF(float(c.query("radius", 0.0002)),
                         int(c.query("direction", 0)), center,
                         bool(c.query("internal_flow", True)))
        rot = float(c.query("rotation", 0)) / 180.0 * math.pi
        rot_axe = int(c.query("rotation_axe", 0))
        return RotateIF(cyl, rot, rot_axe) if rot != 0 else cyl
    if geom_type == "sphere":
        s = pp.scoped("sphere")
        center = tuple(float(v) for v in s.getarr("center", 3))[:nd]
        return SphereIF(float(s.query("radius", 0.0002)), center,
                        bool(s.query("internal_flow", True)))
    if geom_type == "box":
        b = pp.scoped("box")
        lo = tuple(float(v) for v in b.queryarr("Lo", [0.0] * 3, 3))[:nd]
        hi = tuple(float(v) for v in b.queryarr("Hi", [1.0] * 3, 3))[:nd]
        offset = float(b.query("offset", 1.0e-15))
        lo = tuple(v + offset for v in lo)
        hi = tuple(v + offset for v in hi)
        return BoxIF(lo, hi, True)
    if geom_type == "annulus":
        a = pp.scoped("annulus")
        direction = int(a.query("direction", 0))
        oc = tuple(float(v) for v in a.getarr("outer_center", 3))[:nd]
        ic = tuple(float(v) for v in a.getarr("inner_center", 3))[:nd]
        outer = CylinderIF(float(a.query("outer_radius", 0.002)),
                           direction, oc, True)
        inner = CylinderIF(float(a.query("inner_radius", 0.001)),
                           direction, ic, False)
        return UnionIF([outer, inner])
    if geom_type == "twocylinders":
        # fluid outside BOTH cylinders (EB2::makeUnion of the two bodies,
        # eb_twocylinders.cpp:60-62)
        t = pp.scoped("twocylinders")
        c1 = tuple(float(v) for v in t.getarr("center1", 3))[:nd]
        c2 = tuple(float(v) for v in t.getarr("center2", 3))[:nd]
        cyl1 = CylinderIF(float(t.query("radius1", 0.0002)),
                          int(t.query("direction1", 0)), c1, False)
        cyl2 = CylinderIF(float(t.query("radius2", 0.0002)),
                          int(t.query("direction2", 0)), c2, False)
        return UnionIF([cyl1, cyl2])
    if geom_type == "spherecube":
        # fluid outside sphere AND cube (eb_spherecube.cpp:21-23)
        sphere = SphereIF(0.5, (1.8, 1.8, 2.8)[:nd], False)
        cube = BoxIF((1.85, 1.85, 2.85)[:nd], (2.5, 2.5, 3.5)[:nd], False)
        return UnionIF([sphere, cube])
    if geom_type == "tuscan":
        # two solid boxes + center connector carved out of the fluid
        # (eb_tuscan.cpp:20-110); fluid = complement of the box union
        xlo, xhi = 0.125, 0.875
        ylo, yhi = xlo, xhi
        zlen = 0.2
        zlo, zhi = zlen, 1.0 - zlen

        def plane(point, normal):
            return PlaneIF(tuple(point[:nd]), tuple(normal[:nd]))

        sides = [plane((0, ylo, 0), (0, 1, 0)), plane((xhi, 0, 0), (-1, 0, 0)),
                 plane((0, yhi, 0), (0, -1, 0)), plane((xlo, 0, 0), (1, 0, 0))]
        box1 = IntersectionIF(sides + [plane((0, 0, zlo), (0, 0, -1))])
        box2 = IntersectionIF(sides + [plane((0, 0, zhi), (0, 0, 1))])
        mf = 0.25
        xl2, xh2 = xlo + mf * (xhi - xlo), xhi - mf * (xhi - xlo)
        yl2, yh2 = ylo + mf * (yhi - ylo), yhi - mf * (yhi - ylo)
        box3 = IntersectionIF([
            plane((0, yl2, 0), (0, 1, 0)), plane((xh2, 0, 0), (-1, 0, 0)),
            plane((0, yh2, 0), (0, -1, 0)), plane((xl2, 0, 0), (1, 0, 0))])
        return UnionIF([box1, box2, box3])
    if geom_type == "jcap":
        # fluid = union of two finite capped cylinders
        # (eb_cyl_tuscan.cpp:25-67, EB2::makeIntersection of fluid-inside
        # cylinders = min = union of the fluid regions)
        j = pp.scoped("jcap")
        c1 = tuple(float(v) for v in j.getarr("center1", 3))[:nd]
        c2 = tuple(float(v) for v in j.getarr("center2", 3))[:nd]
        cyl1 = CylinderIF(float(j.query("radius1", 0.25)),
                          int(j.query("direction1", 0)), c1, True,
                          height=float(j.query("height1", 0.3)))
        cyl2 = CylinderIF(float(j.query("radius2", 0.25)),
                          int(j.query("direction2", 0)), c2, True,
                          height=float(j.query("height2", 0.3)))
        return IntersectionIF([cyl1, cyl2])
    raise ValueError(f"Unknown EB geometry '{geom_type}'")


# =====================================================================
# cut-cell data
# =====================================================================

@dataclasses.dataclass
class EBData:
    """Static cut-cell arrays (device-shippable)."""
    vfrac: np.ndarray                  # (cells) in [0,1]
    afrac: List[np.ndarray]            # per axis, faces (n+1 along axis)
    flags: np.ndarray                  # (cells) REGULAR/CUT/COVERED
    # EB boundary geometric data per cell (zero in non-cut cells):
    eb_area: np.ndarray                # |A_eb| / dx^(d-1) scaled area
    eb_normal: np.ndarray              # (cells, d), unit, into the FLUID
    centroid: np.ndarray               # (cells, d) fluid centroid offset
                                       # from cell center in units of dx
    # face fluid-area centroid offsets from the face center, units of dx
    # (normal component always 0; reference EBFArrayBoxFactory
    # getFaceCent, consumed by incflo_mol_predict_eb.cpp:99-101)
    face_cent: Optional[List[np.ndarray]] = None   # per axis: faces+(d,)
    # per-OCTANT fluid fractions (2n per axis): the sub-cell integration
    # data for the exact cut-cell nodal FEM operator (the analog of
    # MLNodeLaplacian's EB stencil integration,
    # incflo_apply_nodal_projection.cpp:134-153)
    vfrac_oct: Optional[np.ndarray] = None
    # distance (physical) from the fluid centroid to the EB wall along
    # the normal; 0 outside cut cells (second-order wall stencils)
    wall_dist: Optional[np.ndarray] = None
    all_regular: bool = False

    @property
    def has_eb(self) -> bool:
        return not self.all_regular


def _simplex_fraction(corner_phi: np.ndarray, nd: int) -> np.ndarray:
    """Fraction of the unit box where the multilinear interpolant of the
    corner values is < 0, via the exact planar-cut formula applied to the
    least-squares plane of the corners.  corner_phi: (..., 2)*nd array
    with one trailing axis of size 2 per dimension."""
    # plane: mean + sum_i g_i (x_i - 1/2), g_i = mean corner difference
    axes = tuple(range(-nd, 0))
    c = corner_phi.mean(axis=axes)
    gs = []
    for d in range(nd):
        ax = d - nd
        hi = np.take(corner_phi, 1, axis=ax)
        lo = np.take(corner_phi, 0, axis=ax)
        gs.append((hi - lo).mean(axis=tuple(range(-(nd - 1), 0)))
                  if nd > 1 else (hi - lo))
    g = np.stack(gs, axis=-1)
    absg = np.abs(g)
    eps = 1e-12 * np.maximum(np.abs(c), 1.0)
    absg = np.maximum(absg, eps[..., None])
    # corners of the oriented box: phi_corner = c + sum_i (s_i - 1/2) |g_i|
    # V = sum_s (-1)^{#s} max(0, -phi_s)^nd / (nd! prod |g_i|)
    vol = np.zeros_like(c)
    for s in itertools.product((0, 1), repeat=nd):
        phi_s = c + sum((si - 0.5) * absg[..., i] for i, si in enumerate(s))
        term = np.maximum(0.0, -phi_s) ** nd
        vol = vol + ((-1.0) ** sum(s)) * term
    vol = vol / (math.factorial(nd) * np.prod(absg, axis=-1))
    vol = np.clip(vol, 0.0, 1.0)
    # uniform-sign boxes are exactly full/empty: the eps-guarded plane
    # formula returns ~0.99x garbage when a gradient component vanishes
    # (axis-aligned geometries), minting spurious cut cells
    all_neg = (corner_phi < 0.0).all(axis=axes)
    all_pos = (corner_phi > 0.0).all(axis=axes)
    return np.where(all_neg, 1.0, np.where(all_pos, 0.0, vol))


# a level of at least this many cells integrates its sub-box offsets on
# a few threads (numpy's loops drop the GIL), THREADS offsets at a time;
# each offset's fraction is the same array either way and the sums take
# them in offset order, so the bits do not depend on the threads
THREADED_CELLS = 1 << 16
THREADS = 4


def _in_order(fn, items, ncells):
    """fn of each of items, yielded in order: on up to THREADS threads for
    a level of ncells >= THREADED_CELLS, at most THREADS results held."""
    nthreads = min(THREADS, os.cpu_count() or 1)
    if ncells < THREADED_CELLS or nthreads < 2:
        yield from map(fn, items)
        return
    items = list(items)
    with concurrent.futures.ThreadPoolExecutor(nthreads) as pool:
        for i in range(0, len(items), nthreads):
            yield from pool.map(fn, items[i:i + nthreads])


def _box_fraction_refined(node_phi: np.ndarray, s: int, nd: int) -> np.ndarray:
    """Fluid fraction of each box of the coarse lattice, where node_phi
    holds phi on the s-refined NODE lattice of shape (s*n1+1, ...): the
    C++ integrator for 2D and 3D."""
    if nd not in (2, 3):
        return _box_fraction_plain(node_phi, s, nd)
    return _box_fraction_native(node_phi, s, nd)


def _box_fraction_plain(node_phi: np.ndarray, s: int, nd: int) -> np.ndarray:
    """The numpy form of the C++ integrator: one pass per sub-box offset
    through _simplex_fraction."""
    shape = tuple((node_phi.shape[d] - 1) // s for d in range(nd))
    total = np.zeros(shape)
    for off in itertools.product(range(s), repeat=nd):
        def slc(d, o):
            return slice(off[d] + o, off[d] + o + s * shape[d], s)
        sub = np.empty(shape + (2,) * nd)
        for cs in itertools.product((0, 1), repeat=nd):
            idx = tuple(slc(d, cs[d]) for d in range(nd))
            sub[(...,) + cs] = node_phi[idx]
        total += _simplex_fraction(sub, nd)
    return total / (s ** nd)


# the C++ integrator, built with the flags incflo_tpu/native builds its
# twin with, so that both produce the same bits
NATIVE_SOURCE = (Path(__file__).resolve().parent.parent / "csrc"
                 / "eb_geometry.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_NATIVE = None


def native_library_path() -> Path:
    from incflo_torch.ops.cuda_build import BUILD_DIR
    digest = hashlib.sha256(NATIVE_SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{NATIVE_SOURCE.stem}_{digest[:16]}.so"


def native_lib() -> ctypes.CDLL:
    """The built integrator: compiled with g++ at first use; a failed
    build raises with the compiler's message."""
    global _NATIVE
    if _NATIVE is None:
        out = native_library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(NATIVE_SOURCE)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                os.unlink(tmp)
                raise RuntimeError(f"cannot run g++ to build "
                                   f"{NATIVE_SOURCE.name}: {e}") from e
            if r.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed ({r.returncode}) on "
                                   f"{NATIVE_SOURCE.name}:\n{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        pd = ctypes.POINTER(ctypes.c_double)
        i64, ci = ctypes.c_int64, ctypes.c_int
        lib.incflo_box_fractions_3d.argtypes = [pd, i64, i64, i64, ci, pd]
        lib.incflo_box_fractions_2d.argtypes = [pd, i64, i64, ci, pd]
        lib.incflo_box_fractions_3d.restype = None
        lib.incflo_box_fractions_2d.restype = None
        _NATIVE = lib
    return _NATIVE


def _box_fraction_native(node_phi: np.ndarray, s: int, nd: int):
    lib = native_lib()
    phi = np.ascontiguousarray(node_phi, dtype=np.float64)
    n = tuple((phi.shape[d] - 1) // s for d in range(nd))
    out = np.empty(n, dtype=np.float64)
    pd = ctypes.POINTER(ctypes.c_double)
    if nd == 3:
        lib.incflo_box_fractions_3d(phi.ctypes.data_as(pd), n[0], n[1],
                                    n[2], s, out.ctypes.data_as(pd))
    else:
        lib.incflo_box_fractions_2d(phi.ctypes.data_as(pd), n[0], n[1], s,
                                    out.ctypes.data_as(pd))
    return out


def compute_eb_data(phi_if: IF, grid: Grid, refine: int = 4) -> EBData:
    """Build EBData by sampling phi on the refine-refined node lattice."""
    nd = grid.ndim
    n = grid.n_cell
    dx = grid.dx
    s = refine

    # node lattice of the refined grid
    coords = []
    for d in range(nd):
        c = grid.prob_lo[d] + np.arange(n[d] * s + 1) * (dx[d] / s)
        shape = [1] * nd
        shape[d] = -1
        coords.append(c.reshape(shape))
    node_phi = np.broadcast_to(
        phi_if(coords), tuple(n[d] * s + 1 for d in range(nd))).copy()
    if np.all(node_phi < 0):
        return EBData(vfrac=np.ones(n),
                      afrac=[np.ones(_face_shape(n, d)) for d in range(nd)],
                      flags=np.zeros(n, np.int8),
                      eb_area=np.zeros(n),
                      eb_normal=np.zeros(n + (nd,)),
                      centroid=np.zeros(n + (nd,)),
                      all_regular=True)

    vfrac = _box_fraction_refined(node_phi, s, nd)
    # octant (half-cell) fluid fractions on the 2x lattice, from the same
    # refined node data (requires refine even, default 4)
    vfrac_oct = _box_fraction_refined(node_phi, s // 2, nd) \
        if s % 2 == 0 else None

    # face area fractions + fluid centroids on the face lattices
    afrac = []
    face_cent = []
    for d in range(nd):
        sl = [slice(None)] * nd
        sl[d] = slice(0, node_phi.shape[d], s)
        face_nodes = node_phi[tuple(sl)]        # coarse along d, fine else
        if nd == 2:
            t = 1 - d
            # 1D fraction along axis t for each face
            a, cent_t = _line_fraction(face_nodes, s, d, t,
                                       with_centroid=True)
            fc = np.zeros(a.shape + (nd,))
            fc[..., t] = cent_t
        else:
            t_axes = [ax for ax in range(3) if ax != d]
            a, cents = _quad_fraction(face_nodes, s, d, t_axes,
                                      with_centroid=True)
            fc = np.zeros(a.shape + (nd,))
            fc[..., t_axes[0]] = cents[0]
            fc[..., t_axes[1]] = cents[1]
        afrac.append(np.clip(a, 0.0, 1.0))
        face_cent.append(fc)

    # snap tiny volume fractions to covered (AMReX EB2 small_volfrac
    # analog); cells below this cannot be represented stably by the
    # cut-cell solvers and are handled by redistribution anyway
    tol = 1e-6
    flags = np.full(n, CUT, np.int8)
    flags[vfrac >= 1.0 - 1e-8] = REGULAR
    flags[vfrac <= tol] = COVERED
    vfrac = np.where(flags == COVERED, 0.0, vfrac)
    vfrac = np.where(flags == REGULAR, 1.0, vfrac)
    # snap face fractions adjacent to covered cells to zero and between
    # regular cells to one (consistency with the flags)
    for d in range(nd):
        a = afrac[d]
        cov = (flags == COVERED)
        reg = (flags == REGULAR)
        pad_cov = np.pad(cov, [(1, 1) if ax == d else (0, 0)
                               for ax in range(nd)], constant_values=False)
        pad_reg = np.pad(reg, [(1, 1) if ax == d else (0, 0)
                               for ax in range(nd)], constant_values=True)
        lo_c = np.take(pad_cov, range(0, n[d] + 1), axis=d)
        hi_c = np.take(pad_cov, range(1, n[d] + 2), axis=d)
        lo_r = np.take(pad_reg, range(0, n[d] + 1), axis=d)
        hi_r = np.take(pad_reg, range(1, n[d] + 2), axis=d)
        a = np.where(lo_c | hi_c, 0.0, a)
        a = np.where(lo_r & hi_r, 1.0, a)
        afrac[d] = a
        # face centroid is meaningless on snapped faces: full faces are
        # centered, closed faces contribute nothing
        full = (a >= 1.0 - 1e-12) | (a <= 0.0)
        face_cent[d] = np.where(full[..., None], 0.0, face_cent[d])

    # EB normal from the phi gradient at cell centers; EB area from the
    # divergence theorem: A_eb * n = -(sum of face-area differences)
    eb_normal = np.zeros(n + (nd,))
    eb_vec = np.zeros(n + (nd,))
    for d in range(nd):
        a = afrac[d]
        lo = np.take(a, range(0, n[d]), axis=d)
        hi = np.take(a, range(1, n[d] + 1), axis=d)
        # divergence theorem over the fluid region:
        # A_eb n_d = -(A_hi - A_lo) * V/dx_d with n pointing into the
        # BODY; negate so the stored normal points INTO THE FLUID
        # (the wall-gradient stencils differentiate along it)
        eb_vec[..., d] = hi - lo
    mag = np.sqrt((eb_vec ** 2).sum(-1))
    eb_area = mag
    with np.errstate(invalid="ignore", divide="ignore"):
        eb_normal = np.where(mag[..., None] > tol, eb_vec / np.maximum(
            mag[..., None], tol), 0.0)

    # fluid centroid per cell (refined subcell-weighted)
    centroid = _centroids(node_phi, s, nd, vfrac)

    # distance from the fluid centroid to the EB wall along the normal
    # (physical units): first-order level-set estimate |phi|/|grad phi|
    # evaluated at the fluid centroid.  Feeds the Dirichlet wall-flux
    # stencil in ops/diffusion.py (the reference gets the equivalent
    # geometry from AMReX's MLEBTensorOp stencil assembly).
    wall_dist = None
    if s % 2 == 0:
        h = s // 2
        ctr = np.ix_(*[np.arange(n[d]) * s + h for d in range(nd)])
        phi_c = node_phi[ctr]
        grad = np.zeros(n + (nd,))
        for d in range(nd):
            idx = [np.arange(n[d2]) * s + h for d2 in range(nd)]
            idx_hi, idx_lo = list(idx), list(idx)
            idx_hi[d] = idx[d] + h
            idx_lo[d] = idx[d] - h
            grad[..., d] = (node_phi[np.ix_(*idx_hi)]
                            - node_phi[np.ix_(*idx_lo)]) / dx[d]
        phi_fc = phi_c + sum(grad[..., d] * centroid[..., d] * dx[d]
                             for d in range(nd))
        gmag = np.sqrt((grad ** 2).sum(-1))
        wall_dist = np.where(
            flags == CUT,
            np.maximum(-phi_fc, 0.0) / np.maximum(gmag, 1e-300), 0.0)

    if vfrac_oct is not None:
        # consistency with the snapped flags: covered cells have no fluid
        # octants, regular cells full ones
        for idx in np.ndindex(*(2,) * nd):
            sl = tuple(slice(i, None, 2) for i in idx)
            sub = vfrac_oct[sl]
            sub[flags == COVERED] = 0.0
            sub[flags == REGULAR] = 1.0
    return EBData(vfrac=vfrac, afrac=afrac, flags=flags, eb_area=eb_area,
                  eb_normal=eb_normal, centroid=centroid,
                  face_cent=face_cent, vfrac_oct=vfrac_oct,
                  wall_dist=wall_dist, all_regular=False)


def _face_shape(n, d):
    return tuple(nn + (1 if ax == d else 0) for ax, nn in enumerate(n))


def _line_fraction(face_nodes, s, d, t, with_centroid=False):
    """2D: fraction of each face (a segment along axis t) that is fluid;
    optionally also the fluid centroid offset along t (units of dx)."""
    # face_nodes: coarse nodes along d (n_d+1), fine nodes along t (s*n_t+1)
    nd = 2
    n_t = (face_nodes.shape[t] - 1) // s
    out = 0.0
    mom = 0.0
    for off in range(s):
        sl_lo = [slice(None)] * nd
        sl_hi = [slice(None)] * nd
        sl_lo[t] = slice(off, off + s * n_t, s)
        sl_hi[t] = slice(off + 1, off + 1 + s * n_t, s)
        lo = face_nodes[tuple(sl_lo)]
        hi = face_nodes[tuple(sl_hi)]
        corner = np.stack([lo, hi], axis=-1)
        f = _simplex_fraction(corner, 1)
        out = out + f
        if with_centroid:
            mom = mom + f * ((off + 0.5) / s - 0.5)
    frac = out / s
    if not with_centroid:
        return frac
    cent = mom / s / np.maximum(frac, 1e-12)
    cent = np.where(frac > 1e-12, cent, 0.0)
    return frac, cent


def _quad_fraction(face_nodes, s, d, t_axes, with_centroid=False):
    """3D: fluid fraction of each face (a quad over the two t axes);
    optionally the fluid centroid offsets along (t1, t2)."""
    nd = 3
    t1, t2 = t_axes
    n1 = (face_nodes.shape[t1] - 1) // s
    n2 = (face_nodes.shape[t2] - 1) // s
    out = 0.0
    mom1 = 0.0
    mom2 = 0.0

    def fraction(offset):
        o1, o2 = offset

        def sl(a1, a2):
            x = [slice(None)] * nd
            x[t1] = slice(o1 + a1, o1 + a1 + s * n1, s)
            x[t2] = slice(o2 + a2, o2 + a2 + s * n2, s)
            return face_nodes[tuple(x)]
        corner = np.stack([np.stack([sl(0, 0), sl(0, 1)], axis=-1),
                           np.stack([sl(1, 0), sl(1, 1)], axis=-1)], axis=-2)
        return _simplex_fraction(corner, 2)
    offsets = list(itertools.product(range(s), repeat=2))
    fracs = _in_order(fraction, offsets, face_nodes.size // (s * s))
    for (o1, o2), f in zip(offsets, fracs):
        out = out + f
        if with_centroid:
            mom1 = mom1 + f * ((o1 + 0.5) / s - 0.5)
            mom2 = mom2 + f * ((o2 + 0.5) / s - 0.5)
    frac = out / (s * s)
    if not with_centroid:
        return frac
    denom = np.maximum(frac, 1e-12) * (s * s)
    c1 = np.where(frac > 1e-12, mom1 / denom, 0.0)
    c2 = np.where(frac > 1e-12, mom2 / denom, 0.0)
    return frac, (c1, c2)


def _centroids(node_phi, s, nd, vfrac):
    """Fluid centroid offsets from the cell center, units of dx, from
    subcell fractions."""
    n = vfrac.shape
    num = np.zeros(n + (nd,))

    def fraction(off):
        sub = np.empty(n + (2,) * nd)
        for cs in itertools.product((0, 1), repeat=nd):
            idx = tuple(slice(off[d] + cs[d], off[d] + cs[d] + s * n[d], s)
                        for d in range(nd))
            sub[(...,) + cs] = node_phi[idx]
        return _simplex_fraction(sub, nd)
    offsets = list(itertools.product(range(s), repeat=nd))
    for off, f in zip(offsets, _in_order(fraction, offsets, vfrac.size)):
        for d in range(nd):
            pos = (off[d] + 0.5) / s - 0.5   # subcell center offset
            num[..., d] += f * pos
    denom = np.maximum(vfrac * (s ** nd) / (s ** nd), 1e-12)
    return num / (s ** nd) / denom[..., None]
