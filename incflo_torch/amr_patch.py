"""Tagged-box patch AMR (port of incflo_tpu/amr_patch.py).

The reference refines arbitrary tagged BoxArrays
(src/incflo_regrid.cpp:8-119) with two-level fillpatch ghosts
(src/boundary_conditions/incflo_fillpatch.cpp:10-255) and average_down
synchronization.  As in incflo_tpu:

  * Each patch is a BOX: a contiguous nd index range in its parent
    (amr.patch_mode = box: a Berger-Rigoutsos-style signature split
    clusters the tags into up to amr.max_patches boxes per parent).
  * amr.patch_mode = slab constrains every box to span the whole domain
    on all but one axis, the one along which the tags localize (the
    interface band of rayleigh_taylor along z).
  * Box bounds snap to blocks of 4 coarse cells and are padded; a regrid
    whose new boxes fit in the old ones keeps the old bounds
    (hysteresis).
  * No subcycling: one dt, the least over the levels, advances every
    level; a patch's ghosts and the Dirichlet closures of its MAC, nodal
    and diffusion solves at its coarse-fine faces are interpolated from
    the parent (old-time state for the ghosts, the just-advanced state
    for the closures), and average_down feeds each patch's solution back
    into its parent every step; a composite pressure sync re-projects
    the parents and re-closes the patches.

Coarse-fine closures (per solve):
  state ghosts      : bilinear cell interpolation of the parent's state
                      through the ext_dir machinery (PatchEV)
  MAC projection    : Dirichlet phi at CF faces = interpolated parent
                      mac_phi                      (bc_override/phi_bvals)
  nodal projection  : Dirichlet phi at CF boundary nodes = nodal
                      prolongation of parent p     (dirichlet_vals)
  diffusion         : Dirichlet velocity/tracer at CF faces =
                      interpolated parent fields   (bvals_override)

The port runs eagerly: no jit and no cache of compiled advances
(incflo_tpu's _adv_cache), and PatchState is a plain class.  The host
side (tagging and clustering) is incflo_tpu's numpy code, copied.  The
kernels a patch runs are those of any walled level: the walled
`cell_smooth` and `nodal_smooth` (Dirichlet at the CF faces) on 3D
levels, and the plain walled Godunov chain (a CF face is never
periodic), where incflo_tpu sweeps and advects its patches in jnp.

With embedded boundaries (incflo_tpu's ordinary path): the cut cells
are tagged on every level (compute_tags; incflo_tagging.cpp:133-140),
each patch builds its own cut-cell geometry on its grid (a patch whose
box holds no cut cell has none), its initial velocity and tracer are
zero in its covered cells, and its nodal projection takes the
vfrac-weighted weak form with its Dirichlet coarse-fine values
(Simulation.apply_projection); the base keeps the exact octant operator.

Split over an x-slab mesh (parallel/mesh.py; incflo_tpu shards each
level's arrays where an axis divides the mesh and replicates it
elsewhere, incflo_tpu/parallel/mesh.py:44-57), the base level is split
and each patch takes one of two forms, by its box alone:
  split       a patch over its split parent's whole x range (a slab
              patch along y or z, a box that spans x, any patch under
              it that does too) takes the same mesh: rank r holds the
              2 nxl patch rows over its own nxl parent rows.  Its
              context is its slab's (the parent's ghost rows come from
              the parent's own halo exchanges), its coarse-fine faces
              lie on y and z, where the slab smoothers take them as
              Dirichlet faces, and it averages down into its parent's
              rows with no exchange;
  replicated  any other patch (an x slab patch, a box with coarse-fine
              x faces, a patch under a replicated one) is held whole on
              every rank and runs with no mesh, the same bits on every
              rank: its context is interpolated from its parent's fields
              gathered whole in rank order (SlabMesh.all_gather_x) and
              grown with the whole parent level's boundary conditions,
              and its average_down writes each rank's rows of a split
              parent.
A split patch cuts its cut-cell arrays to its slab, a replicated one
holds its whole geometry, and a base that does not split is held whole
with the whole tree.  Every rank tags the same gathered densities (and
cut cells) and clusters them the same way, so every rank builds the same
tree, and a regrid may move a patch
between the forms.  The step's one dt is the least over the tree: a
split level's compute_dt reduces over the ranks, and a replicated
patch's is the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from incflo_torch import bcs, probs
from incflo_torch.bcs import BCType
from incflo_torch.config import IncfloConfig
from incflo_torch.grid import Grid
from incflo_torch.ops import multigrid as mg
from incflo_torch.parallel.mesh import mesh_of
from incflo_torch.simulation import Simulation
from incflo_torch.state import LevelState, SimState
from incflo_torch.utils import tracing

BLOCK = 4          # box bounds snap to this many coarse cells
NG_CTX = 4         # interp ghost depth kept in the context arrays

# a patch box: per-axis half-open parent-cell ranges ((lo,...), (hi,...))
Box = Tuple[Tuple[int, ...], Tuple[int, ...]]


def _slab_box(lo: int, hi: int, axis: int, n_cell) -> Box:
    """Box spanning the whole domain except [lo, hi) along `axis`."""
    lo_t = tuple(lo if a == axis else 0 for a in range(len(n_cell)))
    hi_t = tuple(hi if a == axis else n for a, n in enumerate(n_cell))
    return lo_t, hi_t


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def whole_grid(grid: Grid) -> Grid:
    """The whole level of a rank's x slab (SlabGrid.full), else grid."""
    return grid if mesh_of(grid) is None else grid.full


def _rows(sim) -> Tuple[int, int]:
    """(first, count) of the x cell rows of its level that sim holds:
    its slab's on a mesh, else all of them."""
    grid = sim.grid
    return (grid.x0, grid.n_cell[0]) if sim.mesh is not None \
        else (0, grid.n_cell[0])


def _whole_eb(sim):
    """sim's cut-cell arrays with the whole level's cut mask (a split
    level's slabs of it gathered in rank order), as compute_tags reads
    them; None without cut cells."""
    eb = sim.eb
    if eb is None or sim.mesh is None:
        return eb
    return dataclasses.replace(eb, cut=sim.mesh.all_gather_x(eb.cut))


def _whole_ev(ev, grid: Grid, mesh):
    """The ghost-value provider `ev` of a rank's slab for the whole
    level `grid`: a patch's PatchEV with its interpolated parent window
    gathered whole, ghost rows included (every rank the same bits); the
    deck's physical ExtDirValues on the whole grid."""
    if isinstance(ev, PatchEV):
        return PatchEV(_whole_ev(ev.base, grid, mesh), ev.interior,
                       mesh.all_gather_x(ev.full, ghosts=ev.ng), ev.ng)
    return bcs.ExtDirValues(grid, ev.values, ev.probtype)


# ---------------------------------------------------------------------
# interpolation helpers (parent cells -> child cells, ratio 2)
# ---------------------------------------------------------------------

def _prolong_window(cw: torch.Tensor, nd: int) -> torch.Tensor:
    """Bilinear 2x cell prolongation of a parent window that carries one
    parent ghost on every spatial axis; the output drops the half-child
    overhang, so it maps onto 2*(w-2)+2 child cells: the children of the
    interior plus ONE child ghost ring."""
    out = cw
    for ax in range(nd):
        n = out.shape[ax]
        mid = mg._slice_axis(out, ax, slice(1, n - 1))
        left = mg._slice_axis(out, ax, slice(0, n - 2))
        right = mg._slice_axis(out, ax, slice(2, n))
        even = 0.75 * mid + 0.25 * left
        odd = 0.75 * mid + 0.25 * right
        body = mg._interleave(even, odd, ax)    # 2*(n-2) children
        lo = (0.75 * mg._slice_axis(out, ax, slice(0, 1))
              + 0.25 * mg._slice_axis(out, ax, slice(1, 2)))
        hi = (0.75 * mg._slice_axis(out, ax, slice(n - 1, n))
              + 0.25 * mg._slice_axis(out, ax, slice(n - 2, n - 1)))
        out = torch.cat([lo, body, hi], dim=ax)
    return out


def _nodal_prolong_window(pw: torch.Tensor, nd: int, periodic) -> torch.Tensor:
    """Linear 2x nodal prolongation of a parent NODE window: bounded axes
    w -> 2w-1 (even copy, odd average); periodic axes hold UNIQUE nodes
    (w of them) and give 2w children through the wraparound."""
    out = pw
    for ax in range(nd):
        n = out.shape[ax]
        if periodic[ax]:
            wrapped = torch.cat([out, mg._slice_axis(out, ax, slice(0, 1))],
                                dim=ax)
            odd = 0.5 * (mg._slice_axis(wrapped, ax, slice(0, n))
                         + mg._slice_axis(wrapped, ax, slice(1, n + 1)))
            out = mg._interleave(out, odd, ax)
        else:
            odd = 0.5 * (mg._slice_axis(out, ax, slice(0, n - 1))
                         + mg._slice_axis(out, ax, slice(1, n)))
            body = mg._interleave(mg._slice_axis(out, ax, slice(0, n - 1)),
                                  odd, ax)
            out = torch.cat([body, mg._slice_axis(out, ax, slice(n - 1, n))],
                            dim=ax)
    return out


def _avg_down_window(f: torch.Tensor, nd: int) -> torch.Tensor:
    """2^nd child average over the first nd axes."""
    for ax in range(nd):
        n = f.shape[ax]
        f = 0.5 * (mg._slice_axis(f, ax, slice(0, n, 2))
                   + mg._slice_axis(f, ax, slice(1, n, 2)))
    return f


class PatchEV:
    """ExtDirValues of a patch: coarse-fine faces read interpolated
    parent data; true domain faces ask the physical provider."""

    def __init__(self, base_ev, interior, full: torch.Tensor, ng: int):
        self.base = base_ev
        self.interior = interior          # set of (axis, side)
        self.full = full                  # (n_f + 2ng per axis, ncomp)
        self.ng = ng
        self.ncomp = full.shape[-1]

    def slab(self, face_ax, side, comp, pads, dtype, g=1, device=None):
        if (face_ax, side) not in self.interior:
            return self.base.slab(face_ax, side, comp, pads, dtype, g=g,
                                  device=device)
        a = self.full[..., comp]
        sl = []
        for ax in range(a.dim()):
            n_ax = a.shape[ax] - 2 * self.ng
            if ax == face_ax:
                sl.append(slice(self.ng - g, self.ng) if side == 0
                          else slice(self.ng + n_ax, self.ng + n_ax + g))
            else:
                p = pads[ax]
                sl.append(slice(self.ng - p, self.ng + n_ax + p))
        # trailing singleton: grow()'s ghost blocks carry the comp axis
        return a[tuple(sl)][..., None].to(dtype)


class PatchSim(Simulation):
    """Simulation on a box patch with coarse-fine closures at its
    interior faces.  set_context() must run before any advance or init
    entry point."""

    PREBUILD = False

    def __init__(self, cfg: IncfloConfig, interior,
                 parent_lo: Tuple[int, ...], parent: Simulation,
                 face_domain, mesh=None):
        super().__init__(cfg, device=parent.device, mesh=mesh)
        self.cf_interior = frozenset(interior)   # {(axis, side)}
        # parent cell index of the patch lo corner, per axis (along x of
        # a split patch that of its slab in its parent's slab: 0)
        self.parent_lo = tuple(parent_lo)
        self._parent = parent
        # a patch held whole under a split parent reads the parent's
        # fields gathered whole, on the whole parent level's grid
        self._gathers = parent.mesh is not None and mesh is None
        self._pgrid = whole_grid(parent.grid) if self._gathers \
            else parent.grid
        self.face_domain = tuple(face_domain)
        # CF faces carry interpolated parent CELL data (FillPatch
        # semantics: stencils treat the ghosts as interior, not as a
        # face-located Dirichlet value); forces extrapolate
        for bcr in (self.vel_bcrec, self.den_bcrec, self.tra_bcrec):
            for (ax, side) in self.cf_interior:
                bcr[:, ax, side] = BCType.cf_fill
        for (ax, side) in self.cf_interior:
            self.force_bcrec[:, ax, side] = BCType.foextrap
        self._ctx_set = False
        self._base_evs = (self.vel_ev, self.den_ev, self.tra_ev)

    # -- context ------------------------------------------------------
    def _interp_full(self, field, grow_fn):
        """Bilinear parent->child interpolation of one parent field over
        the patch plus NG_CTX child ghosts on every axis."""
        nd = self.grid.ndim
        ngc = NG_CTX // 2 + 1                    # parent ghosts needed
        g = grow_fn(field, ngc)                  # parent + ngc ghosts
        sl = [slice(None)] * g.dim()
        for ax in range(nd):
            npatch_c = self.grid.n_cell[ax] // 2  # parent cells under patch
            lo = self.parent_lo[ax]               # grown-frame offset
            sl[ax] = slice(lo, lo + npatch_c + 2 * ngc)
        f = _prolong_window(g[tuple(sl)], nd)
        # prolong of (m + 2*ngc) parent cells per axis gives
        # 2m + 4*ngc - 2 children -> child ghost depth 2*ngc - 1
        have = 2 * ngc - 1
        t = [slice(have - NG_CTX, f.shape[a] - (have - NG_CTX))
             for a in range(nd)]
        return f[tuple(t)]

    def _grow_foex(self, x, g):
        """Parent ghost fill by first-order extrapolation (fields with no
        physical BC machinery: pressure-like ones)."""
        rec = bcs.make_bcrecs(x.shape[-1], self._pgrid.ndim) * 0 \
            + BCType.foextrap
        return bcs.grow(x, g, self._pgrid, rec)

    def _take(self, t, nodal=False):
        """A parent field as the context reads it: the parent's own (its
        slab, for a split patch), or gathered whole (_gathers); nodal:
        the last rank holds node nx where x ends in boundaries."""
        if not self._gathers:
            return t
        return self._parent.mesh.all_gather_x(
            t, extra_last=nodal and not self._pgrid.periodic[0])

    def _parent_growers(self):
        """The parent's velocity, density and tracer ghost fills (each
        (field with a component axis, ng)): its own, or -- for a patch
        held whole under a split parent -- the whole parent level's, its
        ghost-value providers gathered whole."""
        par = self._parent
        if not self._gathers:
            return (par.grow_vel,
                    lambda x, g: par.grow_rho(x[..., 0], g)[..., None],
                    par.grow_tra)
        grid = self._pgrid
        recs = (par.vel_bcrec, par.den_bcrec, par.tra_bcrec)
        evs = [_whole_ev(ev, grid, par.mesh)
               for ev in (par.vel_ev, par.den_ev, par.tra_ev)]
        return tuple((lambda x, g, rec=rec, ev=ev:
                      bcs.grow(x, g, grid, rec, ev))
                     for rec, ev in zip(recs, evs))

    def set_context(self, parent_lvl: LevelState,
                    parent_lvl_old: Optional[LevelState] = None):
        """Interpolate the parent level state into the patch halo and the
        solver boundary values.

        parent_lvl_old, when given, feeds the STATE ghost fills (the
        old-time convective stencils of the fine step read the parent's
        old state, the reference's FillPatch at t_old); the implicit-solve
        closures (MAC/nodal/diffusion Dirichlet values) always come from
        the just-advanced parent_lvl."""
        nd = self.grid.ndim
        take = self._take
        grow_vel, grow_rho, grow_tra = self._parent_growers()
        ghost_src = parent_lvl_old if parent_lvl_old is not None \
            else parent_lvl
        vel_g_full = self._interp_full(take(ghost_src.velocity), grow_vel)
        rho_g_full = self._interp_full(take(ghost_src.density)[..., None],
                                       grow_rho)
        tra_g_full = self._interp_full(take(ghost_src.tracer), grow_tra)
        if parent_lvl_old is not None:
            vel_full = self._interp_full(take(parent_lvl.velocity),
                                         grow_vel)
            tra_full = self._interp_full(take(parent_lvl.tracer), grow_tra)
        else:
            vel_full, tra_full = vel_g_full, tra_g_full
        mac_full = self._interp_full(take(parent_lvl.mac_phi)[..., None],
                                     self._grow_foex)

        self.vel_ev = PatchEV(self._base_evs[0], self.cf_interior,
                              vel_g_full, NG_CTX)
        self.den_ev = PatchEV(self._base_evs[1], self.cf_interior,
                              rho_g_full, NG_CTX)
        self.tra_ev = PatchEV(self._base_evs[2], self.cf_interior,
                              tra_g_full, NG_CTX)

        # solver boundary values at the CF faces
        self._mac_bvals, self._vel_bvals, self._tra_bvals = {}, {}, {}
        for (fax, side) in self.cf_interior:
            def face_val(full):
                n_ax = full.shape[fax] - 2 * NG_CTX
                if side == 0:
                    gh = mg._slice_axis(full, fax, slice(NG_CTX - 1, NG_CTX))
                    inb = mg._slice_axis(full, fax,
                                         slice(NG_CTX, NG_CTX + 1))
                else:
                    gh = mg._slice_axis(full, fax, slice(NG_CTX + n_ax,
                                                         NG_CTX + n_ax + 1))
                    inb = mg._slice_axis(full, fax, slice(NG_CTX + n_ax - 1,
                                                          NG_CTX + n_ax))
                v = 0.5 * (gh + inb)
                # transverse axes BELOW fax are already ghost-padded by 1
                # when the solver's axis-ordered pad reaches fax
                for a2 in range(nd):
                    if a2 == fax:
                        continue
                    m = full.shape[a2] - 2 * NG_CTX
                    v = mg._slice_axis(v, a2, slice(NG_CTX - 1,
                                                    NG_CTX + m + 1)
                                       if a2 < fax
                                       else slice(NG_CTX, NG_CTX + m))
                return v

            self._mac_bvals[(fax, side)] = face_val(mac_full)[..., 0]
            self._vel_bvals[(fax, side)] = face_val(vel_full)
            self._tra_bvals[(fax, side)] = face_val(tra_full)

        # nodal Dirichlet values: prolong the parent nodal p window
        self._nodal_dvals = self._nodal_dvals_from(parent_lvl.p)
        self._nodal_dvals_override = None
        self._ctx_set = True

    def _nodal_dvals_from(self, parent_p):
        """CF Dirichlet node values from a parent nodal field."""
        pf = self._interp_nodal_p(parent_p)
        out = {}
        for (fax, side) in self.cf_interior:
            n_f = pf.shape[fax]
            out[(fax, side)] = mg._slice_axis(
                pf, fax, slice(0, 1) if side == 0 else slice(n_f - 1, n_f))
        return out

    # -- hooks consumed by Simulation ---------------------------------
    def _cf_override(self):
        assert self._ctx_set, "PatchSim.set_context() not called"
        return {f: mg.SolverBC.DIRICHLET for f in self.cf_interior}

    def _mac_bc_args(self):
        return {"bc_override": self._cf_override(),
                "phi_bvals": dict(self._mac_bvals)}

    def _nodal_bc_args(self):
        # the composite-sync correction solve takes the parent's DELTA-p
        # (an incremental phi), not the full p
        vals = self._nodal_dvals if self._nodal_dvals_override is None \
            else self._nodal_dvals_override
        return self._cf_override(), dict(vals)

    def _diff_bc_args(self, field):
        return self._cf_override(), dict(
            self._vel_bvals if field == "vel" else self._tra_bvals)

    def init_state_from(self, parent_state: SimState) -> SimState:
        """Initial fine state: OWN ICs for the advected fields (a sharper
        interface than interpolation) but p and gp INHERITED from the
        parent's post-init solve.  The patch's own initial projection
        against the CF Dirichlet-phi closure would mint spurious
        velocity; the reference runs InitialProjection on the composite
        hierarchy."""
        assert self._ctx_set
        base = self.init_from_parent(parent_state)
        own = probs.init_fluid(self.cfg, self.cfg.grid, self.dtype,
                               self.device)
        cut = (lambda t: t) if self.mesh is None \
            else (lambda t: self.mesh.slab(t).contiguous())
        lvl = base.level._replace(velocity=cut(own.velocity),
                                  density=cut(own.density),
                                  tracer=cut(own.tracer))
        if self.eb is not None:     # covered cells start at rest
            f = self.eb.fluid[..., None]
            lvl = lvl._replace(velocity=lvl.velocity * f,
                               tracer=lvl.tracer * f)
        return base._replace(level=lvl)

    # -- regrid support (reference MakeNewLevelFromCoarse) -------------
    def init_from_parent(self, parent_state: SimState) -> SimState:
        """Fine state purely by interpolation of the parent (the fill of
        newly refined cells; the caller copies surviving old fine data
        over the overlap)."""
        assert self._ctx_set
        nd = self.grid.ndim

        def interior(full):
            return full[tuple(slice(NG_CTX, full.shape[a] - NG_CTX)
                              for a in range(nd))]

        plvl = parent_state.level
        take = self._take
        lvl = LevelState(
            velocity=interior(self.vel_ev.full),
            density=interior(self.den_ev.full)[..., 0],
            tracer=interior(self.tra_ev.full),
            gp=interior(self._interp_full(take(plvl.gp), self._grow_foex)),
            p=self._interp_nodal_p(plvl.p),
            mac_phi=interior(self._interp_full(
                take(plvl.mac_phi)[..., None], self._grow_foex))[..., 0],
        )
        return parent_state._replace(level=lvl)

    def _interp_nodal_p(self, p):
        """The patch's nodes prolonged from a parent nodal field.  Along
        x of a split patch the slab's nodes and, beyond them, the right
        neighbour's first (the last rank of an x that ends in boundaries
        holds node nx itself): the bounded prolongation of those nxl + 1
        parent nodes gives the slab's 2 nxl child nodes and one more,
        which only that last rank keeps."""
        nd = self.grid.ndim
        per = list(self.grid.periodic)
        pw = self._take(p, nodal=True)
        pgrid = self._pgrid
        split = self.mesh is not None
        if split:
            pw = self.mesh.halo_x(pw, 0, 1, periodic=pgrid.periodic[0])
            per[0] = False
        for ax in range(1 if split else 0, nd):
            if per[ax]:
                # the patch covers the whole periodic axis: unique nodes,
                # exact wraparound prolongation
                continue
            lo = self.parent_lo[ax]
            npatch_c = self.grid.n_cell[ax] // 2
            if pgrid.periodic[ax]:
                idx = torch.arange(lo, lo + npatch_c + 1,
                                   device=pw.device) % pgrid.n_cell[ax]
                pw = torch.index_select(pw, ax, idx)
            else:
                pw = mg._slice_axis(pw, ax, slice(lo, lo + npatch_c + 1))
        out = _nodal_prolong_window(pw, nd, per)
        if split and not self.mesh.ends(self.grid.periodic[0])[1]:
            out = out.narrow(0, 0, out.shape[0] - 1)
        return out


# ---------------------------------------------------------------------
# tagging and clustering (host numpy; incflo_tpu/amr_patch.py:406-667)
# ---------------------------------------------------------------------

def compute_tags(cfg: IncfloConfig, rho: np.ndarray, grid: Grid,
                 eb=None, lev: int = 0) -> np.ndarray:
    """ErrorEst tags on level `lev` (incflo_tagging.cpp:20-44; cut cells
    forced per :133-140).  rhoerr/gradrhoerr are PER-LEVEL arrays: level
    lev uses entry lev, the last entry repeated past the end."""
    rho = _np(rho)
    tags = np.zeros(rho.shape, bool)
    if len(cfg.rhoerr) > 0:
        tags |= rho > cfg.rhoerr[min(lev, len(cfg.rhoerr) - 1)]
    if len(cfg.gradrhoerr) > 0:
        thr = cfg.gradrhoerr[min(lev, len(cfg.gradrhoerr) - 1)]
        for ax in range(rho.ndim):
            d = np.abs(np.diff(rho, axis=ax))
            pad = [(0, 1) if a == ax else (0, 0) for a in range(rho.ndim)]
            tags |= np.pad(d, pad) >= thr
            pad = [(1, 0) if a == ax else (0, 0) for a in range(rho.ndim)]
            tags |= np.pad(d, pad) >= thr
    if cfg.tag_region:
        coords = [np.asarray(grid.cell_centers_1d(ax)).reshape(
            [-1 if a == ax else 1 for a in range(grid.ndim)])
            for ax in range(grid.ndim)]
        inside = np.ones(grid.cell_shape, bool)
        for ax in range(grid.ndim):
            inside &= (coords[ax] >= cfg.tag_region_lo[ax]) \
                & (coords[ax] <= cfg.tag_region_hi[ax])
        tags |= inside
    if eb is not None:
        tags |= _np(eb.cut) > 0.5
    return tags


def choose_patch_mode(cfg: IncfloConfig) -> str:
    """Patch mode of an amr.max_level > 0 deck without amr.patch_mode:
    'box' when nd box clustering captures the INITIAL tags with clearly
    less area than the best slab (tags localized in several axes); 'slab'
    when they localize along one axis (a band); 'dense' (whole-domain
    fine advance) when they don't localize.  The initial density comes
    from the port's init_fluid on the CPU."""
    from incflo_torch.simulation import has_eb
    lvl = probs.init_fluid(cfg, cfg.grid, getattr(torch, cfg.dtype), "cpu")
    tags = compute_tags(cfg, lvl.density, cfg.grid)
    if has_eb(cfg):
        # forced cut-cell tagging (incflo_tagging.cpp:133-140)
        from incflo_torch.eb import geometry as ebgeom
        phi_if = ebgeom.make_eb_geometry(cfg.eb_geometry, cfg.pp, cfg.grid)
        data = ebgeom.compute_eb_data(phi_if, cfg.grid)
        if data.has_eb:
            tags |= data.flags == ebgeom.CUT
    if not tags.any():
        return "dense"
    best = 1.0
    for ax in range(tags.ndim):
        best = min(best, float(_project(tags, ax).mean()))
    boxes = _choose_boxes(tags, cfg.grid.n_cell, cfg.max_patches)
    box_frac = sum(int(np.prod([h - l for l, h in zip(lo, hi)]))
                   for lo, hi in boxes) / tags.size
    if box_frac <= 0.5 and box_frac <= 0.5 * best:
        return "box"
    return "slab" if best <= 0.5 else "dense"


def _project(tags: np.ndarray, axis: int) -> np.ndarray:
    """Whether any tag lies in each row along `axis`."""
    proj = tags
    for a2 in sorted(range(tags.ndim), reverse=True):
        if a2 != axis:
            proj = proj.any(axis=a2)
    return proj


def _choose_slab(tags: np.ndarray, axis: int, n: int) -> Tuple[int, int]:
    """Tagged index range along `axis`, padded by 1 block and snapped."""
    return _choose_slabs(tags, axis, n, max_patches=1)[0]


def _choose_slabs(tags: np.ndarray, axis: int, n: int,
                  max_patches: int = 4) -> List[Tuple[int, int]]:
    """Cluster the tagged rows along `axis` into up to `max_patches`
    disjoint slabs, each padded by one block and snapped (the 1D analog
    of the reference's ErrorEst -> box clustering, incflo_regrid.cpp:
    8-119).  Runs separated by small gaps merge first; over the budget
    the narrowest gaps keep merging."""
    idx = np.nonzero(_project(tags, axis))[0]
    if len(idx) == 0:
        # nothing tagged: keep a minimal centred slab alive
        mid = n // 2
        return [(max(0, mid - BLOCK), min(n, mid + BLOCK))]
    # maximal runs of tagged rows
    runs = []
    start = prev = int(idx[0])
    for i in idx[1:]:
        i = int(i)
        if i == prev + 1:
            prev = i
            continue
        runs.append((start, prev + 1))
        start = prev = i
    runs.append((start, prev + 1))
    # pad + snap each run
    slabs = []
    for lo, hi in runs:
        lo = max(0, (lo // BLOCK - 1) * BLOCK)
        hi = min(n, ((hi + BLOCK - 1) // BLOCK + 1) * BLOCK)
        slabs.append([lo, hi])

    # merge overlapping/touching, then merge smallest gaps to budget
    def merge_once(i):
        slabs[i][1] = max(slabs[i][1], slabs[i + 1][1])
        del slabs[i + 1]

    i = 0
    while i < len(slabs) - 1:
        if slabs[i + 1][0] <= slabs[i][1]:
            merge_once(i)
        else:
            i += 1
    while len(slabs) > max_patches:
        gaps = [slabs[i + 1][0] - slabs[i][1]
                for i in range(len(slabs) - 1)]
        merge_once(int(np.argmin(gaps)))
    return [tuple(s) for s in slabs]


def _tag_bbox(tags: np.ndarray) -> Optional[Box]:
    nz = np.nonzero(tags)
    if len(nz[0]) == 0:
        return None
    return (tuple(int(a.min()) for a in nz),
            tuple(int(a.max()) + 1 for a in nz))


def _box_eff(tags: np.ndarray, box: Box) -> float:
    sub = tags[tuple(slice(lo, hi) for lo, hi in zip(*box))]
    return float(sub.mean()) if sub.size else 1.0


def _split_box(tags: np.ndarray, box: Box):
    """One Berger-Rigoutsos split: cut at the longest zero run of the
    in-box tag signature (preferred) or at the strongest inflection of
    its second difference; each half shrinks to its own tag bounding
    box.  None when no admissible cut exists."""
    lo_t, hi_t = box
    nd = tags.ndim
    sub = tags[tuple(slice(lo, hi) for lo, hi in zip(lo_t, hi_t))]
    best = None                      # (kind, score, ax, cut)
    for ax in range(nd):
        n = sub.shape[ax]
        if n < 2 * BLOCK:
            continue
        sig = sub
        for a2 in sorted(range(nd), reverse=True):
            if a2 != ax:
                sig = sig.sum(axis=a2)
        # longest interior zero run
        zero = np.nonzero(sig == 0)[0]
        if len(zero):
            runs = np.split(zero, np.nonzero(np.diff(zero) > 1)[0] + 1)
            runs = [r for r in runs if r[0] > 0 and r[-1] < n - 1]
            if runs:
                r = max(runs, key=len)
                cand = ("zero", len(r), ax, int(r[len(r) // 2]) + 1)
                if best is None or (best[0] != "zero"
                                    or cand[1] > best[1]):
                    best = cand
                continue
        if best is not None and best[0] == "zero":
            continue
        # inflection of the signature Laplacian, away from the ends
        d2 = np.diff(sig.astype(np.int64), n=2)       # at cuts 1..n-2
        flip = np.nonzero(np.abs(np.diff(np.sign(d2))) > 0)[0]
        flip = flip[(flip >= BLOCK - 1) & (flip <= n - 1 - BLOCK)]
        if len(flip):
            mag = np.abs(d2[flip + 1] - d2[flip])
            k = int(np.argmax(mag))
            cand = ("infl", float(mag[k]), ax, int(flip[k]) + 2)
            if best is None or (best[0] == "infl" and cand[1] > best[1]):
                best = cand
    if best is None:
        return None
    _, _, ax, cut = best
    halves = []
    for r in (slice(0, cut), slice(cut, sub.shape[ax])):
        idx = [slice(None)] * nd
        idx[ax] = r
        bb = _tag_bbox(sub[tuple(idx)])
        if bb is None:
            continue
        off = [lo_t[a] for a in range(nd)]
        off[ax] += r.start
        halves.append((tuple(bb[0][a] + off[a] for a in range(nd)),
                       tuple(bb[1][a] + off[a] for a in range(nd))))
    return halves if len(halves) == 2 else None


def _boxes_overlap(a: Box, b: Box) -> bool:
    """Overlapping OR touching (closed-range test): touching siblings
    must merge too, since a patch's CF ghosts read only parent data."""
    return all(a[0][d] <= b[1][d] and b[0][d] <= a[1][d]
               for d in range(len(a[0])))


def _merge_boxes(a: Box, b: Box) -> Box:
    return (tuple(min(x, y) for x, y in zip(a[0], b[0])),
            tuple(max(x, y) for x, y in zip(a[1], b[1])))


def _choose_boxes(tags: np.ndarray, n_cell, max_patches: int
                  ) -> List[Box]:
    """Cluster the tags into up to max_patches nd boxes (the reference
    ErrorEst -> Berger-Rigoutsos cluster -> BoxArray pipeline,
    incflo_regrid.cpp:8-119, with a bounded box budget).  Boxes are
    padded by one BLOCK and snapped per axis; overlapping boxes merge."""
    bb = _tag_bbox(tags)
    if bb is None:
        mid = tuple(s // 2 for s in tags.shape)
        return [(tuple(max(0, m - BLOCK) for m in mid),
                 tuple(min(n, m + BLOCK) for m, n in zip(mid, tags.shape)))]
    boxes = [bb]
    # split the least-efficient box until every box is tight or the
    # budget is reached (one box more per pass)
    while len(boxes) < max_patches:
        order = sorted(range(len(boxes)),
                       key=lambda i: _box_eff(tags, boxes[i]))
        done = True
        for i in order:
            if _box_eff(tags, boxes[i]) >= 0.7:
                break
            halves = _split_box(tags, boxes[i])
            if halves is not None:
                boxes[i:i + 1] = halves
                done = False
                break
        if done:
            break
    # pad + snap + clip per axis
    out = []
    for lo_t, hi_t in boxes:
        lo2 = tuple(max(0, (lo // BLOCK - 1) * BLOCK) for lo in lo_t)
        hi2 = tuple(min(n, ((hi + BLOCK - 1) // BLOCK + 1) * BLOCK)
                    for hi, n in zip(hi_t, n_cell))
        out.append((lo2, hi2))
    # merge any overlapping pair to a bounding box until disjoint
    changed = True
    while changed:
        changed = False
        for i in range(len(out)):
            for j in range(i + 1, len(out)):
                if _boxes_overlap(out[i], out[j]):
                    out[i] = _merge_boxes(out[i], out[j])
                    del out[j]
                    changed = True
                    break
            if changed:
                break
    return sorted(out)


def _contains(outer: Box, inner: Box) -> bool:
    """outer box contains inner box (per-axis [lo, hi) ranges)."""
    return all(ol <= il and ih <= oh
               for ol, il, ih, oh in zip(outer[0], inner[0],
                                         inner[1], outer[1]))


def _overlap_volume(a: Box, b: Box) -> int:
    v = 1
    for d in range(len(a[0])):
        w = min(a[1][d], b[1][d]) - max(a[0][d], b[0][d])
        if w <= 0:
            return 0
        v *= w
    return v


def _copy_overlap(init: SimState, old: SimState, box: Box,
                  old_box: Box, rows=None, old_rows=None) -> SimState:
    """Copy the overlapping fine region (parent-cell box intersection)
    of the old fine state into the rebuilt one.  rows, old_rows: (first,
    count) of the x cell rows of its patch each state holds (a split
    patch's slab), None for all of them."""
    nd = len(box[0])
    ov_lo = [max(box[0][d], old_box[0][d]) for d in range(nd)]
    ov_hi = [min(box[1][d], old_box[1][d]) for d in range(nd)]
    if any(ov_hi[d] <= ov_lo[d] for d in range(nd)):
        return init
    # the fine rows each state holds, in the parent's fine index frame
    lo = [2 * box[0][d] for d in range(nd)]
    olo = [2 * old_box[0][d] for d in range(nd)]
    a = [2 * ov_lo[d] for d in range(nd)]
    b = [2 * ov_hi[d] for d in range(nd)]
    for held, start in ((rows, lo), (old_rows, olo)):
        if held is not None:
            start[0] += held[0]
            a[0] = max(a[0], start[0])
            b[0] = min(b[0], start[0] + held[1])
    if b[0] <= a[0]:
        return init
    dst = tuple(slice(a[d] - lo[d], b[d] - lo[d]) for d in range(nd))
    src = tuple(slice(a[d] - olo[d], b[d] - olo[d]) for d in range(nd))

    def cp(a, b):
        a = a.clone()
        a[dst] = b[src]
        return a

    lvl = init.level
    return init._replace(level=lvl._replace(
        velocity=cp(lvl.velocity, old.level.velocity),
        density=cp(lvl.density, old.level.density),
        tracer=cp(lvl.tracer, old.level.tracer),
        gp=cp(lvl.gp, old.level.gp)))


class PatchState:
    """Per-level SimStates (parents before children) presenting the
    level-0 scalars with the one-level SimState surface, so that the CLI
    driver loop works unchanged."""

    def __init__(self, levels):
        self.levels = tuple(levels)

    @property
    def t(self):
        return self.levels[0].t

    @property
    def dt(self):
        return self.levels[0].dt

    @property
    def step(self):
        return self.levels[0].step

    @property
    def level(self):
        return self.levels[0].level


class SlabAMRSimulation:
    """Tagged-box patch AMR driver (amr.patch_mode = box or slab).

    The hierarchy is a PATCH TREE stored flat: sims[0] is the base
    Simulation; every further entry is a PatchSim whose parent is
    sims[parent[i]].  Each level-(L-1) entry may carry several disjoint
    level-L boxes (amr.max_patches per parent).  In slab mode every box
    spans the whole domain except along the single axis where the tags
    localize; box mode clusters in all dimensions.

    device as for Simulation (None: the card); mesh: the SlabMesh the
    tree is split over (the module docstring: split and replicated
    patches)."""

    def __init__(self, cfg: IncfloConfig, device=None, mesh=None):
        assert cfg.max_level >= 1
        self.cfg = cfg
        self.base_grid = cfg.grid
        self.max_level = cfg.max_level
        self.max_patches = cfg.max_patches
        self.composite_sync = cfg.composite_sync
        self.box_mode = cfg.patch_mode == "box"
        self.mesh = mesh
        self.sim0 = Simulation(cfg, device=device, mesh=mesh)
        self.device = self.sim0.device
        self.dtype = self.sim0.dtype
        self.axis = self._pick_axis()
        self._reset_tree()

    def _reset_tree(self):
        self.sims: List[Simulation] = [self.sim0]
        self.bounds: List[Box] = [((0,) * self.base_grid.ndim,
                                   tuple(self.base_grid.n_cell))]
        self.parent: List[int] = [-1]
        self.level_of: List[int] = [0]
        self.masks: List[Optional[np.ndarray]] = [None]

    def _cluster(self, tags: np.ndarray, parent_sim) -> List[Box]:
        """Tags -> child boxes by the clustering mode; no tags, no
        children."""
        if not tags.any():
            return []
        n_cell = whole_grid(parent_sim.grid).n_cell
        if self.box_mode:
            return _choose_boxes(tags, n_cell, self.max_patches)
        slabs = _choose_slabs(tags, self.axis, n_cell[self.axis],
                              self.max_patches)
        return [_slab_box(lo, hi, self.axis, n_cell) for lo, hi in slabs]

    # -- geometry of the hierarchy ------------------------------------
    def _best_axis(self, tags: np.ndarray) -> int:
        """Axis along which the tags localize (fewest tagged rows); the
        last axis when nothing is tagged yet."""
        nd = tags.ndim
        best_ax, best_frac = nd - 1, 1.1
        for ax in range(nd):
            proj = _project(tags, ax)
            frac = proj.mean() if proj.size else 1.0
            if frac < best_frac - 1e-9:
                best_ax, best_frac = ax, frac
        return best_ax

    def _pick_axis(self) -> int:
        lvl = probs.init_fluid(self.cfg, self.cfg.grid, self.dtype,
                               self.device)
        return self._best_axis(compute_tags(self.cfg, _np(lvl.density),
                                            self.cfg.grid,
                                            eb=_whole_eb(self.sim0)))

    def _tag_level(self, rho, parent_sim, lev: int = 0) -> np.ndarray:
        """ErrorEst of the level refined NEXT above parent_sim, in the
        parent's whole grid, from its density `rho` and its cut cells (a
        split parent's slabs are gathered whole, in rank order, so that
        every rank tags the same bits); `lev` selects the per-level
        threshold."""
        if parent_sim.mesh is not None:
            rho = parent_sim.mesh.all_gather_x(rho)
        return compute_tags(self.cfg, _np(rho), whole_grid(parent_sim.grid),
                            eb=_whole_eb(parent_sim), lev=lev)

    def _build_patch(self, parent_idx: int, box: Box) -> PatchSim:
        """A PatchSim over the parent-cell box [lo, hi) of
        sims[parent_idx]: split over the parent's mesh where the box
        spans the split parent's whole x range, else whole."""
        parent = self.sims[parent_idx]
        pg = whole_grid(parent.grid)
        nd = pg.ndim
        lo_t, hi_t = box
        n_f = []
        prob_lo = list(pg.prob_lo)
        prob_hi = list(pg.prob_hi)
        periodic = list(pg.periodic)
        # a patch face is PHYSICAL when it coincides with the domain face
        # through every coarser level; anything else -- the wrap point of
        # a partially covered periodic axis too -- is a CF interior face
        parent_dom = tuple((not pg.periodic[a], not pg.periodic[a])
                           for a in range(nd)) \
            if parent is self.sim0 else parent.face_domain
        interior = []
        face_dom = []
        for ax in range(nd):
            lo, hi = lo_t[ax], hi_t[ax]
            n_f.append(2 * (hi - lo))
            dx = pg.dx[ax]
            prob_lo[ax] = pg.prob_lo[ax] + lo * dx
            prob_hi[ax] = pg.prob_lo[ax] + hi * dx
            fd = (lo == 0 and parent_dom[ax][0],
                  hi == pg.n_cell[ax] and parent_dom[ax][1])
            face_dom.append(fd)
            if not (pg.periodic[ax] and lo == 0 and hi == pg.n_cell[ax]):
                periodic[ax] = False
                if not fd[0]:
                    interior.append((ax, 0))
                if not fd[1]:
                    interior.append((ax, 1))
        gf = Grid(tuple(n_f), tuple(prob_lo), tuple(prob_hi),
                  tuple(periodic), domain_lo=pg.origin,
                  domain_hi=pg.domain_hi if pg.domain_hi is not None
                  else pg.prob_hi)
        split = parent.mesh is not None and lo_t[0] == 0 \
            and hi_t[0] == pg.n_cell[0]
        return PatchSim(dataclasses.replace(self.cfg, grid=gf), interior,
                        lo_t, parent, face_dom,
                        mesh=parent.mesh if split else None)

    def _indices_at_level(self, lev: int) -> List[int]:
        return [i for i, l in enumerate(self.level_of) if l == lev]

    def _add(self, p: int, box: Box, lev: int) -> PatchSim:
        ps = self._build_patch(p, box)
        self.sims.append(ps)
        self.bounds.append(box)
        self.parent.append(p)
        self.level_of.append(lev)
        self.masks.append(None)
        return ps

    # -- lifecycle ----------------------------------------------------
    def init_state(self) -> PatchState:
        """The tree from the initial tags and each entry's t = 0 state."""
        states = [self.sim0.init_state()]
        for lev in range(1, self.max_level + 1):
            for p in self._indices_at_level(lev - 1):
                parent_state = states[p]
                tags = self._tag_level(parent_state.level.density,
                                       self.sims[p], lev=lev - 1)
                for box in self._cluster(tags, self.sims[p]):
                    ps = self._add(p, box, lev)
                    ps.set_context(parent_state.level)
                    states.append(ps.init_state_from(parent_state))
                self.masks[p] = self._mask_of_children(p)
        return PatchState(states)

    def load_tree(self, meta, load) -> PatchState:
        """Rebuild the tree that `meta` records (a patch checkpoint's
        Patch.json: axis, bounds, parents, levels, nlevels) and each
        entry's state from load(i, sim) -> SimState of entry i on its
        Simulation sim (on a mesh the rows sim.mesh gives it: a split
        level's slab, a replicated one whole).  A pre-tree record (no
        "parents") is a chain of one patch a level; legacy slab bounds
        [lo, hi] are boxes along the axis."""
        n = int(meta["nlevels"])
        parents = meta.get("parents", [-1] + list(range(0, n - 1)))
        levels = meta.get("levels", list(range(n)))
        self.axis = int(meta["axis"])

        def as_box(b, parent_n_cell):
            if isinstance(b[0], (list, tuple)):
                return tuple(b[0]), tuple(b[1])
            return _slab_box(int(b[0]), int(b[1]), self.axis, parent_n_cell)

        self._reset_tree()
        self.bounds = [as_box(meta["bounds"][0], self.base_grid.n_cell)]
        states = [load(0, self.sim0)]
        for i in range(1, n):
            p = int(parents[i])
            ps = self._add(p, as_box(meta["bounds"][i],
                                     whole_grid(self.sims[p].grid).n_cell),
                           int(levels[i]))
            ps.set_context(states[p].level)
            states.append(load(i, ps))
        for p in range(len(self.sims)):
            self.masks[p] = self._mask_of_children(p)
        return PatchState(states)

    def tree_meta(self):
        """The tree as load_tree and a patch checkpoint record it."""
        return {"axis": self.axis,
                "bounds": [[list(b[0]), list(b[1])] for b in self.bounds],
                "parents": list(self.parent), "levels": list(self.level_of),
                "nlevels": len(self.sims)}

    def _mask_of_children(self, p: int) -> Optional[np.ndarray]:
        """The whole level's mask of the cells entry p's children cover
        (the tree's record, the same on every rank; plotfiles write
        it)."""
        kids = [i for i in range(1, len(self.sims)) if self.parent[i] == p]
        if not kids:
            return None
        m = np.zeros(whole_grid(self.sims[p].grid).cell_shape, bool)
        for i in kids:
            lo_t, hi_t = self.bounds[i]
            m[tuple(slice(lo, hi) for lo, hi in zip(lo_t, hi_t))] = True
        return m

    # -- advance ------------------------------------------------------
    def advance(self, state: PatchState) -> PatchState:
        """One dt for the whole tree, then a regrid on its cadence."""
        out = PatchState(self._advance_impl(list(state.levels)))
        # the context each patch keeps is that of its parent's new state
        # (plotfiles, regrid and checkpoint ghost fills read it)
        for i in range(1, len(self.sims)):
            self.sims[i].set_context(out.levels[self.parent[i]].level)
        if self.cfg.regrid_int > 0 \
                and int(out.step) % self.cfg.regrid_int == 0:
            out = self.regrid(out)
        return out

    def _advance_impl(self, states: List[SimState]) -> List[SimState]:
        # one dt for the whole hierarchy (no subcycling)
        with tracing.span("dt"):
            dt = self.sim0.peek_dt(states[0])
            for i in range(1, len(self.sims)):
                self.sims[i].set_context(states[self.parent[i]].level)
                dt = torch.minimum(dt, self.sims[i].peek_dt(states[i]))
        out = [self.sim0._advance_impl(states[0], dt_force=dt)]
        for i in range(1, len(self.sims)):
            # the new parent state closes the implicit solves; the OLD
            # parent state feeds the old-time convective ghost fills
            p = self.parent[i]
            self.sims[i].set_context(out[p].level,
                                     parent_lvl_old=states[p].level)
            out.append(self.sims[i]._advance_impl(states[i], dt_force=dt))
        # two-way coupling: average the fine solutions down into each
        # parent's covered ranges (the reference's average_down)
        self._sync_all(out)
        if self.composite_sync:
            # composite pressure sync: re-project each parent (absorbing
            # the fine data) and re-solve each patch's CORRECTION field
            # with CF Dirichlet data = the parent's prolonged DELTA-p, one
            # multiplicative-Schwarz pass toward the reference's composite
            # NodalProjector (incflo_apply_nodal_projection.cpp:140-154)
            p_before = out[0].level.p
            out[0] = self.sim0.reproject(out[0], dt)
            dp = {0: out[0].level.p - p_before}
            for i in range(1, len(self.sims)):
                p = self.parent[i]
                self.sims[i].set_context(out[p].level)
                self.sims[i]._nodal_dvals_override = \
                    self.sims[i]._nodal_dvals_from(dp[p])
                pb = out[i].level.p
                out[i] = self.sims[i].reproject(out[i], dt)
                self.sims[i]._nodal_dvals_override = None
                dp[i] = out[i].level.p - pb
            self._sync_all(out)
        return out

    def _sync_all(self, out):
        for i in range(len(self.sims) - 1, 0, -1):
            p = self.parent[i]
            out[p] = self._sync_down(out[p], out[i], self.bounds[i],
                                     _rows(self.sims[i]),
                                     _rows(self.sims[p]))

    def _sync_down(self, cs: SimState, fs: SimState, bounds: Box,
                   rows, parent_rows) -> SimState:
        """average_down of the fine state fs into the parent state cs
        over the box.  rows, parent_rows: (first, count) of the x cell
        rows each holds of its level (_rows: a slab or all of them):
        each rank writes the parent rows it holds, with no exchange."""
        nd = self.base_grid.ndim
        # the parent rows under the fine rows, and those the parent holds
        start = bounds[0][0] + rows[0] // 2
        a = max(start, parent_rows[0])
        b = min(start + rows[1] // 2, parent_rows[0] + parent_rows[1])
        if b <= a:
            return cs
        sl = (slice(a - parent_rows[0], b - parent_rows[0]),) + tuple(
            slice(lo, hi) for lo, hi in zip(bounds[0][1:], bounds[1][1:]))
        src = slice(a - start, b - start)

        def put(cfield, ffield):
            out = cfield.clone()
            out[sl] = _avg_down_window(ffield, nd)[src].to(cfield.dtype)
            return out

        lvl, f = cs.level, fs.level
        return cs._replace(level=lvl._replace(
            velocity=put(lvl.velocity, f.velocity),
            density=put(lvl.density, f.density),
            tracer=put(lvl.tracer, f.tracer),
            gp=put(lvl.gp, f.gp)))

    # -- regrid -------------------------------------------------------
    def regrid(self, state: PatchState) -> PatchState:
        """Recompute the patch tree from the current tags.  The slab axis
        is RE-PICKED from the level-0 tags (slab mode); surviving patches
        (same parent entry, parent frame unchanged) keep their fine data
        over the overlap, everything else re-initializes from parent
        interpolation (the reference's RemakeLevel /
        MakeNewLevelFromCoarse, incflo_regrid.cpp:8-119)."""
        states = list(state.levels)
        tags0 = self._tag_level(states[0].level.density, self.sim0)
        new_axis = self._best_axis(tags0)
        axis_changed = (not self.box_mode) and new_axis != self.axis
        self.axis = new_axis
        old_sims, old_bounds, old_parent = self.sims, self.bounds, self.parent
        self._reset_tree()
        new_states = [states[0]]
        # old entry index kept per NEW parent entry for overlap reuse
        kept_src = {0: (0, True)}      # new idx -> (old idx, frame_same)
        for lev in range(1, self.max_level + 1):
            for p in self._indices_at_level(lev - 1):
                parent_state = new_states[p]
                tags = self._tag_level(parent_state.level.density,
                                       self.sims[p], lev=lev - 1)
                boxes = self._cluster(tags, self.sims[p])
                src_p, frame_same = kept_src.get(p, (None, False))
                old_kids = [] if src_p is None else \
                    [j for j in range(1, len(old_sims))
                     if old_parent[j] == src_p]
                # hysteresis: when every new box still lies in a distinct
                # old kid, keep the OLD layout (the old kids were
                # disjoint, so the tiling stays disjoint)
                if frame_same and not axis_changed and old_kids \
                        and boxes and len(boxes) <= len(old_kids):
                    taken: List[int] = []
                    for box in boxes:
                        j = next((j for j in old_kids if j not in taken
                                  and _contains(old_bounds[j], box)), None)
                        if j is None:
                            break
                        taken.append(j)
                    if len(taken) == len(boxes):
                        boxes = [old_bounds[j] for j in taken]
                for box in boxes:
                    i = len(self.sims)
                    ps = self._add(p, box, lev)
                    ps.set_context(parent_state.level)
                    match = None
                    if frame_same and not axis_changed:
                        best_ov = 0
                        for j in old_kids:
                            ov = _overlap_volume(box, old_bounds[j])
                            if ov > best_ov:
                                best_ov, match = ov, j
                    if match is not None and box == old_bounds[match]:
                        # identical placement: keep the old state whole
                        new_states.append(states[match])
                        kept_src[i] = (match, True)
                        continue
                    init = ps.init_from_parent(parent_state)
                    if match is not None:
                        old, old_sim = states[match], old_sims[match]
                        if old_sim.mesh is not None and ps.mesh is None:
                            # a split patch's data for a replicated one
                            old = old._replace(level=old.level._replace(
                                **{f: old_sim.mesh.all_gather_x(
                                    getattr(old.level, f)) for f in
                                    ("velocity", "density", "tracer",
                                     "gp")}))
                            old_sim = None
                        init = _copy_overlap(
                            init, old, box, old_bounds[match],
                            _rows(ps) if ps.mesh is not None else None,
                            _rows(old_sim) if old_sim is not None
                            and old_sim.mesh is not None else None)
                    new_states.append(init)
                    kept_src[i] = (match, False)
                self.masks[p] = self._mask_of_children(p)
        return PatchState(new_states)
