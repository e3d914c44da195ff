"""Full inputs-file options surface (reference src/setup/init.cpp:7-223,
src/boundary_conditions/boundary_conditions.cpp:9-131,
src/rheology/incflo_read_rheology_parameters.cpp:5-90,
src/setup/set_background_pressure.cpp:5-59).

`IncfloConfig.from_parmparse` reproduces the reference's defaults and
validation aborts so its benchmark decks run unmodified.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from incflo_torch import bcs
from incflo_torch.grid import Grid
from incflo_torch.parmparse import ParmParse


class DiffusionType(enum.IntEnum):
    Explicit = 0
    Crank_Nicolson = 1
    Implicit = 2


class FluidModel(enum.IntEnum):
    Newtonian = 0
    powerlaw = 1
    Bingham = 2
    HerschelBulkley = 3
    deSouzaMendesDutra = 4


_FLUID_NAMES = {
    "newtonian": FluidModel.Newtonian,
    "powerlaw": FluidModel.powerlaw,
    "bingham": FluidModel.Bingham,
    "hb": FluidModel.HerschelBulkley,
    "smd": FluidModel.deSouzaMendesDutra,
}

_FACE_NAMES_3D = ["xlo", "xhi", "ylo", "yhi", "zlo", "zhi"]


@dataclasses.dataclass
class IncfloConfig:
    # geometry / grid
    grid: Grid = None
    max_level: int = 0
    ref_ratio: int = 2
    regrid_int: int = -1
    patch_mode: str = ""
    max_patches: int = 4   # boxes per parent patch (box-cluster cap)
    composite_sync: bool = True   # patch AMR: post-step composite
                                  # pressure re-projection exchange

    # time stepping
    stop_time: float = -1.0
    max_step: int = -1
    steady_state: bool = False
    steady_state_tol: float = 1.0e-5
    fixed_dt: float = -1.0
    cfl: float = 0.5
    init_shrink: float = 0.1
    initial_iterations: int = 3
    do_initial_proj: bool = True

    # physics
    delp: Tuple[float, ...] = (0.0, 0.0, 0.0)
    gravity: Tuple[float, ...] = (0.0, 0.0, 0.0)
    ro_0: float = 1.0
    mu: float = 1.0
    ntrac: int = 1
    mu_s: Tuple[float, ...] = (0.0,)
    constant_density: bool = True
    advect_tracer: bool = False
    test_tracer_conservation: bool = False

    # advection scheme
    use_godunov: bool = False
    godunov_ppm: bool = True
    godunov_use_forces_in_trans: bool = False
    godunov_include_diff_in_forcing: bool = True
    use_mac_phi_in_godunov: bool = False

    # diffusion
    diff_type: DiffusionType = DiffusionType.Implicit
    use_tensor_solve: bool = True
    # EB no-slip wall flux order: 2 = deferred-correction Taylor stencil
    # (matches MLEBTensorOp accuracy), 1 = diagonal drag only
    eb_wall_order: int = 2
    use_tensor_correction: bool = False

    # rheology
    fluid_model: FluidModel = FluidModel.Newtonian
    n_0: float = 0.0
    tau_0: float = 0.0
    papa_reg: float = 0.0
    eta_0: float = 0.0

    # initial conditions
    probtype: int = 0
    ic_u: float = 0.0
    ic_v: float = 0.0
    ic_w: float = 0.0
    ic_p: float = 0.0

    # MG tolerances (reference incflo.H:332-372)
    mac_mg_rtol: float = 1.0e-11
    mac_mg_atol: float = 1.0e-14
    mac_mg_maxiter: int = 200
    nodal_mg_rtol: float = 1.0e-11
    nodal_mg_atol: float = 1.0e-14
    nodal_mg_maxiter: int = 100
    diff_mg_rtol: float = 1.0e-11
    diff_mg_atol: float = 1.0e-14
    diff_mg_maxiter: int = 100
    tensor_mg_rtol: float = 1.0e-11
    tensor_mg_atol: float = 1.0e-14
    tensor_mg_maxiter: int = 100

    # I/O
    plot_file: str = "plt"
    plot_int: int = -1
    plot_per_exact: float = -1.0
    plot_per_approx: float = -1.0
    check_file: str = "chk"
    check_int: int = -1
    restart_file: str = ""
    plotfile_on_restart: bool = False
    KE_int: int = -1
    verbose: int = 0

    # plot field selection (plt_ccse_regtest semantics, init.cpp:174-222)
    plt_fields: Tuple[str, ...] = ()
    plt_error_u: bool = False
    plt_error_v: bool = False
    plt_error_w: bool = False
    plt_error_p: bool = False
    plt_error_mac_p: bool = False

    # AMR tagging (incflo_tagging.cpp:20-44)
    rhoerr: Tuple[float, ...] = ()
    gradrhoerr: Tuple[float, ...] = ()
    tag_region: bool = False
    tag_region_lo: Tuple[float, ...] = (0.0, 0.0, 0.0)
    tag_region_hi: Tuple[float, ...] = (0.0, 0.0, 0.0)

    # boundary conditions
    bc_kind: np.ndarray = None        # (ndim,2) of BCKind
    bc_velocity: np.ndarray = None    # (ndim,2,ndim)
    bc_density: np.ndarray = None     # (ndim,2)
    bc_tracer: np.ndarray = None      # (ndim,2,ntrac)
    bc_pressure: np.ndarray = None    # (ndim,2)

    # EB geometry string ("" == all regular)
    eb_geometry: str = "all_regular"

    # derived
    use_boussinesq: bool = False
    gp0: Tuple[float, ...] = (0.0, 0.0, 0.0)
    p000: float = 0.0

    # numerics
    dtype: str = "float64"

    # full table (job-info provenance dump)
    pp: Optional[ParmParse] = None

    # ------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.grid.ndim

    def need_divtau(self) -> bool:
        """reference incflo.H:590-592"""
        return not ((not self.godunov_include_diff_in_forcing)
                    and self.diff_type == DiffusionType.Implicit)

    def nghost_state(self, has_eb: bool = False) -> int:
        """reference incflo.H:560-565"""
        if has_eb:
            return 5 if self.use_godunov else 4
        return 3 if self.use_godunov else 2

    def nghost_force(self) -> int:
        return 1 if self.use_godunov else 0

    def nghost_mac(self, has_eb: bool = False) -> int:
        if has_eb:
            return 4 if self.use_godunov else 3
        return 1 if self.use_godunov else 0

    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str, argv=()) -> "IncfloConfig":
        return cls.from_parmparse(ParmParse.from_file(path, argv))

    @classmethod
    def from_text(cls, text: str, argv=()) -> "IncfloConfig":
        return cls.from_parmparse(ParmParse.from_text(text, argv))

    @classmethod
    def from_parmparse(cls, pp: ParmParse) -> "IncfloConfig":
        c = cls()
        c.pp = pp

        # geometry.* --------------------------------------------------
        geo = pp.scoped("geometry")
        prob_lo = geo.getarr("prob_lo")
        prob_hi = geo.getarr("prob_hi")
        ndim = len(prob_lo)
        periodic = geo.queryarr("is_periodic", [0] * ndim, ndim)
        amr = pp.scoped("amr")
        n_cell = amr.getarr("n_cell", ndim)
        c.grid = Grid(tuple(int(n) for n in n_cell),
                      tuple(float(v) for v in prob_lo),
                      tuple(float(v) for v in prob_hi),
                      tuple(bool(v) for v in periodic))

        c.max_level = int(amr.query("max_level", 0))
        c.regrid_int = int(amr.query("regrid_int", -1))
        # "slab": patch-based refinement (amr_patch.py); "" = auto
        c.patch_mode = str(amr.query("patch_mode", ""))
        c.max_patches = int(amr.query("max_patches", 4))
        c.composite_sync = bool(amr.query("composite_sync", 1))
        c.KE_int = int(amr.query("KE_int", -1))

        # no-prefix ----------------------------------------------------
        c.stop_time = float(pp.query("stop_time", -1.0))
        c.max_step = int(pp.query("max_step", -1))
        c.steady_state = bool(pp.query("steady_state", 0))

        # incflo.* -----------------------------------------------------
        inc = pp.scoped("incflo")
        c.verbose = int(inc.query("verbose", 0))
        c.steady_state_tol = float(inc.query("steady_state_tol", 1.0e-5))
        c.initial_iterations = int(inc.query("initial_iterations", 3))
        c.do_initial_proj = bool(inc.query("do_initial_proj", 1))
        c.fixed_dt = float(inc.query("fixed_dt", -1.0))
        c.cfl = float(inc.query("cfl", 0.5))
        c.init_shrink = float(inc.query("init_shrink", 0.1))
        if c.init_shrink > 1.0:
            raise ValueError("We require init_shrink <= 1.0")

        c.delp = tuple(inc.queryarr("delp", [0.0] * ndim, ndim))
        c.gravity = tuple(inc.queryarr("gravity", [0.0] * ndim, ndim))
        c.constant_density = bool(inc.query("constant_density", True))
        c.advect_tracer = bool(inc.query("advect_tracer", False))
        c.test_tracer_conservation = bool(
            inc.query("test_tracer_conservation", False))

        c.use_godunov = bool(inc.query("use_godunov", False))
        c.godunov_ppm = bool(inc.query("use_ppm", True))
        c.godunov_use_forces_in_trans = bool(
            inc.query("godunov_use_forces_in_trans", False))
        c.godunov_include_diff_in_forcing = bool(
            inc.query("godunov_include_diff_in_forcing", True))
        c.use_mac_phi_in_godunov = bool(inc.query("use_mac_phi_in_godunov", False))
        if not c.use_godunov:
            c.godunov_include_diff_in_forcing = False

        dt_i = int(inc.query("diffusion_type", 2))
        if dt_i not in (0, 1, 2):
            raise ValueError("diffusion_type must be 0 (explicit), 1 (CN), 2 (implicit)")
        c.diff_type = DiffusionType(dt_i)

        c.use_tensor_solve = bool(inc.query("use_tensor_solve", True))
        c.eb_wall_order = int(inc.query("eb_wall_order", 2))
        c.use_tensor_correction = bool(inc.query("use_tensor_correction", False))
        if c.use_tensor_solve and c.use_tensor_correction:
            raise ValueError("cannot have both use_tensor_solve and use_tensor_correction")
        if c.diff_type != DiffusionType.Implicit and c.use_tensor_correction:
            raise ValueError("use_tensor_correction requires implicit diffusion")
        if (not c.use_godunov) and c.cfl > 0.5:
            raise ValueError("cfl <= 0.5 required for MOL advection")
        if c.use_godunov and c.cfl > 1.0:
            raise ValueError("cfl <= 1.0 required for Godunov advection")

        c.probtype = int(inc.query("probtype", 0))
        c.ic_u = float(inc.query("ic_u", 0.0))
        c.ic_v = float(inc.query("ic_v", 0.0))
        c.ic_w = float(inc.query("ic_w", 0.0))
        c.ic_p = float(inc.query("ic_p", 0.0))
        c.mu = float(inc.query("mu", 1.0))
        c.ro_0 = float(inc.query("ro_0", 1.0))
        if c.ro_0 < 0:
            raise ValueError("ro_0 must be >= 0")
        c.ntrac = int(inc.query("ntrac", 1))
        if c.ntrac <= 0:
            c.advect_tracer = False
        if c.ntrac < 1:
            raise ValueError("We currently require at least one tracer")
        c.mu_s = tuple(inc.queryarr("mu_s", [0.0] * c.ntrac, c.ntrac))

        # rheology (incflo.* prefix) ------------------------------------
        fm = str(inc.query("fluid_model", "newtonian")).lower()
        if fm not in _FLUID_NAMES:
            raise ValueError("Unknown fluid_model! Choose newtonian, powerlaw, bingham, hb, smd")
        c.fluid_model = _FLUID_NAMES[fm]
        if c.fluid_model != FluidModel.Newtonian:
            c.n_0 = float(inc.query("n", 0.0))
            c.tau_0 = float(inc.query("tau_0", 0.0))
            c.papa_reg = float(inc.query("papa_reg", 0.0))
            c.eta_0 = float(inc.query("eta_0", 0.0))
            if c.fluid_model == FluidModel.powerlaw:
                assert c.n_0 > 0.0 and c.n_0 != 1.0
            elif c.fluid_model == FluidModel.Bingham:
                assert c.tau_0 > 0.0 and c.papa_reg > 0.0
            elif c.fluid_model == FluidModel.HerschelBulkley:
                assert c.n_0 > 0.0 and c.n_0 != 1.0 and c.tau_0 > 0.0 and c.papa_reg > 0.0
            elif c.fluid_model == FluidModel.deSouzaMendesDutra:
                assert c.n_0 > 0.0 and c.tau_0 > 0.0 and c.eta_0 > 0.0

        # mac_proj.* / nodal_proj.* -------------------------------------
        mac = pp.scoped("mac_proj")
        c.mac_mg_rtol = float(mac.query("mg_rtol", 1.0e-11))
        c.mac_mg_atol = float(mac.query("mg_atol", 1.0e-14))
        c.mac_mg_maxiter = int(mac.query("mg_maxiter", 200))
        nod = pp.scoped("nodal_proj")
        c.nodal_mg_rtol = float(nod.query("mg_rtol", 1.0e-11))
        c.nodal_mg_atol = float(nod.query("mg_atol", 1.0e-14))
        sdiff = pp.scoped("scalar_diffusion")
        c.diff_mg_rtol = float(sdiff.query("mg_rtol", 1.0e-11))
        c.diff_mg_atol = float(sdiff.query("mg_atol", 1.0e-14))
        c.diff_mg_maxiter = int(sdiff.query("mg_max_iter", 100))
        # the tensor (velocity) solve reads its own scope
        # (reference DiffusionTensorOp::readParameters,
        # src/diffusion/DiffusionTensorOp.cpp:80-98)
        tdiff = pp.scoped("tensor_diffusion")
        c.tensor_mg_rtol = float(tdiff.query("mg_rtol", 1.0e-11))
        c.tensor_mg_atol = float(tdiff.query("mg_atol", 1.0e-14))
        c.tensor_mg_maxiter = int(tdiff.query("mg_max_iter", 100))

        # I/O ------------------------------------------------------------
        c.check_file = str(amr.query("check_file", "chk"))
        c.check_int = int(amr.query("check_int", -1))
        c.restart_file = str(amr.query("restart", ""))
        c.plotfile_on_restart = bool(amr.query("plotfile_on_restart", False))
        c.plot_file = str(amr.query("plot_file", "plt"))
        c.plot_int = int(amr.query("plot_int", -1))
        c.plot_per_exact = float(amr.query("plot_per_exact", -1.0))
        c.plot_per_approx = float(amr.query("plot_per_approx", -1.0))
        npos = sum(1 for v in (c.plot_int > 0, c.plot_per_exact > 0,
                               c.plot_per_approx > 0) if v)
        if npos > 1:
            raise ValueError("Choose only one of plot_int / plot_per_exact / plot_per_approx")

        c.plt_fields = _plot_fields(amr, ndim)
        c.plt_error_u = bool(amr.query("plt_error_u", False))
        c.plt_error_v = bool(amr.query("plt_error_v", False))
        c.plt_error_w = bool(amr.query("plt_error_w", False))
        c.plt_error_p = bool(amr.query("plt_error_p", False))
        c.plt_error_mac_p = bool(amr.query("plt_error_mac_p", False))

        # tagging; single values extend to all levels (reference
        # incflo_tagging.cpp:26-34 resize-with-last)
        nlev = c.max_level + 1

        def _levarr(name):
            if not inc.contains(name):
                return ()
            v = [float(x) for x in inc.queryarr(name, [], None)]
            if v:
                v = v + [v[-1]] * (nlev - len(v))
            return tuple(v[:nlev])

        c.rhoerr = _levarr("rhoerr")
        c.gradrhoerr = _levarr("gradrhoerr")
        c.tag_region = bool(inc.query("tag_region", False))
        c.tag_region_lo = tuple(inc.queryarr("tag_region_lo", [0.0] * ndim, ndim))
        c.tag_region_hi = tuple(inc.queryarr("tag_region_hi", [0.0] * ndim, ndim))

        # EB geometry
        c.eb_geometry = str(inc.query("geometry", "all_regular"))

        # boundary conditions (init_bcs) ------------------------------------
        c._read_bcs(pp)
        c._set_background_pressure()

        c.dtype = str(inc.query("dtype", "float64"))
        return c

    # ------------------------------------------------------------------
    def _read_bcs(self, pp: ParmParse):
        ndim = self.ndim
        self.bc_kind = np.full((ndim, 2), int(bcs.BCKind.undefined), np.int32)
        self.bc_velocity = np.zeros((ndim, 2, ndim))
        self.bc_density = np.ones((ndim, 2))
        self.bc_tracer = np.zeros((ndim, 2, self.ntrac))
        self.bc_pressure = np.zeros((ndim, 2))

        for ax in range(ndim):
            for side in range(2):
                name = _FACE_NAMES_3D[2 * ax + side]
                face = pp.scoped(name)
                kind = bcs.bc_kind_from_string(str(face.query("type", "null")))
                if kind in (bcs.BCKind.pressure_inflow, bcs.BCKind.pressure_outflow):
                    self.bc_pressure[ax, side] = float(face.get("pressure"))
                elif kind == bcs.BCKind.mass_inflow:
                    v = face.queryarr("velocity", [0.0] * ndim, ndim)
                    self.bc_velocity[ax, side] = v
                    self.bc_density[ax, side] = float(face.query("density", 1.0))
                    self.bc_tracer[ax, side] = face.queryarr(
                        "tracer", [0.0] * self.ntrac, self.ntrac)
                elif kind == bcs.BCKind.no_slip_wall:
                    v = face.queryarr("velocity", [0.0] * ndim, ndim)
                    v[ax] = 0.0  # wall cannot move in its normal direction
                    self.bc_velocity[ax, side] = v
                if self.grid.periodic[ax]:
                    if kind != bcs.BCKind.undefined:
                        raise ValueError("Wrong BC type for periodic boundary")
                    kind = bcs.BCKind.periodic
                self.bc_kind[ax, side] = int(kind)

    def _set_background_pressure(self):
        """reference src/setup/set_background_pressure.cpp:5-59"""
        self.p000 = self.ic_p
        ndim = self.ndim
        gp0 = [0.0] * ndim
        if self.probtype in (11, 111, 112, 113):
            self.use_boussinesq = True
            self.gp0 = tuple(gp0)
            return
        eps = np.finfo(np.float64).eps
        problen = self.grid.prob_length
        delp_dir = -1
        for d in range(ndim):
            if abs(self.delp[d]) > eps:
                if delp_dir != -1:
                    raise ValueError("set_background_pressure: conflicting sources")
                delp_dir = d
                gp0[d] = -self.delp[d] / problen[d]
        for d in range(ndim):
            lo_k, hi_k = bcs.BCKind(int(self.bc_kind[d, 0])), bcs.BCKind(int(self.bc_kind[d, 1]))
            pio = (lo_k == bcs.BCKind.pressure_inflow and hi_k == bcs.BCKind.pressure_outflow) \
                or (hi_k == bcs.BCKind.pressure_inflow and lo_k == bcs.BCKind.pressure_outflow)
            if pio:
                if delp_dir != -1:
                    raise ValueError("set_background_pressure: conflicting sources")
                delp_dir = d
                gp0[d] = (self.bc_pressure[d, 1] - self.bc_pressure[d, 0]) / problen[d]
        for d in range(ndim):
            dpdx = self.gravity[d] * self.ro_0
            if abs(dpdx) > eps:
                if delp_dir != -1:
                    raise ValueError("set_background_pressure: conflicting sources")
                delp_dir = d
                gp0[d] = dpdx
        self.gp0 = tuple(gp0)

    # -- BC tables -------------------------------------------------------
    def velocity_bcrecs(self) -> bcs.BCRecs:
        return bcs.velocity_bcrecs(self.bc_kind, self.ndim)

    def density_bcrecs(self) -> bcs.BCRecs:
        return bcs.scalar_bcrecs(self.bc_kind, 1, self.ndim)

    def tracer_bcrecs(self) -> bcs.BCRecs:
        return bcs.scalar_bcrecs(self.bc_kind, self.ntrac, self.ndim)

    def force_bcrecs(self, ncomp: int) -> bcs.BCRecs:
        return bcs.force_bcrecs(self.bc_kind, ncomp, self.ndim)

    # grid: the level the values fill (a rank's x slab on a mesh), else
    # the deck's
    def velocity_ext_values(self, grid=None) -> bcs.ExtDirValues:
        return bcs.ExtDirValues(grid or self.grid, self.bc_velocity,
                                self.probtype)

    def density_ext_values(self, grid=None) -> bcs.ExtDirValues:
        return bcs.ExtDirValues(grid or self.grid, self.bc_density[..., None],
                                self.probtype)

    def tracer_ext_values(self, grid=None) -> bcs.ExtDirValues:
        return bcs.ExtDirValues(grid or self.grid, self.bc_tracer,
                                self.probtype)


def _plot_fields(amr: ParmParse, ndim: int) -> Tuple[str, ...]:
    """Resolve the plt_* field selection incl. plt_ccse_regtest
    (reference init.cpp:174-222)."""
    defaults = {
        "velx": 1, "vely": 1, "velz": 1, "gpx": 1, "gpy": 1, "gpz": 1,
        "rho": 1, "tracer": 1, "p": 0, "macphi": 0, "eta": 0, "vort": 1,
        "strainrate": 0, "divu": 0, "vfrac": 1, "forcing": 0,
    }
    sel = dict(defaults)
    if int(amr.query("plt_ccse_regtest", 0)) != 0:
        # regtest resets the defaults (notably vort/vfrac -> 0), then the
        # plt_* queries below may still override (init.cpp:174-216)
        sel.update({"vort": 0, "vfrac": 0})
    for k in list(sel):
        sel[k] = int(amr.query(f"plt_{k}", sel[k]))
    if ndim == 2:
        sel["velz"] = 0
        sel["gpz"] = 0
    return tuple(k for k, v in sel.items() if v)
