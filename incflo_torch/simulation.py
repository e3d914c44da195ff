"""The time integrator (port of incflo_tpu/simulation.py): Advance =
ComputeDt -> ApplyPredictor [-> ApplyCorrector (MOL)] -> nodal
projection, run eagerly as PyTorch ops on one device.

Orchestration mirrors reference src/incflo_advance.cpp,
src/incflo_apply_predictor.cpp, src/incflo_apply_corrector.cpp,
src/incflo_compute_dt.cpp, src/incflo_compute_forces.cpp and
src/projection/incflo_apply_nodal_projection.cpp: state tensors carry no
ghosts, old/new pairs are function inputs/outputs.

Decks advect by Godunov or by MOL.  On a 3D fully periodic grid the
Godunov chain runs through the CUDA kernels of csrc/godunov.cu on the
card (their plain PyTorch versions on the CPU); a 2D grid, a grid with
walls or inflow/outflow sides, and the use_forces_in_trans option take
the general plain chain on either device, as does predict with
use_mac_phi_in_godunov (ops/godunov.py).  MOL (ops/mol.py) is plain PyTorch on both.  With constant density the MAC and nodal systems, and a Newtonian
fluid's implicit velocity system, are prebuilt and solved directly
(ops/spectral.py) where the operator allows it; otherwise they are built
from the current density (and viscosity) every step and solved by
multigrid V-cycles (ops/multigrid.py) whose smoothers on 3D levels are
the CUDA kernels of csrc/smoothers.cu, walls and the EB wall term
included, one launch a call; 2D levels are smoothed in plain PyTorch.

Embedded boundaries (eb/, incflo_tpu/simulation.py:40-66, 289-330,
519-700): the cut-cell geometry is computed once on the host; the deck
advects by MOL-EB (a deck asking for Godunov is switched to it, with a
warning), the MAC projection is area-fraction weighted, the velocity
solve carries the EB wall term, and the nodal projection is the exact
octant cut-cell operator -- prebuilt as 27-point stencils for constant
density, on the 2x octant lattice otherwise.

A 2D periodic constant-density Newtonian MOL deck (tgv2d) steps on the
card in one launch of the fused step kernel (ops/step2d_kernels.py,
csrc/step2d.cu) when the deck qualifies (step2d_kernels.supported) and
its fixed-trip tensor CG converges at the first dt; `_advance_impl` is
the plain step.

Sharded: given a mesh (parallel/mesh.py), a one-level deck, 2D or 3D --
Godunov (PPM or PLM, with use_forces_in_trans and use_mac_phi_in_godunov)
or MOL; each side of each axis periodic, a slip or no-slip wall, mass
inflow, pressure inflow or pressure outflow; constant or variable
density, tracers, Newtonian or non-Newtonian fluids, gravity or
Boussinesq buoyancy, explicit, Crank-Nicolson or implicit diffusion;
with or without embedded boundaries -- runs split along x over the
mesh's ranks.  Each rank's Simulation holds
its x slab of every field (self.grid is a parallel.mesh.SlabGrid; where
x ends in boundaries the last rank also holds node nx of p) and advance
/ advance_n do what they do on one device: the ghost fills and operator
pads exchange x halos (the x halo first, then the y and z fills, as on
one device) and take the level's boundary forms at its own x faces on
the end ranks (SlabGrid.x_edge), a fully periodic 3D Godunov deck's
chain runs the halo-slab kernels (godunov_kernels.predict_sharded /
advect_sharded; with use_mac_phi_in_godunov predict takes the plain
chain and advect the kernels, with use_forces_in_trans both take the
plain chain, as on one rank) and any other the plain walled chain or
MOL on the slab's ghost-filled windows, the direct solves reduce-scatter
their x contraction, the iterative ones run multigrid on the slab
(ops/multigrid.py: the slab smoother kernels on 3D levels and the plain
flux-form sweeps on 2D ones, one halo exchange a call, with the level's
x walls on the end ranks, the coarse levels whole on every rank), and
compute_dt, the norms and the CG dots reduce over the ranks.  The
MAC-phi face gradient of use_mac_phi_in_godunov takes its x pads from
the neighbouring ranks.  The fused 2D step stays off under a mesh
(_fused_step), as pallas_guard turns it off in incflo_tpu.  An EB deck
builds the whole level's cut-cell geometry on every rank and keeps its
slab of it (eb/ops.slab_arrays); whether it takes the EB path is the
whole level's answer, so a rank whose slab has no cut cell still takes
part in every exchange.  MOL-EB and the cut-cell operators run on the
slab's windows, the 27-point (9-point in 2D) EB nodal stencils are built
whole on every rank and cut to the slab (EBNodalSolver.shard), the
octant lattice of a variable-density deck is a 2 nxl-row slab of a
NodalSolver on the mesh.  The AMR drivers split their levels over a mesh
too (amr_patch.py, amr.py).  A level whose nx does not split into equal
slabs at least parallel.mesh.HALO cells wide is held whole on every rank
(SlabMesh.splits says which: the Simulation takes no mesh for it and
runs as on one device, with no exchange), as incflo_tpu
replicates an axis that does not divide its mesh.  Under a mesh a solve
whose direct form is the rfftn one (an axis above 256 cells) runs
V-cycles on the slab, as incflo_tpu's spectral.usable makes it
(ops/spectral.py).

Scope of this port: 2D or 3D, with or without embedded boundaries:
Godunov or MOL advection, each axis periodic or ending in a slip or
no-slip wall, mass inflow, pressure inflow or pressure outflow; constant
or variable density, gravity or Boussinesq buoyancy, tracer advection
and diffusion; Newtonian or non-Newtonian fluids (power law, Bingham,
Herschel-Bulkley, de Souza Mendes-Dutra); explicit, Crank-Nicolson or
implicit diffusion.

Phases: with utils/tracing.SPANS on, the step records a span for each of
its phases (tracing.PHASES: dt, forces, predict, mac, advect, diffuse,
nodal; MOL's corrector a second set), and __init__ one for the build of
the constant-density solvers (static_solvers); off, each is one test.
The fused step records none.

AMR: a deck with amr.max_level > 0 builds its base level here, as
incflo_tpu's does; the drivers are amr.py (dense fine level) and
amr_patch.py (patch tree).  A patch (amr_patch.PatchSim) overrides the
coarse-fine hooks _mac_bc_args, _nodal_bc_args and _diff_bc_args
(incflo_tpu/simulation.py:334-345): its MAC, nodal and diffusion solves
then take Dirichlet values at its coarse-fine faces, never a prebuilt or
direct solver, and the nodal solve never the prebuilt hat operator.
peek_dt, reproject and _advance_impl(dt_force=) serve the drivers'
one-dt hierarchy and composite sync.  incflo_tpu's _ctx / _swap_ctx
(:938-953) only pass prebuilt solvers into jit as arguments; the port
has no jit and keeps them as attributes.  A patch split over a mesh
passes it here like any level; one held whole on every rank passes none.
With embedded boundaries a patch builds its own cut-cell geometry on its
grid (incflo_tpu/simulation.py:40-48), and its nodal projection, whose
coarse-fine faces take Dirichlet values, takes the vfrac-weighted weak
form: the exact octant operator has no Dirichlet threading
(incflo_tpu/simulation.py:518-527).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from incflo_torch import bcs, probs
from incflo_torch.bcs import BCKind
from incflo_torch.config import DiffusionType, FluidModel, IncfloConfig
from incflo_torch.ops import diffusion, godunov, mac_projection, mol
from incflo_torch.ops import multigrid as mg
from incflo_torch.ops import rheology
from incflo_torch.ops.stencil import inner
from incflo_torch.state import LevelState, SimState
from incflo_torch.utils import tracing


def has_eb(cfg: IncfloConfig) -> bool:
    """The deck names an EB geometry (it may still prove all regular)."""
    return cfg.eb_geometry not in ("", "all_regular", "null")


# the weight of the old-time tracer Laplacian in the predictor's tracer
# update, by diffusion type (incflo_tpu/simulation.py:403-405)
LAP_WEIGHT = {DiffusionType.Explicit: 1.0,
              DiffusionType.Crank_Nicolson: 0.5,
              DiffusionType.Implicit: 0.0}


class Simulation:
    """Single-level incompressible Navier-Stokes engine on one device, or
    on one rank's x slab of a level split over a mesh.

    device None means "cuda" (on a mesh "cuda:{rank % device_count}");
    pass device="cpu" to run on the CPU with the kernels' plain versions.
    Asking for the card where there is none raises."""

    # constant density: build the prebuilt solvers (a patch, whose solves
    # all take coarse-fine closures, never uses them)
    PREBUILD = True

    def __init__(self, cfg: IncfloConfig, device=None, mesh=None):
        if cfg.grid.ndim not in (2, 3):
            raise ValueError(f"incflo_torch runs 2D and 3D decks, not "
                             f"{cfg.grid.ndim}D")
        if device is None and mesh is not None and torch.cuda.is_available():
            device = f"cuda:{mesh.rank % torch.cuda.device_count()}"
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("incflo_torch.Simulation: CUDA device "
                               "requested but torch.cuda is not available")
        self.device = device
        self.dtype = getattr(torch, cfg.dtype)
        # the rank's x slab on a mesh, else the whole level; a level that
        # does not split over the mesh is held whole, with no mesh
        if mesh is not None and not mesh.splits(cfg.grid):
            mesh = None
        self.grid = cfg.grid if mesh is None else mesh.local_grid(cfg.grid)
        self.mesh = mesh
        # embedded boundaries: the static cut-cell arrays (eb/ops.py),
        # computed on the host and kept on the device; None where there
        # is no cut cell.  On a mesh every rank builds the whole level's
        # (eb_whole) and keeps its slab of them; whether the deck takes
        # the EB path is the whole level's answer, so that a rank whose
        # slab holds no cut cell still takes part in every exchange
        self.eb = eb_whole = None
        if has_eb(cfg):
            from incflo_torch.eb import geometry as ebgeom
            from incflo_torch.eb import ops as ebops
            phi_if = ebgeom.make_eb_geometry(cfg.eb_geometry, cfg.pp,
                                             cfg.grid)
            data = ebgeom.compute_eb_data(phi_if, cfg.grid)
            if data.has_eb:
                eb_whole = ebops.build_eb_arrays(data, cfg.grid, self.dtype,
                                                 device)
                self.eb = eb_whole if mesh is None else ebops.slab_arrays(
                    eb_whole, mesh, cfg.grid)
        if self.eb is not None and cfg.use_godunov:
            # the reference's EB build compiles predict_godunov out
            # (incflo_compute_MAC_projected_velocities.cpp:80-91): a
            # cut-cell domain advects by MOL-EB (incflo_tpu/simulation.py
            # :49-66)
            warnings.warn(
                "incflo.use_godunov=true with embedded boundaries: the "
                "Godunov scheme does not see cut cells (matching the "
                "reference, whose EB build compiles out predict_godunov); "
                "dispatching advection through the MOL-EB path instead.")
            cfg = dataclasses.replace(
                cfg, use_godunov=False,
                godunov_include_diff_in_forcing=False,
                cfl=min(cfg.cfl, 0.5))   # the MOL stability bound
        self.cfg = cfg
        self.vel_bcrec = cfg.velocity_bcrecs()
        self.den_bcrec = cfg.density_bcrecs()
        self.tra_bcrec = cfg.tracer_bcrecs()
        self.vel_ev = cfg.velocity_ext_values(self.grid)
        self.den_ev = cfg.density_ext_values(self.grid)
        self.tra_ev = cfg.tracer_ext_values(self.grid)
        self.force_bcrec = cfg.force_bcrecs(max(cfg.ntrac, cfg.ndim))
        if cfg.use_godunov:
            self.godunov = godunov.GodunovScheme(
                self.grid, cfg.godunov_ppm, cfg.godunov_use_forces_in_trans)
        self._fused = None          # step2d_kernels.FusedStep, built lazily
        self._fused_ok = None       # the CG probe's verdict
        nd = cfg.grid.ndim
        self._gravity = self._vec(cfg.gravity[:nd])
        self._gp0 = self._vec(cfg.gp0[:nd])
        self._dxinv = self._vec([1.0 / d for d in cfg.grid.dx])
        # constant density: the MAC and nodal operators are dt-independent
        # up to a scalar and Newtonian implicit diffusion re-scales beta =
        # dt, so all three are built once, on the CPU, and moved to the
        # device.  Variable density builds them from the state every
        # step, and a non-Newtonian fluid its velocity operator.
        self._mac_solver = self._nodal_hat = self._diff_proto = None
        self._nodal_eb_hat = None
        if self.PREBUILD and cfg.constant_density:
            with tracing.span("static_solvers"):
                if self.eb is None:
                    self._build_static_solvers()
                else:
                    self._build_static_eb_solvers(eb_whole)

    # ------------------------------------------------------------------
    def _full(self, shape, val):
        return torch.full(shape, val, dtype=self.dtype)

    def _build_static_solvers(self):
        """On a mesh: the whole level's solvers, cut to the slab (a direct
        solve's transforms, or multigrid on the slab)."""
        cfg = self.cfg
        grid = cfg.grid
        inv_rho = 1.0 / cfg.ro_0
        beta = []
        for d in range(grid.ndim):
            shape = tuple(n + (1 if ax == d else 0)
                          for ax, n in enumerate(grid.cell_shape))
            beta.append(self._full(shape, inv_rho))
        bc_lo, bc_hi = mac_projection.projection_solver_bc(cfg.bc_kind, grid)
        mac = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=0.0, beta=1.0,
                            acoef=None, bcoef=tuple(beta))
        # sigma-hat = 1/rho0; the in-step operator with sigma =
        # scaling/rho0 is this one scaled by `scaling`
        nodal = mg.NodalSolver(grid.dx, grid.periodic, bc_lo, bc_hi,
                               self._full(grid.cell_shape, inv_rho))
        if self.mesh is not None:
            mac, nodal = mac.shard(self.mesh), nodal.shard(self.mesh)
        self._mac_solver = mac.to(self.device)
        self._nodal_hat = nodal.to(self.device)
        # the constant coefficients, as Python floats, for the fused step
        # kernel: the MAC face coefficient, the velocity operator's acoef
        # and its face coefficient per (axis, component)
        self._static_coefs = {"mac_b": inv_rho, "diff_a": cfg.ro_0}
        if cfg.fluid_model != FluidModel.Newtonian \
                or cfg.diff_type == DiffusionType.Explicit:
            return      # eta from the state every step, or no solve
        bcs_all = [diffusion.velocity_solver_bc(cfg, c)
                   for c in range(grid.ndim)]
        if not all(b == bcs_all[0] for b in bcs_all):
            return      # slip walls: per-component solves, built per step
        eta_b, diff_b = [], []
        for d in range(grid.ndim):
            shape = tuple(n + (1 if ax == d else 0)
                          for ax, n in enumerate(grid.cell_shape))
            scale = [2.0 if cfg.use_tensor_solve and c == d else 1.0
                     for c in range(grid.ndim)]
            diff_b.append([cfg.mu * f for f in scale])
            eta_b.append(self._full(shape, cfg.mu)[..., None]
                         * torch.tensor(scale, dtype=self.dtype))
        acoef = self._full(grid.cell_shape, cfg.ro_0)
        blo, bhi = bcs_all[0]
        diff = mg.CellSolver(grid.dx, blo, bhi, alpha=1.0, beta=1.0,
                             acoef=acoef[..., None], bcoef=tuple(eta_b))
        if self.mesh is not None:
            diff = diff.shard(self.mesh)
        self._diff_proto = diff.to(self.device)
        self._static_coefs["diff_b"] = diff_b

    def _build_static_eb_solvers(self, eb_whole):
        """Constant-density EB decks (incflo_tpu/simulation.py:289-318),
        on the device: the area-fraction-weighted MAC solver and the
        exact octant cut-cell nodal operator as a 27-point coarse-node
        stencil hierarchy (mg.EBNodalSolver), in hat form sigma_hat =
        1/rho0 -- the in-step operator is scaling x this one.  On a mesh
        the MAC solver runs multigrid on the slab's area fractions, and
        the stencil hierarchy, built whole from eb_whole (the whole
        level's arrays), is cut to the slab (EBNodalSolver.shard)."""
        cfg = self.cfg
        grid = self.grid
        eb = self.eb
        inv_rho = 1.0 / cfg.ro_0
        bc_lo, bc_hi = mac_projection.projection_solver_bc(cfg.bc_kind, grid)
        beta_eff = tuple(eb.afrac[d] * inv_rho for d in range(grid.ndim))
        self._mac_solver = mg.CellSolver(grid.dx, bc_lo, bc_hi, alpha=0.0,
                                         beta=1.0, acoef=None,
                                         bcoef=beta_eff, direct=False,
                                         mesh=self.mesh)
        if eb.vfrac_oct is None:
            return
        whole = cfg.grid
        try:
            nodal = mg.EBNodalSolver(
                whole.dx, whole.periodic, bc_lo, bc_hi,
                self._full(whole.cell_shape, inv_rho).to(self.device),
                eb_whole.vfrac_oct)
        except ValueError:
            return      # an odd periodic extent: the octant lattice
        self._nodal_eb_hat = nodal if self.mesh is None \
            else nodal.shard(self.mesh)

    def _eb_fine_meta(self):
        """The sigma-free fine (2x) NodalLevel of the right-hand side and
        gradient transfers (on a mesh the slab's 2 nxl fine cells)."""
        grid = self.grid
        nd = grid.ndim
        return mg.NodalLevel(tuple(d / 2 for d in grid.dx), grid.periodic,
                             (int(mg.SolverBC.NEUMANN),) * nd,
                             (int(mg.SolverBC.NEUMANN),) * nd,
                             None, None, tuple(2 * n for n in grid.n_cell),
                             mesh=self.mesh)

    # ------------------------------------------------------------------
    # ghost fills (physical BCs only, one level)
    # ------------------------------------------------------------------
    def grow_vel(self, vel, ng):
        return bcs.grow(vel, ng, self.grid, self.vel_bcrec, self.vel_ev)

    def grow_rho(self, rho, ng):
        return bcs.grow_scalar(rho, ng, self.grid, self.den_bcrec,
                               self.den_ev)

    def grow_tra(self, tra, ng):
        return bcs.grow(tra, ng, self.grid, self.tra_bcrec, self.tra_ev)

    def grow_vel_hom(self, v, ng):
        """Homogeneous velocity ghost fill (ext_dir ghosts = 0)."""
        return bcs.grow(v, ng, self.grid, self.vel_bcrec)

    def grow_force(self, f, ng=1):
        ncomp = f.shape[-1]
        return bcs.grow(f, ng, self.grid, self.force_bcrec[:ncomp])

    # ------------------------------------------------------------------
    # coarse-fine hooks (amr_patch.PatchSim overrides them; the base
    # simulation spans the whole domain and has no interior faces)
    # ------------------------------------------------------------------
    def _mac_bc_args(self):
        """Extra keywords of project_mac_velocities at coarse-fine faces."""
        return {}

    def _nodal_bc_args(self):
        """(bc_override, dirichlet_vals) of the nodal projection."""
        return None, None

    def _diff_bc_args(self, field):
        """(solver_bc_override, bvals_override) of the diffusion solves of
        `field`, "vel" or "tra"."""
        return None, None

    # ------------------------------------------------------------------
    # forces (reference incflo_compute_forces.cpp)
    # ------------------------------------------------------------------
    def _vec(self, vals):
        return torch.as_tensor(list(vals), dtype=self.dtype,
                               device=self.device)

    def compute_vel_forces(self, rho, tra_o, tra_n, gp,
                           include_pressure_gradient=True):
        """-(gp + gp0)/rho + gravity; with Boussinesq buoyancy (probtypes
        11, 111-113) gravity times the time-centred first tracer,
        0.5 (tra_o + tra_n), minus gp/rho, and no gp0."""
        rhoinv = (1.0 / rho)[..., None]
        if self.cfg.use_boussinesq:
            ft = 0.5 * (tra_o[..., 0] + tra_n[..., 0])
            f = self._gravity * ft[..., None]
            if include_pressure_gradient:
                f = f - gp * rhoinv
            return f
        if include_pressure_gradient:
            return -(gp + self._gp0) * rhoinv + self._gravity
        return -self._gp0 * rhoinv + self._gravity

    def compute_tra_forces(self, rho):
        """External forcing of (rho s): zero (reference
        incflo_compute_forces.cpp:5-32)."""
        return torch.zeros(self.grid.cell_shape + (self.cfg.ntrac,),
                           dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # dt (reference incflo_compute_dt.cpp: Kang et al. CFL formula)
    # ------------------------------------------------------------------
    def compute_dt(self, vel, rho, vel_forces, s: SimState,
                   initialization=False):
        cfg = self.cfg
        dxinv = self._dxinv
        if self.eb is not None:   # covered cells are not in the reduction
            mask = self.eb.fluid[..., None]
            conv_cfl = torch.max(torch.abs(vel) * mask * dxinv)
            forc_cfl = torch.max(torch.abs(vel_forces) * mask * dxinv)
        else:
            conv_cfl = torch.max(torch.abs(vel) * dxinv)
            forc_cfl = torch.max(torch.abs(vel_forces) * dxinv)
        rhoinv_max = torch.max(1.0 / rho)
        maxima = [conv_cfl, forc_cfl, rhoinv_max]
        explicit = cfg.diff_type == DiffusionType.Explicit
        if explicit and cfg.fluid_model != FluidModel.Newtonian:
            # eta can exceed mu by orders of magnitude (Bingham near zero
            # strain rate): the stability bound takes the actual viscosity
            eta = rheology.compute_viscosity(self.grow_vel(vel, 1), self.grid,
                                             1, cfg, out_ng=0, eb=self.eb)
            if self.eb is not None:
                eta = eta * self.eb.fluid
            maxima.append(torch.max(eta / rho))
        if self.mesh is not None:   # the whole level's maxima
            maxima = self.mesh.all_reduce_max(torch.stack(maxima)).unbind()
        conv_cfl, forc_cfl, rhoinv_max = maxima[:3]
        cd_cfl = conv_cfl   # Crank-Nicolson or implicit: no diffusive CFL
        if explicit:
            # Newtonian: mu max(1/rho) (incflo_compute_dt.cpp:135-146)
            mu_over_rho = maxima[3] if len(maxima) > 3 \
                else rhoinv_max * cfg.mu
            cd_cfl = conv_cfl + mu_over_rho * 2.0 * torch.sum(dxinv * dxinv)
        comb_cfl = cd_cfl + torch.sqrt(cd_cfl * cd_cfl + 4.0 * forc_cfl)
        dt_new = 2.0 * cfg.cfl / torch.clamp_min(comb_cfl, 1e-300)
        if initialization:
            dt_new = dt_new * cfg.init_shrink
        eps = torch.finfo(self.dtype).eps
        # from-rest bootstrap (see incflo_tpu compute_dt)
        diff_any = (rhoinv_max * cfg.mu * 2.0
                    * torch.sum(dxinv * dxinv))
        fallback = torch.where(
            diff_any > eps, cfg.cfl / torch.clamp_min(diff_any, 1e-300),
            torch.full_like(diff_any, cfg.stop_time / 100.0
                            if cfg.stop_time > 0 else 1.0))
        dt_new = torch.where(comb_cfl <= eps,
                             torch.where(s.dt > 0, 0.5 * s.dt, fallback),
                             dt_new)
        # 10% growth limiter
        factor = 1.1
        if cfg.plot_per_exact > 0:
            cap_base = torch.where(s.prev_dt < s.prev_prev_dt,
                                   torch.maximum(s.prev_dt, s.prev_prev_dt),
                                   s.dt)
        else:
            cap_base = s.dt
        grow_cap = factor * cap_base
        dt_new = torch.where(s.dt > 0.0, torch.minimum(dt_new, grow_cap),
                             dt_new)
        # don't overshoot plot_per_exact times
        if cfg.plot_per_exact > 0:
            per = cfg.plot_per_exact
            crossing = (torch.trunc((s.t + dt_new + eps) / per)
                        > torch.trunc((s.t + eps) / per))
            dt_clamped = torch.trunc((s.t + dt_new) / per) * per - s.t
            dt_new = torch.where(crossing, dt_clamped, dt_new)
        # don't overshoot stop_time
        if (not cfg.steady_state) and cfg.stop_time > 0.0:
            dt_new = torch.where(s.t + dt_new > cfg.stop_time,
                                 cfg.stop_time - s.t, dt_new)
        dt_new = torch.where(dt_new < eps, 0.5 * s.dt, dt_new)
        if cfg.fixed_dt > 0.0:
            return torch.tensor(cfg.fixed_dt, dtype=self.dtype,
                                device=self.device)
        return dt_new.to(self.dtype)

    # ------------------------------------------------------------------
    # convective term (reference compute_convective_term, Godunov path)
    # ------------------------------------------------------------------
    def _vel_forces_g(self, rho, tra, gp, divtau_o, include_gp=True):
        """The Godunov forcing grown by 1: forces (+ divtau_o with
        godunov_include_diff_in_forcing)."""
        vf = self.compute_vel_forces(rho, tra, tra, gp,
                                     include_pressure_gradient=include_gp)
        if self.cfg.godunov_include_diff_in_forcing and divtau_o is not None:
            vf = vf + divtau_o
        return self.grow_force(vf)

    def convective_term_godunov(self, vel, rho, tra, mac_phi0, gp,
                                divtau_o, laps_o, dt):
        """Predict half-time MAC velocities, project them, then advect
        velocity, density and rho*tracer
        (incflo_compute_advection_term.cpp:37-114).  Returns (conv_u,
        conv_r, conv_t, mac_phi).  With use_mac_phi_in_godunov the
        prediction takes the forces without gp and the last MAC phi's
        face gradient instead, the MAC solve starts from mac_phi0 dt/2,
        and mac_phi is kept as 2 phi / dt (incflo_tpu/simulation.py
        :372-407); otherwise prediction and advection take the same
        forces."""
        cfg = self.cfg
        grid = self.grid
        ng = cfg.nghost_state()
        mac_phi_in = cfg.use_mac_phi_in_godunov
        with tracing.span("predict"):
            vel_g = self.grow_vel(vel, ng)
            rho_g = self.grow_rho(rho, ng)
            vf_g = self._vel_forces_g(rho, tra, gp, divtau_o,
                                      include_gp=not mac_phi_in)

            rho_g1 = inner(rho_g, ng - 1, grid.ndim)
            beta = mac_projection.inv_rho_on_faces(rho_g1, grid)

            gmacphi, phi0 = None, mac_phi0
            if mac_phi_in:
                # mac_phi is stored pressure-like (2 phi / dt); the fluxes
                # of the MAC operator are (1/rho) grad(mac_phi) on the
                # faces (on a slab the x pads from the neighbouring ranks)
                bc_lo, bc_hi = mac_projection.projection_solver_bc(
                    cfg.bc_kind, grid)
                lev0 = mg.CellLevel(grid.dx, tuple(bc_lo), tuple(bc_hi), 0.0,
                                    1.0, None, tuple(beta), mesh=self.mesh)
                gmacphi = [-f for f in mg.cell_fluxes(mac_phi0, lev0)]
                phi0 = mac_phi0 * (0.5 * dt)
            umac = self.godunov.predict(vel_g, vf_g, dt, ng, self.vel_bcrec,
                                        gmacphi=gmacphi)
        with tracing.span("mac"):
            cf = self._mac_bc_args()
            umac, mac_phi = mac_projection.project_mac_velocities(
                umac, beta, grid, cfg.bc_kind, phi0=phi0,
                rtol=cfg.mac_mg_rtol, atol=cfg.mac_mg_atol,
                maxiter=cfg.mac_mg_maxiter,
                prebuilt_solver=None if cf else self._mac_solver,
                direct=False, **cf)
        with tracing.span("advect"):
            if mac_phi_in:
                mac_phi = mac_phi * (2.0 / dt)
                vf_g = self._vel_forces_g(rho, tra, gp, divtau_o)
            conv_u = self.godunov.advect(vel_g, umac, vf_g, dt, ng,
                                         self.vel_bcrec, [0] * grid.ndim,
                                         True)
            if cfg.constant_density:
                conv_r = torch.zeros_like(rho)
            else:
                conv_r = self.godunov.advect(rho_g[..., None], umac, None,
                                             dt, ng, self.den_bcrec, [1],
                                             False)[..., 0]
            if cfg.advect_tracer:
                tf = self.compute_tra_forces(rho)
                if cfg.godunov_include_diff_in_forcing and laps_o is not None:
                    tf = tf + laps_o
                tf_g = self.grow_force(tf)
                rhotrac = rho_g[..., None] * self.grow_tra(tra, ng)
                conv_t = self.godunov.advect(rhotrac, umac, tf_g, dt, ng,
                                             self.tra_bcrec,
                                             [1] * cfg.ntrac, False)
            else:
                conv_t = torch.zeros_like(tra)
        return conv_u, conv_r, conv_t, mac_phi

    def convective_term_mol(self, vel, rho, tra, mac_phi0):
        """MOL path (incflo_compute_advection_term.cpp, MOL branch):
        upwind face velocities, MAC projection, then the upwind flux
        divergence of velocity, density and rho*tracer; with embedded
        boundaries the centroid-aware face states (eb/mol.py), the
        cut-cell rate and its redistribution (eb/ops.py).  Returns
        (conv_u, conv_r, conv_t, mac_phi, umac)."""
        cfg = self.cfg
        grid = self.grid
        eb = self.eb
        ng = cfg.nghost_state()
        if eb is not None:
            from incflo_torch.eb import mol as ebmol
            from incflo_torch.eb import ops as ebops
        with tracing.span("predict"):
            vel_g = self.grow_vel(vel, ng)
            rho_g = self.grow_rho(rho, ng)
            if eb is not None:
                umac = ebmol.predict_vels_on_faces_eb(vel_g, grid, ng,
                                                      self.vel_bcrec, eb)
            else:
                umac = mol.predict_vels_on_faces(vel_g, grid, ng,
                                                 self.vel_bcrec)
            beta = mac_projection.inv_rho_on_faces(
                inner(rho_g, ng - 1, grid.ndim), grid)
        with tracing.span("mac"):
            cf = self._mac_bc_args()
            umac, mac_phi = mac_projection.project_mac_velocities(
                umac, beta, grid, cfg.bc_kind, phi0=mac_phi0,
                rtol=cfg.mac_mg_rtol, atol=cfg.mac_mg_atol,
                maxiter=cfg.mac_mg_maxiter,
                prebuilt_solver=None if cf else self._mac_solver,
                direct=False, eb=eb, **cf)

        def rate(q_g, bcrec):
            if eb is None:
                return mol.convective_rate(mol.compute_convective_fluxes(
                    q_g, umac, grid, ng, bcrec), grid)
            fluxes = ebmol.compute_convective_fluxes_eb(q_g, umac, grid, ng,
                                                        bcrec, eb)
            return ebops.redistribute(
                ebops.eb_convective_rate(fluxes, grid, eb), grid, eb)

        with tracing.span("advect"):
            conv_u = rate(vel_g, self.vel_bcrec)
            if cfg.constant_density:
                conv_r = torch.zeros_like(rho)
            else:
                conv_r = rate(rho_g[..., None], self.den_bcrec)[..., 0]
            if cfg.advect_tracer:
                conv_t = rate(rho_g[..., None] * self.grow_tra(tra, ng),
                              self.tra_bcrec)
            else:
                conv_t = torch.zeros_like(tra)
        return conv_u, conv_r, conv_t, mac_phi, umac

    # ------------------------------------------------------------------
    # nodal projection (reference incflo_apply_nodal_projection.cpp)
    # ------------------------------------------------------------------
    def apply_projection(self, vel, vel_o, rho_proj, gp, p, scaling,
                         incremental: bool, small_dt_flag):
        """Returns (velocity, p, gp) after the projection.  With embedded
        boundaries one of incflo_tpu's three cut-cell forms
        (simulation.py:519-605): the prebuilt EBNodalSolver of a
        constant-density deck, else the regular NodalSolver on the 2x
        octant lattice, else (no octant data, or Dirichlet values at
        coarse-fine faces, which the exact operator does not thread) the
        vfrac-weighted operator; covered cells end at zero velocity.  A
        coarse-fine override (a patch) makes its faces Dirichlet with the
        values of _nodal_bc_args, solved by V-cycles on an operator built
        here."""
        grid = self.grid
        eb = self.eb
        override, dvals = self._nodal_bc_args()
        if not incremental:
            vel = vel + gp * (scaling / rho_proj)[..., None]
        if incremental:
            vel_in = vel - vel_o
            inflow_scale = torch.zeros((), dtype=self.dtype,
                                       device=self.device)
        else:
            vel_in = vel - small_dt_flag * vel_o
            inflow_scale = 1.0 - small_dt_flag
        sigma = scaling / rho_proj
        phi0 = None if incremental else p
        if eb is not None and eb.vfrac_oct is not None and dvals is None:
            phi, gphi = self._eb_exact_projection(vel_in, inflow_scale,
                                                  sigma, scaling, phi0)
            return self._projected(vel, sigma, gphi, phi, p, gp, incremental)
        if eb is not None:      # the vfrac-weighted weak form
            vel_in = vel_in * eb.vfrac[..., None]
        upads = self._pad_vel_for_divergence(vel_in, inflow_scale)
        if self._nodal_hat is not None and override is None:
            # constant density: sigma = scaling * sigma_hat, so the
            # prebuilt operator solves the scaled system
            # L_hat phi = rhs / scaling, directly
            solver = self._nodal_hat
            rhs = mg._nodes_unique(mg.nodal_divergence(upads, grid.dx),
                                   solver.levels[0]) / scaling
            # a direct solve ignores the start and the tolerances; with
            # walls the prebuilt operator iterates V-cycles to them
            phi = solver.solve(rhs, x0=None if incremental else p,
                               rtol=self.cfg.nodal_mg_rtol,
                               atol=self.cfg.nodal_mg_atol / scaling,
                               maxiter=self.cfg.nodal_mg_maxiter)
        else:
            bc_lo, bc_hi = mac_projection.projection_solver_bc(
                self.cfg.bc_kind, grid)
            for (ax, side), bc in (override or {}).items():
                (bc_lo if side == 0 else bc_hi)[ax] = bc
            solver = mg.NodalSolver(grid.dx, grid.periodic, bc_lo, bc_hi,
                                    sigma if eb is None else sigma * eb.vfrac,
                                    direct=False, mesh=self.mesh)
            rhs = mg._nodes_unique(mg.nodal_divergence(upads, grid.dx),
                                   solver.levels[0])
            # warm start: p is last step's phi (pressure varies slowly)
            phi = solver.solve(rhs, x0=None if incremental else p,
                               rtol=self.cfg.nodal_mg_rtol,
                               atol=self.cfg.nodal_mg_atol,
                               maxiter=self.cfg.nodal_mg_maxiter,
                               dirichlet_vals=dvals)
        gphi = solver.grad_at_cells(phi)
        return self._projected(vel, sigma, gphi, phi, p, gp, incremental)

    def _projected(self, vel, sigma, gphi, phi, p, gp, incremental):
        """(velocity, p, gp) of a projection's phi and its cell gradient."""
        vel_new = vel - sigma[..., None] * gphi
        if self.eb is not None:
            vel_new = vel_new * self.eb.fluid[..., None]
        if incremental:
            return vel_new, p + phi, gp + gphi
        return vel_new, phi, gphi

    def _eb_exact_projection(self, vel_in, inflow_scale, sigma, scaling,
                             phi0):
        """(phi, cell gradient) of the exact octant cut-cell projection:
        the prebuilt coarse-node stencils (constant density, hat form:
        the operator is scaling x the prebuilt one), else the regular
        NodalSolver on the 2x octant lattice with sigma x octant
        fraction, phi taken at the coincident nodes."""
        cfg = self.cfg
        grid = self.grid
        nd = grid.ndim
        upads_f = self._octant_refine_pads(
            self._pad_vel_for_divergence(vel_in, inflow_scale))
        if self._nodal_eb_hat is not None:
            fmeta = self._eb_fine_meta()
            rhs = mg.eb_nodal_divergence(upads_f, fmeta) / scaling
            phi = self._nodal_eb_hat.solve(
                rhs, x0=phi0, rtol=cfg.nodal_mg_rtol,
                atol=cfg.nodal_mg_atol / scaling,
                maxiter=cfg.nodal_mg_maxiter)
            return phi, self._eb_grad_at_cells(mg._prolong_nodal(phi, fmeta),
                                               fmeta)
        sigma_f = sigma
        for ax in range(nd):
            sigma_f = torch.repeat_interleave(sigma_f, 2, dim=ax)
        bc_lo, bc_hi = mac_projection.projection_solver_bc(cfg.bc_kind, grid)
        solver_f = mg.NodalSolver(tuple(d / 2 for d in grid.dx),
                                  grid.periodic, bc_lo, bc_hi,
                                  sigma_f * self.eb.vfrac_oct, direct=False,
                                  mesh=self.mesh)
        flev = solver_f.levels[0]
        rhs_f = mg._nodes_unique(mg.nodal_divergence(upads_f, flev.dx), flev)
        x0 = None if phi0 is None else mg._prolong_nodal(phi0, flev)
        phi_f = solver_f.solve(rhs_f, x0=x0, rtol=cfg.nodal_mg_rtol,
                               atol=cfg.nodal_mg_atol,
                               maxiter=cfg.nodal_mg_maxiter)
        phi = phi_f[tuple(slice(0, None, 2) for _ in range(nd))]
        return phi, self._eb_grad_at_cells(phi_f, flev)

    def _octant_refine_pads(self, upads):
        """The fine-lattice (2x) padded velocity components, weighted by
        the octant fluid fractions: each coarse cell's value copied to
        its octants and scaled by their fluid fraction; a ghost cell
        copies the coarse ghost (incflo_tpu/simulation.py:646-670).  On
        a mesh the octant fractions' x ghosts are the whole level's rows
        (eb.vfrac_oct_x1)."""
        grid = self.grid
        nd = grid.ndim
        op = self.eb.vfrac_oct_x1
        if op is None:
            op = self.eb.vfrac_oct
            op = mg._wrap_pad(op, 0) if grid.periodic[0] \
                else mg._edge_pad(op, 0)
        for ax in range(1, nd):
            op = mg._wrap_pad(op, ax) if grid.periodic[ax] \
                else mg._edge_pad(op, ax)
        out = []
        for u in upads:
            uf = u
            for ax in range(nd):
                uf = torch.repeat_interleave(uf, 2, dim=ax)   # 2n+4 cells
                uf = uf.narrow(ax, 1, uf.shape[ax] - 2)
            out.append(uf * op)
        return out

    def _eb_grad_at_cells(self, phi_f, fine_lev):
        """The cell gradient consistent with the octant-lattice
        projection: the octant-fraction-weighted average of the fine
        cells' gradients of the fine nodal phi."""
        grid = self.grid
        nd = grid.ndim
        oct_frac = self.eb.vfrac_oct

        def agg(a):
            for ax in range(nd):
                n = a.shape[ax]
                a = (mg._slice_axis(a, ax, slice(0, n, 2))
                     + mg._slice_axis(a, ax, slice(1, n, 2)))
            return a

        wsum = agg(oct_frac)
        wsafe = torch.clamp_min(wsum, 1e-12)
        comps = []
        for ax in range(nd):
            gf = mg._node_to_cellgrad(phi_f, fine_lev, ax)
            comps.append(torch.where(wsum > 1e-12,
                                     agg(gf * oct_frac) / wsafe, 0.0))
        return torch.stack(comps, dim=-1)

    def _pad_vel_for_divergence(self, vel, inflow_scale):
        """One ghost per axis: wrap on periodic axes (on a mesh, x from
        the neighbouring ranks, all components in one exchange), zero
        beyond every other side; then the ghost band of a mass-inflow
        side takes, in the face-normal component, the inflow profile
        times inflow_scale (zero in incremental mode; the reference's
        set_inflow_velocity before the NodalProjector); on a slab the
        x bands at the level's own x faces only."""
        grid = self.grid
        nd = grid.ndim
        first = 0
        if self.mesh is not None:
            zero = lambda t: torch.zeros_like(t.narrow(0, 0, 1))
            vel = self.mesh.halo_x(vel, 1, periodic=grid.periodic[0],
                                   ends=(zero, zero))
            first = 1
        upads = []
        for c in range(nd):
            u = vel[..., c]
            for ax in range(first, nd):
                u = mg._wrap_pad(u, ax) if grid.periodic[ax] \
                    else mg._zero_pad(u, ax)
            upads.append(u)
        for ax in range(nd):
            if grid.periodic[ax]:
                continue
            for side in range(2):
                if BCKind(int(self.cfg.bc_kind[ax, side])) \
                        != BCKind.mass_inflow or not grid.edge(ax, side):
                    continue
                # on a slab the band spans the x halo too: those columns
                # are the level's interior but for the level's own x
                # ghosts, which stay zero as on one rank
                pads = [first if a == 0 else 0 for a in range(nd)]
                val = self.vel_ev.slab(ax, side, ax, pads, self.dtype,
                                       device=self.device)
                if val.dim() > nd:       # drop the component axis
                    val = val[..., 0]
                u = upads[ax].clone()
                band = u.narrow(ax, 0 if side == 0 else u.shape[ax] - 1, 1)
                for a in range(nd):
                    if a != ax:
                        k = 1 - pads[a]
                        band = band.narrow(a, k, u.shape[a] - 2 * k)
                band.copy_(torch.broadcast_to(val, band.shape)
                           * inflow_scale)
                if first and ax != 0:
                    mesh = self.mesh
                    if mesh.rank == 0:
                        band.narrow(0, 0, 1).zero_()
                    if mesh.rank == mesh.size - 1:
                        band.narrow(0, band.shape[0] - 1, 1).zero_()
                upads[ax] = u
        return upads

    # ------------------------------------------------------------------
    # predictor (reference incflo_apply_predictor.cpp)
    # ------------------------------------------------------------------
    def _viscosity(self, vel_g, ng):
        """eta grown by 1; with embedded boundaries covered cells get
        eta = 0 (the reference's compute_viscosity_at_level) and cut
        cells the one-sided strain-rate stencils."""
        eta_g1 = rheology.compute_viscosity(vel_g, self.grid, ng, self.cfg,
                                            out_ng=1, eb=self.eb)
        if self.eb is not None:
            bcrec = bcs.make_bcrecs(1, self.grid.ndim) * 0 \
                + int(bcs.BCType.foextrap)
            eta_g1 = eta_g1 * bcs.grow_scalar(self.eb.fluid, 1, self.grid,
                                              bcrec)
        return eta_g1

    def _tracer_eta_faces(self):
        grid = self.grid
        out = []
        for n in range(self.cfg.ntrac):
            faces = []
            for d in range(grid.ndim):
                shape = tuple(grid.n_cell[a] + (1 if a == d else 0)
                              for a in range(grid.ndim))
                faces.append(torch.full(shape, self.cfg.mu_s[n],
                                        dtype=self.dtype,
                                        device=self.device))
            out.append(faces)
        return out

    def _dt_diff(self, dt):
        """The dt of the implicit diffusion solves: dt (implicit) or dt / 2
        (Crank-Nicolson).  Explicit diffusion makes no solve."""
        kind = self.cfg.diff_type
        if kind == DiffusionType.Explicit:
            raise ValueError("explicit diffusion makes no diffusion solve")
        return dt if kind == DiffusionType.Implicit else 0.5 * dt

    def _diffuse_vel(self, vel_new, rho_new, eta_faces, eta_g1, dt_diff,
                     fixed_trips, cg):
        """The implicit velocity solve; with a list `cg` the tensor CG's
        best residual and its tolerance are appended to it."""
        ng = self.cfg.nghost_state()
        dbc, dbv = self._diff_bc_args("vel")
        out = diffusion.diffuse_velocity(
            vel_new, rho_new, eta_faces, dt_diff, self.cfg, self.grid,
            eta_g1=eta_g1, grow_fn=lambda v: self.grow_vel(v, ng), ng=ng,
            grow_hom_fn=lambda v: self.grow_vel_hom(v, ng),
            prebuilt_solver=self._diff_proto if dbc is None else None,
            direct=False, return_tensor_res=cg is not None,
            fixed_trips=fixed_trips, eb=self.eb, solver_bc_override=dbc,
            bvals_override=dbv)
        if cg is None:
            return out
        cg.append(out[1:])
        return out[0]

    def _diffuse_tra(self, tra_new, rho_new, tra_eta_faces, dt):
        """The implicit tracer solves."""
        sbc, sbv = self._diff_bc_args("tra")
        return diffusion.diffuse_scalar(
            tra_new, rho_new, tra_eta_faces, self._dt_diff(dt), self.cfg,
            self.grid, eb=self.eb, solver_bc_override=sbc,
            bvals_override=sbv)

    def apply_predictor(self, old: LevelState, dt, incremental: bool,
                        small_dt_flag, fixed_trips=None, cg=None):
        """Returns (new LevelState, aux): aux holds the old-time terms the
        MOL corrector reuses."""
        cfg = self.cfg
        grid = self.grid
        ng = cfg.nghost_state()
        vel_o, rho_o, tra_o = old.velocity, old.density, old.tracer
        cn = cfg.diff_type == DiffusionType.Crank_Nicolson
        explicit = cfg.diff_type == DiffusionType.Explicit

        with tracing.span("forces"):
            vel_g = self.grow_vel(vel_o, ng)
            eta_g1 = self._viscosity(vel_g, ng)
            eta_faces = diffusion.eta_to_faces(eta_g1, grid, eb=self.eb)

            divtau_o = None
            if cfg.need_divtau() or cfg.use_tensor_correction:
                divtau_o = diffusion.compute_divtau(vel_o, vel_g, rho_o,
                                                    eta_faces, eta_g1, cfg,
                                                    grid, ng, eb=self.eb)
            laps_o = None
            if cfg.advect_tracer:
                tra_eta_faces = self._tracer_eta_faces()
                if cfg.need_divtau():
                    laps_o = diffusion.compute_laps(tra_o, tra_eta_faces,
                                                    cfg, grid, eb=self.eb)
        if cfg.use_godunov:
            conv_u, conv_r, conv_t, mac_phi = self.convective_term_godunov(
                vel_o, rho_o, tra_o, old.mac_phi, old.gp, divtau_o, laps_o,
                dt)
        else:
            conv_u, conv_r, conv_t, mac_phi, umac = self.convective_term_mol(
                vel_o, rho_o, tra_o, old.mac_phi)

        with tracing.span("diffuse"):
            # density update + half-time density
            if cfg.constant_density:
                rho_new, rho_nph = rho_o, rho_o
            else:
                rho_new = rho_o + dt * conv_r
                rho_nph = 0.5 * (rho_o + rho_new)

            # tracer update (for rho*s; then divide by rho_new)
            tra_new = tra_o
            if cfg.advect_tracer:
                lap_w = LAP_WEIGHT[cfg.diff_type]
                rhs = rho_o[..., None] * tra_o + dt * (
                    conv_t + self.compute_tra_forces(rho_nph))
                if lap_w != 0.0 and laps_o is not None:
                    rhs = rhs + dt * lap_w * laps_o
                tra_new = rhs / rho_new[..., None]
                if not explicit:
                    tra_new = self._diffuse_tra(tra_new, rho_new,
                                                tra_eta_faces, dt)

            # velocity update
            vel_f = self.compute_vel_forces(rho_nph, tra_o, tra_new, old.gp)
            dv = conv_u + vel_f
            if explicit:
                dv = dv + divtau_o
            elif cn:
                dv = dv + 0.5 * divtau_o
            elif cfg.use_tensor_correction:
                dv = dv + divtau_o   # difference of tensor and scalar divtau
            vel_new = vel_o + dt * dv
            if not explicit:
                vel_new = self._diffuse_vel(vel_new, rho_new, eta_faces,
                                            eta_g1, self._dt_diff(dt),
                                            fixed_trips, cg)

        with tracing.span("nodal"):
            vel_new, p_new, gp_new = self.apply_projection(
                vel_new, vel_o, rho_nph, old.gp, old.p, dt, incremental,
                small_dt_flag)
            if self.eb is not None:
                from incflo_torch.eb import ops as ebops
                vel_new = ebops.correct_small_cells(vel_new, umac, grid,
                                                    self.eb)
        new = LevelState(velocity=vel_new, density=rho_new, tracer=tra_new,
                         gp=gp_new, p=p_new, mac_phi=mac_phi)
        return new, dict(conv_u=conv_u, conv_r=conv_r, conv_t=conv_t,
                         divtau_o=divtau_o, laps_o=laps_o)

    # ------------------------------------------------------------------
    # corrector (MOL; reference incflo_apply_corrector.cpp)
    # ------------------------------------------------------------------
    def apply_corrector(self, old: LevelState, star: LevelState, aux,
                        dt, small_dt_flag, fixed_trips=None, cg=None):
        """The second MOL stage: the convective term of the predicted
        state averaged with the old one; with explicit diffusion divtau
        and the tracer Laplacian of the predicted state too
        (incflo_tpu/simulation.py:800-882, the no-EB branch)."""
        cfg = self.cfg
        grid = self.grid
        ng = cfg.nghost_state()
        vel_o, rho_o, tra_o = old.velocity, old.density, old.tracer
        cn = cfg.diff_type == DiffusionType.Crank_Nicolson
        explicit = cfg.diff_type == DiffusionType.Explicit

        conv_u, conv_r, conv_t, mac_phi, umac = self.convective_term_mol(
            star.velocity, star.density, star.tracer, star.mac_phi)

        with tracing.span("forces"):
            vel_g = self.grow_vel(star.velocity, ng)
            eta_g1 = self._viscosity(vel_g, ng)
            eta_faces = diffusion.eta_to_faces(eta_g1, grid, eb=self.eb)
            divtau = None
            if explicit or cfg.use_tensor_correction:
                divtau = diffusion.compute_divtau(star.velocity, vel_g,
                                                  star.density, eta_faces,
                                                  eta_g1, cfg, grid, ng,
                                                  eb=self.eb)
            tra_eta_faces = self._tracer_eta_faces()
            laps = None
            if cfg.advect_tracer and explicit:
                laps = diffusion.compute_laps(star.tracer, tra_eta_faces,
                                              cfg, grid, eb=self.eb)

        with tracing.span("diffuse"):
            if cfg.constant_density:
                rho_new, rho_nph = rho_o, rho_o
            else:
                rho_new = rho_o + dt * 0.5 * (conv_r + aux["conv_r"])
                rho_nph = 0.5 * (rho_o + rho_new)

            tra_new = tra_o
            if cfg.advect_tracer:
                rhs = rho_o[..., None] * tra_o + dt * (
                    0.5 * (conv_t + aux["conv_t"])
                    + self.compute_tra_forces(rho_nph))
                if explicit:
                    rhs = rhs + dt * 0.5 * (aux["laps_o"] + laps)
                elif cn:
                    rhs = rhs + dt * 0.5 * aux["laps_o"]
                tra_new = rhs / rho_new[..., None]
                if not explicit:
                    tra_new = self._diffuse_tra(tra_new, rho_new,
                                                tra_eta_faces, dt)

            vel_f = self.compute_vel_forces(rho_nph, tra_o, tra_new, star.gp)
            dv = 0.5 * (conv_u + aux["conv_u"]) + vel_f
            if explicit:
                dv = dv + 0.5 * (aux["divtau_o"] + divtau)
            elif cn:
                dv = dv + 0.5 * aux["divtau_o"]
            elif cfg.use_tensor_correction:
                dv = dv + divtau
            vel_new = vel_o + dt * dv
            if not explicit:
                vel_new = self._diffuse_vel(vel_new, rho_new, eta_faces,
                                            eta_g1, self._dt_diff(dt),
                                            fixed_trips, cg)

        with tracing.span("nodal"):
            vel_new, p_new, gp_new = self.apply_projection(
                vel_new, vel_o, rho_nph, star.gp, old.p, dt, False,
                small_dt_flag)
            if self.eb is not None:
                from incflo_torch.eb import ops as ebops
                vel_new = ebops.correct_small_cells(vel_new, umac, grid,
                                                    self.eb)
        return LevelState(velocity=vel_new, density=rho_new, tracer=tra_new,
                          gp=gp_new, p=p_new, mac_phi=mac_phi)

    # ------------------------------------------------------------------
    # one full step
    # ------------------------------------------------------------------
    def peek_dt(self, s: SimState):
        """The dt the next advance would take (the AMR drivers advance
        every level with the least over the levels)."""
        old = s.level
        vf = self.compute_vel_forces(old.density, old.tracer, old.tracer,
                                     old.gp)
        return self.compute_dt(old.velocity, old.density, vf, s)

    def reproject(self, s: SimState, dt) -> SimState:
        """Incremental re-projection of the current velocity: removes its
        residual divergence and adds the correction to p and gp.  The
        patch driver's composite pressure sync (incflo_tpu/simulation.py
        :920-936): a parent re-projects after absorbing its children's
        averaged-down solution, and each patch then re-closes against
        the corrected parent."""
        lvl = s.level
        vel, p, gp = self.apply_projection(
            lvl.velocity, torch.zeros_like(lvl.velocity), lvl.density,
            lvl.gp, lvl.p, dt, True,
            torch.zeros((), dtype=self.dtype, device=self.device))
        if self.eb is not None:
            vel = vel * self.eb.fluid[..., None]
        return s._replace(level=lvl._replace(velocity=vel, p=p, gp=gp))

    def _advance_impl(self, s: SimState, fixed_trips=None, cg=None,
                      dt_force=None) -> SimState:
        """One plain step (incflo_tpu Simulation._advance_impl).
        fixed_trips: the tensor CG runs that many masked trips
        (diffusion.diffuse_velocity) instead of its adaptive loop; cg: a
        list that gathers each velocity solve's (best residual,
        tolerance).  The predictor and corrector pass both through.
        dt_force: the step's dt, given by an AMR driver (else
        compute_dt's)."""
        old = s.level
        with tracing.span("dt"):
            dt = self.peek_dt(s) if dt_force is None else dt_force
            small_dt = torch.where((s.t > 0.0) & (dt < 0.1 * s.dt), 1.0,
                                   0.0).to(self.dtype)
        new, aux = self.apply_predictor(old, dt, False, small_dt,
                                        fixed_trips, cg)
        if not self.cfg.use_godunov:
            new = self.apply_corrector(old, new, aux, dt, small_dt,
                                       fixed_trips, cg)
        return SimState(level=new, t=s.t + dt, dt=dt, prev_dt=s.dt,
                        prev_prev_dt=s.prev_dt, step=s.step + 1)

    def _fused_step(self, s: SimState):
        """The fused step kernel of this deck on the card, or None: on
        the CPU, on a mesh, outside step2d_kernels.supported, or when the
        fixed-trip tensor CG misses its tolerance at the first dt
        (incflo_tpu/simulation.py:981-991).  A kernel that fails to build
        or launch raises: there is no fallback."""
        if self.device.type != "cuda" or self.mesh is not None:
            return None
        if self._fused is None and self._fused_ok is None:
            from incflo_torch.ops import step2d_kernels
            if not step2d_kernels.supported(self):
                self._fused_ok = False
            else:
                self._fused_ok = step2d_kernels.cg_probe_ok(self, s)
                if self._fused_ok:
                    self._fused = step2d_kernels.FusedStep(self)
        return self._fused

    def advance(self, s: SimState) -> SimState:
        """One time step."""
        fused = self._fused_step(s)
        return fused(s) if fused is not None else self._advance_impl(s)

    def advance_n(self, s: SimState, n: int) -> SimState:
        """n time steps."""
        for _ in range(n):
            s = self.advance(s)
        return s

    # ------------------------------------------------------------------
    # initialization (reference InitData / InitialProjection /
    # InitialIterations, setup/init.cpp:228-300)
    # ------------------------------------------------------------------
    def _initial_projection(self, level: LevelState) -> LevelState:
        one = torch.ones((), dtype=self.dtype, device=self.device)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        vel, _, _ = self.apply_projection(
            level.velocity, level.velocity, level.density, level.gp,
            level.p, one, False, zero)
        # p and gp are reset to zero after the initial projection
        return level._replace(velocity=vel, p=torch.zeros_like(level.p),
                              gp=torch.zeros_like(level.gp))

    def _initial_iteration(self, s: SimState) -> SimState:
        """One pressure iteration: predictor in incremental mode, then
        discard the state update, keeping p/gp."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        star, _ = self.apply_predictor(s.level, s.dt, True, zero)
        lvl = s.level._replace(p=star.p, gp=star.gp, mac_phi=star.mac_phi)
        return s._replace(level=lvl)

    def init_state(self) -> SimState:
        """The t = 0 state after the initial projection and iterations;
        on a mesh the rank's slab of the whole level's initial fields."""
        cfg = self.cfg
        level = probs.init_fluid(cfg, cfg.grid, self.dtype, self.device)
        if self.mesh is not None:
            level = LevelState(*(self.mesh.slab(f).contiguous()
                                 for f in level))
        if self.eb is not None:
            f = self.eb.fluid[..., None]
            level = level._replace(velocity=level.velocity * f,
                                   tracer=level.tracer * f)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        s = SimState(level=level, t=zero, dt=zero, prev_dt=zero,
                     prev_prev_dt=zero,
                     step=torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        if cfg.do_initial_proj:
            s = s._replace(level=self._initial_projection(s.level))
        if cfg.initial_iterations > 0:
            vf = self.compute_vel_forces(s.level.density, s.level.tracer,
                                         s.level.tracer, s.level.gp)
            dt0 = self.compute_dt(s.level.velocity, s.level.density, vf, s,
                                  initialization=True)
            s = s._replace(dt=dt0)
            for _ in range(cfg.initial_iterations):
                s = self._initial_iteration(s)
        return s

    # ------------------------------------------------------------------
    def evolve(self, max_steps: Optional[int] = None, callback=None):
        """Main loop (reference incflo::Evolve).  Returns the final state."""
        cfg = self.cfg
        s = self.init_state()
        nmax = cfg.max_step if max_steps is None else max_steps
        while True:
            t, step = float(s.t), int(s.step)
            if cfg.stop_time >= 0 and t >= cfg.stop_time - 1e-15:
                break
            if nmax >= 0 and step >= nmax:
                break
            s = self.advance(s)
            if callback is not None:
                callback(s)
        return s
