"""The fused step of a 2D, fully periodic, constant-density deck (the
tgv2d class): the hand-written cooperative CUDA kernel of
incflo_torch/csrc/step2d.cu and its plain PyTorch version.

  out_of_scope(sim)   why the kernel cannot run sim's step, or None
  supported(sim)      the gating of incflo_tpu/ops/pallas_step2d.py:84-109
  cg_probe_ok(sim, s) the setup-time check of the fixed-trip tensor CG
                      (pallas_step2d._cg_probe_ok, :586-625)
  step_plain(sim, s)  the plain version: Simulation._advance_impl with
                      FIXED_TRIPS tensor CG trips.  The oracle of the
                      kernel on the card, and what FusedStep runs on a
                      state on the CPU.
  FusedStep(sim)      replaces incflo_tpu/ops/pallas_step2d.py:
                      FusedStep._kernel (:501, pallas_call at :563).  Built
                      once per Simulation: it gathers the three direct
                      solvers' per-axis transforms and eigenvalues and a
                      workspace onto the card; a call is one cooperative
                      launch that computes the whole step (launch counter
                      "step2d") and returns the new SimState, with t, dt,
                      prev_dt and prev_prev_dt as 0-d device tensors and
                      no host sync.  FusedStep.probe runs the kernel's
                      probe instantiation (step2d_launch_probe): the same
                      step, block 0 timing each segment (probe_split).
  launch_plan(cells, itemsize)  the kernel's panels, CTAs and shared
                      memory, checked by the C entry against its source.
  solve_panels_plain(sym, rhs, ...)  a direct solve in the kernel's
                      order: row phase, column phase, row phase.

The kernel's design, and what bounds it, is in the note at the top of
csrc/step2d.cu; its scope is what out_of_scope(sim) checks, and
FusedStep raises outside it.

On a CPU state FusedStep runs step_plain; on a CUDA state it launches the
kernel or raises: there is no fallback to the plain step.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from incflo_torch.config import DiffusionType, FluidModel
from incflo_torch.ops import cuda_build, diffusion, spectral
from incflo_torch.ops.cuda_build import DT_CODE, check_rc, ptr, stream
from incflo_torch.state import LevelState, SimState

SOURCE = cuda_build.CSRC_DIR / "step2d.cu"

# launch counter, raised where the wrapper launches the kernel and nowhere
# else
LAUNCHES = {"step2d": 0}

REPLACES = {"step2d": "incflo_tpu/ops/pallas_step2d.py:501 (FusedStep._kernel)"}

# at most 256^2 cells (pallas_step2d.MAX_CELLS): the working set then
# still fits the card's L2 and the step is launch-bound
MAX_CELLS = 256 * 256

# tensor CG trips of the fused step (incflo_tpu's INCFLO_TENSOR_K default)
FIXED_TRIPS = 12

# the kernel's tables, in the order of the enums of csrc/step2d.cu
PTR_NAMES = (
    "vel", "rho", "gp", "t", "dt", "prev_dt", "prev_prev_dt", "step",
    "mf0", "mv0", "mf1", "mv1", "mlam",
    "df0", "dv0", "df1", "dv1", "dlam", "da0",
    "nf0", "nv0", "nf1", "nv1", "nlam",
    "vel_out", "gp_out", "p_out", "mac_phi_out", "scal_out", "step_out",
    "cg_out", "diag_out",
    "umac0", "umac1", "phi", "srhs", "h1", "h2", "rhs", "x", "r", "p", "p2",
    "z", "xb", "ap", "conv", "dtau", "vstar", "gpstar", "pstar", "vproj",
    "part")
FPAR_NAMES = (
    "dx0", "dx1", "dxi0", "dxi1", "two_cfl", "cfl", "mu", "fallback",
    "per", "stop", "fixed", "rtol", "atol", "gp00", "gp01", "g0", "g1",
    "macb0", "macb1", "dacoef", "db00", "db01", "db10", "db11")
IPAR_NAMES = ("nx", "ny", "cn", "tensor", "tcorr", "trips", "ppe", "stop_on",
              "fixed_on")
# workspace fields of two components (the rest have one); `part` holds
# SLOTS partials per CTA
_WS2 = ("h1", "h2", "rhs", "x", "r", "p", "p2", "z", "xb", "ap", "conv",
        "dtau", "vstar", "gpstar", "vproj")
_WS1 = ("umac0", "umac1", "phi", "srhs", "pstar")
# the pointers that change from call to call: the state and the outputs
_PER_CALL = ("vel", "rho", "gp", "t", "dt", "prev_dt", "prev_prev_dt",
             "step", "vel_out", "gp_out", "p_out", "mac_phi_out",
             "scal_out", "step_out", "cg_out", "diag_out")
SLOTS = 8
THREADS = 256

# The launch plan's constants (csrc/step2d.cu kPanel, kKT, kKTP, kNSP,
# kMaxAxis, kStages; the C entry rejects a plan they disagree with): rows
# of a row panel and columns of a column panel, the depth of a staged
# k-tile of a transform matrix and its row pitch in elements of the
# kernel's type (by element size), a panel's row pitch (doubles), the
# longest axis, and the k-tile stages
PANEL = 4
KTILE = {4: 64, 8: 32}
KPITCH = {4: 68, 8: 36}
NPITCH = 20
MAX_AXIS = 256
STAGES = 2
SMEM_BLOCK = 232448       # H100: shared memory one CTA may take (227 KB)


class Plan(NamedTuple):
    panel: int          # rows of a row panel, columns of a column panel
    ktile: int          # depth of a staged k-tile of a transform matrix
    row_panels: int
    col_panels: int
    ctas: int           # one a panel; the kernel caps it at the
                        # cooperative limit, past which a CTA walks panels
    smem: int           # dynamic shared-memory bytes of a CTA


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(cells, itemsize: int) -> int:
    """Dynamic shared memory of a CTA (csrc/step2d.cu smem_bytes): the
    panel and the column phase's spectral panel in double, then the
    k-tile stages of a transform matrix in the kernel's type, sized by
    the longer axis."""
    n = max(cells)
    return (2 * _round_up(n, KTILE[itemsize]) * NPITCH * 8
            + STAGES * _round_up(n, 16) * KPITCH[itemsize]
            * itemsize)


def launch_plan(cells, itemsize: int) -> Plan:
    """The kernel's launch plan for a (nx, ny) grid: one CTA per row
    panel and column panel (the larger count), PANEL rows or columns a
    panel; the C entry checks it against its source."""
    nx, ny = cells
    rp, cp = -(-nx // PANEL), -(-ny // PANEL)
    return Plan(PANEL, KTILE[itemsize], rp, cp, max(rp, cp),
                smem_bytes(cells, itemsize))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.step2d_launch.argtypes = [ctypes.c_int, vp, vp, vp, vp, ip, vp]
        lib.step2d_launch.restype = ctypes.c_int
        lib.step2d_launch_probe.argtypes = [ctypes.c_int, vp, vp, vp, vp, ip,
                                            vp, ctypes.c_int, vp]
        lib.step2d_launch_probe.restype = ctypes.c_int
        lib.step2d_max_blocks.argtypes = [ctypes.c_int, ctypes.c_int, ip]
        lib.step2d_max_blocks.restype = ctypes.c_int
        lib.step2d_layout.argtypes = [ip] * 5
        lib.step2d_layout.restype = ctypes.c_int
        got = [ctypes.c_int() for _ in range(5)]
        lib.step2d_layout(*[ctypes.byref(g) for g in got])
        want = (len(PTR_NAMES), len(FPAR_NAMES), len(IPAR_NAMES), SLOTS,
                THREADS)
        if tuple(g.value for g in got) != want:
            raise RuntimeError(f"step2d.cu tables {[g.value for g in got]} "
                               f"differ from step2d_kernels.py {want}")
        _LIB = lib
    return _LIB


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sym_direct(solver) -> bool:
    sym = getattr(solver, "symbol", None)
    return sym is not None and sym.fwd is not None


def out_of_scope(sim) -> Optional[str]:
    """Why `sim`'s step is outside the kernel's scope, or None: the kernel
    runs 2D, fully periodic grids of at most MAX_CELLS cells and at least
    4 per axis, constant density without a tracer, a Newtonian fluid
    without Boussinesq buoyancy, MOL advection, Crank-Nicolson or
    implicit diffusion, float32 or float64, with the MAC, velocity and
    nodal systems all solved by fast diagonalization."""
    grid, cfg = sim.grid, sim.cfg
    if grid.ndim != 2:
        return f"{grid.ndim}D grids"
    if not all(grid.periodic):
        return "grids with walls"
    if grid.n_cell[0] * grid.n_cell[1] > MAX_CELLS:
        return f"more than {MAX_CELLS} cells"
    if min(grid.n_cell) < 4:
        return "axes of fewer than 4 cells"
    if not cfg.constant_density or cfg.advect_tracer:
        return "variable density or tracer advection"
    if cfg.fluid_model != FluidModel.Newtonian:
        return "non-Newtonian fluids"
    if cfg.use_boussinesq:
        return "Boussinesq buoyancy"
    if cfg.diff_type not in (DiffusionType.Crank_Nicolson,
                             DiffusionType.Implicit):
        return "explicit diffusion"
    if cfg.use_godunov:
        return "Godunov advection"
    if sim.eb is not None:
        return "embedded boundaries"
    if sim.dtype not in DT_CODE:
        return f"{sim.dtype}"
    if not all(_sym_direct(s) for s in (sim._mac_solver, sim._diff_proto,
                                         sim._nodal_hat)):
        return "solvers without a fast-diagonalization symbol"
    return None


def supported(sim) -> bool:
    """Whether Simulation runs `sim`'s step as the fused kernel: in its
    scope and float32 (pallas_step2d.supported without its environment
    switches; float64 is for the tight check against step_plain)."""
    return sim.dtype == torch.float32 and out_of_scope(sim) is None


def cg_probe_ok(sim, s: SimState) -> bool:
    """One fixed-trip tensor solve of the state's velocity at the step's
    dt, whose best residual must reach the tolerance the adaptive CG
    enforces, max(rtol * |rhs|, atol): a deck whose cross coupling is too
    strong for FIXED_TRIPS trips is not fused (pallas_step2d._cg_probe_ok;
    it reads one bool back to the host, once per Simulation)."""
    cfg = sim.cfg
    if cfg.diff_type not in (DiffusionType.Crank_Nicolson,
                             DiffusionType.Implicit):
        return True
    if not cfg.use_tensor_solve:
        return True
    ng = cfg.nghost_state()
    lvl = s.level
    vf = sim.compute_vel_forces(lvl.density, lvl.tracer, lvl.tracer, lvl.gp)
    dt = sim.compute_dt(lvl.velocity, lvl.density, vf, s)
    vel_g = sim.grow_vel(lvl.velocity, ng)
    eta_g1 = sim._viscosity(vel_g, ng)
    eta_faces = diffusion.eta_to_faces(eta_g1, sim.grid)
    _, res, tol = diffusion.diffuse_velocity(
        lvl.velocity, lvl.density, eta_faces, sim._dt_diff(dt), cfg,
        sim.grid, eta_g1=eta_g1, grow_fn=lambda v: sim.grow_vel(v, ng),
        ng=ng, grow_hom_fn=lambda v: sim.grow_vel_hom(v, ng),
        prebuilt_solver=sim._diff_proto, direct=False,
        return_tensor_res=True, fixed_trips=FIXED_TRIPS)
    return bool(res <= tol)


def solve_panels_plain(sym, rhs, alpha, beta, singular: bool):
    """A direct solve in the kernel's order (csrc/step2d.cu solve), plain
    PyTorch: the row phase (the axis-1 forward transform), the column
    phase (the axis-0 forward transform, the eigenvalue divide -- the
    mask-form zero mode of a singular symbol, else alpha a0 + beta lam --
    and the axis-0 inverse), then the row phase (the axis-1 inverse).
    sym is a 2D fast-diagonalization spectral.Symbol; rhs (nx, ny) or
    (nx, ny, C).  spectral.solve transforms axis 0 first: transforms
    along different axes commute."""
    c = spectral._contract
    s = sym.sym_face
    s = beta * s if sym.a0 is None else alpha * sym.a0 + beta * s
    if rhs.dim() > 2 and not sym.batched:
        s = s[..., None]
    h = c(c(rhs, sym.fwd[1], 1), sym.fwd[0], 0)
    if singular:
        at0 = spectral._at_origin(sym, h)
        s = torch.where(spectral._at_origin(sym, s), 1.0, s)
        h = torch.where(at0, 0.0, h)
    h = h / s
    return c(c(h, sym.inv[0], 0), sym.inv[1], 1)


def step_plain(sim, s: SimState,
               cg: Optional[List] = None) -> SimState:
    """The plain version of the kernel: one step with FIXED_TRIPS tensor
    CG trips.  A list `cg` gathers each velocity solve's (best residual,
    tolerance)."""
    return sim._advance_impl(s, fixed_trips=FIXED_TRIPS, cg=cg)


class FusedStep:
    """The fused step of one Simulation (see the module docstring)."""

    def __init__(self, sim):
        why = out_of_scope(sim)
        if why is not None:
            raise NotImplementedError(f"step2d kernel: {why} are outside "
                                      f"its scope")
        self.sim = sim
        cfg, grid = sim.cfg, sim.grid
        dev, dt = sim.device, sim.dtype
        nx, ny = grid.n_cell
        self.n = nx * ny
        self.consts = {}

        def put(name, t):
            self.consts[name] = t.to(device=dev, dtype=dt).contiguous()

        for key, solver in (("m", sim._mac_solver), ("d", sim._diff_proto),
                            ("n", sim._nodal_hat)):
            sym = solver.symbol
            put(key + "f0", sym.fwd[0])
            put(key + "v0", sym.inv[0])
            put(key + "f1", sym.fwd[1])
            put(key + "v1", sym.inv[1])
            put(key + "lam", sym.sym_face)
        # the velocity symbol's constant acoef, one value per component
        put("da0", sim._diff_proto.symbol.a0.reshape(-1).expand(2))

        co = sim._static_coefs
        fp = {
            "dx0": grid.dx[0], "dx1": grid.dx[1],
            "dxi0": 1.0 / grid.dx[0], "dxi1": 1.0 / grid.dx[1],
            "two_cfl": 2.0 * cfg.cfl, "cfl": cfg.cfl, "mu": cfg.mu,
            "fallback": cfg.stop_time / 100.0 if cfg.stop_time > 0 else 1.0,
            "per": cfg.plot_per_exact, "stop": cfg.stop_time,
            "fixed": cfg.fixed_dt, "rtol": cfg.tensor_mg_rtol,
            "atol": cfg.tensor_mg_atol,
            "gp00": cfg.gp0[0], "gp01": cfg.gp0[1],
            "g0": cfg.gravity[0], "g1": cfg.gravity[1],
            "macb0": co["mac_b"], "macb1": co["mac_b"],
            "dacoef": co["diff_a"],
            "db00": co["diff_b"][0][0], "db01": co["diff_b"][0][1],
            "db10": co["diff_b"][1][0], "db11": co["diff_b"][1][1],
        }
        ip = {
            "nx": nx, "ny": ny,
            "cn": int(cfg.diff_type == DiffusionType.Crank_Nicolson),
            "tensor": int(cfg.use_tensor_solve),
            "tcorr": int(cfg.use_tensor_correction), "trips": FIXED_TRIPS,
            "ppe": int(cfg.plot_per_exact > 0),
            "stop_on": int((not cfg.steady_state) and cfg.stop_time > 0.0),
            "fixed_on": int(cfg.fixed_dt > 0.0),
        }
        self._fpar = (ctypes.c_double * len(FPAR_NAMES))(
            *[float(fp[k]) for k in FPAR_NAMES])
        self._ipar = (ctypes.c_int * len(IPAR_NAMES))(
            *[int(ip[k]) for k in IPAR_NAMES])
        self.plan = launch_plan((nx, ny), torch.empty((), dtype=dt)
                                .element_size())
        self._plan = (ctypes.c_int * 4)(self.plan.panel, self.plan.ktile,
                                        self.plan.ctas, self.plan.smem)
        self.ws = None
        if dev.type != "cpu":
            self.ws = {k: torch.empty(2 * self.n, dtype=dt, device=dev)
                       for k in _WS2}
            self.ws.update({k: torch.empty(self.n, dtype=dt, device=dev)
                            for k in _WS1})
            self.ws["part"] = torch.empty(SLOTS * self.plan.ctas, dtype=dt,
                                          device=dev)
        # the pointer table, its fixed entries filled once
        self._ptrs = (ctypes.c_void_p * len(PTR_NAMES))()
        if self.ws is not None:
            for i, k in enumerate(PTR_NAMES):
                if k not in _PER_CALL:
                    self._ptrs[i] = ptr(self.consts.get(k, self.ws.get(k))
                                        ).value
        self._per_call = [(PTR_NAMES.index(k), k) for k in _PER_CALL]
        self.blocks = None          # grid size of the last launch
        self.diag = None            # (barriers, CG trips x2) of the last launch
        self.last_cg = None

    def step(self, s: SimState) -> Tuple[SimState, torch.Tensor]:
        """(new state, cg): cg holds the predictor's and the corrector's
        best tensor-CG residual and tolerance, (res, tol, res, tol)."""
        vel = s.level.velocity
        if vel.device.type == "cpu":
            cg = []
            out = step_plain(self.sim, s, cg)
            flat = [v for pair in cg for v in pair]
            return out, torch.stack(flat).to(vel.dtype)
        return self._launch(s)

    def __call__(self, s: SimState) -> SimState:
        out, self.last_cg = self.step(s)
        return out

    def probe(self, s: SimState) -> Tuple[SimState, dict]:
        """One step through the kernel's probe instantiation
        (step2d_launch_probe; not on the main path, not counted in
        LAUNCHES): (new state, probe_split of its records).  Syncs."""
        rec = torch.zeros((PROBE_CAP, 3), dtype=torch.int64,
                          device=s.level.velocity.device)
        out, _ = self._launch(s, rec)
        torch.cuda.synchronize()
        return out, probe_split(rec.cpu().tolist())

    def _launch(self, s: SimState, probe: Optional[torch.Tensor] = None
                ) -> Tuple[SimState, torch.Tensor]:
        sim = self.sim
        if self.ws is None:
            raise ValueError("step2d: this FusedStep was built for a "
                             "Simulation on the CPU")
        lvl = s.level
        dt, dev = sim.dtype, sim.device
        nx, ny = sim.grid.n_cell
        vel, rho, gp = lvl.velocity, lvl.density, lvl.gp
        for name, t, shape in (("velocity", vel, (nx, ny, 2)),
                               ("density", rho, (nx, ny)),
                               ("gp", gp, (nx, ny, 2))):
            if (t.dtype != dt or t.device.type != dev.type
                    or tuple(t.shape) != shape):
                raise ValueError(f"step2d: {name} must be {dt} {shape} on "
                                 f"{dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        vel, rho, gp = vel.contiguous(), rho.contiguous(), gp.contiguous()
        scal_in = [x.to(device=dev, dtype=dt).contiguous()
                   for x in (s.t, s.dt, s.prev_dt, s.prev_prev_dt)]
        step_in = s.step.to(device=dev, dtype=torch.int32).contiguous()
        out = {"vel_out": torch.empty_like(vel),
               "gp_out": torch.empty_like(gp),
               "p_out": torch.empty((nx, ny), dtype=dt, device=dev),
               "mac_phi_out": torch.empty((nx, ny), dtype=dt, device=dev),
               "scal_out": torch.empty(4, dtype=dt, device=dev),
               "step_out": torch.empty((), dtype=torch.int32, device=dev),
               "cg_out": torch.empty(4, dtype=dt, device=dev),
               "diag_out": torch.empty(3, dtype=torch.int32, device=dev)}
        tensors = {"vel": vel, "rho": rho, "gp": gp, "t": scal_in[0],
                   "dt": scal_in[1], "prev_dt": scal_in[2],
                   "prev_prev_dt": scal_in[3], "step": step_in, **out}
        for i, k in self._per_call:
            self._ptrs[i] = tensors[k].data_ptr()
        lib = _lib()
        nblk = ctypes.c_int()
        if probe is not None:
            rc = lib.step2d_launch_probe(
                DT_CODE[dt], self._ptrs, self._fpar, self._ipar, self._plan,
                ctypes.byref(nblk), probe.data_ptr(), probe.shape[0],
                stream(vel))
            check_rc("step2d probe", rc)
        else:
            rc = lib.step2d_launch(DT_CODE[dt], self._ptrs, self._fpar,
                                   self._ipar, self._plan,
                                   ctypes.byref(nblk), stream(vel))
            check_rc("step2d", rc)
            LAUNCHES["step2d"] += 1
        self.blocks = nblk.value
        self.diag = out["diag_out"]
        sc = out["scal_out"]
        level = LevelState(velocity=out["vel_out"], density=lvl.density,
                           tracer=lvl.tracer, gp=out["gp_out"],
                           p=out["p_out"], mac_phi=out["mac_phi_out"])
        return SimState(level=level, t=sc[0], dt=sc[1], prev_dt=sc[2],
                        prev_prev_dt=sc[3], step=out["step_out"]), \
            out["cg_out"]


# the probe's record kinds (csrc/step2d.cu enum Seg) and its capacity
PROBE_KINDS = ("start", "transform", "barrier", "elementwise", "finish",
               "panel load", "epilogue")
PROBE_CAP = 1024


def probe_split(records) -> dict:
    """The probe's records [kind, globaltimer ns, clock64] (block 0 of
    the grid, one a segment) as ms by kind: each interval between two
    records belongs to the later record's kind.  Also the clock64 split
    as shares of the total, the count of barriers stamped, and from the
    last record (kind -1) the share of the transforms' k-loops spent
    waiting for a k-tile."""
    recs = [r for r in records if r[1] != 0 and r[0] >= 0]
    kloop = [r for r in records if r[0] == -1]
    kparts = [r for r in records if r[0] == -2]
    ms = {k: 0.0 for k in PROBE_KINDS[1:]}
    cyc = dict(ms)
    for prev, cur in zip(recs, recs[1:]):
        kind = PROBE_KINDS[cur[0]]
        ms[kind] += (cur[1] - prev[1]) * 1e-6
        cyc[kind] += cur[2] - prev[2]
    total = (recs[-1][1] - recs[0][1]) * 1e-6
    ncyc = max(recs[-1][2] - recs[0][2], 1)
    return {"ms": ms, "total_ms": total,
            "clock_share": {k: v / ncyc for k, v in cyc.items()},
            # block 0 thread 0's clocks in the transforms' k-loops spent
            # waiting for a k-tile (and the barrier after the wait)
            "kloop_wait_share": (kloop[0][1] / max(kloop[0][2], 1)
                                 if kloop else None),
            # and issuing the next k-tile's copies, and the products
            "kloop_issue_share": (kparts[0][1] / max(kloop[0][2], 1)
                                  if kparts else None),
            "kloop_mma_share": (kparts[0][2] / max(kloop[0][2], 1)
                                if kparts else None),
            "clock_ghz": ncyc / max(recs[-1][1] - recs[0][1], 1),
            "segments": len(recs) - 1,
            "barriers": sum(1 for r in recs if r[0] == 2)}


def max_blocks(dtype, cells) -> int:
    """The most blocks a cooperative launch of the kernel may have on the
    current card for a (nx, ny) grid (occupancy at its shared memory x
    SM count)."""
    out = ctypes.c_int()
    smem = smem_bytes(cells, torch.empty((), dtype=dtype).element_size())
    check_rc("step2d_max_blocks",
             _lib().step2d_max_blocks(DT_CODE[dtype], smem,
                                      ctypes.byref(out)))
    return out.value
