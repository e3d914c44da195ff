"""The plain reference step of the benchmark's decks: incflo's Godunov
predictor with Crank-Nicolson tensor diffusion and the nodal projection
(incflo_advance.cpp, incflo_apply_predictor.cpp, incflo_compute_dt.cpp,
the MAC and nodal projections), for 3D decks whose axes are periodic or
end in slip walls, constant or variable density, with or without an
advected tracer, Newtonian.

It imports nothing of the program and takes nothing the program made:
it works the operators, the initial projection and every solve out
again from the deck and the fields it is given.  Its solves are its own
(solve.py), its Godunov chains frozen copies of the plain ones
(godunov_periodic.py, godunov_walls.py).  It computes in the data type
of the fields it is given: float64 for the check, float32 for its
control.  State: a dict of velocity (*cells, 3), density (*cells),
tracer (*cells, 1), gp (*cells, 3), p (*nodes), and the 0-d tensors t
and dt (the last step's dt, zero before the first)."""

from __future__ import annotations

import torch

from benchmark.reference import godunov_periodic as gper
from benchmark.reference import ops
from benchmark.reference.deck import Deck
from benchmark.reference.godunov_walls import WindowedGodunov
from benchmark.reference.solve import FastDiag, bicgstab, pcg

NG = 3          # ghost cells of the Godunov chain


def grid_volume(grid):
    dx = grid.dx
    return dx[0] * dx[1] * dx[2]


class ReferenceStep:
    def __init__(self, deck: Deck, dtype, device):
        self.deck, self.dtype, self.device = deck, dtype, device
        g = self.grid = deck.grid
        self.vel_rec = deck.velocity_bcrecs()
        self.sca_rec = deck.scalar_bcrecs()
        self.periodic = all(g.periodic)
        self.ke = torch.as_tensor(ops.q1_element(g.dx), dtype=dtype,
                                  device=device)
        self._node_pairs = [ops.node_matrices_1d(g, ax) for ax in range(3)]
        # boundary codes: projections and scalars Neumann at walls; the
        # velocity's normal component Dirichlet there
        self.bc_scalar = [("P", "P") if p else ("N", "N") for p in g.periodic]
        self.bc_vel = [[("P", "P") if g.periodic[ax] else
                        (("D", "D") if ax == c else ("N", "N"))
                        for ax in range(3)] for c in range(3)]
        self._mats = {}

    # -- helpers -------------------------------------------------------
    def _t(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _mats_1d(self, bc):
        key = tuple(bc)
        if key not in self._mats:
            op = ops.CellOp(self.grid, bc, (1.0, 1.0, 1.0))
            self._mats[key] = [op.matrix_1d(ax) for ax in range(3)]
        return self._mats[key]

    def _cell_prec(self, bc, a, scales):
        return FastDiag.cell(self._mats_1d(bc), a, scales, self.dtype,
                             self.device)

    def _vel_forces(self, rho, gp):
        """-(gp + gp0) / rho + g, gp0 = ro_0 g the background pressure
        gradient of incflo's set_background_pressure.cpp."""
        gp0 = self._t([self.deck.ro_0 * g for g in self.deck.gravity])
        return -(gp + gp0) / rho[..., None] + self._t(self.deck.gravity)

    # -- dt (incflo_compute_dt.cpp; Crank-Nicolson: no diffusive limit) -
    def compute_dt(self, vel, rho, gp, dt_old):
        dxinv = self._t([1.0 / d for d in self.grid.dx])
        conv = torch.max(torch.abs(vel) * dxinv)
        forc = torch.max(torch.abs(self._vel_forces(rho, gp)) * dxinv)
        comb = conv + torch.sqrt(conv * conv + 4.0 * forc)
        dt = 2.0 * self.deck.cfl / torch.clamp_min(comb, 1e-300)
        return torch.where(dt_old > 0.0, torch.minimum(dt, 1.1 * dt_old), dt)

    # -- MAC projection ------------------------------------------------
    def mac_project(self, umac, beta):
        op = ops.CellOp(self.grid, self.bc_scalar, beta)
        rhs = -ops.mac_divergence(umac, self.grid)
        b_mean = float(sum(b.mean() for b in beta) / 3.0) \
            if torch.is_tensor(beta[0]) else float(beta[0])
        prec = self._cell_prec(self.bc_scalar, 0.0, [b_mean] * 3)
        # L = -div(beta grad) is symmetric positive semi-definite
        phi = pcg(op.apply, rhs, prec, singular=True)
        fl = op.fluxes(phi)
        return [umac[d] - fl[d] for d in range(3)]

    # -- nodal projection (non-incremental) ----------------------------
    def nodal_project(self, vel, vel_old, rho, gp, scaling, small_dt):
        vel = vel + gp * (scaling / rho)[..., None]
        vel_in = vel - small_dt * vel_old
        sigma = scaling / rho
        rhs = ops.nodal_divergence(vel_in, self.grid)
        vol = grid_volume(self.grid)
        prec = FastDiag.nodal(self._node_pairs, float(sigma.mean()) / vol,
                              self.dtype, self.device)
        # incflo's nodal operator is -A: solve A phi = -div u
        phi = pcg(lambda x: ops.nodal_apply(x, sigma, self.grid, self.ke),
                  -rhs, prec, singular=True)
        gphi = ops.nodal_grad(phi, self.grid)
        return vel - sigma[..., None] * gphi, phi, gphi

    def initial_projection(self, vel, rho):
        one = self._t(1.0)
        vel, _, _ = self.nodal_project(vel, vel, rho, torch.zeros_like(vel),
                                       one, self._t(0.0))
        return vel

    # -- diffusion -----------------------------------------------------
    def divtau(self, vel, vel_g, rho):
        """div(mu (grad u + grad u^T)) / rho with the velocity's wall
        values (zero normal velocity at a slip wall)."""
        mu = self.deck.mu
        parts = []
        for c in range(3):
            op = ops.CellOp(self.grid, self.bc_vel[c], (mu, mu, mu))
            parts.append(-op.apply(vel[..., c]))
        out = torch.stack(parts, dim=-1) \
            + ops.transpose_term(vel_g, mu, self.grid, NG)
        return out / rho[..., None]

    def laps(self, tra):
        mu_s = self.deck.mu_s
        op = ops.CellOp(self.grid, self.bc_scalar, (mu_s, mu_s, mu_s))
        return -op.apply(tra[..., 0])[..., None]

    def diffuse_tracer(self, tra, rho, dt_diff):
        mu_s = self.deck.mu_s
        op = ops.CellOp(self.grid, self.bc_scalar, (mu_s,) * 3, acoef=rho,
                        beta=dt_diff)
        prec = self._cell_prec(self.bc_scalar, float(rho.mean()),
                               [float(dt_diff) * mu_s] * 3)
        s = pcg(op.apply, rho * tra[..., 0], prec, x0=tra[..., 0].clone())
        return s[..., None]

    def diffuse_velocity(self, vel, rho, dt_diff):
        mu = self.deck.mu
        dtd = float(dt_diff)
        if not self.periodic:
            # a slip wall: one scalar solve per component (its own
            # boundary codes), no cross coupling in the implicit part
            comps = []
            for c in range(3):
                bc = self.bc_vel[c]
                op = ops.CellOp(self.grid, bc, (mu,) * 3, acoef=rho,
                                beta=dt_diff)
                prec = self._cell_prec(bc, float(rho.mean()), [dtd * mu] * 3)
                solve = bicgstab if "D" in sum(bc, ()) else pcg
                comps.append(solve(op.apply, rho * vel[..., c], prec,
                                   x0=vel[..., c].clone()))
            return torch.stack(comps, dim=-1)
        # fully periodic: the coupled tensor system
        # rho u - dt_diff div(mu (grad u + grad u^T)) = rho u*
        bc = self.bc_vel[0]
        ops_c = []
        precs = []
        for c in range(3):
            scale = [2.0 if d == c else 1.0 for d in range(3)]
            ops_c.append(ops.CellOp(self.grid, bc,
                                    tuple(mu * s for s in scale),
                                    acoef=rho, beta=dt_diff))
            precs.append(self._cell_prec(bc, float(rho.mean()),
                                         [dtd * mu * s for s in scale]))

        def apply(u):
            ug = ops.grow(u, NG, self.grid, self.vel_rec)
            cross = ops.transpose_term(ug, mu, self.grid, NG, cross_only=True)
            return torch.stack([ops_c[c].apply(u[..., c]) for c in range(3)],
                               dim=-1) - dt_diff * cross

        def prec(r):
            return torch.stack([precs[c](r[..., c]) for c in range(3)],
                               dim=-1)

        return bicgstab(apply, rho[..., None] * vel, prec, x0=vel.clone())

    # -- Godunov --------------------------------------------------------
    def _godunov(self):
        return None if self.periodic else WindowedGodunov(self.grid,
                                                          self.deck.use_ppm)

    def _predict(self, vel_g, vf_g, dt):
        if self.periodic:
            return gper.predict(self.grid, ops.inner(vel_g, NG),
                                ops.inner(vf_g, 1), dt, self.deck.use_ppm)
        return self._godunov().predict(vel_g, vf_g, dt, NG, self.vel_rec)

    def _advect(self, q_g, umac, f_g, dt, recs, iconserv, is_vel):
        if self.periodic:
            return gper.advect(self.grid, ops.inner(q_g, NG), umac,
                               None if f_g is None else ops.inner(f_g, 1),
                               dt, iconserv, self.deck.use_ppm)
        return self._godunov().advect(q_g, umac, f_g, dt, NG, recs, iconserv,
                                      is_vel)

    # -- one step --------------------------------------------------------
    def step(self, st):
        """The next state of `st` (incflo_tpu's _advance_impl with the
        Godunov predictor and Crank-Nicolson diffusion)."""
        deck, grid = self.deck, self.grid
        vel_o, rho_o, tra_o = st["velocity"], st["density"], st["tracer"]
        gp_o = st["gp"]
        dt = self.compute_dt(vel_o, rho_o, gp_o, st["dt"])
        small_dt = torch.where((st["t"] > 0.0) & (dt < 0.1 * st["dt"]),
                               1.0, 0.0).to(self.dtype)
        vel_g = ops.grow(vel_o, NG, grid, self.vel_rec)
        rho_g = ops.grow_scalar(rho_o, NG, grid, self.sca_rec)
        divtau_o = self.divtau(vel_o, vel_g, rho_o)
        laps_o = self.laps(tra_o) if deck.advect_tracer else None

        # Godunov: predict, MAC-project, advect
        force_rec = deck.force_bcrecs(3)
        vf_g = ops.grow(self._vel_forces(rho_o, gp_o) + divtau_o, 1, grid,
                        force_rec)
        beta = ops.inv_rho_on_faces(ops.inner(rho_g, NG - 1), grid)
        umac = self._predict(vel_g, vf_g, dt)
        umac = self.mac_project(umac, beta)
        conv_u = self._advect(vel_g, umac, vf_g, dt, self.vel_rec,
                              [0, 0, 0], True)
        if deck.constant_density:
            rho_new = rho_nph = rho_o
        else:
            conv_r = self._advect(rho_g[..., None], umac, None, dt,
                                  self.sca_rec, [1], False)[..., 0]
            rho_new = rho_o + dt * conv_r
            rho_nph = 0.5 * (rho_o + rho_new)

        tra_new = tra_o
        if deck.advect_tracer:
            tf_g = ops.grow(laps_o, 1, grid, deck.force_bcrecs(1))
            rhotrac = rho_g[..., None] * ops.grow(tra_o, NG, grid,
                                                  self.sca_rec)
            conv_t = self._advect(rhotrac, umac, tf_g, dt, self.sca_rec,
                                  [1], False)
            rhs = rho_o[..., None] * tra_o + dt * conv_t + dt * 0.5 * laps_o
            tra_new = self.diffuse_tracer(rhs / rho_new[..., None], rho_new,
                                          0.5 * dt)

        dv = conv_u + self._vel_forces(rho_nph, gp_o) + 0.5 * divtau_o
        vel_new = self.diffuse_velocity(vel_o + dt * dv, rho_new, 0.5 * dt)
        vel_new, p_new, gp_new = self.nodal_project(
            vel_new, vel_o, rho_nph, gp_o, dt, small_dt)
        return {"velocity": vel_new, "density": rho_new, "tracer": tra_new,
                "gp": gp_new, "p": p_new, "t": st["t"] + dt, "dt": dt}
