"""Godunov (corner-transport-upwind) advection: port of
incflo_tpu/ops/godunov.py:127-803 for 3D grids.

  predict():  half-time face-normal velocities for the MAC projection.
  advect():   dq/dt = -div(umac q) (iconserv) or -(u.grad)q with full
              corner-transport transverse corrections.

On fully periodic grids the chain has no boundary forms, so both
dispatch to ops/godunov_kernels (the CUDA kernels on the card, their
plain PyTorch versions on the CPU).  A grid with a non-periodic axis
takes the wall forms of the plain versions (ops/godunov_walls.py) on
either device, as incflo_tpu runs such grids through its jnp Godunov and
not through its Pallas kernels: the choice is made here, by the grid's
periodicity alone.  On an x slab of a mesh (grid.mesh) both take the
halo-slab forms, predict_sharded and advect_sharded, as
incflo_tpu/ops/godunov.py:482-491 and :657-667 dispatch to
pallas_godunov's.  2D, use_forces_in_trans and the use_mac_phi_in_godunov
warm start wait for ROADMAP A8 and raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from incflo_torch.grid import Grid
from incflo_torch.ops import godunov_kernels as gk
from incflo_torch.ops.stencil import inner
from incflo_torch.parallel.mesh import mesh_of


class GodunovScheme:
    def __init__(self, grid: Grid, use_ppm: bool, use_forces_in_trans: bool):
        self.grid = grid
        self.use_ppm = use_ppm
        self.uft = use_forces_in_trans
        self.nd = grid.ndim

    def _check(self):
        if self.nd != 3:
            raise NotImplementedError(
                "incflo_torch GodunovScheme covers 3D grids; 2D comes with "
                "ROADMAP A8")
        if self.uft:
            raise NotImplementedError(
                "godunov_use_forces_in_trans is not ported yet (ROADMAP A8)")

    def predict(self, vel_g: torch.Tensor, forces_g: Optional[torch.Tensor],
                dt, ng: int, bcrecs: np.ndarray,
                gmacphi: Optional[List[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """vel_g grown by ng, forces_g grown by 1 (or None).  Returns the
        three MAC face arrays (n+1 along their own axis)."""
        self._check()
        if gmacphi is not None:
            raise NotImplementedError(
                "use_mac_phi_in_godunov is not ported yet (ROADMAP A8)")
        if not all(self.grid.periodic):
            return gk.predict_plain(self.grid, vel_g, forces_g, dt,
                                    self.use_ppm, bcrecs=bcrecs, ng=ng)
        vel = inner(vel_g, ng, self.nd)
        forces = inner(forces_g, 1, self.nd) if forces_g is not None \
            else None
        if mesh_of(self.grid) is not None:
            return gk.predict_sharded(self.grid, vel, forces, dt,
                                      self.use_ppm)
        return gk.predict(self.grid, vel, forces, dt, self.use_ppm)

    def advect(self, q_g: torch.Tensor, umac: Sequence[torch.Tensor],
               forces_g: Optional[torch.Tensor], dt, ng: int,
               bcrecs: np.ndarray, iconserv: Sequence[int],
               is_velocity: bool) -> torch.Tensor:
        """q_g grown by ng; umac interior face arrays (n+1 own axis).
        Returns dq/dt on the interior."""
        self._check()
        if not all(self.grid.periodic):
            return gk.advect_plain(self.grid, q_g, umac, forces_g, dt,
                                   tuple(int(i) for i in iconserv),
                                   self.use_ppm, bcrecs=bcrecs, ng=ng,
                                   is_velocity=is_velocity)
        q = inner(q_g, ng, self.nd)
        forces = inner(forces_g, 1, self.nd) if forces_g is not None \
            else None
        iconserv = tuple(int(i) for i in iconserv)
        if mesh_of(self.grid) is not None:
            return gk.advect_sharded(self.grid, q, umac, forces, dt,
                                     iconserv, self.use_ppm)
        return gk.advect(self.grid, q, umac, forces, dt, iconserv,
                         self.use_ppm)
