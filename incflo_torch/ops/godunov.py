"""Godunov (corner-transport-upwind) advection: port of
incflo_tpu/ops/godunov.py:127-803.

  predict():  half-time face-normal velocities for the MAC projection.
  advect():   dq/dt = -div(umac q) (iconserv) or -(u.grad)q with full
              corner-transport transverse corrections.

On a 3D fully periodic grid the chain has no boundary forms, so both
dispatch to ops/godunov_kernels (the CUDA kernels on the card, their
plain PyTorch versions on the CPU).  Every other case takes the general
form of the plain chain (ops/godunov_walls.py) on grown arrays, on
either device, as incflo_tpu runs such cases through its jnp Godunov and
not through its Pallas kernels (pallas_godunov.supported asks for 3D and
every axis periodic, and godunov.py:475,648 send use_forces_in_trans
past them): a 2D grid, a grid with a wall, and use_forces_in_trans.
With use_mac_phi_in_godunov only predict, which takes the MAC-phi face
gradient, runs the plain chain (godunov.py:475); advect, which that
option does not enter, keeps the kernel (godunov.py:648 gates on
use_forces_in_trans alone).  The choice is made here, from the grid and
the deck alone.
On an x slab of a mesh (grid.mesh) a fully periodic grid's chain takes
the halo-slab forms, predict_sharded and advect_sharded, as
incflo_tpu/ops/godunov.py:482-491 and :657-667 dispatch to
pallas_godunov's; a slab of any other grid the general plain chain.
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

    def _plain_chain(self) -> bool:
        """True where the kernels do not run: 2D, a wall, or forces in
        the transverse traces."""
        return self.nd != 3 or not all(self.grid.periodic) or self.uft

    def predict(self, vel_g: torch.Tensor, forces_g: Optional[torch.Tensor],
                dt, ng: int, bcrecs: np.ndarray,
                gmacphi: Optional[List[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """vel_g grown by ng, forces_g grown by 1 (or None).  Returns the
        MAC face arrays (n+1 along their own axis).  gmacphi: the
        use_mac_phi_in_godunov face gradient -(1/rho) grad(mac_phi)."""
        if self._plain_chain() or gmacphi is not None:
            return gk.predict_plain(self.grid, vel_g, forces_g, dt,
                                    self.use_ppm, bcrecs=bcrecs, ng=ng,
                                    use_forces_in_trans=self.uft,
                                    gmacphi=gmacphi)
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
        iconserv = tuple(int(i) for i in iconserv)
        if self._plain_chain():
            return gk.advect_plain(self.grid, q_g, umac, forces_g, dt,
                                   iconserv, self.use_ppm, bcrecs=bcrecs,
                                   ng=ng, is_velocity=is_velocity,
                                   use_forces_in_trans=self.uft)
        q = inner(q_g, ng, self.nd)
        forces = inner(forces_g, 1, self.nd) if forces_g is not None \
            else None
        if mesh_of(self.grid) is not None:
            return gk.advect_sharded(self.grid, q, umac, forces, dt,
                                     iconserv, self.use_ppm)
        return gk.advect(self.grid, q, umac, forces, dt, iconserv,
                         self.use_ppm)
