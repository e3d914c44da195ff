"""Diagnostics: max-value prints, NaN checks, kinetic energy, steady state
(port of incflo_tpu/utils/diagnostics.py).

The reference stubs most of these (src/utilities/diagnostics.cpp:8-85
`#if 0`, incflo_steady_state.cpp "Abort(TODO)"); they follow the
reference's documented spec.  Given the SlabMesh of a level split along
x (parallel/mesh.py), each reduces over the ranks, so every rank returns
the whole level's value (a collective: every rank calls it).
"""

from __future__ import annotations

import torch

from incflo_torch.parallel.mesh import mesh_of
from incflo_torch.state import LevelState


def _max(t: torch.Tensor, mesh) -> float:
    m = torch.max(t)
    return float(m if mesh is None else mesh.all_reduce_max(m))


def _sum(t: torch.Tensor, mesh) -> float:
    s = torch.sum(t)
    return float(s if mesh is None else mesh.all_reduce_sum(s))


def max_values(lvl: LevelState, mesh=None) -> dict:
    """PrintMaxValues payload: max |u|,|v|,|w|, |gp|, rho/tracer ranges."""
    nd = lvl.velocity.shape[-1]
    out = {}
    names = "uvw"
    for d in range(nd):
        out[f"max_{names[d]}"] = _max(lvl.velocity[..., d].abs(), mesh)
        out[f"max_gp{'xyz'[d]}"] = _max(lvl.gp[..., d].abs(), mesh)
    out["rho_min"] = -_max(-lvl.density, mesh)
    out["rho_max"] = _max(lvl.density, mesh)
    out["max_p"] = _max(lvl.p.abs(), mesh)
    return out


def print_max_values(lvl: LevelState, time: float, mesh=None):
    """Print max_values' line; on a mesh every rank calls it and rank 0
    prints."""
    mv = max_values(lvl, mesh)
    if mesh is not None and mesh.rank != 0:
        return
    print(f"  t = {time:.8g}: " + "  ".join(f"{k}={v:.6g}"
                                            for k, v in mv.items()))


def check_for_nans(lvl: LevelState, mesh=None) -> bool:
    """True if any state field contains a non-finite value."""
    bad = torch.zeros((), dtype=torch.float32, device=lvl.velocity.device)
    for f in (lvl.velocity, lvl.density, lvl.tracer, lvl.gp, lvl.p):
        bad = torch.maximum(bad, (~torch.isfinite(f)).any().float())
    return _max(bad, mesh) > 0.0


def kinetic_energy(lvl: LevelState, grid, mesh=None) -> float:
    """0.5 * integral(rho |u|^2) (the reference's KE_int hook,
    ComputeKineticEnergy stub).  On a rank's slab grid (SlabGrid) the
    mesh defaults to the grid's."""
    mesh = mesh_of(grid) if mesh is None else mesh
    vol = 1.0
    for d in grid.dx:
        vol *= d
    ke = 0.5 * _sum(lvl.density * torch.sum(lvl.velocity ** 2, dim=-1),
                    mesh) * vol
    return float(ke)


def steady_state_reached(old: LevelState, new: LevelState, dt,
                         tol: float, mesh=None) -> bool:
    """The spec'd formula from reference incflo_steady_state.cpp:5-17
    (stubbed there): max |u_new - u_old| / dt < tol, or the relative L1
    change < tol."""
    diff = torch.abs(new.velocity - old.velocity)
    max_change = _max(diff, mesh) / float(dt)
    denom = _sum(torch.abs(new.velocity), mesh)
    rel_l1 = _sum(diff, mesh) / max(denom, 1e-300)
    return max_change < tol or rel_l1 < tol
