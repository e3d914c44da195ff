"""Simulation state of torch tensors (port of incflo_tpu/state.py).

One dense tensor per field, no ghost cells stored, old/new pairs handled
functionally by the step.  Field layout (C order, x index first,
components last), the same as incflo_tpu:
  velocity : (*cell_shape, ndim)
  density  : (*cell_shape)
  tracer   : (*cell_shape, ntrac)
  gp       : (*cell_shape, ndim)   lagged pressure gradient (state!)
  p        : (*node_shape)         node-centred pressure
  mac_phi  : (*cell_shape)         MAC-projection potential (warm start)

`level_from_numpy` / `sim_from_numpy` take a dict of numpy arrays keyed
by the field names (e.g. `np.asarray(jax_state.level.velocity)`), so a
run can start from another package's state; the `*_to_numpy` pair goes
the other way.  `patch_from_numpy` / `patch_to_numpy` do the same for a
patch AMR tree: the tree's record (axis, bounds, parents, levels) and
one such dict per entry, as incflo_tpu's SlabAMRSimulation and its
PatchState hold them.
Given the SlabMesh of a level split along x (parallel/mesh.py),
`*_from_numpy` keep the rank's x slab of whole-level arrays, and
`*_to_numpy` gather the whole level from every rank's slab (a
collective: every rank calls them).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from incflo_torch.grid import Grid


class LevelState(NamedTuple):
    velocity: torch.Tensor
    density: torch.Tensor
    tracer: torch.Tensor
    gp: torch.Tensor
    p: torch.Tensor
    mac_phi: torch.Tensor


class SimState(NamedTuple):
    """Whole-simulation state advanced by one step.  The scalars are 0-d
    tensors on the state's device, so a step never syncs for them."""
    level: LevelState
    t: torch.Tensor
    dt: torch.Tensor
    prev_dt: torch.Tensor
    prev_prev_dt: torch.Tensor
    step: torch.Tensor          # int32


_SCALARS = ("t", "dt", "prev_dt", "prev_prev_dt")


def zeros_level(grid: Grid, ntrac: int, dtype, device) -> LevelState:
    cs = grid.cell_shape
    ns = grid.node_shape
    d = grid.ndim
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return LevelState(
        velocity=z(cs + (d,)),
        density=torch.ones(cs, dtype=dtype, device=device),
        tracer=z(cs + (ntrac,)),
        gp=z(cs + (d,)),
        p=z(ns),
        mac_phi=z(cs),
    )


def level_from_numpy(d: Dict[str, np.ndarray], device, dtype,
                     mesh=None) -> LevelState:
    """The level from whole-level arrays; on a mesh the rank's slab."""
    def field(a):
        t = torch.tensor(np.asarray(a), dtype=dtype)
        return t if mesh is None else mesh.slab(t).contiguous()
    return LevelState(**{k: field(d[k]).to(device)
                         for k in LevelState._fields})


def level_to_numpy(level: LevelState, mesh=None) -> Dict[str, np.ndarray]:
    """Whole-level arrays; on a mesh gathered from every rank."""
    def full(t):
        return t if mesh is None else mesh.gather(t)
    return {k: full(getattr(level, k).detach()).cpu().numpy()
            for k in LevelState._fields}


def sim_from_numpy(d: Dict[str, np.ndarray], device, dtype,
                   mesh=None) -> SimState:
    """`d` holds the LevelState fields and t, dt, prev_dt, prev_prev_dt,
    step."""
    sc = {k: torch.tensor(np.asarray(d[k]), dtype=dtype).to(device)
          for k in _SCALARS}
    step = torch.tensor(np.asarray(d["step"]), dtype=torch.int32).to(device)
    return SimState(level=level_from_numpy(d, device, dtype, mesh),
                    step=step, **sc)


def sim_to_numpy(s: SimState, mesh=None) -> Dict[str, np.ndarray]:
    out = level_to_numpy(s.level, mesh)
    for k in _SCALARS + ("step",):
        out[k] = getattr(s, k).detach().cpu().numpy()
    return out


def patch_from_numpy(amr, meta, levels, device=None, dtype=None):
    """Rebuild the tree of `amr` (an amr_patch.SlabAMRSimulation) from
    `meta` ({"axis", "bounds", "parents", "levels", "nlevels"}, the
    record of a patch checkpoint's Patch.json) and return the
    amr_patch.PatchState of the per-entry dicts `levels` (as for
    sim_from_numpy: whole-level arrays), on amr's device and dtype unless
    given.  On a mesh each split level keeps the rank's slab, and a
    replicated one the whole level."""
    device = amr.device if device is None else device
    dtype = amr.dtype if dtype is None else dtype
    return amr.load_tree(
        meta, lambda i, sim: sim_from_numpy(levels[i], device, dtype,
                                            sim.mesh))


def patch_to_numpy(amr, ps):
    """The per-entry whole-level dicts of a patch tree's state (as
    sim_to_numpy): on a mesh the split levels gathered from every rank
    (a collective), the replicated ones as each rank holds them."""
    return [sim_to_numpy(s, sim.mesh) for sim, s in zip(amr.sims, ps.levels)]
