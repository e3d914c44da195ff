"""Checkpoint / plotfile I/O (port of incflo_tpu/utils/io.py), in the same
on-disk format: a checkpoint or plotfile written by either package is
read by the other.

Preserves the reference's persistence CONTRACT (src/utilities/io.cpp):
  * checkpoint = directory with a text `Header` (version, step, time, dt,
    prev dts, prob domain, cell counts) + per-level field data; restart
    reconstructs the state whatever the rank count.
  * plotfile = directory with a JSON `Header` listing the plotted fields
    + the field data; the error-vs-exact fields print
    "Norm0/Norm2 of xxx error" lines (the convergence-harness metric,
    reference io.cpp:482-561).

Data is stored as .npz (dense, layout-stable) rather than VisMF binaries;
the Header carries the same information.  A level split along x over a
SlabMesh (parallel/mesh.py) writes one Level_0.shard<rank>.npz per rank
with a manifest per rank (Shards.json on rank 0, Shards.p<rank>.json on
the others), the analog of per-rank VisMF files.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np
import torch

from incflo_torch import bcs
from incflo_torch.config import IncfloConfig
from incflo_torch.eb import ops as ebops
from incflo_torch.ops import derive, rheology
from incflo_torch.state import LevelState, SimState

HDR_VERSION = "Checkpoint version: 1"


LEVEL_FIELDS = ("velocity", "density", "tracer", "gp", "p", "mac_phi")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rank(mesh) -> int:
    return 0 if mesh is None else mesh.rank


def write_checkpoint(path: str, s: SimState, cfg: IncfloConfig, mesh=None):
    """Checkpoint directory with the reference Header contract
    (src/utilities/io.cpp:16-102).

    A whole level writes one Level_0.npz.  Given the SlabMesh its state
    is split over, every rank writes its own x slab to
    Level_0.shard<rank>.npz and a manifest of it -- Shards.json on rank 0,
    Shards.p<rank>.json on the others -- with no gather: every rank
    calls it, and no data crosses ranks."""
    rank = _rank(mesh)
    os.makedirs(path, exist_ok=True)
    grid = cfg.grid
    hdr = [
        HDR_VERSION,
        "1",                                     # number of levels
        f"{int(s.step)}",
        f"{float(s.t):.17g}",
        f"{float(s.dt):.17g}",
        f"{float(s.prev_dt):.17g}",
        f"{float(s.prev_prev_dt):.17g}",
        " ".join(f"{v:.17g}" for v in grid.prob_lo),
        " ".join(f"{v:.17g}" for v in grid.prob_hi),
        " ".join(str(n) for n in grid.n_cell),
        " ".join("1" if p else "0" for p in grid.periodic),
    ]
    if rank == 0:          # one Header; the rank writers race otherwise
        with open(os.path.join(path, "Header"), "w") as f:
            f.write("\n".join(hdr) + "\n")

    fields = {name: _numpy(getattr(s.level, name)) for name in LEVEL_FIELDS}
    if mesh is None:
        np.savez(os.path.join(path, "Level_0.npz"), **fields)
        return

    # the manifest format of incflo_tpu/utils/io.py:88-109: each field's
    # global shape and its blocks; a rank's block is its x rows
    # (SlabMesh.rows: where x ends in boundaries the last rank's block of
    # p holds node nx too)
    fname = f"Level_0.shard{rank}.npz"
    manifest = {"format": 1, "process": rank, "fields": {}}
    for name, data in fields.items():
        rows = grid.node_shape[0] if name == "p" else grid.n_cell[0]
        start = [mesh.rows(rows)[0]] + [0] * (data.ndim - 1)
        manifest["fields"][name] = {
            "shape": [rows] + list(data.shape[1:]),
            "entries": [{"file": fname, "start": start,
                         "shape": list(data.shape)}]}
    np.savez(os.path.join(path, fname), **fields)
    mname = "Shards.json" if rank == 0 else f"Shards.p{rank}.json"
    with open(os.path.join(path, mname), "w") as f:
        json.dump(manifest, f)


def _read_field_shards(path, name, meta, dtype, npz_cache, region=None):
    """Assemble (a region of) a field from its shard files.  region is a
    tuple of slices into the global array (None = whole array)."""
    gshape = tuple(meta["shape"])
    if region is None:
        region = tuple(slice(0, n) for n in gshape)
    rshape = tuple(sl.stop - sl.start for sl in region)
    out = np.empty(rshape, dtype)
    covered = np.zeros(rshape, bool)
    for e in meta["entries"]:
        start = e["start"]
        shp = e["shape"]
        src_sl, dst_sl = [], []
        empty = False
        for sl, s0, n in zip(region, start, shp):
            lo = max(sl.start, s0)
            hi = min(sl.stop, s0 + n)
            if hi <= lo:
                empty = True
                break
            src_sl.append(slice(lo - s0, hi - s0))
            dst_sl.append(slice(lo - sl.start, hi - sl.start))
        if empty:
            continue
        if e["file"] not in npz_cache:
            npz_cache[e["file"]] = np.load(os.path.join(path, e["file"]))
        out[tuple(dst_sl)] = npz_cache[e["file"]][name][tuple(src_sl)]
        covered[tuple(dst_sl)] = True
    if not covered.all():
        raise ValueError(
            f"checkpoint field '{name}': manifest entries do not cover "
            f"the requested region (missing {int((~covered).sum())} of "
            f"{covered.size} elements)")
    return out


def _merged_manifest(path):
    """Every rank's manifest (Shards.json, Shards.p<K>.json) merged."""
    manifest = None
    for mp in sorted(glob.glob(os.path.join(path, "Shards*.json"))):
        with open(mp) as f:
            m = json.load(f)
        if manifest is None:
            manifest = m
        else:
            for name, meta in m["fields"].items():
                manifest["fields"][name]["entries"].extend(meta["entries"])
    return manifest


def read_checkpoint(path: str, cfg: IncfloConfig, dtype, device=None,
                    mesh=None) -> SimState:
    """Restart from a checkpoint onto `device` (None: the mesh's device,
    else the card).  Given a SlabMesh, each rank loads only its own x
    slab: from a per-rank checkpoint it assembles the slab from the
    overlapping shard files and never reads the whole field, so the
    restart does not depend on the rank count that wrote it (reference
    io.cpp:195)."""
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    with open(os.path.join(path, "Header")) as f:
        lines = [l.rstrip("\n") for l in f]
    if lines[0] != HDR_VERSION:
        raise ValueError(f"bad checkpoint header: {lines[0]}")
    step = int(lines[2])
    t, dt, prev_dt, prev_prev_dt = (float(lines[i]) for i in range(3, 7))
    n_cell = tuple(int(v) for v in lines[9].split())
    if n_cell != cfg.grid.n_cell:
        raise ValueError(f"checkpoint grid {n_cell} != inputs grid "
                         f"{cfg.grid.n_cell}")
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def region(gshape):
        if mesh is None:
            return None
        start, count = mesh.rows(gshape[0])
        return ((slice(start, start + count),)
                + tuple(slice(0, n) for n in gshape[1:]))

    if os.path.exists(os.path.join(path, "Shards.json")):
        manifest = _merged_manifest(path)
        npz_cache: Dict[str, object] = {}

        def load(name):
            meta = manifest["fields"][name]
            return _read_field_shards(path, name, meta, np_dtype, npz_cache,
                                      region(tuple(meta["shape"])))
    else:
        d = np.load(os.path.join(path, "Level_0.npz"))

        def load(name):
            a = d[name]
            r = region(a.shape)
            return a if r is None else a[r]

    def tensor(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    lvl = LevelState(**{name: tensor(load(name)) for name in LEVEL_FIELDS})
    mk = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return SimState(level=lvl, t=mk(t), dt=mk(dt), prev_dt=mk(prev_dt),
                    prev_prev_dt=mk(prev_prev_dt),
                    step=torch.tensor(step, dtype=torch.int32,
                                      device=device))


# ---------------------------------------------------------------------
# plotfile
# ---------------------------------------------------------------------

def _whole(s: SimState, sim) -> SimState:
    """The whole level's state: on a mesh gathered from every rank (a
    collective)."""
    mesh = getattr(sim, "mesh", None)
    if mesh is None:
        return s
    return s._replace(level=LevelState(*(mesh.gather(f) for f in s.level)))


def _derived_fields(vel, grid, cfg, sim, want, grow) -> Dict[str, object]:
    """The plot fields that read ghost cells or the EB arrays (vort,
    strainrate, divu, eta, vfrac) of velocity `vel` on `grid`, grown by
    grow(vel, 2): the whole level, or a rank's slab (its EB arrays, the
    x ghosts from the neighbours) whose results the caller gathers."""
    eb = sim.eb
    out = {}
    vel_g = grow(vel, 2) \
        if {"vort", "strainrate", "divu", "eta"} & want else None
    if "vort" in want:
        out["vort"] = ebops.eb_vorticity(vel_g, grid, 2, eb) \
            if eb is not None else derive.vorticity(vel_g, grid, 2)
    if "strainrate" in want:
        out["strainrate"] = ebops.eb_strainrate(vel_g, grid, 2, eb) \
            if eb is not None else rheology.strainrate(vel_g, grid, 2)
    if "divu" in want:
        out["divu"] = derive.divu_cc(vel_g, grid, 2)
    if "eta" in want:
        out["eta"] = rheology.compute_viscosity(vel_g, grid, 2, cfg,
                                                out_ng=0, eb=eb)
    if "vfrac" in want:
        # reference plots the EB volume fraction (io.cpp vfrac field);
        # all-regular domains plot 1.0 like EB_set_covered semantics
        out["vfrac"] = eb.vfrac if eb is not None \
            else torch.ones(grid.cell_shape, dtype=torch.float64,
                            device=vel.device)
    return out


def _plot_fields(s: SimState, cfg: IncfloConfig, sim,
                 derived=None) -> Dict[str, np.ndarray]:
    """The plotted fields of the whole level's state s; derived: the
    fields of _derived_fields, given where they were computed on a
    mesh's slabs (else they are computed here, on the whole level)."""
    grid = cfg.grid
    lvl = s.level
    nd = grid.ndim
    out: Dict[str, np.ndarray] = {}
    names = {0: "velx", 1: "vely", 2: "velz"}
    gp_names = {0: "gpx", 1: "gpy", 2: "gpz"}
    want = set(cfg.plt_fields)
    if derived is None:
        # the whole level's ghost fill (sim.grow_vel on one device)
        derived = _derived_fields(
            lvl.velocity, grid, cfg, sim, want,
            lambda v, ng: bcs.grow(v, ng, grid, sim.vel_bcrec, sim.vel_ev))

    for c in range(nd):
        if names[c] in want:
            out[names[c]] = _numpy(lvl.velocity[..., c])
        if gp_names[c] in want:
            out[gp_names[c]] = _numpy(lvl.gp[..., c])
    if "rho" in want:
        out["rho"] = _numpy(lvl.density)
    if "tracer" in want:
        for n in range(cfg.ntrac):
            out[f"tracer{n}" if cfg.ntrac > 1 else "tracer"] = \
                _numpy(lvl.tracer[..., n])
    if "p" in want:
        out["p"] = _numpy(derive.node_to_cell(lvl.p, grid))
    if "macphi" in want:
        out["macphi"] = _numpy(lvl.mac_phi)
    for k in ("vort", "strainrate", "divu", "eta", "vfrac"):
        if k in derived:
            out[k] = _numpy(derived[k])
    if "forcing" in want:
        # instantaneous velocity forcing -(gp+gp0)/rho + g (or Boussinesq)
        f = sim.compute_vel_forces(lvl.density, lvl.tracer, lvl.tracer,
                                   lvl.gp)
        for c in range(nd):
            out[f"forcing{'xyz'[c]}"] = _numpy(f[..., c])
    return out


def gather_plot_fields(s: SimState, cfg: IncfloConfig, sim
                       ) -> Dict[str, np.ndarray]:
    """Build the plotted field dict per cfg.plt_fields + plt_error_*:
    whole-level numpy arrays, on every rank of a mesh (a collective): the
    fields that read ghost cells or the EB arrays computed on each rank's
    slab and gathered, the rest from the gathered state."""
    derived = _slab_derived(s, cfg, sim)
    return _plot_fields(_whole(s, sim), cfg, sim, derived)


def _slab_derived(s: SimState, cfg: IncfloConfig, sim):
    """On a mesh, _derived_fields of each rank's slab, gathered (a
    collective); None on one device."""
    mesh = getattr(sim, "mesh", None)
    if mesh is None:
        return None
    return {k: mesh.gather(v) for k, v in _derived_fields(
        s.level.velocity, sim.grid, cfg, sim, set(cfg.plt_fields),
        sim.grow_vel).items()}


def error_norm_fields(s: SimState, cfg: IncfloConfig) -> Dict[str, np.ndarray]:
    """error-vs-exact fields + printed norms (probtype 1/2 only;
    reference io.cpp:482-561 + incflo_error.cpp), of a whole level's
    state."""
    out = {}
    grid = cfg.grid
    lvl = s.level
    dtype, dev = lvl.velocity.dtype, lvl.velocity.device
    t, dt = float(s.t), float(s.dt)
    if cfg.plt_error_u or cfg.plt_error_v or cfg.plt_error_w:
        ex = derive.exact_velocity(cfg.probtype, grid, t, dtype, dev)
        sel = [("u", 0, cfg.plt_error_u), ("v", 1, cfg.plt_error_v)]
        if grid.ndim == 3:
            sel.append(("w", 2, cfg.plt_error_w))
        for nm, c, on in sel:
            if on:
                out[f"error_{nm}"] = _numpy(lvl.velocity[..., c] - ex[c])
    if cfg.plt_error_p:
        p_cc = derive.node_to_cell(lvl.p, grid)
        ex = derive.exact_pressure(cfg.probtype, grid, t, dt, dtype, dev)
        err = _numpy(p_cc - ex)
        out["error_p"] = err - err.mean()   # pressure defined up to constant
    if cfg.plt_error_mac_p:
        ex = derive.exact_pressure(cfg.probtype, grid, t, dt, dtype, dev)
        err = _numpy(lvl.mac_phi - ex)
        out["error_mac_p"] = err - err.mean()
    return out


def print_error_norms(fields: Dict[str, np.ndarray]):
    """The lines the convergence_{2d,3d}/todo_print harness greps."""
    name_map = {"error_u": "u", "error_v": "v", "error_w": "w",
                "error_p": "p", "error_mac_p": "mac_p"}
    for k, v in fields.items():
        if k not in name_map:
            continue
        nm = name_map[k]
        n0 = np.max(np.abs(v))
        n2 = np.sqrt(np.mean(v ** 2))
        print(f"  Norm0 of {nm} error {n0:.12e}")
        print(f"  Norm2 of {nm} error {n2:.12e}")


def write_plotfile(path: str, s: SimState, cfg: IncfloConfig, sim):
    """Write the plotfile; on a mesh every rank calls it (the fields are
    gathered) and rank 0 prints and writes.  Returns the fields."""
    derived = _slab_derived(s, cfg, sim)
    s = _whole(s, sim)
    fields = _plot_fields(s, cfg, sim, derived)
    err = error_norm_fields(s, cfg) if cfg.probtype in (1, 2) and (
        cfg.plt_error_u or cfg.plt_error_v or cfg.plt_error_w
        or cfg.plt_error_p or cfg.plt_error_mac_p) else {}
    lead = _rank(getattr(sim, "mesh", None)) == 0
    if lead and err:
        print_error_norms(err)
    fields.update(err)
    if not lead:
        return fields
    os.makedirs(path, exist_ok=True)
    hdr = {
        "version": "IncfloTPU-Plotfile-1",
        "step": int(s.step), "time": float(s.t), "dt": float(s.dt),
        "prob_lo": list(cfg.grid.prob_lo), "prob_hi": list(cfg.grid.prob_hi),
        "n_cell": list(cfg.grid.n_cell),
        "fields": sorted(fields.keys()),
    }
    with open(os.path.join(path, "Header"), "w") as f:
        json.dump(hdr, f, indent=1)
    np.savez(os.path.join(path, "Level_0.npz"), **fields)
    return fields


def write_plotfile_amr(path: str, s: SimState, amrsim, cfg: IncfloConfig):
    """Multi-level plotfile of the dense-fine driver (amr.AMRSimulation):
    Level_l.npz holds the level-l view of the solution (average_down)
    plus its refinement mask; the Header lists the hierarchy like the
    reference's WriteMultiLevelPlotfile (incflo_tpu/utils/io.py:348).  On
    a mesh every rank calls it (the fields and masks are gathered) and
    rank 0 writes."""
    from incflo_torch.amr import average_down
    mesh = amrsim.mesh
    fine_fields = gather_plot_fields(s, amrsim.fine_cfg, amrsim.sim)
    masks = amrsim.masks
    if amrsim.sim.mesh is not None:     # a split fine level's rows
        masks = [None if m is None
                 else amrsim.sim.mesh.gather(m.to(torch.uint8)).bool()
                 for m in masks]
    if _rank(mesh) != 0:
        return fine_fields
    os.makedirs(path, exist_ok=True)
    nd = cfg.grid.ndim
    for lev in range(amrsim.max_level + 1):
        r = amrsim.ratio ** (amrsim.max_level - lev)
        out = {k: _numpy(average_down(torch.as_tensor(v), r, nd))
               if r > 1 else v for k, v in fine_fields.items()}
        if lev < amrsim.max_level and masks[lev] is not None:
            out["refine_mask"] = _numpy(masks[lev])
        np.savez(os.path.join(path, f"Level_{lev}.npz"), **out)
    hdr = {
        "version": "IncfloTPU-Plotfile-1",
        "step": int(s.step), "time": float(s.t), "dt": float(s.dt),
        "prob_lo": list(cfg.grid.prob_lo), "prob_hi": list(cfg.grid.prob_hi),
        "n_cell": list(cfg.grid.n_cell),
        "finest_level": amrsim.max_level,
        "ref_ratio": amrsim.ratio,
        "fields": sorted(fine_fields.keys()),
    }
    with open(os.path.join(path, "Header"), "w") as f:
        json.dump(hdr, f, indent=1)
    return fine_fields


# ---------------------------------------------------------------------
# patch AMR tree I/O (amr_patch.py; incflo_tpu/utils/io.py:398-482)
# ---------------------------------------------------------------------

def write_plotfile_patch(path: str, state, amr, cfg: IncfloConfig):
    """Plotfile of the patch tree: Level_i.npz holds entry i's OWN
    solution over its own (sub)domain and its placement (patch_lo /
    patch_hi in parent cells, refine_mask of its children); the Header
    the tree.  On a mesh every rank calls it (the split levels' fields
    are gathered) and rank 0 writes."""
    lead = _rank(amr.mesh) == 0
    if lead:
        os.makedirs(path, exist_ok=True)
    for i, (sim, s) in enumerate(zip(amr.sims, state.levels)):
        fields = gather_plot_fields(s, sim.cfg, sim)
        if not lead:
            continue
        if i > 0:
            fields["patch_lo"] = np.asarray(amr.bounds[i][0])
            fields["patch_hi"] = np.asarray(amr.bounds[i][1])
        if amr.masks[i] is not None:
            fields["refine_mask"] = np.asarray(amr.masks[i])
        np.savez(os.path.join(path, f"Level_{i}.npz"), **fields)
    if not lead:
        return
    hdr = {
        "version": "IncfloTPU-Plotfile-1",
        "step": int(state.step), "time": float(state.t),
        "dt": float(state.dt),
        "prob_lo": list(cfg.grid.prob_lo), "prob_hi": list(cfg.grid.prob_hi),
        "n_cell": list(cfg.grid.n_cell),
        "finest_level": max(amr.level_of),
        "ref_ratio": cfg.ref_ratio,
        "patch_axis": amr.axis,
        "patch_bounds": [list(b) for b in amr.bounds],
        "patch_parents": list(amr.parent),
        "patch_levels": list(amr.level_of),
    }
    with open(os.path.join(path, "Header"), "w") as f:
        json.dump(hdr, f, indent=1)


def write_checkpoint_patch(path: str, state, amr, cfg: IncfloConfig):
    """Checkpoint of every tree entry (patch_level_<i>/) and the tree
    (Patch.json) that read_checkpoint_patch rebuilds.  On a mesh every
    rank calls it: each split level is written per rank (one shard a
    rank, write_checkpoint), and rank 0 alone writes the replicated
    levels, whole, and the tree."""
    lead = _rank(amr.mesh) == 0
    for i, s in enumerate(state.levels):
        sim = amr.sims[i]
        if sim.mesh is not None or lead:
            write_checkpoint(os.path.join(path, f"patch_level_{i}"), s,
                             sim.cfg, sim.mesh)
    if lead:
        with open(os.path.join(path, "Patch.json"), "w") as f:
            json.dump(amr.tree_meta(), f)


def read_checkpoint_patch(path: str, amr, cfg: IncfloConfig):
    """Rebuild the tree recorded by write_checkpoint_patch (either
    package's; a pre-tree record is a chain of one patch a level, and
    legacy slab bounds [lo, hi] lie along the recorded axis) in `amr` and
    load every entry's state onto amr's device: on a mesh a split
    level's slab and a replicated level whole, whatever the rank count
    that wrote them."""
    with open(os.path.join(path, "Patch.json")) as f:
        meta = json.load(f)
    return amr.load_tree(meta, lambda i, sim: read_checkpoint(
        os.path.join(path, f"patch_level_{i}"), sim.cfg, amr.dtype,
        amr.device, sim.mesh))


def write_job_info(path: str, cfg: IncfloConfig, device="cpu"):
    """Provenance dump (reference WriteJobInfo, io.cpp:228-313): the
    package and torch versions and the card's name for a run on `device`
    (or "cpu")."""
    import incflo_torch
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "incflo_job_info"), "w") as f:
        f.write("incflo_torch version: %s\n" % incflo_torch.__version__)
        f.write("ndim: %d\nn_cell: %s\n" % (cfg.ndim, cfg.grid.n_cell,))
        f.write("torch: %s\n" % torch.__version__)
        device = torch.device(device)
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        f.write("devices: %s\n" % name)
        f.write("\n== full inputs ==\n")
        if cfg.pp is not None:
            f.write(cfg.pp.dump() + "\n")
