"""Jobs for the ranks of incflo_torch.parallel.launch: each is
job(mesh, **kwargs) and returns numpy arrays and numbers.  They live in
the package, so a spawned rank imports incflo_torch and nothing else."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def halo(mesh, field, lo, hi):
    """halo_x of this rank's slab of `field` (a whole-level array)."""
    full = torch.as_tensor(field).to(mesh.device)
    return mesh.halo_x(mesh.slab(full), lo, hi).cpu().numpy()


def node_rows(mesh, field, lo, hi):
    """This rank's rows of a whole-level node field of an x that ends in
    boundaries (nx + 1 rows; SlabMesh.rows), its halo of (lo, hi) rows
    with nothing across the level's x faces, and the whole field back by
    gather and by all_gather_x."""
    full = torch.as_tensor(field).to(mesh.device)
    mine = mesh.slab(full)
    return {"slab": mine.cpu().numpy(),
            "halo": mesh.halo_x(mine, lo, hi, periodic=False).cpu().numpy(),
            "gather": mesh.gather(mine).cpu().numpy(),
            "all_gather": mesh.all_gather_x(
                mine, extra_last=True).cpu().numpy()}


def several(mesh, jobs):
    """Several jobs in one spawn: jobs is a list of (name, kwargs) of
    functions of this module, or (key, name, kwargs) to run one function
    more than once; returns their results by name (or key)."""
    out = {}
    for job in jobs:
        key, name, kw = job if len(job) == 3 else (job[0],) + tuple(job)
        out[key] = globals()[name](mesh, **kw)
    return out


def wait_for(mesh, path, timeout=900.0):
    """Waits until the file `path` exists -- another process's word that
    the jobs after this one may start -- at most `timeout` seconds, then
    meets the other ranks.  Returns the seconds it waited."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"wait_for: no {path} after {timeout} s")
        time.sleep(0.05)
    mesh.barrier()
    return time.monotonic() - t0


def _level_grid(n_cell, prob_hi):
    """A fully periodic level of n_cell cells (2D or 3D) on [0, prob_hi]."""
    from incflo_torch.grid import Grid
    nd = len(n_cell)
    return Grid(tuple(n_cell), (0.0,) * nd, tuple(prob_hi), (True,) * nd)


def godunov(mesh, n_cell, prob_hi, vel, forces, q, umac, dt, use_ppm,
            iconserv):
    """predict_sharded and advect_sharded on this rank's slab of the
    whole-level fields (umac in the standard n+1 layout; advect takes the
    slab's nxl + 1 x faces of it).  Returns the slab's results."""
    from incflo_torch.ops import godunov_kernels as gk
    grid = mesh.local_grid(_level_grid(n_cell, prob_hi))
    nxl = grid.n_cell[0]
    dev = mesh.device
    t = lambda a: torch.as_tensor(a).to(dev)
    slab = lambda a: mesh.slab(t(a)).contiguous()
    umac_slab = [t(umac[0]).narrow(0, grid.x0, nxl + 1).contiguous()] \
        + [slab(u) for u in umac[1:]]
    pred = gk.predict_sharded(grid, slab(vel), slab(forces), dt, use_ppm)
    rate = gk.advect_sharded(grid, slab(q), umac_slab, slab(forces), dt,
                             iconserv, use_ppm)
    return {"predict": [a.cpu().numpy() for a in pred],
            "advect": rate.cpu().numpy()}


def solves(mesh, deck, rhs_cell, rhs_node, rhs_vec, beta):
    """The prebuilt direct solvers of a deck's sharded Simulation (MAC,
    nodal, Helmholtz with beta) on this rank's slabs of the right-hand
    sides, and their operators applied to those slabs (cell_apply,
    nodal_apply and the MAC fluxes, whose x pads cross ranks)."""
    from incflo_torch import IncfloConfig, Simulation
    from incflo_torch.ops import multigrid as mg
    sim = Simulation(IncfloConfig.from_text(deck), device=mesh.device,
                     mesh=mesh)
    slab = lambda a: mesh.slab(torch.as_tensor(a).to(mesh.device))
    helm = sim._diff_proto.with_beta(beta)
    mac_lev = sim._mac_solver.levels[0]
    out = {
        "mac": sim._mac_solver.solve(slab(rhs_cell)),
        "nodal": sim._nodal_hat.solve(slab(rhs_node)),
        "helmholtz": helm.solve(slab(rhs_vec)),
        "mac_apply": mg.cell_apply(slab(rhs_cell), mac_lev),
        "nodal_apply": mg.nodal_apply(slab(rhs_node),
                                      sim._nodal_hat.levels[0]),
        "helmholtz_apply": mg.cell_apply(slab(rhs_vec), helm.levels[0]),
        "mac_flux_x": mg.cell_fluxes(slab(rhs_cell), mac_lev)[0]}
    return {k: v.cpu().numpy() for k, v in out.items()}


def scope_errors(mesh, decks, on_default_device=(), dense=()):
    """The error each deck raises when its driver splits it over this
    mesh ((type name, message), or None if it builds): a Simulation, or
    for an AMR deck the patch tree (amr_patch.SlabAMRSimulation; for the
    decks named in `dense` the dense fine level, amr.AMRSimulation); the
    decks named in on_default_device are built without a device
    argument.  Under "SlabMesh()": the same for a SlabMesh built without
    a device."""
    from incflo_torch import IncfloConfig, Simulation
    from incflo_torch.amr import AMRSimulation
    from incflo_torch.amr_patch import SlabAMRSimulation
    from incflo_torch.parallel.mesh import SlabMesh

    def make(deck, name):
        cfg = IncfloConfig.from_text(deck)
        driver = Simulation if cfg.max_level == 0 else \
            AMRSimulation if name in dense else SlabAMRSimulation
        return driver(cfg, device=None if name in on_default_device
                      else mesh.device, mesh=mesh)
    builds = {name: (lambda deck=deck, name=name: make(deck, name))
              for name, deck in decks.items()}
    builds["SlabMesh()"] = SlabMesh
    out = {}
    for name, build in builds.items():
        try:
            build()
            out[name] = None
        except (NotImplementedError, RuntimeError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# the iterative solves' tallies a step reports (multigrid.COUNTS): CG
# iterations of the cell solves, V-cycles of the nodal ones, iterations
# of the tensor CG
ITER_KINDS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")


def steps(mesh, deck, nsteps, start=None, perturb=None):
    """The deck's init (or the whole-level state `start`, carried over
    rank by rank; perturb: a whole-level array added to the velocity
    after init) and `nsteps` steps on this rank's slab (or on the whole
    level, where it does not split and is held whole on every rank).
    Returns the whole-level states after init and after each step (rank
    0 only), whether the level is split, the
    tensor CG's iterations in each step, this rank's tallies of each
    step (ITER_KINDS; the first entry init's), its solver tallies,
    Godunov and smoother launches, the 27-point (9-point) EB nodal and
    2D flux-form slab sweep calls (multigrid.STENCIL_SLAB, SLAB_2D), and
    its exchanges by kind (calls)."""
    from incflo_torch import IncfloConfig, Simulation, state
    from incflo_torch.ops import godunov_kernels as gk
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    sim = Simulation(IncfloConfig.from_text(deck), device=mesh.device,
                     mesh=mesh)
    mg.reset_counts()
    gk.reset_launches()
    sk.reset_launches()
    mesh.reset_stats()
    s = sim.init_state() if start is None else state.sim_from_numpy(
        start, mesh.device, sim.dtype, sim.mesh)
    if perturb is not None:
        s = _perturbed(s, sim.mesh, perturb)
    states = [state.sim_to_numpy(s, sim.mesh)]
    tallies = [{k: mg.COUNTS[k] for k in ITER_KINDS}]
    for _ in range(nsteps):
        before = dict(mg.COUNTS)
        s = sim.advance(s)
        tallies.append({k: mg.COUNTS[k] - before[k] for k in ITER_KINDS})
        states.append(state.sim_to_numpy(s, sim.mesh))
    return {"states": states if mesh.rank == 0 else None,
            "split": sim.mesh is not None,
            "cg_trips": [t["tensor_cg_iters"] for t in tallies[1:]],
            "tallies": tallies, "counts": dict(mg.COUNTS),
            "launches": dict(gk.LAUNCHES),
            "smoother_launches": dict(sk.LAUNCHES),
            "stencil_slab_calls": mg.STENCIL_SLAB["calls"],
            "slab_2d_calls": dict(mg.SLAB_2D),
            "comm": {k: v["calls"] for k, v in mesh.stats.items()},
            "mesh": mesh.describe()}


@contextlib.contextmanager
def level_tallies(amr, tallies):
    """A context in which each step and re-projection of an AMR driver's
    levels (Simulation._advance_impl, reproject) adds, under its tree
    level in the dict it yields (the dense driver's fine level: 0), what
    it adds to the counters `tallies` ({name: dict of counts}: the
    kernel launches, the 2D slab sweeps, ...)."""
    from incflo_torch.simulation import Simulation
    out = {}
    saved = {name: getattr(Simulation, name)
             for name in ("_advance_impl", "reproject")}

    def counted(fn):
        def wrapped(sim, *args, **kwargs):
            before = {k: dict(t) for k, t in tallies.items()}
            try:
                return fn(sim, *args, **kwargs)
            finally:
                lev = out.setdefault(
                    amr.level_of[amr.sims.index(sim)] if hasattr(
                        amr, "level_of") else 0, {})
                for k, t in tallies.items():
                    got = lev.setdefault(k, dict.fromkeys(t, 0))
                    for c in t:
                        got[c] += t[c] - before[k][c]
        return wrapped
    try:
        for name, fn in saved.items():
            setattr(Simulation, name, counted(fn))
        yield out
    finally:
        for name, fn in saved.items():
            setattr(Simulation, name, fn)


def amr_steps(mesh, deck, nsteps, dense=False, moved=None):
    """An AMR deck split over the mesh: the patch tree
    (amr_patch.SlabAMRSimulation) or, dense, the dense fine level
    (amr.AMRSimulation), from its init through `nsteps` steps and then, for each dict of IncfloConfig fields in `moved`
    (e.g. a moved tag region), a regrid with them.  Returns the whole
    tree after init and after each step and each regrid, as (tree
    record, per-entry dicts) -- dense: (None, [fine level, its masks])
    -- on rank 0 only; this rank's tallies of each step (ITER_KINDS; the
    first entry init's), each step's dt (a float: the same bits on every
    rank), which entries are split (each state), the steps' exchanges by
    kind (calls), and per tree level the smoother launches, Godunov launches
    and 2D slab sweep calls of the steps and re-projections, the steps'
    nodal solves that iterated (residual / tolerance, V-cycles, maxiter;
    multigrid.NODAL_LOG); the host seconds of the setup (the driver and
    its init) and of the steps (device synchronised)."""
    import dataclasses
    import time
    from incflo_torch import IncfloConfig, state
    from incflo_torch.amr import AMRSimulation
    from incflo_torch.amr_patch import SlabAMRSimulation
    from incflo_torch.ops import godunov_kernels as gk
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    sync = (lambda: torch.cuda.synchronize(mesh.device)) \
        if mesh.device.type == "cuda" else (lambda: None)
    mg.reset_counts()
    gk.reset_launches()
    sk.reset_launches()
    mesh.reset_stats()
    t0 = time.perf_counter()
    cfg = IncfloConfig.from_text(deck)
    amr = (AMRSimulation if dense else SlabAMRSimulation)(
        cfg, device=mesh.device, mesh=mesh)
    s = amr.init_state()
    sync()
    setup_s = time.perf_counter() - t0

    def record():
        if dense:
            fine = amr.sim.mesh
            masks = [None if m is None else m.cpu().numpy() if fine is None
                     else fine.gather(m.to(torch.uint8)).bool().cpu().numpy()
                     for m in amr.masks]
            return None, [state.sim_to_numpy(s, fine), masks]
        return amr.tree_meta(), state.patch_to_numpy(amr, s)

    def split():
        return [amr.sim.mesh is not None] if dense else \
            [sim.mesh is not None for sim in amr.sims]

    states, forms = [record()], [split()]
    tallies = [{k: mg.COUNTS[k] for k in ITER_KINDS}]
    dts = []
    mesh.barrier()
    step_s = 0.0
    mg.NODAL_LOG = []
    with level_tallies(amr, {"smoother": sk.LAUNCHES,
                             "godunov": gk.LAUNCHES,
                             "slab_2d": mg.SLAB_2D}) as per_level:
        comm = dict.fromkeys(mesh.stats, 0)
        for _ in range(nsteps):
            before = dict(mg.COUNTS)
            calls = {k: v["calls"] for k, v in mesh.stats.items()}
            t1 = time.perf_counter()
            s = amr.advance(s)
            sync()
            step_s += time.perf_counter() - t1
            for k, v in mesh.stats.items():
                comm[k] += v["calls"] - calls[k]
            tallies.append({k: mg.COUNTS[k] - before[k] for k in ITER_KINDS})
            dts.append(float(s.dt))
            states.append(record())
            forms.append(split())
    nodal = [(float(res) / float(tol), it, maxiter)
             for res, tol, it, maxiter in mg.NODAL_LOG]
    mg.NODAL_LOG = None
    for fields in moved or ():
        amr.cfg = dataclasses.replace(amr.cfg, **fields)
        amr.sim0.cfg = amr.cfg
        s = amr.regrid(s)
        states.append(record())
        forms.append(split())
    return {"states": states if mesh.rank == 0 else None,
            "tallies": tallies, "dts": dts, "split": forms,
            "comm": comm, "per_level": per_level, "nodal_solves": nodal,
            "setup_s": setup_s,
            "ms_per_step": step_s / max(nsteps, 1) * 1e3,
            "mesh": mesh.describe()}


def context_of(amr, old, new):
    """The coarse-fine context of every patch of a patch tree (amr, on
    one rank or a rank of a mesh) rebuilt from the whole-level trees old
    and new ((meta, per-entry dicts) of one tree at two times): each
    patch's set_context from its parent's new state with the old one's
    ghosts -- its interpolated windows (PatchEV.full: velocity, density,
    tracer), the Dirichlet face values of its MAC, velocity and tracer
    solves and its nodal Dirichlet values -- then its init_from_parent
    and the parent state after its _sync_down.  Returns, per patch,
    numpy arrays as this rank holds them (a split patch's slab, a
    replicated one whole)."""
    from incflo_torch import state
    from incflo_torch.amr_patch import _rows
    olds = state.patch_from_numpy(amr, *old).levels
    news = state.patch_from_numpy(amr, *new).levels
    faces = lambda d: {f"{ax} {side}": v for (ax, side), v in d.items()}
    out = []
    for i in range(1, len(amr.sims)):
        sim, p = amr.sims[i], amr.parent[i]
        sim.set_context(news[p].level, parent_lvl_old=olds[p].level)
        init = sim.init_from_parent(news[p]).level
        synced = amr._sync_down(news[p], news[i], amr.bounds[i],
                                _rows(sim), _rows(amr.sims[p])).level
        out.append(_numpy_tree({
            "split": sim.mesh is not None,
            "full": {"velocity": sim.vel_ev.full, "density": sim.den_ev.full,
                     "tracer": sim.tra_ev.full},
            "mac_bvals": faces(sim._mac_bvals),
            "vel_bvals": faces(sim._vel_bvals),
            "tra_bvals": faces(sim._tra_bvals),
            "nodal_dvals": faces(sim._nodal_dvals),
            "init": init._asdict(), "synced": synced._asdict()}))
    return out


def patch_context(mesh, deck, old, new):
    """context_of a deck's patch tree split over the mesh."""
    from incflo_torch import IncfloConfig
    from incflo_torch.amr_patch import SlabAMRSimulation
    amr = SlabAMRSimulation(IncfloConfig.from_text(deck),
                            device=mesh.device, mesh=mesh)
    return context_of(amr, old, new)


def amr_checkpoint(mesh, deck, nsteps, path, whole=None):
    """Per-rank patch-tree checkpoints (utils/io.py): the deck's init and
    `nsteps` steps split over the mesh, written to `path` (each split
    level one shard a rank, the replicated levels and the tree by rank
    0), then read back onto this mesh and advanced one step; and, given
    the directory `whole` of a one-rank checkpoint of the same tree, the
    same restart from it.  Returns on rank 0 the whole trees ((meta,
    per-entry dicts)) written, after the unbroken run's next step, and
    read back and after its step for each restart."""
    from incflo_torch import IncfloConfig, state
    from incflo_torch.amr_patch import SlabAMRSimulation
    from incflo_torch.utils import io
    cfg = IncfloConfig.from_text(deck)
    amr = SlabAMRSimulation(cfg, device=mesh.device, mesh=mesh)
    s = amr.init_state()
    for _ in range(nsteps):
        s = amr.advance(s)
    io.write_checkpoint_patch(path, s, amr, cfg)
    mesh.barrier()
    tree = lambda ps: (amr.tree_meta(), state.patch_to_numpy(amr, ps))
    out = {"written": tree(s), "unbroken": tree(amr.advance(s))}
    for key, src in (("restarted", path), ("whole_restarted", whole)):
        if src is not None:
            r = io.read_checkpoint_patch(src, amr, cfg)
            out[key + "_read"] = tree(r)
            out[key] = tree(amr.advance(r))
    return out if mesh.rank == 0 else None


def counted_steps(mesh, deck, nsteps, count=(), **kw):
    """steps() with every call of the functions `count` of
    ops/godunov_kernels counted on this rank (the kernel wrappers and
    the plain chains: which ones a deck's dispatch reaches, whatever the
    device); their calls by name under "calls"."""
    from incflo_torch.ops import godunov_kernels as gk
    calls = dict.fromkeys(count, 0)
    saved = {name: getattr(gk, name) for name in count}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    try:
        for name, fn in saved.items():
            setattr(gk, name, counted(name, fn))
        out = steps(mesh, deck, nsteps, **kw)
    finally:
        for name, fn in saved.items():
            setattr(gk, name, fn)
    out["calls"] = calls
    return out


def _perturbed(s, mesh, perturb):
    """s with this rank's rows of the whole-level array `perturb` (all of
    them where mesh is None: a level held whole), in the state's dtype,
    added to its velocity."""
    v = s.level.velocity
    p = torch.as_tensor(perturb).to(v.device) if mesh is None \
        else _rows(mesh, perturb)
    return s._replace(level=s.level._replace(velocity=v + p.to(v.dtype)))


def _rows(mesh, a, extra=0):
    """This rank's x rows of a whole-level array (SlabMesh.rows: the last
    rank's extra node row of an x that ends in boundaries) or, with
    extra, nxl + extra rows (a slab's nxl + 1 x faces)."""
    t = torch.as_tensor(a).to(mesh.device)
    if not extra:
        return mesh.slab(t).contiguous()
    nxl = (a.shape[0] - extra) // mesh.size
    return t.narrow(0, mesh.rank * nxl, nxl + extra).contiguous()


def slab_smoothers(mesh, cases):
    """The slab smoothers on this rank's rows of whole-level arrays.
    cases: dicts with "kind" ("cell" or "nodal"), the level's x and b,
    its smoother coefficients (cell: diag, dinv, F, Fwall with None for
    a periodic axis; nodal: sigma at the cells, dinv, dx), bc, and the
    (nsweeps, want_residual) calls.  Where x ends in walls the first
    rank passes the level's low x wall plane Fwall[0]; where x is
    periodic and Fwall[0] is given (the EB wall term's levels: face 0
    differs from face n) it is the x wrap plane, left out where the case
    says "xwrap": False.  Returns, per case and call, this rank's rows of
    x and of the residual (None without it)."""
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    out = []
    for c in cases:
        x, b = _rows(mesh, c["x"]), _rows(mesh, c["b"])
        periodic = int(c["bc"][0][0]) == sk.PERIODIC
        got = []
        if c["kind"] == "cell":
            planes = [_rows(mesh, w) for w in c["Fwall"][1:] if w is not None]
            coefs = mg._SlabCoefs(mesh, [_rows(mesh, c["diag"]),
                                         _rows(mesh, c["dinv"])]
                                  + [_rows(mesh, f) for f in c["F"]]
                                  + planes, periodic)
            xwall = xwrap = None
            if mesh.ends(periodic)[0]:
                xwall = torch.as_tensor(c["Fwall"][0]).to(mesh.device)
            if periodic and c["Fwall"][0] is not None \
                    and c.get("xwrap", True):
                xwrap = torch.as_tensor(c["Fwall"][0]).to(mesh.device)
            for n, want in c["calls"]:
                ext = coefs.get(*sk.slab_depth(n, want))
                it = iter(ext[5:])
                fw = (xwall,) + tuple(None if w is None else next(it)
                                      for w in c["Fwall"][1:])
                got.append(sk.cell_smooth_slab(mesh, x, b, ext[0], ext[1],
                                               ext[2:5], n, want, c["bc"],
                                               fw, xwrap=xwrap))
        else:
            dinv = mg._SlabCoefs(mesh, [_rows(mesh, c["dinv"])], periodic)
            sigma = mg._SlabCoefs(mesh, [_rows(mesh, c["sigma"])], periodic)
            for n, want in c["calls"]:
                lo, hi = sk.slab_depth(n, want)
                got.append(sk.nodal_smooth_slab(
                    mesh, x, b, sigma.get(lo, hi - 1)[0],
                    dinv.get(lo, hi)[0], c["dx"], n, want, c["bc"]))
        out.append([(a.cpu().numpy(), None if r is None else r.cpu().numpy())
                    for a, r in got])
    return out


def eb_operators(sim, vel, dudt, umac, nodal_cases=()):
    """The EB operators of `sim` (a whole level, or a rank's slab) on
    vel, dudt and umac (its rows: umac's x faces nxl + 1): the MOL-EB
    face velocities of vel and the EB fluxes, rate and redistribution of
    vel advected by umac, the redistribution of dudt, the small-cell
    correction of vel from umac, the cut-cell strain rate and the
    viscosity grown by one, and sim's EB arrays.  nodal_cases: dicts of
    a level of sim's 27-point EB nodal hierarchy, its x and b (the
    slab's rows, or the whole level's where the level runs whole on
    every rank) and the (nsweeps, want_residual) calls of its smoother.
    Returns numpy arrays."""
    import dataclasses
    from incflo_torch.eb import mol as ebmol
    from incflo_torch.eb import ops as ebops
    from incflo_torch.ops import rheology
    grid, eb, ng = sim.grid, sim.eb, sim.cfg.nghost_state()
    vel_g = sim.grow_vel(vel, ng)
    fluxes = ebmol.compute_convective_fluxes_eb(vel_g, umac, grid, ng,
                                               sim.vel_bcrec, eb)
    rate = ebops.eb_convective_rate(fluxes, grid, eb)
    out = {"umac": ebmol.predict_vels_on_faces_eb(vel_g, grid, ng,
                                                  sim.vel_bcrec, eb),
           "fluxes": fluxes, "rate": rate,
           "rate_redistributed": ebops.redistribute(rate, grid, eb),
           "redistributed": ebops.redistribute(dudt, grid, eb),
           "small": ebops.correct_small_cells(vel, umac, grid, eb),
           "strainrate": ebops.eb_strainrate(vel_g, grid, ng, eb),
           "eta_g1": rheology.compute_viscosity(vel_g, grid, ng, sim.cfg,
                                                out_ng=1, eb=eb),
           "arrays": {f.name: getattr(eb, f.name)
                      for f in dataclasses.fields(eb)
                      if f.name != "offsets"}}
    solver = sim._nodal_eb_hat
    out["nodal_sweeps"] = [
        [solver._smooth_res(c["x"], c["b"], c["level"], n, want)
         for n, want in c["calls"]] for c in nodal_cases]
    out["n_slab"] = None if solver is None else solver.n_slab
    return _numpy_tree(out)


def eb_forms(mesh, deck, vel, dudt, umac, nodal_cases=()):
    """eb_operators of a deck's sharded Simulation on this rank's rows of
    whole-level vel, dudt and umac (faces), and of the nodal cases' x
    and b (the whole level's on a level that runs whole on every
    rank)."""
    from incflo_torch import IncfloConfig, Simulation
    sim = Simulation(IncfloConfig.from_text(deck), device=mesh.device,
                     mesh=mesh)
    n_slab = sim._nodal_eb_hat.n_slab if sim._nodal_eb_hat else 0
    cases = [dict(c, **{k: torch.as_tensor(c[k]).to(mesh.device)
                        if c["level"] >= n_slab else _rows(mesh, c[k])
                        for k in ("x", "b")}) for c in nodal_cases]
    um = [_rows(mesh, umac[0], 1)] + [_rows(mesh, u) for u in umac[1:]]
    return eb_operators(sim, _rows(mesh, vel), _rows(mesh, dudt), um, cases)


def _numpy_tree(obj):
    """Tensors (in lists, tuples and dicts) as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy_tree(v) for v in obj)
    return obj


def ghost_fill(mesh, deck, vel, rho, tra, ng):
    """The ghost fills of a deck's Simulation on this rank's slab of
    whole-level fields (velocity, density and tracer grown by ng, the
    inflow profiles and values included)."""
    from incflo_torch import IncfloConfig, Simulation
    sim = Simulation(IncfloConfig.from_text(deck), device=mesh.device,
                     mesh=mesh)
    out = {"velocity": sim.grow_vel(_rows(mesh, vel), ng),
           "density": sim.grow_rho(_rows(mesh, rho), ng),
           "tracer": sim.grow_tra(_rows(mesh, tra), ng)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def walled_godunov_chain(sim, vel, forces, q, dt):
    """The Godunov chain of a step on sim's level (a rank's slab on a
    mesh): the ghost fills, the MAC prediction, the advection of
    velocity, density and rho*tracer.  Returns the arrays by name."""
    ng = sim.cfg.nghost_state()
    vel_g = sim.grow_vel(vel, ng)
    f_g = sim.grow_force(forces)
    umac = sim.godunov.predict(vel_g, f_g, dt, ng, sim.vel_bcrec)
    rho_g = sim.grow_rho(1.0 + 0.1 * vel[..., 0], ng)
    out = {f"umac{d}": u for d, u in enumerate(umac)}
    out["conv_u"] = sim.godunov.advect(vel_g, umac, f_g, dt, ng,
                                       sim.vel_bcrec, [0] * vel.shape[-1],
                                       True)
    out["conv_r"] = sim.godunov.advect(rho_g[..., None], umac, None, dt, ng,
                                       sim.den_bcrec, [1], False)
    out["conv_t"] = sim.godunov.advect(rho_g[..., None]
                                       * sim.grow_tra(q, ng), umac, None,
                                       dt, ng, sim.tra_bcrec,
                                       [1] * q.shape[-1], False)
    return out


def godunov_walls(mesh, deck, vel, forces, q, dt):
    """walled_godunov_chain on this rank's slab of whole-level fields."""
    from incflo_torch import IncfloConfig, Simulation
    sim = Simulation(IncfloConfig.from_text(deck), device=mesh.device,
                     mesh=mesh)
    out = walled_godunov_chain(sim, _rows(mesh, vel), _rows(mesh, forces),
                               _rows(mesh, q), dt)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _solver(mesh, c, device="cpu"):
    """A CellSolver ("cell": dx, bc_lo, bc_hi, alpha, beta, acoef or
    None, bcoef with nx + 1 x faces, ebc or None) or NodalSolver
    ("nodal": dx, periodic, bc_lo, bc_hi, sigma) of case c, from this
    rank's rows of its whole-level coefficients on the mesh, or from the
    whole level's on `device` where mesh is None; direct=False."""
    from incflo_torch.ops import multigrid as mg
    rows = (lambda a, extra=0: torch.as_tensor(a, device=device)) \
        if mesh is None else (lambda a, extra=0: _rows(mesh, a, extra))
    if c["kind"] == "cell":
        opt = lambda k: None if c.get(k) is None else rows(c[k])
        return mg.CellSolver(c["dx"], c["bc_lo"], c["bc_hi"], c["alpha"],
                             c["beta"], opt("acoef"),
                             [rows(b, 1 if ax == 0 else 0)
                              for ax, b in enumerate(c["bcoef"])],
                             ebc=opt("ebc"), direct=False, mesh=mesh)
    return mg.NodalSolver(c["dx"], c["periodic"], c["bc_lo"], c["bc_hi"],
                          rows(c["sigma"]), direct=False, mesh=mesh)


def slab_solves(mesh, cases):
    """Multigrid solves on this rank's slab: each case builds its solver
    (_solver) from its rows of the whole-level coefficients, with the
    mesh, and solves its rows of rhs from its rows of x0 (or zero) with
    `kw`.  Returns per case this rank's rows of x, the residual, the
    iterations, the hierarchy's slab levels and its depth."""
    out = []
    for c in cases:
        solver = _solver(mesh, c)
        x0 = None if c.get("x0") is None else _rows(mesh, c["x0"])
        x, res, it = solver.solve_info(_rows(mesh, c["rhs"]), x0=x0,
                                       **c.get("kw", {}))
        depth = (len(solver._whole.levels) if solver._whole is not None
                 else len(solver.levels))
        out.append({"x": x.cpu().numpy(), "res": float(res), "iters": it,
                    "n_slab": solver.n_slab, "depth": depth})
    return out


def solver_sweeps(mesh, cases, device="cpu"):
    """The smoothers of multigrid solvers at every level: each case
    builds its solver (_solver) on this rank's rows, or on the whole
    level on `device` where mesh is None, and calls _smooth_res on level
    li with the level's x and b (this rank's rows on a slab level, the
    whole level's on one that runs whole) for each (nsweeps,
    want_residual) of "calls", each call twice.  Returns per case the
    slab levels (n_slab) and per level and call this rank's rows of x
    and of the residual, the halo exchanges of the repeated call (its
    coefficients already extended) and the 2D slab sweep calls it
    counted (multigrid.SLAB_2D)."""
    from incflo_torch.ops import multigrid as mg
    out = []
    for c in cases:
        solver = _solver(mesh, c, device)
        n_slab = solver.n_slab if mesh is not None else len(solver.levels)
        levels = []
        for li, lev in enumerate(c["levels"]):
            whole = mesh is None or li >= n_slab
            dev = device if mesh is None else mesh.device
            t = (lambda a: torch.as_tensor(a, device=dev)) if whole \
                else (lambda a: _rows(mesh, a))
            x, b = t(lev["x"]), t(lev["b"])
            got = []
            for n, want in lev["calls"]:
                solver._smooth_res(x, b, li, n, want)
                halo = 0 if mesh is None else mesh.stats["halo"]["calls"]
                calls = dict(mg.SLAB_2D)
                xr, rr = solver._smooth_res(x, b, li, n, want)
                got.append({
                    "x": xr.cpu().numpy(),
                    "res": None if rr is None else rr.cpu().numpy(),
                    "halo": 0 if mesh is None
                    else mesh.stats["halo"]["calls"] - halo,
                    "slab_2d": {k: mg.SLAB_2D[k] - calls[k]
                                for k in calls}})
            levels.append(got)
        out.append({"n_slab": n_slab, "levels": levels})
    return out


def sweep_levels(case, nranks, seed):
    """case (of _solver; its coefficients' dtype is the sweeps') with a
    seeded x and b at every level of its hierarchy and the calls whose
    halo fits the nranks-rank slabs: k sweeps + the residual, k' sweeps
    without, the residual alone."""
    import numpy as np
    solver = _solver(None, case)
    dtype = np.asarray(case["sigma"] if case["kind"] == "nodal"
                       else case["bcoef"][0]).dtype
    rand = lambda shape, s: (-1.0 + 2.0 * np.random.default_rng(s).random(
        shape)).astype(dtype)
    levels = []
    for li, lev in enumerate(solver.levels):
        shape = tuple(solver.diags[li].shape)
        cells = lev.cells[0] if case["kind"] == "nodal" else shape[0]
        nxl = cells // nranks
        levels.append(dict(x=rand(shape, seed + li),
                           b=rand(shape, seed + 50 + li),
                           calls=[(max((nxl - 2) // 2, 1), True),
                                  (max(nxl // 2, 1), False), (0, True)]))
    return dict(case, levels=levels)


def sweep_mismatches(results, key, cases, whole):
    """Where the ranks' solver_sweeps (results[rank][key]) differ from
    the whole level's (whole): every slab level's rows of x and of the
    residual must be the whole level's bit for bit, a repeated call make
    one halo exchange and one 2D slab sweep call of its kind; a level
    that runs whole must equal the whole level and exchange nothing.
    Returns (the failures as (case, rank, level, call, what), the slab
    levels of each case and rank)."""
    import numpy as np
    from incflo_torch.ops import multigrid as mg
    per = int(mg.SolverBC.PERIODIC)
    nranks = len(results)
    bad, n_slabs = [], []
    for k, c in enumerate(cases):
        ends = c["kind"] == "nodal" and c["bc_lo"][0] != per
        for r, res in enumerate(results):
            got = res[key][k]
            n_slab = got["n_slab"]
            for li, (gl, wl) in enumerate(zip(got["levels"],
                                              whole[k]["levels"])):
                for j, (g, w) in enumerate(zip(gl, wl)):
                    fail = lambda what: bad.append((k, r, li, j, what))
                    if li >= n_slab:
                        if not np.array_equal(g["x"], w["x"]):
                            fail("x of a whole level")
                        if g["halo"] != 0:
                            fail(f"{g['halo']} halo exchanges")
                        continue
                    n = w["x"].shape[0]
                    nxl = (n - ends) // nranks
                    last = r == nranks - 1
                    rows = slice(r * nxl, (r + 1) * nxl + (ends and last))
                    if not np.array_equal(g["x"], w["x"][rows]):
                        fail("x")
                    if (g["res"] is None) != (w["res"] is None) or (
                            w["res"] is not None
                            and not np.array_equal(g["res"],
                                                   w["res"][rows])):
                        fail("residual")
                    if g["halo"] != 1:
                        fail(f"{g['halo']} halo exchanges")
                    want = {"cell": int(c["kind"] == "cell"),
                            "nodal": int(c["kind"] == "nodal")}
                    if g["slab_2d"] != want:
                        fail(f"2D slab sweep calls {g['slab_2d']}")
            n_slabs.append(n_slab)
    return bad, n_slabs


def timed_steps(mesh, deck, warm, nsteps, instrumented, perturb=None):
    """From init (perturb: a whole-level array added to the velocity
    after it): `warm` steps, then `nsteps` steps timed on the host
    clock (device synchronised, the ranks started together), with the
    Godunov and smoother launch counts and the solver tallies zeroed just
    before them;
    then `instrumented` steps with each exchange timed (SlabMesh.timed).
    Returns the whole-level state after the timed steps (rank 0 only),
    the launches and tallies of the timed steps (the 27-point EB nodal
    smoother's and the 2D flux-form slab sweep calls among them), their
    nodal solves that iterated (residual / tolerance, V-cycles, maxiter;
    multigrid.NODAL_LOG), ms/step, the exchanges' calls,
    bytes and ms per step of the instrumented steps, and the seconds of
    the setup (the Simulation and its init)."""
    import time
    from incflo_torch import IncfloConfig, Simulation, state
    from incflo_torch.ops import godunov_kernels as gk
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    sync = (lambda: torch.cuda.synchronize(mesh.device)) \
        if mesh.device.type == "cuda" else (lambda: None)
    t_setup = time.perf_counter()
    sim = Simulation(IncfloConfig.from_text(deck), device=mesh.device,
                     mesh=mesh)
    s = sim.init_state()
    sync()
    setup_s = time.perf_counter() - t_setup
    if perturb is not None:
        s = _perturbed(s, mesh, perturb)
    s = sim.advance_n(s, warm)
    sync()
    mesh.barrier()
    gk.reset_launches()
    sk.reset_launches()
    mg.reset_counts()
    mg.NODAL_LOG = []
    t0 = time.perf_counter()
    s = sim.advance_n(s, nsteps)
    sync()
    ms = (time.perf_counter() - t0) / nsteps * 1e3
    nodal = [(float(res) / float(tol), it, maxiter)
             for res, tol, it, maxiter in mg.NODAL_LOG]
    mg.NODAL_LOG = None
    launches, counts = dict(gk.LAUNCHES), dict(mg.COUNTS)
    smoother_launches = dict(sk.LAUNCHES)
    stencil_calls = mg.STENCIL_SLAB["calls"]
    slab_2d_calls = dict(mg.SLAB_2D)
    final = state.sim_to_numpy(s, mesh)
    mesh.barrier()
    mesh.reset_stats()
    mesh.timed = True
    t0 = time.perf_counter()
    sim.advance_n(s, instrumented)
    sync()
    ms_inst = (time.perf_counter() - t0) / instrumented * 1e3
    mesh.timed = False
    comm = {k: {"calls_per_step": v["calls"] / instrumented,
                "bytes_per_step": v["bytes"] / instrumented,
                "ms_per_step": v["s"] / instrumented * 1e3}
            for k, v in mesh.stats.items()}
    return {"state": final if mesh.rank == 0 else None, "ms_per_step": ms,
            "instrumented_ms_per_step": ms_inst, "launches": launches,
            "smoother_launches": smoother_launches, "counts": counts,
            "stencil_slab_calls": stencil_calls,
            "slab_2d_calls": slab_2d_calls, "nodal_solves": nodal,
            "setup_s": setup_s, "comm": comm, "mesh": mesh.describe()}


def checkpoint(mesh, deck, nsteps, path, dense=None):
    """Per-rank checkpoints (utils/io.py): the deck's init and `nsteps`
    steps on this rank's slab, written to `path` (one shard a rank), then
    read back from `path` onto this mesh and advanced one step; and, given
    the directory `dense` of a whole-level checkpoint, the same restart
    from it.  Returns the whole-level states written and after each
    restart's step (rank 0 only)."""
    from incflo_torch import IncfloConfig, Simulation, state
    from incflo_torch.utils import io
    cfg = IncfloConfig.from_text(deck)
    sim = Simulation(cfg, device=mesh.device, mesh=mesh)
    s = sim.advance_n(sim.init_state(), nsteps)
    io.write_checkpoint(path, s, cfg, mesh)
    mesh.barrier()
    out = {"written": state.sim_to_numpy(s, mesh)}
    for key, src in (("restarted", path), ("dense_restarted", dense)):
        if src is not None:
            r = io.read_checkpoint(src, cfg, sim.dtype, mesh=mesh)
            out[key] = state.sim_to_numpy(sim.advance(r), mesh)
    return out if mesh.rank == 0 else None


def cli(mesh, argv, cwd):
    """incflo_torch.main.run(argv) on this rank, from directory cwd:
    every rank runs the driver, rank 0 prints and writes the plotfiles.
    Returns its exit code and what it printed."""
    import contextlib
    import io as stringio
    import os
    from incflo_torch import main
    out = stringio.StringIO()
    os.chdir(cwd)
    with contextlib.redirect_stdout(out):
        rc = main.run(argv, mesh=mesh)
    return {"rc": rc, "stdout": out.getvalue()}
