"""CLI driver: the `incflo` executable analog (port of incflo_tpu/main.py).

Usage:  python -m incflo_torch.main <inputs-file> [key=value ...]
        python -m incflo_torch.main --describe

Mirrors reference src/main.cpp + incflo::Evolve (src/incflo.cpp:106-166):
reads a ParmParse deck, initializes (or restarts), evolves with the
plot/checkpoint cadence, and prints the same style of step/timing lines
as incflo_tpu's driver, writing the same files.

It runs on the card.  INCFLO_PLATFORM=cpu asks for the CPU (the kernels'
plain versions); with no card and no such request it exits with an
error.  A deck with amr.max_level > 0 runs the patch tree
(amr_patch.SlabAMRSimulation; amr.patch_mode slab or box, auto-selected
and printed when the deck names none) or the dense fine level
(amr.AMRSimulation), one step a call.  INCFLO_PROFILE_DIR=<dir> writes
a torch.profiler chrome trace there of the run from the driver's build to
the end of the evolve loop, the build's static solvers and the step's
phases (utils/tracing) as ranges above the kernels.  The kernels
build into incflo_torch/_build/ at their first use.  Given a SlabMesh
(parallel/mesh.py; the job `cli` of parallel/workers.py), every rank
runs `run` on its x slab of any deck, 2D or 3D, one level or either AMR
driver (every rank picks the same patch mode and builds the same tree):
each writes its own checkpoint shards, and rank 0 alone prints, writes
the plotfiles and the whole levels of a checkpoint.  A level that does
not split over the ranks is held whole on every rank
(parallel/mesh.py), and rank 0 writes its checkpoint whole, which any
rank count reads back.
"""

from __future__ import annotations

import contextlib
import math
import os
import subprocess
import sys
import time as wallclock

import torch


def write_now(step: int, t: float, dt: float, last_plt: int, cfg) -> bool:
    """reference incflo::writeNow (incflo.cpp:221-266)."""
    if cfg.plot_int > 0:
        return step % cfg.plot_int == 0
    if cfg.plot_per_exact > 0:
        eps = 1.0e-14
        return abs(math.remainder(t, cfg.plot_per_exact)) < eps * max(1.0, abs(t)) \
            or abs((t / cfg.plot_per_exact) - round(t / cfg.plot_per_exact)) < 1e-10
    if cfg.plot_per_approx > 0:
        eps = 1.0e-14
        n_prev = int((t - dt + eps) / cfg.plot_per_approx)
        n_now = int((t + eps) / cfg.plot_per_approx)
        return n_now > n_prev
    return False


def _describe():
    """Build-info dump (reference main.cpp --describe / writeBuildInfo)."""
    import incflo_torch
    print(f"incflo_torch {incflo_torch.__version__}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    print(f"devices: {n} CUDA {names}")
    try:
        git = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))
        print(f"git hash: {git.stdout.strip()}")
    except OSError:
        pass


def _device(mesh):
    """The run's device: the mesh's, else the card unless
    INCFLO_PLATFORM=cpu; None (after printing why) where there is none."""
    if mesh is not None:
        return mesh.device
    plat = os.environ.get("INCFLO_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        print(f"error: INCFLO_PLATFORM={plat!r}: incflo_torch runs on "
              f"'cuda' (the default) or 'cpu'", file=sys.stderr)
        return None
    if not torch.cuda.is_available():
        print("error: incflo_torch runs on a CUDA device and torch.cuda is "
              "not available; set INCFLO_PLATFORM=cpu to run on the CPU",
              file=sys.stderr)
        return None
    return torch.device("cuda")


@contextlib.contextmanager
def _profiled(prof_dir, device, rank, say):
    """Under a torch.profiler, the spans of utils/tracing as its ranges,
    when prof_dir is given; the chrome trace trace.rank<rank>.json is
    written there after the block.  The profiler and the spans stop
    whatever the block raises."""
    if not prof_dir:
        yield
        return
    from incflo_torch.utils import tracing
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    tracing.SPANS = tracing.RANGES
    try:
        yield
    finally:
        tracing.SPANS = None
        prof.stop()
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, f"trace.rank{rank}.json"))
    say(f"Wrote profiler trace to {prof_dir}")


def run(argv, mesh=None):
    if argv and argv[0] == "--describe":
        _describe()
        return 0
    if not argv:
        print("usage: python -m incflo_torch.main <inputs-file> "
              "[key=value ...]")
        return 2

    from incflo_torch.config import IncfloConfig
    try:
        cfg = IncfloConfig.from_file(argv[0], argv[1:])
    except FileNotFoundError:
        print(f"error: inputs file not found: {argv[0]}", file=sys.stderr)
        return 2
    device = _device(mesh)
    if device is None:
        return 2

    from incflo_torch.simulation import Simulation
    from incflo_torch.utils import diagnostics, io

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    # optional profiling from the driver's build on (a torch.profiler
    # chrome trace; reference analog: AMReX TinyProfiler via TINY_PROFILE)
    with _profiled(os.environ.get("INCFLO_PROFILE_DIR"), device,
                   0 if mesh is None else mesh.rank, say):
        # the drivers of incflo_tpu/main.py:83-123: a patch tree (slab or
        # box, auto-selected when the deck names none), the dense fine
        # level, or one level
        patch_mode = cfg.patch_mode
        if cfg.max_level > 0 and patch_mode == "":
            from incflo_torch import amr_patch
            patch_mode = amr_patch.choose_patch_mode(cfg)
            say(f"amr.patch_mode auto-selected: {patch_mode}")
        patches = cfg.max_level > 0 and patch_mode in ("slab", "box")
        io_cfg = cfg
        if patches:
            cfg.patch_mode = patch_mode     # record the resolved mode
            from incflo_torch.amr_patch import SlabAMRSimulation
            amr = SlabAMRSimulation(cfg, device=device, mesh=mesh)
            sim = amr.sim0

            def write_plot(path, s):
                io.write_plotfile_patch(path, s, amr, cfg)

            def write_chk(path, s):
                io.write_checkpoint_patch(path, s, amr, cfg)

            def read_chk(path):
                return io.read_checkpoint_patch(path, amr, cfg)
        elif cfg.max_level > 0:
            from incflo_torch.amr import AMRSimulation
            amr = AMRSimulation(cfg, device=device, mesh=mesh)
            sim = amr.sim
            io_cfg = amr.fine_cfg

            def write_plot(path, s):
                io.write_plotfile_amr(path, s, amr, cfg)
        else:
            amr = None
            sim = Simulation(cfg, device=device, mesh=mesh)

            def write_plot(path, s):
                if sim.mesh is not None or lead:
                    io.write_plotfile(path, s, cfg, sim)
        driver = sim if amr is None else amr
        # the one level's (the dense driver's fine level's) mesh: None where
        # it is held whole on every rank
        level_mesh = sim.mesh
        if not patches:
            def write_chk(path, s):
                if level_mesh is not None or lead:
                    io.write_checkpoint(path, s, io_cfg, level_mesh)

            def read_chk(path):
                s = io.read_checkpoint(path, io_cfg, sim.dtype, device,
                                       level_mesh)
                if amr is not None:
                    amr.regrid(s)
                return s

        def write_info(path):
            if lead:
                io.write_job_info(path, cfg, device)


        # EB surface dump (reference WriteMyEBSurface)
        if lead and sim.eb is not None and int(cfg.pp.scoped("incflo").query(
                "write_eb_surface", 0)):
            from incflo_torch.eb import geometry as ebgeom
            from incflo_torch.eb import surface
            phi_if = ebgeom.make_eb_geometry(cfg.eb_geometry, cfg.pp, cfg.grid)
            data = ebgeom.compute_eb_data(phi_if, cfg.grid)
            surface.write_eb_surface("eb_surface.stl", data, cfg.grid)
            print("Wrote eb_surface.stl")

        t0 = wallclock.time()
        if cfg.restart_file:
            say(f"Restarting from checkpoint {cfg.restart_file}")
            s = read_chk(cfg.restart_file)
            if cfg.plotfile_on_restart:
                path = f"{cfg.plot_file}{int(s.step):05d}"
                write_plot(path, s)
        else:
            s = driver.init_state()
            if cfg.check_int > 0:
                write_chk(f"{cfg.check_file}{int(s.step):05d}", s)
            if cfg.plot_int > 0 or cfg.plot_per_exact > 0 \
                    or cfg.plot_per_approx > 0:
                path = f"{cfg.plot_file}{int(s.step):05d}"
                write_plot(path, s)
                write_info(path)
        sync()
        init_time = wallclock.time() - t0
        say(f"Time spent in InitData():    {init_time}")

        t0 = wallclock.time()
        last_plt = -1
        last_chk = -1
        nsteps = 0
        # batch steps into one advance_n call when nothing needs a per-step
        # host read (no verbose prints, no steady-state test, no time-based
        # plotting), in incflo_tpu's power-of-two batches, so that both
        # packages take the same sequence of steps.  stop_time decks batch
        # too: the batch size is bounded by a conservative prediction of the
        # dt-crossing (dt grows at most 1.1x/step -- compute_dt's growth
        # limiter), so the in-step stop_time clamp only ever fires on single
        # steps.  An AMR run is never batched (incflo_tpu/main.py:178-180).
        can_batch = (amr is None and cfg.verbose <= 0 and not cfg.steady_state
                     and cfg.plot_per_exact <= 0
                     and cfg.plot_per_approx <= 0)

        def _steps_to_stop(t, dt_now, limit):
            """Largest k <= limit with t + sum_{i<=k} dt*1.1^i safely below
            stop_time (conservative upper envelope of the next k dts)."""
            if cfg.stop_time < 0:
                return limit
            if dt_now <= 0.0:
                return 1
            k, tt, dtk = 0, t, dt_now
            while k < limit:
                dtk *= 1.1
                if tt + dtk >= cfg.stop_time * (1.0 - 1e-12):
                    break
                tt += dtk
                k += 1
            return max(1, k)

        def _next_boundary(step):
            """Steps until the next cadence point (plot/check/KE/max_step)."""
            dists = []
            for ival in (cfg.plot_int, cfg.check_int, cfg.KE_int):
                if ival > 0:
                    dists.append(ival - step % ival)
            if cfg.max_step >= 0:
                dists.append(cfg.max_step - step)
            return max(1, min(dists)) if dists else 16

        while True:
            t, step = float(s.t), int(s.step)
            if cfg.stop_time >= 0 and t >= cfg.stop_time - 1e-15 \
                    and not cfg.steady_state:
                break
            if cfg.max_step >= 0 and step >= cfg.max_step:
                break

            step_t0 = wallclock.time()
            prev_level = s.level
            if can_batch:
                limit = _steps_to_stop(t, float(s.dt),
                                       min(_next_boundary(step), 16))
                nbatch = 1
                while nbatch * 2 <= limit:
                    nbatch *= 2
            else:
                nbatch = 1
            s = sim.advance_n(s, nbatch) if nbatch > 1 else driver.advance(s)
            sync()            # the printed step times are the device's too
            nsteps += nbatch
            t, step, dt = float(s.t), int(s.step), float(s.dt)
            if cfg.verbose > 0:
                say(f"Step {step} : t = {t:.12g}, dt = {dt:.12g} "
                    f"[{wallclock.time()-step_t0:.3f}s]")
            if cfg.verbose > 1 and (level_mesh is not None or lead):
                diagnostics.print_max_values(s.level, t, level_mesh)
            if cfg.KE_int > 0 and step % cfg.KE_int == 0:
                ke = diagnostics.kinetic_energy(s.level, sim.grid, level_mesh)
                say(f"Time, Kinetic Energy: {t}, {ke}")
            if cfg.steady_state and diagnostics.steady_state_reached(
                    prev_level, s.level, dt, cfg.steady_state_tol, level_mesh):
                say(f"Steady state reached at step {step}, t = {t}")
                break

            if write_now(step, t, dt, last_plt, cfg):
                path = f"{cfg.plot_file}{step:05d}"
                write_plot(path, s)
                write_info(path)
                last_plt = step
            if cfg.check_int > 0 and step % cfg.check_int == 0:
                write_chk(f"{cfg.check_file}{step:05d}", s)
                last_chk = step


    evolve_time = wallclock.time() - t0
    say(f"Time spent in Evolve():    {evolve_time}")
    if nsteps:
        say(f"Time per step:    {evolve_time/nsteps}")

    # final outputs (reference Evolve tail)
    t, step = float(s.t), int(s.step)
    if cfg.plot_int > 0 or cfg.plot_per_exact > 0 or cfg.plot_per_approx > 0:
        if step != last_plt:
            write_plot(f"{cfg.plot_file}{step:05d}", s)
    if cfg.check_int > 0 and step != last_chk:
        write_chk(f"{cfg.check_file}{step:05d}", s)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
