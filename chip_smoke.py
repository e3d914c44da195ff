#!/usr/bin/env python3
"""Smoke run of incflo_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # also print the device time of the
                                     # steps (torch.profiler) and where the
                                     # rt step's time goes by section

Phases (any failure ends the run with a non-zero exit):
  1. build   the CUDA kernels of incflo_torch/csrc/godunov.cu,
             csrc/smoothers.cu and csrc/step2d.cu with nvcc, one process
             each, together; ptxas's registers, stack and spills of each
             kernel are printed.
  2. kernels each kernel against its plain PyTorch version on the card.
             Godunov, at the shear3d levels n = 128 (128x128x32) and 256
             (256x256x64), PPM and PLM, with and without forces, iconserv
             0 and 1: uad, predict_d and advect bit-equal in float32 and
             within 1e-14 relative in float64; their f32 times at both
             levels, and the device launches of one call counted as the
             kernel nodes of a CUDA graph that captured it (each must be
             one, in the halo-slab mode too).  Smoothers (one launch a
             call): a coarse-level shape
             (64x64x16) and the fine-level shape (128x128x32), 2 sweeps
             and 8 (cell bottom) / 24 (nodal bottom), with and without the
             residual, variable coefficients from a seed, the cell
             smoother also with three components.  The walled cell
             smoother: Neumann and Dirichlet sides in five combinations
             (those of the rt deck, those of tests/test_pallas_smoother.py,
             one with a non-periodic x) at the rt fine level 64x64x128 and
             a coarse 8x8x16, 2 and 8 sweeps, with and without the
             residual, one and three components.  The walled nodal
             smoother: rt's sides, a Dirichlet side and a walled x at
             64x64x129 and 8x8x17 nodes, 2 and 24 sweeps, with and without
             the residual.  Every smoother case bit-equal in float32 and
             within 1e-13 relative in float64, and every wrapper call one
             device launch as the C entries count them at their launch
             sites (sk.DEVICE_LAUNCHES == sk.LAUNCHES).  Each kernel and
             its plain version timed on the card.
  2a. levels every level of the shear3d_vd and rt hierarchies at the call
             its V-cycles make there (cell 1 sweep + residual, 8 at the
             bottom; nodal 2 + residual, 24 at the bottom), f32, through
             the solvers' own _smooth_res: bit-equal to the plain version;
             one call captured in a CUDA graph is one kernel node (the
             measured device launches of the kernels line); kernel ms in
             the regime it chooses and in the other one, forced, where
             the level fits one CTA's shared memory (decided before the
             call), plain ms, bound ms.
  2b. step2d the fused step kernel (csrc/step2d.cu, one cooperative launch
             a step) against its plain version step2d_kernels.step_plain on
             the card, tgv2d from init_state, compared after each of 3
             steps, at 32^2, 128^2 and 256^2.  float32: within rtol 1e-4 /
             atol 1e-5 of each field's max (velocity, p, gp, mac_phi, dt),
             and elementwise on every field but gp; and, against a float64
             step_plain from the same start, the kernel's error at most
             twice step_plain's own (+ 4 ulps) on every field.  float64:
             1e-9 relative.  Each velocity solve's best tensor-CG residual
             must be under its tolerance, in the kernel as in the plain
             version.  Then at 128^2 and 256^2 f32: the kernel's and the
             plain step's times under CUDA-graph replay, one kernel node
             a captured call, the split of the kernel's time by its probe
             instantiation (transform, barrier wait, elementwise work,
             reduction finish), the bound, and the transforms' floors at
             the FP64 tensor-core and FMA rates.
  3. solvers CellSolver.solve and NodalSolver.solve (V-cycles) on cuda
             against cpu, float64, random coefficients: 32x32x8 fully
             periodic (same iteration count, solution to 1e-9), and
             16x16x32 with the rt deck's walls on z (same iteration count,
             solution to 1e-12).
  4. paths   the whole step on cuda (kernels) and on cpu (plain
             versions), float64, 3 steps from one state: shear3d
             (velocity, p, gp) and shear3d_vd from both of its starts
             (also density, tracer, mac_phi) at 32x32x8, and rt at
             16x16x32, and tgv2d at 32^2 (velocity, p, gp, mac_phi; in
             float64 the card takes the plain step); agreement to 1e-9
             relative.  The decks of ROADMAP A9c and 3D MOL likewise
             over PATH_STEPS (2) steps,
             every field (velocity, density, tracer, p, gp, mac_phi) and
             dt to 1e-9, the solvers' iterations of both runs printed:
             channel (mass inflow, pressure outflow, no-slip y walls,
             MOL) at 32x16x8, bingham (between no-slip walls, MOL, from
             rest plus a smooth perturbation from a seed) at 16x16x8,
             bubble (Boussinesq, slip z walls, Godunov) at 16^3,
             shear3d_explicit (explicit diffusion, the Godunov kernels)
             and shear3d_mol (3D MOL) at 32x32x8.  And tgv2d at 32^2
             with explicit diffusion in float32 through
             Simulation.advance on cuda: the plain step, no step2d
             launch.  The decks of ROADMAP A8 and A11 likewise
             (PATH_STEPS steps), every field and dt to 1e-9 and the
             solvers' iterations equal:
             tgv2d with Godunov at 32^2, plain, with
             use_mac_phi_in_godunov and with use_forces_in_trans;
             shear3d at 32x32x8 with use_mac_phi_in_godunov (its predict
             in the plain chain, no uad or predict_d launch, its advect
             through the kernel); rt2d,
             the one-level form of tests/test_amr_patch.py:15-37 (16x32);
             channel_cyl with its cylinder at 32x16x8 and
             poiseuille_cyl_bingham with its cylinder at 16x16x8 (from
             rest plus a smooth perturbation, zero in covered cells).
  5. main    through incflo_torch.Simulation on cuda, float32.  shear3d:
             n = 128 (128x128x32), 20 warm-up + 20 timed steps, and
             n = 256 (256x256x64), 2 warm-up + 3 timed steps.  shear3d_vd
             (variable density, tracer; multigrid V-cycles) at 128x128x32
             from init_state and from a density perturbed by +-40%, 2
             warm-up + 5 timed steps each.  rt (Rayleigh-Taylor: slip
             walls on z, gravity, variable density, a tracer) at
             64x64x128, 2 warm-up + 5 timed steps.  The kernels' launch
             counters are zeroed just before each run and read just after:
             the Godunov counts must equal the per-step launches times the
             steps (none on the walled rt grid, which takes the plain wall
             forms by design), the smoother counts must be positive (on rt
             the walled cell and nodal smoothers), each smoother call one
             device launch, and the per-step tallies of shear3d_vd and rt
             (CG iterations, V-cycles, smoother calls, host syncs) those
             of TALLIES to the digit; the final fields are finite and the
             projection has converged.  tgv2d at 128^2 and 256^2, 2
             warm-up + 20 timed steps, fused (Simulation.advance_n: exactly
             one step2d launch a step) and the plain step
             (Simulation._advance_impl: none) in turns; the amplitude
             follows the exact Taylor-Green decay to 1e-3.  The A9c and
             3D MOL decks at their full widths, 2 warm-up + 5 timed steps
             each: channel 128x64x16, bingham 128x128x32, bubble 64^3,
             shear3d_explicit and shear3d_mol 128x128x32; ms/step,
             cells/s, the kernels' launches (the Godunov kernels 1/3/3 a
             step on shear3d_explicit and none elsewhere; the walled
             smoothers on the walled decks, none elsewhere; step2d
             none; each smoother call one device launch), the per-step
             tallies of TALLIES to the digit, finite fields; the
             projection: on the periodic decks the re-projection of the
             final velocity, on the walled ones every nodal solve of one
             more step within its tolerance before maxiter (the bubble's
             within STAGNATION_BOUND times it, and its final velocity
             re-projected from zero to 1; bingham's also divergence-free
             to rounding, |div u| dx/|u| <= 1e-4); channel: the
             MAC-projected flux through the outflow face equals the
             inflow's to 1e-4; bingham: mirror-symmetric about both
             centre planes to 1e-5 of max |u|; bubble: it rises.  The
             A8 and A11 cells at their bench widths, 2 warm-up + 5 timed
             steps each: channel_cyl 128x64x16 and
             poiseuille_cyl_bingham 128x128x32 with their cylinders (as
             bench.py:_deck builds them), tgv2d with Godunov at 128^2,
             rt2d (the x-z section of bench.py's rt deck) at 64x128;
             ms/step, the launches of every kernel (the cell smoother on
             the EB decks' MAC, velocity and tracer levels, walled on the
             channel, none on the 2D decks), the tallies of TALLIES to
             the digit (a cell that differs prints its own), finite
             fields, covered cells at rest, the next step's nodal solves
             each within its tolerance before maxiter (rt2d's within
             STAGNATION_BOUND times it, and its final velocity
             re-projected from zero to 1), on the EB decks the next
             step's cell CG solves before maxiter and within
             CELL_STAGNATION_BOUND times their tolerance, tgv2d's decay
             to 1e-3; then one profiled step each for the device idle
             share.
             Last, the cut-cell velocity solver that one more
             poiseuille_cyl_bingham step builds: `cell_smooth` on its
             fine and first coarse level (the EB wall term folded into
             diag, face 0 of the periodic z axis as a wrap plane, three
             components), bit-equal to cell_smooth_plain in float32 and
             on the same coefficients in float64, one kernel node a
             call, its and the plain version's time and the bound
             ("levels_eb").
  5a. cli   the CLI driver, incflo_torch.main.run, on the card in a
             temporary directory: bench's shear3d deck at 128x128x32 f32,
             max_step = 4, check_int = plot_int = 2, plt_vort, then a
             restart from chk00002 to step 4 (the launch counters zeroed
             just before each run and read just after: uad / predict_d /
             advect 1 / 3 / 3 a step and nothing else; the restarted
             chk00004 bit-equal to the unbroken one; every plotfile field
             finite); tgv2d at 128^2 f32 with plt_error_u (one step2d
             launch a step, six finite Norm lines).  One line a run with
             the driver's ms/step beside the card's name and power limit.
  5b. amr   ROADMAP A13 and A13b, patch AMR (incflo_torch/amr_patch.py),
             with embedded boundaries too.  paths: the CPU parity decks of
             tests/test_torch_amr_*.py (the two-level RT2D slab with fixed
             dt, the Taylor-vortex band at n = 32, the probtype-21 box),
             the 3D RT slab deck of tests/test_amr_patch.py:309-326 at
             16x16x32, and bench's channel_cyl with its cylinder and
             amr.max_level = 1 at 32x16x8, on cuda and on cpu in float64,
             each from its own init_state, 1 step (the EB deck 2, the
             second regridding) and one regrid: the same trees, every
             entry's fields and dt to 1e-9, equal iterations.  main,
             float32 through SlabAMRSimulation.advance: rt_amr (bench's rt
             64x64x128 with amr.max_level = 1, gradrhoerr 0.1, regrid
             every 2 steps, at cfl 0.5: a 128x128x32 z slab) and
             shear3d_amr (bench's shear3d 128x128x32 with a tagged band z
             in [0.10, 0.15]: a 256x256x32 slab), 2 warm-up + 5 timed
             steps each; channel_cyl_amr (the "amr_eb" cell: bench's
             channel_cyl 128x64x16 with amr.max_level = 1, regrid every 2
             steps; the cut cells tag a band of x around the cylinder, a
             48x128x32 slab with cut cells of its own), 1 warm-up + 2
             timed steps; the patch mode resolves to slab along each
             cell's axis (mode and band printed); ms/step, setup s, the
             cells per level, the bounds after each step, the launches a
             step of each kernel per level (counters zeroed before the
             warm-up, read after the timed steps: shear3d_amr's base level
             the Godunov kernels 1 / 3 / 3 a step and nothing else,
             channel_cyl_amr's EB base level the walled cell smoother
             only, every other level the walled smoothers and nothing
             else), the solvers' tallies, finite fields with covered cells
             at rest; one more step, profiled, its nodal solves within
             the bounds of AMR_NODAL_BOUNDS (a cell's own in
             AMR_NODAL_BOUNDS_OF).  levels: every level of the patches'
             MAC, velocity, tracer and nodal hierarchies that the
             profiled step builds (Dirichlet faces on both sides of the
             slab axis, b seeded on the nodal Dirichlet rows; on the EB
             patch the cut-cell coefficients with the wall term and the
             vfrac-weighted nodal sigma), at the V-cycles' calls: the
             walled smoothers bit-equal to their plain versions in
             float32 (through the solvers' _smooth_res) and within 1e-13
             in float64, one kernel node a call, kernel, plain and bound
             ms.  cli: incflo_torch.main on rt_amr's deck, max_step = 4
             with a patch checkpoint and a plotfile every 2 steps, and on
             channel_cyl_amr's at 32x16x8 in float64, max_step = 2 with
             both every step; the patch mode auto-selected, then a
             restart from the middle step whose last checkpoint is
             bit-equal to the unbroken one (the EB geometry rebuilt from
             the deck).
  6. sharded the x-slab mesh of incflo_torch/parallel and the halo-slab
             Godunov kernels (B8).  First the kernels in one process (after
             phase 2): the shear3d n = 128 level cut into 2 slabs (nxl 64)
             and 4 (nxl 32) from a seeded field, float32 and float64,
             every uad_halo, predict_d_halo and advect_halo output against
             its slab plain version and against the unsharded kernel's
             output on the same rows, bit-equal in float32 and within
             1e-14 relative in float64; their times at nxl 64 and 32.
             Then shear3d n = 128 through Simulation(mesh=...) on 2
             spawned ranks (incflo_torch.parallel.launch): NCCL with one
             GPU a rank where the host has two, else gloo with both ranks
             on cuda:0 (printed).  Every 2-rank run of this phase
             (sharded, sharded_mg, sharded_xwalls, sharded_eb, sharded_2d,
             sharded_amr) shares one spawn of the ranks (run_sharded):
             the ranks run every part's untimed jobs (float64, bit
             equality) while this process runs the parts' 1-rank
             references, then, behind a gate those open, every part's
             timed jobs with the card to themselves; then each part
             checks and prints its results.  float64 init + 3 steps against the
             1-rank step from the same start, to 1e-11 relative, with
             equal tensor-CG iterations; float32 2 warm-up + 5 timed
             steps, the launch counts zeroed just before them and read
             after (1 uad_halo, 3 predict_d_halo, 3 advect_halo wrapper
             calls per rank and step, no unsharded Godunov launch), the
             state after 7 steps held against a 1-rank float64 run beside
             the 1-rank float32 run (at most twice its error + 4 ulps on
             every field); ms/step; then 3 instrumented steps that time
             each exchange (halo, all-reduce, reduce-scatter ms/step).
             slab: the slab forms of the smoother kernels
             (cell_smooth_slab, nodal_smooth_slab) at every level of
             rt's MAC and nodal hierarchies (64x64x128, seeded variable
             coefficients) whose 2-rank slabs are even, f32, at the
             V-cycles' call where its halo fits: each rank's extended
             slab through the kernel bit-equal to its plain version on
             the same inputs, its middle planes bit-equal to the whole
             level's kernel rows, one kernel node a call, kernel, plain
             and bound ms.  sharded_mg: rt (64x64x128, x slabs of 32)
             and shear3d_vd (128x128x32, slabs of 64) on 2 ranks sharing
             the card, multigrid on the slabs: float64 init + 1 step
             against the 1-rank port to 1e-11 with equal CG iterations,
             V-cycles and tensor-CG iterations in every step on both
             ranks; float32 1 warm-up + 2 timed steps (launch counts
             zeroed just before them: both slab smoother kernels launched
             on every rank), held against a 1-rank float64 run beside
             the 1-rank float32 run (at most twice its error + 4 ulps);
             ms/step, slab launches a step per rank, one instrumented
             step's exchanges by kind (calls, bytes, ms).
             sharded_xwalls: x-slab meshes whose x ends in walls, inflow
             or outflow.  The slab forms with the level's x wall on an
             end rank (the first rank's low side, the last rank's high
             one, nodes: the last rank's extra node nx) at every level of
             the channel's (128x64x16) nodal hierarchy (Neumann inflow,
             the Dirichlet outflow plane) and tracer cell hierarchy
             (Dirichlet inflow, Neumann outflow), seeded variable
             coefficients, f32, as "slab" checks them.  Then bench's
             channel without its cylinder at 128x64x16 (3D MOL, the
             direct MAC and tensor solves, nodal V-cycles on the slabs,
             the tracer's cell sweeps) and the bingham deck at 64x64x16
             (no-slip x and y walls, V-cycle CG) on 2 ranks sharing the
             card, as sharded_mg runs its cells (bingham's p, gp and
             mac_phi, rounding noise from rest, relative to its pressure
             scale delp = 2).
             sharded_eb: embedded boundaries on the mesh, the slab forms
             at every level of channel_cyl's and poiseuille_cyl_bingham's
             MAC and cut-cell velocity hierarchies, then both decks
             (128x64x16 and 64x64x16) on 2 ranks sharing the card.
             sharded_2d: 2D decks and the two Godunov options on the
             mesh, on 2 ranks sharing the card as sharded_mg runs its
             cells (the f32 steps from init): tgv2d 128^2 by MOL and by
             Godunov, incflo_tpu's 2D EB cylinder at 128^2, rt2d 64x128
             (2D V-cycles on slabs with y walls; its f32 nodal solves
             stagnate above their tolerance, so its f32 witness takes
             the 1-rank runs from starts one rounding apart), shear3d
             128x128x32 with use_mac_phi_in_godunov (advect_halo
             launched on every rank, uad_halo and predict_d_halo no
             time) and with both options (no Godunov kernel: forces in
             the traces take the plain chain); the 2D slab sweep calls
             and the 9-point EB slab sweeps a step per rank; rt2d's f32
             MAC and nodal sweeps at every slab level bit-equal to the
             whole level's rows on the card.
             sharded_amr: both AMR drivers split over 2 ranks sharing
             the card: rt_amr (64x64x128 with its 128x128x32 z slab
             patch over the whole x range) float64 init + 1 step against
             the 1-rank port to 1e-11 on every level with equal tallies
             and dts on every rank, float32 init + 2 steps (a regrid
             after the second) against the witness of sharded_mg; the
             slab smoothers launched on every rank's base and patch;
             ms/step, setup s, exchanges by kind, the launches a step
             per rank by level.  Then in float64 against 1 rank:
             shear3d_amr on a 32x32x32 base (the halo-slab Godunov
             kernels on its split base), the box deck (its patch held
             whole on every rank) and a dense rt2d deck.
             sharded_amr_eb: float64 init + 1 step on 2 ranks against 1
             rank: amr_eb's deck at 64x32x8 (the base split, the patch
             held whole with its whole geometry; within 1e-11, or, where
             its nodal solves stop at maxiter, with equal stops on both
             ranks and within the error of 1-rank runs from starts one
             rounding apart), shear3d 127x128x32 (nx does not split: the
             level held whole on every rank, bit-equal to 1 rank, no
             exchange), shear3d 264x8x8 (an axis above 256 cells: V-cycles
             on the slabs in place of the rfftn solve, within 1e-11 of the
             port on a 1-rank mesh of this process, equal tallies).
Then one JSON line of kernel results, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.

It imports neither JAX nor incflo_tpu and writes its own deck text (the
shear3d, rt and tgv2d decks of bench.py; shear3d_vd adds
constant_density = false, advect_tracer = true and mu_s = 0.0002;
channel_cyl and poiseuille_cyl_bingham with and without their cylinder;
the bubble of probtype 111; tgv2d with Godunov; the 2D rt; the AMR
decks).  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32/float64 rates outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
# and the FP64 tensor cores (DMMA, mma.sync .f64)
PEAK_DMMA = 67e12

PER_STEP = {"uad": 1, "predict_d": 3, "advect": 3}
# shear3d_vd also advects the density and rho*tracer
PER_STEP_VD = {"uad": 1, "predict_d": 3, "advect": 5}
# the Godunov kernels, each one fused launch a call: float32 bit for
# bit, float64 within this, relative to the field's max
TOL_EXACT_F64 = 1e-14
GODUNOV_SIZES = (128, 256)
SMOOTHERS = ("cell_smooth", "nodal_smooth")
WALLED = "cell_smooth_walled"
WALLED_NODAL = "nodal_smooth_walled"
TOL_WALLED_F64 = 1e-13
# (lo, hi) BC codes per axis of the walled smoother cases: 0 periodic,
# 1 Neumann, 2 Dirichlet
WALL_BCS = {
    "rt scalar (p, p, neumann)": ((0, 0, 1), (0, 0, 1)),
    "rt normal velocity (p, p, dirichlet)": ((0, 0, 2), (0, 0, 2)),
    "(p, dirichlet, neumann)": ((0, 2, 1), (0, 2, 1)),
    "(p, neumann, p)": ((0, 1, 0), (0, 1, 0)),
    "walled x (dirichlet|neumann, neumann, p)": ((2, 1, 0), (1, 1, 0)),
}
# walled nodal smoother cases: rt's sides, a Dirichlet side, a walled x
WALL_NODAL_BCS = {
    "rt (p, p, neumann)": ((0, 0, 1), (0, 0, 1)),
    "dirichlet side (p, p, dirichlet|neumann)": ((0, 0, 2), (0, 0, 1)),
    "walled x (neumann, p, neumann)": ((1, 0, 1), (1, 0, 1)),
}
# smoothers, float32: errors in x and in the residual over max(1, |field|):
# the kernels repeat their plain versions' operations, so none is allowed
TOL_SMOOTH_X, TOL_SMOOTH_RES = 0.0, 0.0
TOL_SMOOTH_F64 = 1e-13
# per-step tallies of the shear3d_vd and rt cells (f32, the deck's
# tolerances): the kernels are bit-equal to their plain versions, so the
# solvers take the same iterations as before the smoothers were redesigned
TALLIES = {
    "shear3d_vd init_state": {"cell_iters": 6.0, "nodal_cycles": 4.8,
                              "cell_smooth": 65.0, "nodal_smooth": 43.2,
                              "host_syncs": 18.8},
    "shear3d_vd perturbed_density": {"cell_iters": 5.6, "nodal_cycles": 5.6,
                                     "cell_smooth": 61.4,
                                     "nodal_smooth": 50.4,
                                     "host_syncs": 19.2},
    "rt": {"cell_iters": 25.2, "nodal_cycles": 5.8, WALLED: 336.2,
           "host_syncs": 46.0},
    # the A9c and 3D MOL cells (their first chip runs, timed and
    # profiled, read the same)
    "channel": {"cell_iters": 0.0, "nodal_cycles": 5.8,
                "tensor_cg_iters": 4.0, WALLED: 2.0, WALLED_NODAL: 40.6,
                "host_syncs": 19.8},
    "bingham": {"cell_iters": 79.2, "nodal_cycles": 3.0,
                "tensor_cg_iters": 45.6, WALLED: 1161.2, WALLED_NODAL: 27.0,
                "host_syncs": 139.8},
    "bubble": {"cell_iters": 13.4, "nodal_cycles": 5.2,
               "tensor_cg_iters": 0.0, WALLED: 195.4, WALLED_NODAL: 57.2,
               "host_syncs": 31.6},
    "shear3d_explicit": {"cell_iters": 0.0, "nodal_cycles": 0.0,
                         "tensor_cg_iters": 0.0, "host_syncs": 0.0},
    "shear3d_mol": {"cell_iters": 0.0, "nodal_cycles": 0.0,
                    "tensor_cg_iters": 0.0, "host_syncs": 2.0},
    # the A8 and A11 cells (read from their chip runs)
    "channel_cyl": {"cell_iters": 23.4, "nodal_cycles": 8.8,
                    "tensor_cg_iters": 4.0, "cell_smooth": 0.0,
                    "nodal_smooth": 0.0, WALLED: 225.8, WALLED_NODAL: 0.0,
                    "host_syncs": 58.2},
    "poiseuille_cyl_bingham": {"cell_iters": 192.0, "nodal_cycles": 13.6,
                               "tensor_cg_iters": 42.8,
                               "cell_smooth": 2189.2, "nodal_smooth": 0.0,
                               WALLED: 0.0, WALLED_NODAL: 0.0,
                               "host_syncs": 270.4},
    "tgv2d_godunov": {"cell_iters": 0.0, "nodal_cycles": 0.0,
                      "tensor_cg_iters": 1.0, "cell_smooth": 0.0,
                      "nodal_smooth": 0.0, WALLED: 0.0, WALLED_NODAL: 0.0,
                      "host_syncs": 3.0},
    "rt2d": {"cell_iters": 15.8, "nodal_cycles": 6.8, "tensor_cg_iters": 0.0,
             "cell_smooth": 0.0, "nodal_smooth": 0.0, WALLED: 0.0,
             WALLED_NODAL: 0.0, "host_syncs": 34.6},
    # the AMR cells, the whole tree a step (read from their chip runs)
    "rt_amr": {"cell_iters": 41.6, "nodal_cycles": 18.8,
               "tensor_cg_iters": 4.0, "host_syncs": 92.4},
    "shear3d_amr": {"cell_iters": 11.8, "nodal_cycles": 9.0,
                    "tensor_cg_iters": 0.0, "host_syncs": 28.8},
    "channel_cyl_amr": {"cell_iters": 60.5, "nodal_cycles": 144.5,
                        "tensor_cg_iters": 4.0, "host_syncs": 255.0},
}
VD_KEYS = """
incflo.constant_density = false
incflo.advect_tracer = true
incflo.mu_s = 0.0002
"""


def deck_header(dtype):
    tol = "1e-11" if dtype == "float64" else "1e-5"
    atol = "1e-14" if dtype == "float64" else "1e-7"
    return f"""
incflo.initial_iterations = 0
incflo.dtype = {dtype}
mac_proj.mg_rtol = {tol}
mac_proj.mg_atol = {atol}
nodal_proj.mg_rtol = {tol}
nodal_proj.mg_atol = {atol}
scalar_diffusion.mg_rtol = {tol}
scalar_diffusion.mg_atol = {atol}
tensor_diffusion.mg_rtol = {tol}
tensor_diffusion.mg_atol = {atol}
stop_time = -1
max_step = 1000000
"""


def rt_deck(n, dtype):
    """The rt deck of bench.py:_deck (probtype 5, Rayleigh-Taylor):
    n/2 x n/2 x n cells, periodic in x and y, slip walls on z, gravity,
    variable density, one advected and diffused tracer, Godunov PPM,
    Crank-Nicolson diffusion."""
    return deck_header(dtype) + f"""
amr.n_cell = {n // 2} {n // 2} {n}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 0.5 0.5 1.0
geometry.is_periodic = 1 1 0
zlo.type = "sw"
zhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. 0. -0.1
incflo.use_godunov = true
incflo.constant_density = false
incflo.advect_tracer = true
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.diffusion_type = 1
incflo.cfl = 0.9
incflo.init_shrink = 1.0
"""


def tgv2d_deck(n, dtype):
    """The tgv2d deck of bench.py:_deck (probtype 1, the 2D Taylor-Green
    vortex): n x n fully periodic, MOL advection, implicit tensor
    diffusion (the defaults), mu = 0.01, cfl = 0.45."""
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n}
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1. 1.
geometry.is_periodic = 1 1
incflo.probtype = 1
incflo.mu = 0.01
incflo.cfl = 0.45
"""


def shear3d_deck(n, dtype, vd=False):
    """The shear3d deck of bench.py:_deck (probtype 21, Godunov PPM,
    Crank-Nicolson tensor diffusion, fully periodic); vd adds variable
    density and tracer advection (shear3d_vd)."""
    nz = max(n // 4, 8)
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n} {nz}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 0.25
geometry.is_periodic = 1 1 1
incflo.probtype = 21
incflo.mu = 0.0002
incflo.cfl = 0.9
incflo.init_shrink = 1.0
incflo.use_godunov = true
incflo.diffusion_type = 1
""" + (VD_KEYS if vd else "")


EXPLICIT = "incflo.diffusion_type = 0\n"
MOL = "incflo.use_godunov = false\nincflo.cfl = 0.5\n"


def channel_deck(n, dtype):
    """channel_cyl of bench.py:_deck without its cylinder: n x n/2 x
    max(n/8, 8) cells of a 1.2 x 0.4 x 0.1 box, mass inflow (1, 0, 0) with
    tracer 1 at x-lo, pressure outflow at x-hi, no-slip y walls, periodic
    z, probtype 31 (the Poiseuille profile), MOL, implicit diffusion, one
    advected tracer."""
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n // 2} {max(n // 8, 8)}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1.2 0.4 0.1
geometry.is_periodic = 0 0 1
ylo.type = "nsw"
yhi.type = "nsw"
xlo.type = "mi"
xlo.velocity = 1. 0. 0.
xlo.tracer = 1.
xhi.type = "po"
xhi.pressure = 0.0
incflo.probtype = 31
incflo.ic_u = 1.0
incflo.mu = 0.001
incflo.ntrac = 1
incflo.advect_tracer = true
incflo.mu_s = 0.001
incflo.cfl = 0.45
"""


def bingham_deck(n, dtype):
    """poiseuille_cyl_bingham of bench.py:_deck without its cylinder,
    between no-slip walls on x and y (periodic z): n x n x max(n/4, 8)
    cells of a 4 x 4 x 0.5 box, MOL, a Bingham fluid (mu 1, tau_0 1,
    papa_reg 0.001) driven by delp (0, 0, 2), fixed dt 0.01."""
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n} {max(n // 4, 8)}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 4. 4. 0.5
geometry.is_periodic = 0 0 1
xlo.type = "nsw"
xhi.type = "nsw"
ylo.type = "nsw"
yhi.type = "nsw"
incflo.delp = 0. 0. 2.
incflo.fluid_model = "bingham"
incflo.mu = 1.
incflo.tau_0 = 1.
incflo.papa_reg = 0.001
incflo.fixed_dt = 0.01
"""


def bubble_deck(n, dtype):
    """probtype 111, the Boussinesq bubble: n^3 cells of the unit cube,
    periodic x and y, slip walls on z, gravity (0, 0, -1), Godunov PPM,
    implicit diffusion, one advected tracer, mu = mu_s = 0.001."""
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n} {n}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
geometry.is_periodic = 1 1 0
zlo.type = "sw"
zhi.type = "sw"
incflo.probtype = 111
incflo.gravity = 0. 0. -1.
incflo.use_godunov = true
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.001
incflo.mu_s = 0.001
"""


# the decks of ROADMAP A9c and 3D MOL: (deck text of (n, dtype), n of the
# "paths" phase, n of the "main" phase)
A9C_DECKS = {
    "channel": (channel_deck, 32, 128),
    "bingham": (bingham_deck, 16, 128),
    "bubble": (bubble_deck, 16, 64),
    "shear3d_explicit": (lambda n, dt: shear3d_deck(n, dt) + EXPLICIT,
                         32, 128),
    "shear3d_mol": (lambda n, dt: shear3d_deck(n, dt) + MOL, 32, 128),
}
# the bubble's f32 in-step nodal solve stops on stagnation above its
# tolerance (2.746 x at 64^3 on an H100; incflo_tpu's likewise, 1.3-2.6 x
# at 32^3 on the CPU, tests/test_torch_bubble_f32.py; ROADMAP C): held to
# this many times the tolerance, the others to 1
STAGNATION_BOUND = 3.0
# the kernels each A9c deck's main run must launch (every other kernel
# no time): the Godunov kernels on the periodic Godunov deck only (the
# walled bubble takes the plain wall forms), the walled smoothers where
# the deck iterates V-cycles on walled levels
A9C_KERNELS = {
    "channel": (WALLED, WALLED_NODAL),
    "bingham": (WALLED, WALLED_NODAL),
    "bubble": (WALLED, WALLED_NODAL),
    "shear3d_explicit": tuple(PER_STEP),
    "shear3d_mol": (),
}


# ---------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------

# A graph replay bracketed by events also measures the host's submission
# of the graph, during which the card idles: one short call per graph
# would time that.  So fn is captured as many
# times in one graph as make a replay last about MIN_GRAPH_MS, and a
# replay's time is divided by that count.
MIN_GRAPH_MS = 1.0
MAX_CALLS = 200


def device_ms(fn, reps=25, warm=3):
    """Median device time of one fn() call in ms: fn is captured in a
    CUDA graph k times back to back (k from a first single-call replay,
    so that a replay lasts about MIN_GRAPH_MS), each replay is bracketed
    by CUDA events and its time divided by k, so neither the host's
    Python overhead nor its graph submission is in the number."""
    import math
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()

    def capture(k):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(k):
                fn()
        for _ in range(warm):
            g.replay()
        return g

    def replay_ms(g, n):
        times = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    g = capture(1)
    k = min(MAX_CALLS, max(1, math.ceil(MIN_GRAPH_MS / replay_ms(g, 5))))
    if k == 1:
        return replay_ms(g, reps)
    del g
    return replay_ms(capture(k), reps) / k


def count_ops(fn, split=False):
    """Arithmetic, compare and select operations of fn(): the elements
    produced by each such aten op (clamp counts 2), and 2*M*N*K for each
    matrix product (mm, bmm) of M x K by K x N.  split: (all operations,
    those of the matrix products)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    names = {"add", "sub", "mul", "div", "neg", "abs", "sign", "minimum",
             "maximum", "where", "gt", "ge", "lt", "le", "eq", "ne",
             "logical_and", "logical_or", "logical_not", "bitwise_and",
             "bitwise_or", "bitwise_not", "rsub", "reciprocal", "clamp"}

    class Count(TorchDispatchMode):
        ops = 0
        mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ("mm", "bmm"):
                self.ops += 2 * out.numel() * args[0].shape[-1]
                self.mm += 2 * out.numel() * args[0].shape[-1]
            elif name in names and isinstance(out, torch.Tensor):
                self.ops += out.numel() * (2 if name == "clamp" else 1)
            return out

    with Count() as c:
        fn()
    return (c.ops, c.mm) if split else c.ops


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def abs_err(a, b):
    return float((a - b).abs().max())


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_build(cuda_build, sources, meanwhile=None):
    """nvcc on every source at once (cuda_build.build_all, in a thread);
    meanwhile() runs here until it ends."""
    import concurrent.futures
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(cuda_build.build_all, sources, True)
        if meanwhile is not None:
            meanwhile()
        paths = built.result()
    s = time.time() - t0
    for path in paths.values():
        print(f"[build] {os.path.relpath(path, HERE)}", flush=True)
    print(f"[build] {len(paths)} libraries in {s:.1f} s", flush=True)
    return s


def smooth_fields(shape, ncomp, seed, dtype, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    xs = [np.linspace(0, 2 * np.pi, n, endpoint=False) for n in shape]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    out = []
    for c in range(ncomp):
        a, b, d = rng.normal(size=3)
        out.append(a * np.sin(X + c) + b * np.cos(2 * Y - c)
                   + d * np.sin(Z + 0.3 * c)
                   + 0.1 * rng.standard_normal(X.shape))
    return torch.as_tensor(np.stack(out, -1), dtype=dtype).to(device)


def kernel_inputs(grid, dtype, dev):
    import torch
    vel = smooth_fields(grid.n_cell, 3, 1, dtype, dev)
    forces = 0.3 * smooth_fields(grid.n_cell, 3, 2, dtype, dev)
    q = smooth_fields(grid.n_cell, 3, 3, dtype, dev)
    # a CFL-limited dt for |u| ~ 1 on the n = 128 grid
    dt = torch.tensor(0.9 * min(grid.dx) / float(vel.abs().max()),
                      dtype=dtype, device=dev)
    return vel, forces, q, dt


def godunov_errors(gk, grid, dtype, torch, res):
    """Every Godunov kernel against its plain version on one grid and
    type: bit for bit in float32 and within TOL_EXACT_F64 in float64.
    PPM and PLM, predict_d with and without forces, advect iconserv 0
    and 1."""
    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    key = "max_rel_err_f32" if f32 else "max_rel_err_f64"

    def note(k, a, b):
        r = res[k]
        r[key] = max(r[key], rel_err(a, b))
        if f32:
            r["max_abs_err"] = max(r["max_abs_err"], abs_err(a, b))
            if not torch.equal(a, b):
                raise AssertionError(f"{k} at {grid.n_cell}: float32 "
                                     "differs from the plain version by "
                                     f"{abs_err(a, b):.3e}")

    vel, forces, q, dt = kernel_inputs(grid, dtype, dev)
    for ppm in (True, False):
        u_k = gk.uad(grid, vel, dt, ppm)
        u_p = gk.uad_plain(grid, vel, dt, ppm)
        for a, b in zip(u_k, u_p):
            note("uad", a, b)
        for with_f in (True, False):
            f = forces if with_f else None
            for d in range(3):
                note("predict_d",
                     gk.predict_d(grid, vel, u_p, f, dt, d, ppm),
                     gk.predict_d_plain(grid, vel, u_p,
                                        None if f is None else f[..., d],
                                        dt, d, ppm))
        umac = gk.predict_plain(grid, vel, forces, dt, ppm)
        for icons in (0, 1):
            for n in range(3):
                note("advect",
                     gk.advect_comp(grid, q, n, umac, forces, dt,
                                    bool(icons), ppm),
                     gk.advect_comp_plain(grid, q[..., n], umac,
                                          forces[..., n], dt, bool(icons),
                                          ppm))
    torch.cuda.synchronize()


def godunov_times(gk, sk, grid, torch):
    """f32 times, bound and device launches of one call of each Godunov
    kernel, as the shear3d step calls them: PPM, with forces, the
    convective form (iconserv 0)."""
    dev = torch.device("cuda")
    vel, forces, q, dt = kernel_inputs(grid, torch.float32, dev)
    cells = grid.n_cell[0] * grid.n_cell[1] * grid.n_cell[2]
    u_p = gk.uad_plain(grid, vel, dt, True)
    umac = gk.predict_plain(grid, vel, forces, dt, True)
    f0 = forces[..., 0].contiguous()
    calls = {
        "uad": (lambda: gk.uad(grid, vel, dt, True),
                lambda: gk.uad_plain(grid, vel, dt, True), 6),
        "predict_d": (lambda: gk.predict_d(grid, vel, u_p, forces, dt, 0,
                                           True),
                      lambda: gk.predict_d_plain(grid, vel, u_p, f0, dt, 0,
                                                 True), 8),
        "advect": (lambda: gk.advect_comp(grid, vel, 0, umac, forces, dt,
                                          False, True),
                   lambda: gk.advect_comp_plain(grid, vel[..., 0], umac,
                                                f0, dt, False, True), 6),
    }
    out = {}
    for k, (kern, plain, nfields) in calls.items():
        r = {"device_launches": graph_launches(sk, kern),
             "ms": device_ms(kern), "plain_ms": device_ms(plain),
             "bytes": nfields * cells * 4, "ops": count_ops(plain)}
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
        # -fmad=false: no add-multiply pair issues as one FMA, so the
        # reachable rate of these operations is half the f32 peak
        r["no_fma_bound_ms"] = max(r["bytes"] / PEAK_BYTES,
                                   2 * r["ops"] / PEAK_OPS["float32"]) * 1e3
        if r["device_launches"] != 1:
            raise AssertionError(f"{k}: one call is {r['device_launches']} "
                                 "device launches")
        out[k] = r
        print(f"[kernels] {k} {'x'.join(map(str, grid.n_cell))}: kernel "
              f"{r['ms']:.4f} ms ({r['device_launches']} device launch a "
              f"call), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B, "
              f"{r['ops']} ops; {r['no_fma_bound_ms']:.5f} ms without FMA)",
              flush=True)
    return out


def phase_kernels(gk, sk, grid_of, torch):
    """Errors of every Godunov kernel against its plain version on the
    card at the shear3d levels n = 128 and 256, float64 and float32, then
    the f32 times and device launches per call at both."""
    res = {k: {"max_abs_err": 0.0, "max_rel_err_f32": 0.0,
               "max_rel_err_f64": 0.0} for k in PER_STEP}
    saved = dict(gk.LAUNCHES)
    for n in GODUNOV_SIZES:
        for dtype in (torch.float64, torch.float32):
            godunov_errors(gk, grid_of(n), dtype, torch, res)
    for k, r in res.items():
        t32, t64 = 0.0, TOL_EXACT_F64
        print(f"[kernels] {k} at n = {', '.join(map(str, GODUNOV_SIZES))}: "
              f"f64 rel {r['max_rel_err_f64']:.3e} (tol {t64:g}), f32 rel "
              f"{r['max_rel_err_f32']:.3e} (tol {t32:g})", flush=True)
        if not r["max_rel_err_f64"] <= t64:
            raise AssertionError(f"{k}: float64 disagrees with the plain "
                                 f"version ({r['max_rel_err_f64']:.3e})")
        if not r["max_rel_err_f32"] <= t32:
            raise AssertionError(f"{k}: float32 disagrees with the plain "
                                 f"version ({r['max_rel_err_f32']:.3e})")
    for n in GODUNOV_SIZES:
        times = godunov_times(gk, sk, grid_of(n), torch)
        for k, r in res.items():
            if n == GODUNOV_SIZES[0]:
                r.update(times[k])
            else:
                r[f"at_{n}"] = times[k]
    gk.LAUNCHES.update(saved)      # comparison launches do not count
    return res


P3 = (0, 0, 0)


def vd_operators(mg, shape, dx, dtype, dev, seed, max_levels=1):
    """The operators the shear3d_vd step solves, built by the solvers'
    own constructors from seeded variable coefficients: the MAC Poisson
    operator (1/rho on faces), the batched velocity Helmholtz operator
    (rho, eta, beta = dt/2) and the nodal sigma-Poisson operator
    (sigma = dt/rho).  max_levels = 1 stops at the level itself."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)

    def faces(lo, hi, comp=()):
        out = []
        for ax in range(3):
            f = lo + (hi - lo) * rng.random(shape + comp)
            out.append(t(np.concatenate([f, f.take([0], axis=ax)], axis=ax)))
        return tuple(out)

    dt = 0.9 * min(dx)
    mac = mg.CellSolver(dx, P3, P3, alpha=0.0, beta=1.0, acoef=None,
                        bcoef=faces(0.7, 1.7), max_levels=max_levels,
                        direct=False)
    rho = t(0.6 + 0.8 * rng.random(shape))
    vel = mg.CellSolver(dx, P3, P3, alpha=1.0, beta=0.5 * dt,
                        acoef=rho[..., None],
                        bcoef=faces(1e-4, 3e-4, (3,)), max_levels=max_levels,
                        direct=False)
    nodal = mg.NodalSolver(dx, (True,) * 3, P3, P3, dt / rho,
                           max_levels=max_levels, direct=False)
    return mac, vel, nodal


def smoother_calls(sk, mg, shape, dx, dtype, dev, seed):
    """{case: (kernel(n, res), plain(n, res))} on one level's inputs."""
    import numpy as np
    import torch
    mac, vel, nodal = vd_operators(mg, shape, dx, dtype, dev, seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    out = {}
    for name, cs, comp in (("cell_smooth", mac, ()),
                           ("cell_smooth/3comp", vel, (3,))):
        dinvs, fhis = cs.smoother_coefs()[:2]
        args = (t(rng.standard_normal(shape + comp)),
                t(rng.standard_normal(shape + comp)), cs.diags[0], dinvs[0],
                fhis[0])
        out[name] = (
            lambda n, r, a=args: sk.cell_smooth(*a, n, r),
            lambda n, r, a=args: sk.cell_smooth_plain(*a, n, r))
    args = (t(rng.standard_normal(shape)), t(rng.standard_normal(shape)),
            nodal.sigmas[0], nodal.dinvs[0], dx)
    out["nodal_smooth"] = (
        lambda n, r, a=args: sk.nodal_smooth(*a, n, r),
        lambda n, r, a=args: sk.nodal_smooth_plain(*a, n, r))
    return out


def compare_smoother(r, case, kern, plain, sweeps, dtype, torch):
    """Hold kern(n, want_residual) against plain(n, True) for each n of
    `sweeps`, with and without the residual; the worst errors go into r."""
    for nsw in sweeps:
        xp, rp = plain(nsw, True)
        for want in (True, False):
            xk, rk = kern(nsw, want)
            if (rk is None) == want:
                raise AssertionError(f"{case}: residual returned "
                                     f"{rk is not None}, asked {want}")
            pairs = [("x", xk, xp)] + ([("res", rk, rp)] if want else [])
            for what, a, b in pairs:
                r["cases"] += 1
                if dtype == torch.float64:
                    r["max_rel_err_f64"] = max(r["max_rel_err_f64"],
                                               rel_err(a, b))
                    continue
                e = abs_err(a, b)
                key = f"max_err_{what}_f32"
                r[key] = max(r[key], e / max(1.0, float(b.abs().max())))
                if what == "x":
                    r["max_abs_err"] = max(r["max_abs_err"], e)


def smoother_verdict(name, r, tol_f64):
    print(f"[smoothers] {name}: {r['cases']} comparisons, f64 rel "
          f"{r['max_rel_err_f64']:.3e} (tol {tol_f64:g}), f32 x "
          f"{r['max_err_x_f32']:.3e}, f32 residual "
          f"{r['max_err_res_f32']:.3e} (float32 must be bit-equal)",
          flush=True)
    if not r["max_rel_err_f64"] <= tol_f64:
        raise AssertionError(f"{name}: float64 disagrees with the plain "
                             f"version ({r['max_rel_err_f64']:.3e})")
    if not (r["max_err_x_f32"] <= TOL_SMOOTH_X
            and r["max_err_res_f32"] <= TOL_SMOOTH_RES):
        raise AssertionError(f"{name}: float32 disagrees with the plain "
                             "version")


def bound(nbytes, ops, dtype="float32"):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_smoother(name, tag, kern, plain, nbytes):
    """f32 times of a 2-sweep call with residual and its bound; nbytes =
    each input read once and each output written once per call."""
    m = {"ms": device_ms(lambda: kern(2, True)),
         "plain_ms": device_ms(lambda: plain(2, True)), "bytes": nbytes,
         "ops": count_ops(lambda: plain(2, True))}
    m["bound_ms"], m["bound_by"] = bound(m["bytes"], m["ops"])
    print(f"[smoothers] {name} {tag}: kernel {m['ms']:.4f} ms, plain "
          f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
          f"({m['bound_by']}: {m['bytes']} B, {m['ops']} ops)", flush=True)
    return m


def check_one_launch(sk, tag):
    """Each wrapper call of every smoother family was one device launch."""
    if sk.DEVICE_LAUNCHES != sk.LAUNCHES:
        raise AssertionError(f"{tag}: device launches {sk.DEVICE_LAUNCHES} "
                             f"differ from wrapper calls {sk.LAUNCHES}")


def save_launches(sk):
    return dict(sk.LAUNCHES), dict(sk.DEVICE_LAUNCHES)


def restore_launches(sk, saved):
    """Comparison launches do not count."""
    sk.LAUNCHES.update(saved[0])
    sk.DEVICE_LAUNCHES.update(saved[1])


def new_smoother_result():
    return {"max_abs_err": 0.0, "max_err_x_f32": 0.0, "max_err_res_f32": 0.0,
            "max_rel_err_f64": 0.0, "cases": 0}


def phase_smoothers(sk, mg, grid_of, torch):
    """Errors of the two smoother kernels against their plain versions
    at a coarse-level and the fine-level shape of the n = 128 hierarchy,
    then the f32 times of a 2-sweep call with residual at both."""
    dev = torch.device("cuda")
    levels = {}
    for n in (64, 128):
        g = grid_of(n)
        levels["x".join(str(c) for c in g.n_cell)] = (g.n_cell, g.dx)
    res = {k: new_smoother_result() for k in SMOOTHERS}
    saved = save_launches(sk)
    for dtype in (torch.float64, torch.float32):
        for shape, dx in levels.values():
            calls = smoother_calls(sk, mg, shape, dx, dtype, dev, 11)
            for case, (kern, plain) in calls.items():
                bottom = 24 if case == "nodal_smooth" else 8
                compare_smoother(res[case.split("/")[0]], case, kern, plain,
                                 (2, bottom), dtype, torch)
    torch.cuda.synchronize()
    check_one_launch(sk, "smoothers")
    for k, r in res.items():
        smoother_verdict(k, r, TOL_SMOOTH_F64)

    # times: f32, 2 sweeps + residual, scalar fields, at both shapes
    narrays = {"cell_smooth": 9, "nodal_smooth": 6}
    for tag, (shape, dx) in levels.items():
        calls = smoother_calls(sk, mg, shape, dx, torch.float32, dev, 11)
        cells = shape[0] * shape[1] * shape[2]
        for k in SMOOTHERS:
            res[k][tag] = time_smoother(k, tag, *calls[k],
                                        narrays[k] * cells * 4)
    restore_launches(sk, saved)
    return res


def walled_operator(mg, shape, dx, bc, comp, dtype, dev, seed):
    """A one-level CellSolver with walls and seeded variable coefficients
    whose face terms are as large as its diagonal term, so that the wall
    cells' coefficients matter: the MAC Poisson operator (comp = ()) or a
    batched Helmholtz operator (comp = (3,))."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    bcoef = []
    for ax in range(3):
        fs = tuple(n + (1 if a == ax else 0) for a, n in enumerate(shape))
        f = 0.5 + 1.5 * rng.random(fs + comp)
        if bc[0][ax] == 0:          # the periodic face n is face 0
            f = np.concatenate([f.take(range(shape[ax]), axis=ax),
                                f.take([0], axis=ax)], axis=ax)
        bcoef.append(t(f))
    if not comp:
        return mg.CellSolver(dx, bc[0], bc[1], alpha=0.0, beta=1.0,
                             acoef=None, bcoef=tuple(bcoef), max_levels=1,
                             direct=False)
    return mg.CellSolver(dx, bc[0], bc[1], alpha=1.0,
                         beta=0.3 * min(dx) ** 2,
                         acoef=t(0.5 + 1.5 * rng.random(shape + (1,))),
                         bcoef=tuple(bcoef), max_levels=1, direct=False)


def walled_calls(sk, mg, shape, dx, bc, comp, dtype, dev, seed):
    """(kernel(n, res), plain(n, res), wall plane bytes) on one level."""
    import numpy as np
    import torch
    cs = walled_operator(mg, shape, dx, bc, comp, dtype, dev, seed)
    dinvs, fhis, fwalls = cs.smoother_coefs()
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    args = (t(rng.standard_normal(shape + comp)),
            t(rng.standard_normal(shape + comp)), cs.diags[0], dinvs[0],
            fhis[0])
    kw = dict(bc=bc, Fwall=fwalls[0])
    plane_bytes = sum(w.numel() * w.element_size() for w in fwalls[0]
                      if w is not None)
    return (lambda n, r: sk.cell_smooth(*args, n, r, **kw),
            lambda n, r: sk.cell_smooth_plain(*args, n, r, **kw),
            plane_bytes)


def phase_walled_smoother(sk, mg, torch):
    """The walled cell smoother against its plain version on the card at
    the rt deck's fine level and a coarse one, then its f32 time for a
    2-sweep call with residual (rt's scalar BCs) at both."""
    dev = torch.device("cuda")
    levels = {"64x64x128": ((64, 64, 128), (0.5 / 64, 0.5 / 64, 1.0 / 128)),
              "8x8x16": ((8, 8, 16), (0.5 / 8, 0.5 / 8, 1.0 / 16))}
    r = new_smoother_result()
    saved = save_launches(sk)
    n0 = sk.LAUNCHES[WALLED]
    for dtype in (torch.float64, torch.float32):
        for shape, dx in levels.values():
            for bcname, bc in WALL_BCS.items():
                for comp in ((), (3,)):
                    kern, plain, _ = walled_calls(sk, mg, shape, dx, bc, comp,
                                                  dtype, dev, 21)
                    compare_smoother(r, f"{WALLED} {bcname}", kern, plain,
                                     (2, 8), dtype, torch)
    torch.cuda.synchronize()
    if sk.LAUNCHES[WALLED] == n0:
        raise AssertionError(f"{WALLED}: the wrapper launched no kernel")
    check_one_launch(sk, WALLED)
    smoother_verdict(WALLED, r, TOL_WALLED_F64)
    bc = WALL_BCS["rt scalar (p, p, neumann)"]
    for tag, (shape, dx) in levels.items():
        kern, plain, plane_bytes = walled_calls(sk, mg, shape, dx, bc, (),
                                                torch.float32, dev, 21)
        cells = shape[0] * shape[1] * shape[2]
        # x, b, diag, dinv, three face arrays in, x and the residual out,
        # and the low wall planes
        r[tag] = time_smoother(WALLED, tag, kern, plain,
                               9 * cells * 4 + plane_bytes)
    restore_launches(sk, saved)
    return r


RT_DX = (0.5 / 64, 0.5 / 64, 1.0 / 128)


def walled_nodal_calls(sk, mg, cells, dx, bc, dtype, dev, seed):
    """(kernel(n, res), plain(n, res), sigma bytes) on one walled nodal
    level: sigma = dt / rho with rho in [0.5, 2] from a seed, x and b at
    the nodes (one more than cells along each walled axis)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    periodic = tuple(c == 0 for c in bc[0])
    rho = 0.5 + 1.5 * rng.random(cells)
    ns = mg.NodalSolver(dx, periodic, bc[0], bc[1], t(0.9 * min(dx) / rho),
                        max_levels=1, direct=False)
    nodes = tuple(ns.dinvs[0].shape)
    args = (t(rng.standard_normal(nodes)), t(rng.standard_normal(nodes)),
            ns.sigmas[0], ns.dinvs[0], ns.levels[0].dx)
    return (lambda n, r: sk.nodal_smooth(*args, n, r, bc=bc),
            lambda n, r: sk.nodal_smooth_plain(*args, n, r, bc=bc),
            ns.sigmas[0].numel() * ns.sigmas[0].element_size())


def phase_walled_nodal(sk, mg, torch):
    """The walled nodal smoother against its plain version on the card
    at the rt deck's fine level (64x64x129 nodes) and a coarse one
    (8x8x17): rt's sides, a Dirichlet side and a walled x, 2 and 24
    sweeps, with and without the residual; then its f32 time for a
    2-sweep call with residual (rt's sides) at both."""
    dev = torch.device("cuda")
    levels = {"64x64x129": ((64, 64, 128), RT_DX),
              "8x8x17": ((8, 8, 16), tuple(8 * d for d in RT_DX))}
    r = new_smoother_result()
    saved = save_launches(sk)
    for dtype in (torch.float64, torch.float32):
        for cells, dx in levels.values():
            for bcname, bc in WALL_NODAL_BCS.items():
                kern, plain, _ = walled_nodal_calls(sk, mg, cells, dx, bc,
                                                    dtype, dev, 23)
                compare_smoother(r, f"{WALLED_NODAL} {bcname}", kern, plain,
                                 (2, 24), dtype, torch)
    torch.cuda.synchronize()
    if sk.LAUNCHES[WALLED_NODAL] == saved[0][WALLED_NODAL]:
        raise AssertionError(f"{WALLED_NODAL}: the wrapper launched no "
                             "kernel")
    check_one_launch(sk, WALLED_NODAL)
    smoother_verdict(WALLED_NODAL, r, TOL_SMOOTH_F64)
    bc = WALL_NODAL_BCS["rt (p, p, neumann)"]
    for tag, (cells, dx) in levels.items():
        kern, plain, sig_bytes = walled_nodal_calls(sk, mg, cells, dx, bc,
                                                    torch.float32, dev, 23)
        nodes = cells[0] * cells[1] * (cells[2] + 1)
        # x, b, dinv at the nodes and sigma in, x and the residual out
        r[tag] = time_smoother(WALLED_NODAL, tag, kern, plain,
                               5 * nodes * 4 + sig_bytes)
    restore_launches(sk, saved)
    return r


def rt_operators(mg, cells, dtype, dev, seed):
    """The two operators the rt step solves by V-cycles on every level,
    built by the solvers' own constructors from seeded variable
    coefficients, with rt's sides (periodic x and y, Neumann z): the MAC
    Poisson operator (1/rho on faces) and the nodal sigma-Poisson one
    (sigma = dt/rho)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    lo = hi = (0, 0, 1)
    dx = (0.5 / cells[0], 0.5 / cells[1], 1.0 / cells[2])
    faces = []
    for ax in range(3):
        f = 0.5 + 1.5 * rng.random(tuple(
            n + (1 if a == ax else 0) for a, n in enumerate(cells)))
        if ax < 2:              # the periodic face n is face 0
            f = np.concatenate([f.take(range(cells[ax]), axis=ax),
                                f.take([0], axis=ax)], axis=ax)
        faces.append(t(f))
    mac = mg.CellSolver(dx, lo, hi, alpha=0.0, beta=1.0, acoef=None,
                        bcoef=tuple(faces), direct=False)
    rho = 0.5 + 1.5 * rng.random(cells)
    nodal = mg.NodalSolver(dx, (True, True, False), lo, hi,
                           t(0.9 * min(dx) / rho), direct=False)
    return mac, nodal


def hierarchy_cases(mg, torch, dtype, dev):
    """Every level of the shear3d_vd (128x128x32) and rt (64x64x128)
    hierarchies at the call its V-cycles make there: the pre-smooth with
    the residual (cell 1 sweep, nodal 2) above the bottom, the bottom
    smooth (cell 8 sweeps, nodal 24) at it.  [(deck, family, li, solver,
    x, b, nsweeps, want_residual)] with x and b from a seed."""
    import numpy as np
    rng = np.random.default_rng(31)
    mac, vel, nodal = vd_operators(mg, (128, 128, 32),
                                   (1.0 / 128, 1.0 / 128, 0.25 / 32), dtype,
                                   dev, 29, max_levels=30)
    rt_mac, rt_nodal = rt_operators(mg, (64, 64, 128), dtype, dev, 30)
    out = []
    for deck, family, solver in (
            ("shear3d_vd", "cell_smooth", mac),
            ("shear3d_vd", "cell_smooth/3comp", vel),
            ("shear3d_vd", "nodal_smooth", nodal),
            ("rt", WALLED, rt_mac), ("rt", WALLED_NODAL, rt_nodal)):
        last = len(solver.levels) - 1
        for li in range(last + 1):
            shape = tuple(solver.diags[li].shape)
            x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                device=dev)
            b = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                device=dev)
            n = solver.nu_bottom if li == last else solver.nu1
            out.append((deck, family, li, solver, x, b, n, li < last))
    return out


def level_args(mg, solver, li):
    """(coefficients, keywords) of level li as solver._smooth_res passes
    them to its wrapper, after x, b and before nsweeps."""
    lev = solver.levels[li]
    if isinstance(solver, mg.CellSolver):
        dinvs, fhis, fwalls = solver.smoother_coefs()
        return ((solver.diags[li], dinvs[li], fhis[li]),
                dict(bc=(lev.bc_lo, lev.bc_hi), Fwall=fwalls[li]))
    bc = tuple(tuple(0 if per else code
                     for per, code in zip(lev.periodic, codes))
               for codes in (lev.bc_lo, lev.bc_hi))
    return (solver.sigmas[li], solver.dinvs[li], lev.dx), dict(bc=bc)


# shared memory a CTA may opt in to on an H100 (compute capability 9.0)
SMEM_OPTIN = 227 * 1024


def resident_fits(x, cell, bc, nsweeps):
    """Whether a level fits the resident regime's shared memory, by the
    rule of csrc/smoothers.cu (run_cell, run_nodal): the cell iterate,
    twice where a periodic axis is odd; the nodal iterate twice beside
    the tiles of its smallest brick (8x8x8, balanced against the
    level)."""
    import math
    isz = x.element_size()
    if cell:
        odd = nsweeps > 0 and any(lo == 0 and n > 1 and n % 2
                                  for lo, n in zip(bc[0], x.shape))
        return (2 if odd else 1) * x.numel() * isz <= SMEM_OPTIN
    brick = [-(-n // -(-n // 8)) for n in x.shape]
    tile = (math.prod(v + 2 for v in brick)
            + 9 * math.prod(v + 1 for v in brick))
    return (2 * x.numel() + tile) * isz <= SMEM_OPTIN


def graph_launches(sk, fn):
    """Device launches of one fn() call: the kernel nodes of a CUDA graph
    that captured it (after a warm-up call on the capture stream)."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    n = sk.graph_kernels(g)
    del g
    return n


def smooth_bytes(mg, solver, li, x, want):
    """Bytes of one smoother call: each input read once (x, b and the
    coefficients) and each output written once (x and the residual)."""
    isz = x.element_size()
    if isinstance(solver, mg.CellSolver):
        dinvs, fhis, fwalls = solver.smoother_coefs()
        coefs = [solver.diags[li], dinvs[li], *fhis[li]] + [
            w for w in fwalls[li] if w is not None]
    else:
        coefs = [solver.sigmas[li], solver.dinvs[li]]
    return isz * ((3 + want) * x.numel() + sum(c.numel() for c in coefs))


def phase_levels(sk, mg, torch):
    """Per-level table, f32: every level shape of the shear3d_vd and rt
    hierarchies at the call the V-cycles make there, through the solvers'
    own _smooth_res: bit-equal to the plain version; the device launches
    of one call, counted in a CUDA graph that captured it, must be 1; the
    kernel's time (CUDA-graph replay) in the regime it chooses and in the
    other one, forced, unless that is the resident regime and the level
    does not fit its shared memory (decided before the call); the plain
    version's time; the bound; what was launched."""
    dev = torch.device("cuda")
    rows = []
    saved = save_launches(sk)
    for deck, family, li, solver, x, b, n, want in hierarchy_cases(
            mg, torch, torch.float32, dev):
        name = family.split("/")[0]
        cell = isinstance(solver, mg.CellSolver)
        coefs, kw = level_args(mg, solver, li)
        kern = sk.cell_smooth if cell else sk.nodal_smooth
        plain_fn = sk.cell_smooth_plain if cell else sk.nodal_smooth_plain
        call = lambda: solver._smooth_res(x, b, li, n, want)
        plain = lambda: plain_fn(x, b, *coefs, n, want, **kw)
        got, ref = call(), plain()
        if not all(torch.equal(u, v) for u, v in zip(got, ref)
                   if v is not None):
            raise AssertionError(f"{family} level {li}: kernel and plain "
                                 "version differ")
        plan = sk.LAST_PLAN[name]
        row = {"deck": deck, "family": family, "level": li,
               "shape": "x".join(str(v) for v in x.shape),
               "call": f"{n} sweeps" + (" + residual" if want else ""),
               "regime": "resident" if plan[0] == 1 else "grid",
               "ctas": plan[1], "threads": plan[2], "held": plan[3],
               "device_launches": graph_launches(sk, call),
               "ms": device_ms(call), "plain_ms": device_ms(plain),
               "bytes": smooth_bytes(mg, solver, li, x, want),
               "ops": count_ops(plain)}
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"])
        other = 2 if plan[0] == 1 else 1
        row["other_regime_ms"] = row["other_regime_device_launches"] = None
        if other == 2 or resident_fits(x, cell, kw["bc"], n):
            forced = lambda: kern(x, b, *coefs, n, want, **kw,
                                  _regime=other)
            got = forced()
            if sk.LAST_PLAN[name][0] != other or not all(
                    torch.equal(u, v) for u, v in zip(got, ref)
                    if v is not None):
                raise AssertionError(f"{family} level {li}: the forced "
                                     "regime differs from the plain version")
            row["other_regime_device_launches"] = graph_launches(sk, forced)
            row["other_regime_ms"] = device_ms(forced)
        for k in ("device_launches", "other_regime_device_launches"):
            if row[k] not in (1, None):
                raise AssertionError(f"{family} level {li}: one call is "
                                     f"{row[k]} device launches ({k})")
        rows.append(row)
        o = row["other_regime_ms"]
        print(f"[levels] {deck} {family} level {li} {row['shape']}, "
              f"{row['call']}: kernel {row['ms']:.4f} ms ({row['regime']}, "
              f"{row['ctas']} CTAs of {row['threads']}, held {row['held']},"
              f" {row['device_launches']} device launch), other regime "
              + (f"{o:.4f} ms" if o is not None else "does not fit")
              + f", plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    torch.cuda.synchronize()
    check_one_launch(sk, "levels")
    restore_launches(sk, saved)
    return rows


def launch_keys(levels, family):
    """The kernels line's measured device launches of a family: the most
    over its level rows, both regimes, each one call captured in a CUDA
    graph (phase "levels")."""
    vals = [r[k] for r in levels if r["family"].split("/")[0] == family
            for k in ("device_launches", "other_regime_device_launches")
            if r[k] is not None]
    return {"device_launches_per_call": max(vals),
            "device_launches_calls_measured": len(vals),
            "device_launches_measured_by": "kernel nodes of one call "
            "captured in a CUDA graph, every level of the shear3d_vd and "
            "rt hierarchies at the V-cycles' calls, both regimes"}


def phase_solvers_walled(mg, torch):
    """The V-cycle solvers with the rt deck's walls on cuda against cpu,
    f64, 16x16x32, random coefficients: the same iteration count, the
    solution to 1e-12."""
    import numpy as np
    shape = (16, 16, 32)
    dx = (0.5 / 16, 0.5 / 16, 1.0 / 32)
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    neu, dirich = ((0, 0, 1), (0, 0, 1)), ((0, 0, 2), (0, 0, 2))

    def faces(lo, hi):
        out = []
        for ax in range(3):
            f = lo + (hi - lo) * rng.random(
                tuple(n + (1 if a == ax else 0)
                      for a, n in enumerate(shape)))
            if ax < 2:
                f = np.concatenate([f.take(range(shape[ax]), axis=ax),
                                    f.take([0], axis=ax)], axis=ax)
            out.append(t(f))
        return tuple(out)

    rho = t(0.5 + 1.5 * rng.random(shape))
    dt = 0.9 * min(dx)
    cases = (
        ("walled cell poisson (neumann z)",
         mg.CellSolver(dx, *neu, alpha=0.0, beta=1.0, acoef=None,
                       bcoef=faces(0.5, 2.0), direct=False), shape),
        ("walled cell helmholtz (dirichlet z)",
         mg.CellSolver(dx, *dirich, alpha=1.0, beta=0.5 * dt, acoef=rho,
                       bcoef=faces(0.5, 2.0), direct=False), shape),
        ("walled nodal (neumann z)",
         mg.NodalSolver(dx, (True, True, False), *neu, dt / rho,
                        direct=False), (16, 16, 33)))
    for name, solver, rshape in cases:
        rhs = t(rng.standard_normal(rshape))
        x_c, _, it_c = solver.solve_info(rhs)
        x_g, _, it_g = solver.to("cuda").solve_info(rhs.to("cuda"))
        e = rel_state_err(x_g, x_c)
        print(f"[solvers] {name}: {it_g} iterations on cuda, {it_c} on "
              f"cpu; solution relative {e:.3e} (tol 1e-12)", flush=True)
        if it_g != it_c or it_g < 2 or not e <= 1e-12:
            raise AssertionError(f"{name}: cuda and cpu solves disagree")


def phase_solvers(mg, torch):
    """The V-cycle solvers on cuda against cpu, f64, 32x32x8, random
    coefficients: same iteration count, solution to 1e-9."""
    import numpy as np
    shape = (32, 32, 8)
    dx = (1.0 / 32, 1.0 / 32, 0.25 / 8)
    mac, vel, nodal = vd_operators(mg, shape, dx, torch.float64, "cpu", 3,
                                   max_levels=30)
    rng = np.random.default_rng(5)
    for name, solver, comp in (("cell poisson", mac, ()),
                               ("cell helmholtz x3", vel, (3,)),
                               ("nodal", nodal, ())):
        rhs = torch.as_tensor(rng.standard_normal(shape + comp))
        x_c, _, it_c = solver.solve_info(rhs)
        x_g, _, it_g = solver.to("cuda").solve_info(rhs.to("cuda"))
        e = rel_state_err(x_g, x_c)
        print(f"[solvers] {name}: {it_g} iterations on cuda, {it_c} on "
              f"cpu; solution relative {e:.3e} (tol 1e-9)", flush=True)
        if it_g != it_c or it_g < 2 or not e <= 1e-9:
            raise AssertionError(f"{name}: cuda and cpu solves disagree")


def rel_state_err(a, b):
    import torch
    a = a.detach().cpu().to(torch.float64)
    b = b.detach().cpu().to(torch.float64)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def perturbed_density(grid):
    """1 + 0.4 sin(2 pi x) sin(2 pi y) cos(8 pi z) at the cell centres."""
    import numpy as np
    c = [lo + (np.arange(n) + 0.5) * d
         for n, lo, d in zip(grid.n_cell, grid.prob_lo, grid.dx)]
    x, y, z = np.meshgrid(*c, indexing="ij")
    return 1.0 + 0.4 * (np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)
                        * np.cos(8 * np.pi * z))


def vd_start(sim, start, torch):
    """The two starts of shear3d_vd: init_state, or that state with the
    density replaced by perturbed_density (a 0.6-1.4 contrast)."""
    from incflo_torch import state as st
    s = sim.init_state()
    if start == "perturbed_density":
        d = st.sim_to_numpy(s)
        d["density"] = perturbed_density(sim.grid)
        s = st.sim_from_numpy(d, sim.device, sim.dtype)
    return s


# the CPU halves of the "paths" runs by key, computed while nvcc builds
# the kernels (cpu_paths_ahead)
CPU_RUNS = {}


def cpu_half(key, run):
    """The CPU half of a paths run: the one computed ahead, else run()."""
    return CPU_RUNS.pop(key) if key in CPU_RUNS else run()


def paths_cfg(incflo_torch, name):
    return incflo_torch.IncfloConfig.from_text(
        rt_deck(32, "float64") if name == "rt"
        else tgv2d_deck(32, "float64") if name == "tgv2d"
        else shear3d_deck(32, "float64", name == "shear3d_vd"))


def paths_cpu(incflo_torch, torch, name):
    """phase_paths' CPU half: each start (numpy) and the state 3 steps
    later on cpu."""
    from incflo_torch import state as st
    sim_c = incflo_torch.Simulation(paths_cfg(incflo_torch, name),
                                    device="cpu")
    out = []
    for start in (("init_state", "perturbed_density")
                  if name == "shear3d_vd" else ("init_state",)):
        s_c = vd_start(sim_c, start, torch)
        init = st.sim_to_numpy(s_c)
        for _ in range(3):
            s_c = sim_c.advance(s_c)
        out.append((start, init, s_c))
    return out


def phase_paths(incflo_torch, torch, vd=False, rt=False, tgv=False):
    """The step on cuda (kernels) and on cpu (plain versions), f64 (so
    tgv2d takes its plain step on the card too: only float32 is fused)."""
    from incflo_torch import state as st
    name = "rt" if rt else "shear3d_vd" if vd else "tgv2d" if tgv \
        else "shear3d"
    cpu = cpu_half(("paths", name),
                   lambda: paths_cpu(incflo_torch, torch, name))
    sim_g = incflo_torch.Simulation(paths_cfg(incflo_torch, name),
                                    device="cuda")
    fields = ("velocity", "p", "gp") + (
        ("density", "tracer", "mac_phi") if vd or rt else
        ("mac_phi",) if tgv else ())
    worst = 0.0
    for start, init, s_c in cpu:
        s_g = st.sim_from_numpy(init, "cuda", torch.float64)
        for _ in range(3):
            s_g = sim_g.advance(s_g)
        torch.cuda.synchronize()
        for f in fields:
            e = rel_state_err(getattr(s_g.level, f), getattr(s_c.level, f))
            print(f"[paths] {name} from {start}, {f}: cuda vs cpu relative "
                  f"{e:.3e} (tol 1e-9)", flush=True)
            worst = max(worst, e)
            if not e <= 1e-9:
                raise AssertionError(f"{name} from {start}: cuda and cpu "
                                     f"steps disagree in {f}: {e:.3e}")
    return worst


A9C_FIELDS = ("velocity", "density", "tracer", "p", "gp", "mac_phi")
# the steps of the A9c, 3D MOL, A8 and A11 "paths" runs on cuda and cpu
PATH_STEPS = 2
ITER_KINDS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")


def paths_a9c_cpu(incflo_torch, mg, torch, name):
    """phase_paths_a9c's CPU half: the start (numpy), the state
    PATH_STEPS later on cpu and its solvers' iterations."""
    from incflo_torch import state as st
    from incflo_torch.probs import smooth_perturbation
    deck, n, _ = A9C_DECKS[name]
    cfg = incflo_torch.IncfloConfig.from_text(deck(n, "float64"))
    sim_c = incflo_torch.Simulation(cfg, device="cpu")
    s_c = sim_c.init_state()
    if name == "bingham":
        s_c = s_c._replace(level=s_c.level._replace(
            velocity=s_c.level.velocity + torch.as_tensor(
                smooth_perturbation(cfg.grid, 11))))
    init = st.sim_to_numpy(s_c)
    mg.reset_counts()
    s_c = sim_c.advance_n(s_c, PATH_STEPS)
    return init, s_c, {k: mg.COUNTS[k] for k in ITER_KINDS}


def phase_paths_a9c(incflo_torch, mg, torch, name):
    """An A9c or 3D MOL deck at its "paths" size, float64, PATH_STEPS on
    cuda (kernels) and on cpu (plain versions) from one state (bingham's
    perturbed by probs.smooth_perturbation): every field and dt to 1e-9
    relative; the solvers' iterations of both runs printed."""
    from incflo_torch import state as st
    deck, n, _ = A9C_DECKS[name]
    cfg = incflo_torch.IncfloConfig.from_text(deck(n, "float64"))
    init, s_c, it_c = cpu_half(("a9c", name), lambda: paths_a9c_cpu(
        incflo_torch, mg, torch, name))
    sim_g = incflo_torch.Simulation(cfg, device="cuda")
    s_g = st.sim_from_numpy(init, "cuda", torch.float64)
    mg.reset_counts()
    s_g = sim_g.advance_n(s_g, PATH_STEPS)
    torch.cuda.synchronize()
    iters = [it_c, {k: mg.COUNTS[k] for k in ITER_KINDS}]
    worst = 0.0
    for f in A9C_FIELDS + ("dt",):
        a = s_g.dt if f == "dt" else getattr(s_g.level, f)
        b = s_c.dt if f == "dt" else getattr(s_c.level, f)
        e = rel_state_err(a, b)
        worst = max(worst, e)
        if not e <= 1e-9:
            raise AssertionError(f"paths {name}: cuda and cpu steps disagree "
                                 f"in {f}: {e:.3e}")
    print(f"[paths] {name} {cfg.grid.n_cell} f64, {PATH_STEPS} steps: "
          f"cuda vs cpu "
          f"worst relative {worst:.3e} (tol 1e-9) over "
          f"{', '.join(A9C_FIELDS)}, dt; iterations cpu {iters[0]}, cuda "
          f"{iters[1]}", flush=True)
    return worst


def phase_paths_tgv2d_explicit(incflo_torch, s2, torch):
    """tgv2d at 32^2 with explicit diffusion, float32, through
    Simulation.advance on cuda: outside the fused kernel's scope, so the
    plain step runs and step2d is launched no time."""
    cfg = incflo_torch.IncfloConfig.from_text(tgv2d_deck(32, "float32")
                                              + EXPLICIT)
    sim = incflo_torch.Simulation(cfg)
    s = sim.init_state()
    a0 = float(s.level.velocity.abs().max())
    s2.reset_launches()
    s = sim.advance_n(s, 3)
    torch.cuda.synchronize()
    if s2.LAUNCHES["step2d"] != 0 or sim._fused is not None:
        raise AssertionError(f"tgv2d explicit: step2d launched "
                             f"{s2.LAUNCHES['step2d']} times")
    why = s2.out_of_scope(sim)
    a3 = float(s.level.velocity.abs().max())
    if why != "explicit diffusion" or not 0.9 * a0 < a3 < a0:
        raise AssertionError(f"tgv2d explicit: scope {why!r}, amplitude "
                             f"{a0} -> {a3}")
    print(f"[paths] tgv2d 32^2 explicit diffusion f32 on cuda: 3 plain "
          f"steps (step2d launches 0, out of scope: {why}), amplitude "
          f"{a0:.6f} -> {a3:.6f}", flush=True)


TOL_STEP2D_F32 = (1e-4, 1e-5)     # rtol, atol (tests/test_pallas_step2d.py)
TOL_STEP2D_F64 = 1e-9
# float32 against a float64 step_plain from the same start: the kernel's
# error may be at most this many times step_plain's own, plus 4 ulps of
# the field's max
TRUTH_RATIO = 2.0
STEP2D_FIELDS = ("velocity", "p", "gp", "mac_phi", "dt")
STEP2D_SIZES = (32, 128, 256)


def step2d_err(a, b, dtype, torch):
    """(error, elementwise error).  float32: max |a - b| / (atol + rtol
    max |b|) and numpy allclose's elementwise max(|a - b| / (atol + rtol
    |b|)), each passing at <= 1; float64: max |a - b| / max |b| for both."""
    a = a.detach().double()
    b = b.detach().double()
    if dtype == torch.float32:
        rtol, atol = TOL_STEP2D_F32
        d = (a - b).abs()
        return (float(d.max() / (atol + rtol * b.abs().max())),
                float((d / (atol + rtol * b.abs())).max()))
    e = float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))
    return e, e


def _field(s, f):
    return getattr(s, f) if f == "dt" else getattr(s.level, f)


PROBE_REPS = 5


def probe_median(fs, s0, torch):
    """The fused step's probe instantiation on s0, PROBE_REPS times after
    a warm-up: the median ms of each kind of segment and of the total."""
    for _ in range(2):
        fs.probe(s0)
    splits = [fs.probe(s0)[1] for _ in range(PROBE_REPS)]
    return {"ms": {k: statistics.median(sp["ms"][k] for sp in splits)
                   for k in splits[0]["ms"]},
            "total_ms": statistics.median(sp["total_ms"] for sp in splits),
            "barriers": splits[0]["barriers"]}


def phase_step2d(incflo_torch, s2, skm, torch):
    """The fused step kernel against step_plain on the card, tgv2d from
    init_state, 3 steps compared after each, at 32^2 and at the main
    path's 128^2 and 256^2, f64 and f32.  float32 is also held, with
    step_plain in float32, against a float64 step_plain from the same
    start: gp is a difference of neighbouring nodal phi values over dx,
    so each float32 implementation's last-bit noise in phi reaches gp n/2
    pi-fold, and where gp crosses zero the elementwise bound sits at that
    floor.  gp is held to rtol/atol of its max and to that witness; every
    other field also elementwise.  Then the f32 times at 128^2 and
    256^2, kernel and plain step, under CUDA-graph replay."""
    from incflo_torch import state as st
    eps32 = float(torch.finfo(torch.float32).eps)
    res = {"max_abs_err": 0.0, "max_err_f32": 0.0, "max_rel_err_f64": 0.0,
           "max_elementwise_err_f32": 0.0, "cases": 0,
           "worst_cg_res_over_tol": 0.0, "by_n": {}}
    saved = dict(s2.LAUNCHES)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
        for n in STEP2D_SIZES:
            cfg = incflo_torch.IncfloConfig.from_text(tgv2d_deck(n, name))
            sim = incflo_torch.Simulation(cfg, device="cuda")
            fs = s2.FusedStep(sim)
            sk = sp = sim.init_state()
            if f32:
                sim64 = incflo_torch.Simulation(
                    incflo_torch.IncfloConfig.from_text(
                        tgv2d_deck(n, "float64")), device="cuda")
                s64 = st.sim_from_numpy(st.sim_to_numpy(sk), "cuda",
                                        torch.float64)
            by_n = res["by_n"].setdefault(f"{name} {n}", {
                "err": 0.0, "elementwise_err": {}, "truth_kernel": {},
                "truth_plain": {}})
            for k in range(1, 4):
                n0 = s2.LAUNCHES["step2d"]
                sk, cg_k = fs.step(sk)
                cg_p = []
                sp = s2.step_plain(sim, sp, cg_p)
                if f32:
                    s64 = s2.step_plain(sim64, s64)
                torch.cuda.synchronize()
                if s2.LAUNCHES["step2d"] != n0 + 1:
                    raise AssertionError("step2d: the wrapper launched no "
                                         "kernel")
                errs, elem, tk, tp = {}, {}, {}, {}
                for f in STEP2D_FIELDS:
                    a, b = _field(sk, f), _field(sp, f)
                    errs[f], elem[f] = step2d_err(a, b, dtype, torch)
                    res["cases"] += 1
                    if f32:
                        res["max_abs_err"] = max(res["max_abs_err"],
                                                 abs_err(a.double(),
                                                         b.double()))
                        ref = _field(s64, f)
                        tk[f] = rel_state_err(a, ref)
                        tp[f] = rel_state_err(b, ref)
                        by_n["truth_kernel"][f] = max(
                            by_n["truth_kernel"].get(f, 0.0), tk[f])
                        by_n["truth_plain"][f] = max(
                            by_n["truth_plain"].get(f, 0.0), tp[f])
                        by_n["elementwise_err"][f] = max(
                            by_n["elementwise_err"].get(f, 0.0), elem[f])
                worst = max(errs.values())
                by_n["err"] = max(by_n["err"], worst)
                if f32:    # gp is held to its max and to the witness
                    res["max_elementwise_err_f32"] = max(
                        res["max_elementwise_err_f32"],
                        max(e for f, e in elem.items() if f != "gp"))
                key = "max_err_f32" if f32 else "max_rel_err_f64"
                res[key] = max(res[key], worst)
                cg_k = [float(v) for v in cg_k]
                cg_p = [float(v) for pair in cg_p for v in pair]
                ratio = max(cg_k[0] / cg_k[1], cg_k[2] / cg_k[3],
                            cg_p[0] / cg_p[1], cg_p[2] / cg_p[3])
                res["worst_cg_res_over_tol"] = max(
                    res["worst_cg_res_over_tol"], ratio)
                barriers, t0, t1 = (int(v) for v in fs.diag.tolist())
                print(f"[step2d] {name} {n}^2 step {k}: "
                      + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
                      + ("; elementwise " + ", ".join(
                          f"{f} {e:.2e}" for f, e in elem.items())
                         + "; against float64 step_plain, kernel/plain "
                         + ", ".join(f"{f} {tk[f]:.2e}/{tp[f]:.2e}"
                                     for f in STEP2D_FIELDS)
                         if f32 else "")
                      + f"; CG residual/tolerance kernel {cg_k[0]:.3e}/"
                      f"{cg_k[1]:.3e}, {cg_k[2]:.3e}/{cg_k[3]:.3e}, plain "
                      f"{cg_p[0]:.3e}/{cg_p[1]:.3e}, {cg_p[2]:.3e}/"
                      f"{cg_p[3]:.3e}; {t0} + {t1} CG trips, {barriers} "
                      f"grid barriers, {fs.blocks} blocks", flush=True)
                tag = f"step2d {name} {n}^2 step {k}"
                if ratio > 1.0:
                    raise AssertionError(f"{tag}: a tensor CG missed its "
                                         f"tolerance")
                if f32 and not worst <= 1.0:
                    raise AssertionError(f"{tag}: the kernel and step_plain "
                                         f"differ beyond rtol 1e-4 / atol "
                                         f"1e-5 of the field's max")
                if f32 and not all(e <= 1.0 for f, e in elem.items()
                                   if f != "gp"):
                    raise AssertionError(f"{tag}: the kernel and step_plain "
                                         f"differ beyond rtol 1e-4 / atol "
                                         f"1e-5 elementwise: {elem}")
                if f32 and not all(tk[f] <= TRUTH_RATIO * tp[f] + 4 * eps32
                                   for f in STEP2D_FIELDS):
                    raise AssertionError(f"{tag}: against float64, the "
                                         f"kernel's error {tk} exceeds "
                                         f"{TRUTH_RATIO} x step_plain's "
                                         f"{tp}")
                if not f32 and not worst <= TOL_STEP2D_F64:
                    raise AssertionError(f"{tag}: the kernel and step_plain "
                                         f"differ by {worst:.3e}")
    # the main path's shapes, tgv2d f32 from init_state: kernel and
    # plain times, device launches of a captured call, the probe's split,
    # the bound, and the transforms' FP64 floors
    res["ms_by_n"], res["plain_ms_by_n"], res["at"] = {}, {}, {}
    for n in (256, 128):
        cfg = incflo_torch.IncfloConfig.from_text(tgv2d_deck(n, "float32"))
        sim = incflo_torch.Simulation(cfg, device="cuda")
        s0 = sim.init_state()
        fs = s2.FusedStep(sim)
        r = {"ms": device_ms(lambda: fs.step(s0)),
             "plain_ms": device_ms(lambda: s2.step_plain(sim, s0)),
             "device_launches": graph_launches(skm, lambda: fs.step(s0)),
             "probe": probe_median(fs, s0, torch),
             "plan": fs.plan._asdict(),
             "max_blocks": s2.max_blocks(torch.float32, (n, n))}
        if r["device_launches"] != 1:
            raise AssertionError(f"step2d {n}^2: one call is "
                                 f"{r['device_launches']} device launches")
        r["barriers_per_step"], r["trips_pred"], r["trips_corr"] = (
            int(v) for v in fs.diag.tolist())
        r["grid_blocks"] = fs.blocks
        cells, isz = n * n, 4
        # the state read once and written once: velocity, density, gp in;
        # velocity, gp, p, mac_phi out; the scalars and the CG record
        r["bytes"] = 11 * cells * isz + 13 * isz + 8
        # what this state needs: the adaptive plain step runs the CG trips
        # the kernel runs (the same live rule), not all FIXED_TRIPS
        r["ops"], r["transform_ops"] = count_ops(
            lambda: sim._advance_impl(s0), split=True)
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
        # the transforms alone in double: at the FP64 tensor-core (DMMA)
        # rate and at the FP64 FMA rate
        r["transform_dmma_floor_ms"] = r["transform_ops"] / PEAK_DMMA * 1e3
        r["transform_fma_floor_ms"] = (r["transform_ops"]
                                       / PEAK_OPS["float64"] * 1e3)
        res["at"][n] = r
        res["ms_by_n"][n] = r["ms"]
        res["plain_ms_by_n"][n] = r["plain_ms"]
        pr = r["probe"]
        print(f"[step2d] f32 {n}^2: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms (CUDA-graph replay, median of 25), "
              f"{r['device_launches']} kernel node a call; bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B, "
              f"{r['ops']} ops), transforms {r['transform_ops']} ops: "
              f"{r['transform_dmma_floor_ms']:.5f} ms at the DMMA rate, "
              f"{r['transform_fma_floor_ms']:.5f} at the FP64 FMA rate; "
              f"{r['barriers_per_step']} grid barriers and "
              f"{r['trips_pred']} + {r['trips_corr']} CG trips a step, "
              f"{r['grid_blocks']} blocks of at most {r['max_blocks']}; "
              f"probe (median of {PROBE_REPS}) total "
              f"{pr['total_ms']:.4f} ms = " + ", ".join(
                  f"{k} {v:.4f}" for k, v in pr["ms"].items()), flush=True)
    s2.LAUNCHES.update(saved)      # comparison launches do not count
    for k in ("ms", "plain_ms", "bytes", "ops", "bound_ms", "bound_by",
              "barriers_per_step", "trips_pred", "trips_corr",
              "grid_blocks", "max_blocks", "device_launches"):
        res[k] = res["at"][128][k]
    res["bound_ms_256"] = res["at"][256]["bound_ms"]
    print(f"[step2d] float32 against float64 step_plain (max over 3 steps, "
          f"kernel/plain): " + "; ".join(
              f"{k}: " + ", ".join(
                  f"{f} {v['truth_kernel'][f]:.2e}/{v['truth_plain'][f]:.2e}"
                  for f in STEP2D_FIELDS)
              for k, v in res["by_n"].items() if k.startswith("float32")),
          flush=True)
    return res


def decay_check(sim, s, a0, torch):
    """|u| amplitude over its start against the exact Taylor-Green decay
    exp(-8 pi^2 mu t / rho0): returns the relative difference."""
    import math
    cfg = sim.cfg
    amp = float(s.level.velocity.abs().max()) / a0
    exact = math.exp(-8.0 * math.pi ** 2 * cfg.mu / cfg.ro_0 * float(s.t))
    return abs(amp / exact - 1.0)


def plain_steps(sim):
    """(s, k) -> s after k plain steps, Simulation._advance_impl: on the
    card, tgv2d's step without the fused kernel."""
    def run(s, k):
        for _ in range(k):
            s = sim._advance_impl(s)
        return s
    return run


def run_tgv2d(incflo_torch, mods, torch, n, fused, warm, steps):
    """One timed tgv2d run at n^2 f32, fused (Simulation.advance_n) or
    the plain step; launch counters set to 0 just before its steps and
    read just after.  Returns (row, sim, s, run)."""
    cfg = incflo_torch.IncfloConfig.from_text(tgv2d_deck(n, "float32"))
    sim = incflo_torch.Simulation(cfg)
    run = sim.advance_n if fused else plain_steps(sim)
    s = sim.init_state()
    a0 = float(s.level.velocity.abs().max())
    torch.cuda.synchronize()
    for m in mods:
        m.reset_launches()
    s = run(s, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = run(s, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {}
    for m in mods:
        launches.update(m.LAUNCHES)
    total = warm + steps
    tag = f"tgv2d {n}^2 {'fused' if fused else 'unfused'}"
    want = {k: (total if fused and k == "step2d" else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    for f in ("velocity", "p", "gp", "mac_phi"):
        if not bool(torch.isfinite(getattr(s.level, f)).all()):
            raise AssertionError(f"{tag}: non-finite {f}")
    decay = decay_check(sim, s, a0, torch)
    if not decay <= 1e-3:
        raise AssertionError(f"{tag}: amplitude off the exact decay by "
                             f"{decay:.3e}")
    resid, div_rel = projection_check(sim, s, torch)
    if not resid <= 1e-5:
        raise AssertionError(f"{tag}: nodal solve residual {resid:.3e}")
    if not div_rel <= 1e-2:
        raise AssertionError(f"{tag}: |div u| dx/|u| = {div_rel:.3e}")
    ms = (t1 - t0) / steps * 1e3
    diag = None
    if fused:
        diag = [int(v) for v in sim._fused.diag.tolist()]
    print(f"[main] {tag} f32: {ms:.3f} ms/step, {n * n / (ms * 1e-3):.4e} "
          f"cells/s over {steps} steps after {warm} warm-up; launches per "
          f"step {launches.get('step2d', 0) / total:g} step2d; "
          f"t={float(s.t):.6f} dt={float(s.dt):.6e}; amplitude vs exact "
          f"decay {decay:.2e}; nodal residual {resid:.2e}, |div u| dx/|u| "
          f"{div_rel:.2e}" + (f"; last step: {diag[0]} grid barriers, "
                              f"{diag[1]} + {diag[2]} CG trips"
                              if diag else ""), flush=True)
    return {"deck": "tgv2d", "fused": fused, "n_cell": [n, n],
            "ms_per_step": ms, "cells_per_s": n * n / (ms * 1e-3),
            "steps": steps, "warmup": warm, "launches": launches,
            "launches_per_step": launches.get("step2d", 0) / total,
            "decay_err": decay, "nodal_residual": resid, "div_rel": div_rel,
            "last_step_barriers_trips": diag}, sim, s, run


def phase_main_tgv2d(incflo_torch, mods, torch, profile, kernel_ms,
                     warm=2, steps=20):
    """tgv2d at 128^2 and 256^2, fused and unfused in turns; kernel_ms
    holds the fused kernel's graph-replay time at each n for the
    profile."""
    rows, profiled = [], set()
    for n in (128, 256):
        for fused in (True, False, False, True):
            r, sim, s, run = run_tgv2d(incflo_torch, mods, torch, n, fused,
                                       warm, steps)
            rows.append(r)
            if profile and (n, fused) not in profiled:
                profiled.add((n, fused))
                phase_profile(sim, s, torch,
                              f"{n} tgv2d {'fused' if fused else 'unfused'}",
                              r["ms_per_step"],
                              kernel_ms=kernel_ms[n] if fused else None,
                              run=run)
            del sim, s, run
    return rows


def projection_check(sim, s, torch):
    """Project the final velocity once more with the port's own nodal
    operator L.  The direct solve's residual |L phi - D u| is at the
    rounding of the operator: it is reported relative to |L| |phi|,
    with |L| the magnitude of L's highest (checkerboard) mode.  D u
    itself -- the approximate projection leaves an O(h^2) nodal
    divergence -- is reported relative to |u| / dx."""
    from incflo_torch.ops import multigrid as mg
    grid = sim.grid
    u = s.level.velocity
    upads = sim._pad_vel_for_divergence(u, 1.0)
    solver = sim._nodal_hat
    lev = solver.levels[0]
    rhs = mg._nodes_unique(mg.nodal_divergence(upads, grid.dx), lev)
    rhs = rhs - rhs.mean()
    phi = solver.solve(rhs)
    idx = torch.meshgrid(*[torch.arange(n, device=u.device)
                           for n in rhs.shape], indexing="ij")
    cb = (1 - 2 * (sum(idx) % 2)).to(u.dtype)
    lam_max = float(mg.nodal_apply(cb, lev).abs().max())
    resid = float((mg.nodal_apply(phi, lev) - rhs).abs().max()
                  / (lam_max * phi.abs().max()))
    div_rel = float(rhs.abs().max() * min(grid.dx) / u.abs().max())
    return resid, div_rel


def phase_main(incflo_torch, gk, torch, n, warm, steps):
    cfg = incflo_torch.IncfloConfig.from_text(shear3d_deck(n, "float32"))
    sim = incflo_torch.Simulation(cfg)
    s = sim.init_state()
    torch.cuda.synchronize()
    gk.reset_launches()
    s = sim.advance_n(s, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = sim.advance_n(s, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(gk.LAUNCHES)
    total = warm + steps
    for k, per in PER_STEP.items():
        if launches[k] != per * total:
            raise AssertionError(f"n={n}: kernel {k} launched "
                                 f"{launches[k]} times in {total} steps, "
                                 f"expected {per * total}")
    vel = s.level.velocity
    if not bool(torch.isfinite(vel).all()):
        raise AssertionError(f"n={n}: non-finite velocity")
    cells = 1
    for c in cfg.grid.n_cell:
        cells *= c
    ms = (t1 - t0) / steps * 1e3
    resid, div_rel = projection_check(sim, s, torch)
    if not resid <= 1e-5:
        raise AssertionError(f"n={n}: nodal solve residual {resid:.3e}")
    if not div_rel <= 1e-2:
        raise AssertionError(f"n={n}: |div u| dx/|u| = {div_rel:.3e}")
    print(f"[main] shear3d n={n} {cfg.grid.n_cell} f32: {ms:.3f} ms/step, "
          f"{cells / (ms * 1e-3):.4e} cells/s over {steps} steps after "
          f"{warm} warm-up; t={float(s.t):.6f} dt={float(s.dt):.6e} "
          f"max|u|={float(vel.abs().max()):.6f}; nodal residual "
          f"{resid:.2e}, |div u| dx/|u| {div_rel:.2e}; launches {launches}",
          flush=True)
    return {"n": n, "n_cell": list(cfg.grid.n_cell), "ms_per_step": ms,
            "cells_per_s": cells / (ms * 1e-3), "steps": steps,
            "warmup": warm, "launches": launches, "nodal_residual": resid,
            "div_rel": div_rel}, sim, s


def vd_projection_check(sim, s, mg, torch):
    """The nodal projection of the final velocity once more, at the full
    size on the card: sigma = dt/rho, V-cycles from zero to the deck's
    tolerance.  Returns (residual / tolerance, V-cycles, max |D u|,
    max |D u| dx / |u|)."""
    from incflo_torch.ops import mac_projection
    grid, cfg = sim.grid, sim.cfg
    u = s.level.velocity
    bc_lo, bc_hi = mac_projection.projection_solver_bc(cfg.bc_kind, grid)
    solver = mg.NodalSolver(grid.dx, grid.periodic, bc_lo, bc_hi,
                            s.dt / s.level.density, direct=False)
    rhs = mg._nodes_unique(
        mg.nodal_divergence(sim._pad_vel_for_divergence(u, 1.0), grid.dx),
        solver.levels[0])
    _, res, it = solver.solve_info(rhs, rtol=cfg.nodal_mg_rtol,
                                   atol=cfg.nodal_mg_atol,
                                   maxiter=cfg.nodal_mg_maxiter)
    tol = max(cfg.nodal_mg_rtol * float((rhs - rhs.mean()).abs().max()),
              cfg.nodal_mg_atol)
    div = float(rhs.abs().max())
    return (float(res) / tol, it, div,
            div * min(grid.dx) / float(u.abs().max()))


def check_tallies(tag, per_step):
    """The per-step tallies of a multigrid cell, to the digit.  A cell
    whose tallies differ from TALLIES, or that TALLIES lacks, fails and
    prints its own."""
    keys = TALLIES.get(tag, ("cell_iters", "nodal_cycles", "tensor_cg_iters",
                             "cell_smooth", "nodal_smooth", WALLED,
                             WALLED_NODAL, "host_syncs"))
    got = {k: round(per_step[k], 1) for k in keys}
    if got != TALLIES.get(tag):
        print(f"[tallies] {tag}: " + json.dumps(got), flush=True)
        raise AssertionError(f"{tag}: per-step tallies {got}, expected "
                             f"{TALLIES.get(tag)}")


def phase_main_vd(incflo_torch, gk, sk, mg, torch, start, warm=2, steps=5):
    """shear3d_vd at 128x128x32 f32 on the card from one of its starts."""
    cfg = incflo_torch.IncfloConfig.from_text(
        shear3d_deck(128, "float32", vd=True))
    sim = incflo_torch.Simulation(cfg)
    s = vd_start(sim, start, torch)
    torch.cuda.synchronize()
    gk.reset_launches()
    sk.reset_launches()
    mg.reset_counts()
    s = sim.advance_n(s, warm)
    torch.cuda.synchronize()
    warm_counts = {**mg.COUNTS, **sk.LAUNCHES}
    t0 = time.perf_counter()
    s = sim.advance_n(s, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {**gk.LAUNCHES, **sk.LAUNCHES}
    per_step = {k: (v - warm_counts[k]) / steps
                for k, v in {**mg.COUNTS, **sk.LAUNCHES}.items()}
    total = warm + steps
    for k, per in PER_STEP_VD.items():
        if launches[k] != per * total:
            raise AssertionError(f"shear3d_vd from {start}: kernel {k} "
                                 f"launched {launches[k]} times in {total} "
                                 f"steps, expected {per * total}")
    for k in SMOOTHERS:
        if not per_step[k] > 0:
            raise AssertionError(f"shear3d_vd from {start}: kernel {k} was "
                                 "not launched in the timed steps")
    check_one_launch(sk, f"shear3d_vd from {start}")
    check_tallies(f"shear3d_vd {start}", per_step)
    lvl = s.level
    for f in ("velocity", "density", "tracer", "p", "gp", "mac_phi"):
        if not bool(torch.isfinite(getattr(lvl, f)).all()):
            raise AssertionError(f"shear3d_vd from {start}: non-finite {f}")
    rho_lo, rho_hi = float(lvl.density.min()), float(lvl.density.max())
    if not 0.5 < rho_lo <= rho_hi < 1.5:
        raise AssertionError(f"shear3d_vd from {start}: density left "
                             f"[0.5, 1.5]: {rho_lo}, {rho_hi}")
    cells = 1
    for c in cfg.grid.n_cell:
        cells *= c
    ms = (t1 - t0) / steps * 1e3
    res_over_tol, cycles, div, div_rel = vd_projection_check(sim, s, mg,
                                                             torch)
    if not res_over_tol <= 1.0:
        raise AssertionError(f"shear3d_vd from {start}: the nodal V-cycles "
                             f"stopped at {res_over_tol:.2f} x tolerance")
    if not div_rel <= 1e-2:
        raise AssertionError(f"shear3d_vd from {start}: |div u| dx/|u| = "
                             f"{div_rel:.3e}")
    print(f"[main] shear3d_vd from {start} {cfg.grid.n_cell} f32: "
          f"{ms:.3f} ms/step, {cells / (ms * 1e-3):.4e} cells/s over "
          f"{steps} steps after {warm} warm-up; per step: "
          f"{per_step['cell_iters']:.1f} CG iterations in "
          f"{per_step['cell_solves']:.1f} cell solves, "
          f"{per_step['nodal_cycles']:.1f} nodal V-cycles, "
          f"{per_step['cell_smooth']:.1f} + {per_step['nodal_smooth']:.1f} "
          f"smoother launches, {per_step['host_syncs']:.1f} host syncs; "
          f"t={float(s.t):.6f} dt={float(s.dt):.6e} "
          f"max|u|={float(lvl.velocity.abs().max()):.6f} rho in "
          f"[{rho_lo:.4f}, {rho_hi:.4f}]; max|div u| {div:.3e} "
          f"(dx/|u|: {div_rel:.2e}), re-projection residual "
          f"{res_over_tol:.2f} x tol in {cycles} V-cycles; launches "
          f"{launches}", flush=True)
    return {"deck": "shear3d_vd", "start": start,
            "n_cell": list(cfg.grid.n_cell), "ms_per_step": ms,
            "cells_per_s": cells / (ms * 1e-3), "steps": steps,
            "warmup": warm, "launches": launches, "per_step": per_step,
            "max_div_u": div, "div_rel": div_rel,
            "reprojection_res_over_tol": res_over_tol}, sim, s


def phase_main_rt(incflo_torch, gk, sk, mg, torch, warm=2, steps=5):
    """rt at its bench size, 64x64x128 f32, on the card from init_state."""
    cfg = incflo_torch.IncfloConfig.from_text(rt_deck(128, "float32"))
    sim = incflo_torch.Simulation(cfg)
    s = sim.init_state()
    torch.cuda.synchronize()
    gk.reset_launches()
    sk.reset_launches()
    mg.reset_counts()
    s = sim.advance_n(s, warm)
    torch.cuda.synchronize()
    warm_counts = {**mg.COUNTS, **sk.LAUNCHES}
    t0 = time.perf_counter()
    s = sim.advance_n(s, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {**gk.LAUNCHES, **sk.LAUNCHES}
    per_step = {k: (v - warm_counts[k]) / steps
                for k, v in {**mg.COUNTS, **sk.LAUNCHES}.items()}
    for k in (WALLED, WALLED_NODAL):
        if not per_step[k] > 0:
            raise AssertionError(f"rt: kernel {k} was not launched in the "
                                 "timed steps")
    # by design: every cell and nodal level of this deck has walls and its
    # Godunov chain takes the plain wall forms, so no other kernel may
    # have run
    others = {k: v for k, v in launches.items()
              if k not in (WALLED, WALLED_NODAL) and v}
    if others:
        raise AssertionError(f"rt: unexpected kernel launches {others}")
    check_one_launch(sk, "rt")
    check_tallies("rt", per_step)
    lvl = s.level
    for f in ("velocity", "density", "tracer", "p", "gp", "mac_phi"):
        if not bool(torch.isfinite(getattr(lvl, f)).all()):
            raise AssertionError(f"rt: non-finite {f}")
    if tuple(lvl.p.shape) != (64, 64, 129):
        raise AssertionError(f"rt: nodal pressure shape {tuple(lvl.p.shape)}")
    rho_lo, rho_hi = float(lvl.density.min()), float(lvl.density.max())
    if not 0.45 < rho_lo <= rho_hi < 2.05:
        raise AssertionError(f"rt: density left [0.45, 2.05]: {rho_lo}, "
                             f"{rho_hi}")
    wall_w = float(lvl.velocity[:, :, (0, -1), 2].abs().max())
    cells = 1
    for c in cfg.grid.n_cell:
        cells *= c
    ms = (t1 - t0) / steps * 1e3
    res_over_tol, cycles, div, _ = vd_projection_check(sim, s, mg, torch)
    if not res_over_tol <= 1.0:
        raise AssertionError(f"rt: the nodal V-cycles stopped at "
                             f"{res_over_tol:.2f} x tolerance")
    print(f"[main] rt {cfg.grid.n_cell} f32: {ms:.3f} ms/step, "
          f"{cells / (ms * 1e-3):.4e} cells/s over {steps} steps after "
          f"{warm} warm-up; per step: {per_step['cell_iters']:.1f} CG "
          f"iterations in {per_step['cell_solves']:.1f} cell solves, "
          f"{per_step['nodal_cycles']:.1f} nodal V-cycles, "
          f"{per_step[WALLED]:.1f} {WALLED} + {per_step[WALLED_NODAL]:.1f} "
          f"{WALLED_NODAL} launches, "
          f"{per_step['host_syncs']:.1f} host syncs; t={float(s.t):.6f} "
          f"dt={float(s.dt):.6e} max|u|={float(lvl.velocity.abs().max()):.3e}"
          f" max|w| beside the walls {wall_w:.3e} rho in [{rho_lo:.4f}, "
          f"{rho_hi:.4f}]; max|div u| {div:.3e}, re-projection residual "
          f"{res_over_tol:.2f} x tol in {cycles} V-cycles; launches "
          f"{launches}", flush=True)
    return {"deck": "rt", "start": "init_state",
            "n_cell": list(cfg.grid.n_cell), "ms_per_step": ms,
            "cells_per_s": cells / (ms * 1e-3), "steps": steps,
            "warmup": warm, "launches": launches, "per_step": per_step,
            "max_div_u": div,
            "reprojection_res_over_tol": res_over_tol}, sim, s


def mac_flux_balance(sim, s, torch):
    """The channel's MOL face velocities of the final state after the MAC
    projection (what advects mass and tracer): (flux through the inflow
    face, through the outflow face)."""
    from incflo_torch.ops import mac_projection, mol
    from incflo_torch.ops.stencil import inner
    grid, cfg = sim.grid, sim.cfg
    ng = cfg.nghost_state()
    umac = mol.predict_vels_on_faces(sim.grow_vel(s.level.velocity, ng),
                                     grid, ng, sim.vel_bcrec)
    beta = mac_projection.inv_rho_on_faces(
        inner(sim.grow_rho(s.level.density, ng), ng - 1, grid.ndim), grid)
    umac, _ = mac_projection.project_mac_velocities(
        umac, beta, grid, cfg.bc_kind, rtol=cfg.mac_mg_rtol,
        atol=cfg.mac_mg_atol, maxiter=cfg.mac_mg_maxiter,
        prebuilt_solver=sim._mac_solver, direct=False)
    area = grid.dx[1] * grid.dx[2]
    u = umac[0].to(torch.float64)
    return float(u[0].sum()) * area, float(u[-1].sum()) * area


def nodal_solves(mg, run):
    """Run `run()` and return each iterative nodal solve it made (the
    step's own projections; a direct solve is not listed): (final
    max-norm residual over the tolerance it was held to, V-cycles,
    maxiter), as multigrid.NODAL_LOG records them."""
    return logged_solves(mg, run)[0]


def logged_solves(mg, run):
    """Run `run()`; (its nodal solves as nodal_solves lists them, its
    cell solves whose CG iterated likewise from multigrid.CELL_LOG: the
    best residual over the tolerance, CG iterations, maxiter)."""
    mg.NODAL_LOG, mg.CELL_LOG = [], []
    try:
        run()
        return tuple([(float(res) / float(tol), it, maxiter)
                      for res, tol, it, maxiter in log]
                     for log in (mg.NODAL_LOG, mg.CELL_LOG))
    finally:
        mg.NODAL_LOG = mg.CELL_LOG = None


def phase_main_a9c(incflo_torch, gk, sk, s2, mg, torch, name, warm=2,
                   steps=5):
    """An A9c or 3D MOL deck at its full width, float32, on the card."""
    deck, _, n = A9C_DECKS[name]
    cfg = incflo_torch.IncfloConfig.from_text(deck(n, "float32"))
    sim = incflo_torch.Simulation(cfg)
    s = sim.init_state()
    inside = s.level.tracer[..., 0] < 0.005     # the bubble at t = 0
    torch.cuda.synchronize()
    gk.reset_launches()
    sk.reset_launches()
    s2.reset_launches()
    mg.reset_counts()
    s = sim.advance_n(s, warm)
    torch.cuda.synchronize()
    warm_counts = {**mg.COUNTS, **sk.LAUNCHES}
    t0 = time.perf_counter()
    s = sim.advance_n(s, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {**gk.LAUNCHES, **sk.LAUNCHES, **s2.LAUNCHES}
    if s2.LAUNCHES["step2d"] != 0:
        raise AssertionError(f"{name}: step2d launched "
                             f"{s2.LAUNCHES['step2d']} times on a 3D deck")
    per_step = {k: (v - warm_counts[k]) / steps
                for k, v in {**mg.COUNTS, **sk.LAUNCHES}.items()}
    total = warm + steps
    for k in gk.LAUNCHES:
        want = PER_STEP[k] * total if k in A9C_KERNELS[name] else 0
        if launches[k] != want:
            raise AssertionError(f"{name}: kernel {k} launched {launches[k]} "
                                 f"times in {total} steps, expected {want}")
    for k in sk.LAUNCHES:
        if (per_step[k] > 0) != (k in A9C_KERNELS[name]):
            raise AssertionError(f"{name}: smoother {k} launched "
                                 f"{per_step[k]} times a timed step")
    check_one_launch(sk, name)
    check_tallies(name, per_step)
    lvl = s.level
    for f in A9C_FIELDS:
        if not bool(torch.isfinite(getattr(lvl, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    cells = 1
    for c in cfg.grid.n_cell:
        cells *= c
    ms = (t1 - t0) / steps * 1e3
    out = {"deck": name, "start": "init_state",
           "n_cell": list(cfg.grid.n_cell), "ms_per_step": ms,
           "cells_per_s": cells / (ms * 1e-3), "steps": steps,
           "warmup": warm, "launches": launches, "per_step": per_step}
    vmax = float(lvl.velocity.abs().max())
    if all(cfg.grid.periodic):
        resid, div_rel = projection_check(sim, s, torch)
        if not resid <= 1e-5 or not div_rel <= 1e-2:
            raise AssertionError(f"{name}: nodal residual {resid:.3e}, "
                                 f"|div u| dx/|u| {div_rel:.3e}")
        note = f"nodal residual {resid:.2e}, |div u| dx/|u| {div_rel:.2e}"
        out.update(nodal_residual=resid, div_rel=div_rel)
    else:
        # one more step, each of its nodal solves held to the tolerance
        # it was given, the bubble's to STAGNATION_BOUND times it (a
        # re-projection from zero, as rt's check makes, is no test on the
        # channel: on its walled hierarchy with a Dirichlet outflow the
        # V-cycle diverges from zero on a projected field's divergence,
        # in incflo_tpu too -- ROADMAP C)
        box = [s]

        def one_step():
            box[0] = sim.advance(box[0])
            torch.cuda.synchronize()
        solves = nodal_solves(mg, one_step)
        s = box[0]
        ratios = [r for r, _, _ in solves]
        note = (f"the next step's nodal solves: residual / tol "
                f"{[round(r, 3) for r in ratios]} in "
                f"{[it for _, it, _ in solves]} V-cycles")
        out.update(nodal_res_over_tol=ratios,
                   nodal_cycles=[it for _, it, _ in solves])
        bound = STAGNATION_BOUND if name == "bubble" else 1.0
        if (not solves or max(ratios) > bound
                or any(it >= maxiter for _, it, maxiter in solves)):
            raise AssertionError(f"{name}: the step's nodal solves ended at "
                                 f"{solves} (residual / tolerance, "
                                 f"V-cycles, maxiter); bound {bound}")
        if name == "bingham":
            # a flow along the periodic z between walls, divergence-free
            # by construction: besides its solves, the divergence of the
            # final velocity is rounding
            u = s.level.velocity
            d = mg.nodal_divergence(sim._pad_vel_for_divergence(u, 1.0),
                                    sim.grid.dx)
            div_rel = float(d.abs().max()) * min(sim.grid.dx) / float(
                u.abs().max())
            if not div_rel <= 1e-4:
                raise AssertionError(f"bingham: |div u| dx/|u| {div_rel:.3e}")
            note += f"; |div u| dx/|u| {div_rel:.2e} (tol 1e-4)"
            out["div_rel"] = div_rel
        elif name == "bubble":
            # and as rt's: the final velocity re-projected from zero
            res_over_tol, cycles, div, div_rel = vd_projection_check(
                sim, s, mg, torch)
            if not res_over_tol <= 1.0:
                raise AssertionError(f"bubble: the nodal V-cycles stopped at "
                                     f"{res_over_tol:.2f} x tolerance")
            note += (f"; max|div u| {div:.3e} (dx/|u|: {div_rel:.2e}), "
                     f"re-projection residual {res_over_tol:.2f} x tol in "
                     f"{cycles} V-cycles")
            out.update(max_div_u=div, div_rel=div_rel,
                       reprojection_res_over_tol=res_over_tol)
    if name == "channel":
        f_in, f_out = mac_flux_balance(sim, s, torch)
        bal = abs(f_out - f_in) / f_in
        if not bal <= 1e-4:
            raise AssertionError(f"channel: MAC outflow flux {f_out} against "
                                 f"inflow {f_in} ({bal:.2e})")
        note += (f"; MAC flux in {f_in:.6e}, out {f_out:.6e} (|out - in| / "
                 f"in {bal:.2e}, tol 1e-4)")
        out.update(flux_in=f_in, flux_out=f_out, flux_balance=bal)
    if name == "bingham":
        w = lvl.velocity[..., 2]
        asym = max(float((w - w.flip(0)).abs().max()),
                   float((w - w.flip(1)).abs().max())) / vmax
        if not asym <= 1e-5:
            raise AssertionError(f"bingham: mirror asymmetry {asym:.2e} of "
                                 f"max |u|")
        note += f"; mirror asymmetry {asym:.2e} of max|u| (tol 1e-5)"
        out["mirror_asymmetry"] = asym
    if name == "bubble":
        w = lvl.velocity[..., 2]
        rise = float(w[inside].mean() - w[~inside].mean())
        if not rise > 0:
            raise AssertionError(f"bubble: does not rise ({rise:.3e})")
        note += f"; bubble rises at {rise:.4e} relative to the fluid"
        out["rise"] = rise
    tally = ", ".join(f"{k} {per_step[k]:.1f}" for k in
                      ("cell_iters", "cell_solves", "nodal_cycles",
                       "tensor_cg_iters", "cell_smooth", "nodal_smooth",
                       WALLED, WALLED_NODAL, "host_syncs"))
    print(f"[main] {name} {cfg.grid.n_cell} f32: {ms:.3f} ms/step, "
          f"{cells / (ms * 1e-3):.4e} cells/s over {steps} steps after "
          f"{warm} warm-up; per step: {tally}; t={float(s.t):.6f} "
          f"dt={float(s.dt):.6e} max|u|={vmax:.6f}; {note}; launches "
          f"{launches}", flush=True)
    return out, sim, s


def phase_rt_sections(sim, s, sk, torch, steps=3):
    """Where an rt step's wall time goes: `steps` more steps with the
    walled nodal smoother, the plain walled Godunov calls and the walled
    cell smoother each bracketed by device synchronisations and the host
    clock.  The synchronisations lengthen the step, so the sections are
    reported as shares of this instrumented run."""
    spent = {"nodal_smooth_walled (kernel)": 0.0,
             "walled Godunov predict + advect (plain)": 0.0,
             "cell_smooth_walled (kernel)": 0.0}

    def timed(key, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    keys = list(spent)
    saved = (sk.nodal_smooth, sim.godunov.predict, sim.godunov.advect,
             sk.cell_smooth)
    sk.nodal_smooth = timed(keys[0], saved[0])
    sim.godunov.predict = timed(keys[1], saved[1])
    sim.godunov.advect = timed(keys[1], saved[2])
    sk.cell_smooth = timed(keys[2], saved[3])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sim.advance_n(s, steps)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        sk.nodal_smooth = saved[0]
        sim.godunov.predict, sim.godunov.advect = saved[1], saved[2]
        sk.cell_smooth = saved[3]
    parts = ", ".join(f"{k} {v / steps * 1e3:.2f} ms ({v / total:.2f})"
                      for k, v in spent.items())
    print(f"[sections] rt, {steps} instrumented steps of "
          f"{total / steps * 1e3:.2f} ms: {parts}", flush=True)
    return s


class SmootherCalls:
    """Records each smoother wrapper call made while active, grouped by
    what decides its time (family, level shape, type, sweeps, residual,
    sides), with the arguments of its first call; then times each group
    once under CUDA-graph replay.  The profiler records no device
    activity for a cooperative launch, which is how a smoother call above
    the resident size runs."""

    def __init__(self, sk):
        self.sk = sk
        self.calls = {}

    def __enter__(self):
        self.saved = (self.sk.cell_smooth, self.sk.nodal_smooth)
        for fn in self.saved:
            setattr(self.sk, fn.__name__, self._record(fn))
        return self

    def __exit__(self, *exc):
        self.sk.cell_smooth, self.sk.nodal_smooth = self.saved

    def _record(self, fn):
        def wrapper(*args, **kw):
            x = args[0]
            key = (fn.__name__, tuple(x.shape), str(x.dtype), args[5],
                   args[6], repr(kw.get("bc")))
            entry = self.calls.setdefault(key, [0, fn, args, kw])
            entry[0] += 1
            return fn(*args, **kw)
        return wrapper

    def device_ms(self):
        """Sum over the groups of calls x graph-replay ms, and the calls."""
        total, count = 0.0, 0
        saved = save_launches(self.sk)
        for n, fn, args, kw in self.calls.values():
            total += n * device_ms(lambda: fn(*args, **kw))
            count += n
        restore_launches(self.sk, saved)
        return total, count


SMOOTHER_KERNELS = ("cell_kernel", "nodal_resident", "nodal_grid")


def device_events(prof):
    """([(name, device us)] of the profiled device activity summed by
    name, the host's cudaLaunchCooperativeKernel calls), read from the
    profiler's raw events.  key_averages() would first parse every host
    op of the trace into an event tree, tens of seconds for one step of
    a host-bound deck."""
    from torch.autograd import DeviceType
    dev, coop = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            coop += e.name() == "cudaLaunchCooperativeKernel"
            continue
        dev[e.name()] = dev.get(e.name(), 0.0) + e.duration_ns() * 1e-3
    return list(dev.items()), coop


def phase_profile(sim, s, torch, n, wall_ms, steps=5, kernel_ms=None,
                  run=None, table=True):
    """Device time of `steps` steps by torch.profiler: the busy time per
    step against the step's wall time (from the unprofiled timed run),
    split into the Godunov kernels, the smoother kernels, the fused step
    kernel, matrix products and the rest.  The profiler records no device
    activity for a cooperative launch (only the host's
    cudaLaunchCooperativeKernel call): for the fused step kernel_ms, its
    time under graph replay, stands in for each launch; for the smoothers
    each call made in the profiled steps is timed under graph replay
    (SmootherCalls), and what the profiler saw of them, the resident
    launches, is printed beside it; the line says so.  `run(s, k)` takes
    the steps (sim.advance_n unless given).  Host ops are traced only for
    the table: on a host-bound step of a hundred thousand torch ops
    tracing them cost several times the step."""
    from torch.profiler import ProfilerActivity, profile
    from incflo_torch.ops import smoother_kernels as sk
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if table
                                            else [])
    with SmootherCalls(sk) as smooth, profile(activities=activities) as prof:
        s = (run or sim.advance_n)(s, steps)
        torch.cuda.synchronize()
    if table:
        rows = prof.key_averages()
        print(rows.table(sort_by="cuda_time_total", row_limit=30))
    groups = {"godunov": 0.0, "smoothers": 0.0, "step2d": 0.0,
              "matmul": 0.0, "other": 0.0}
    seen_smoothers = 0.0
    device, coop = device_events(prof)
    for k, us in device:
        if any(t in k for t in ("uad_kernel", "predict_", "advect_")):
            groups["godunov"] += us
        elif any(t in k for t in SMOOTHER_KERNELS):
            seen_smoothers += us
        elif "step2d_kernel" in k:
            groups["step2d"] += us
        elif "gemm" in k or "xmma" in k or "sgemm" in k:
            groups["matmul"] += us
        else:
            groups["other"] += us
    note = ""
    if kernel_ms is not None and coop and groups["step2d"] == 0.0:
        groups["step2d"] = kernel_ms * 1e3 * coop
        note = (f" (step2d not in the trace: {coop} launches x "
                f"{kernel_ms:.4f} ms from graph replay)")
    smooth_ms, ncalls = smooth.device_ms()
    groups["smoothers"] = smooth_ms * 1e3
    if ncalls:
        note += (f" (smoothers: {ncalls} calls in {len(smooth.calls)} kinds, "
                 f"each kind timed under graph replay; the trace saw "
                 f"{seen_smoothers / steps / 1e3:.3f} ms/step of them, the "
                 f"resident launches)")
    busy = sum(groups.values()) / steps / 1e3
    print(f"[profile] n={n}: device busy {busy:.3f} ms/step of "
          f"{wall_ms:.3f} ms/step wall (idle share "
          f"{max(0.0, 1 - busy / wall_ms):.2f}); godunov kernels "
          f"{groups['godunov'] / steps / 1e3:.3f}, smoother kernels "
          f"{groups['smoothers'] / steps / 1e3:.3f}, step2d kernel "
          f"{groups['step2d'] / steps / 1e3:.3f}, matmul "
          f"{groups['matmul'] / steps / 1e3:.3f}, other "
          f"{groups['other'] / steps / 1e3:.3f} ms/step{note}", flush=True)
    return {"busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall_ms),
            **{k: v / steps / 1e3 for k, v in groups.items()}}


# ---------------------------------------------------------------------
# ROADMAP A8 and A11: 2D Godunov, 2D multigrid, embedded boundaries
# ---------------------------------------------------------------------

MAC_PHI = "incflo.use_mac_phi_in_godunov = true\n"
UFT = "incflo.godunov_use_forces_in_trans = true\n"


def tgv2d_godunov_deck(n, dtype, extra=""):
    """tgv2d (bench.py:78-87) with Godunov advection (PPM); `extra` adds
    MAC_PHI or UFT."""
    return tgv2d_deck(n, dtype) + "incflo.use_godunov = true\n" + extra


def rt2d_deck(n, dtype):
    """The x-z section of bench.py's rt deck at n: n/2 x n cells of a
    0.5 x 1 box, periodic x, slip walls on y, probtype 5, gravity
    (0, -0.1), variable density, one advected tracer, Godunov PPM,
    Crank-Nicolson diffusion."""
    return deck_header(dtype) + f"""
amr.n_cell = {n // 2} {n}
geometry.prob_lo = 0. 0.
geometry.prob_hi = 0.5 1.0
geometry.is_periodic = 1 0
ylo.type = "sw"
yhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. -0.1
incflo.use_godunov = true
incflo.constant_density = false
incflo.advect_tracer = true
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.diffusion_type = 1
incflo.cfl = 0.9
incflo.init_shrink = 1.0
"""


def rt2d_patch_deck(dtype):
    """The one-level form of tests/test_amr_patch.py:15-37 (amr.max_level
    = 0): 16 x 32 cells, one initial iteration, the solvers' default
    tolerances."""
    return f"""
incflo.dtype = {dtype}
amr.n_cell = 16 32
amr.max_level = 0
geometry.prob_lo = 0. 0.
geometry.prob_hi = 0.5 1.0
geometry.is_periodic = 1 0
ylo.type = "sw"
yhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. -0.1
incflo.use_godunov = true
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.cfl = 0.9
incflo.init_shrink = 1.0
incflo.initial_iterations = 1
"""


def channel_cyl_deck(n, dtype):
    """channel_cyl of bench.py:125-150 with its cylinder: channel_deck
    and a cylinder of radius 0.05 along z at (0.15, 0.2), a body in the
    flow."""
    return channel_deck(n, dtype) + """
incflo.geometry = "cylinder"
cylinder.internal_flow = false
cylinder.radius = 0.05000001
cylinder.direction = 2
cylinder.center = 0.15 0.2 0.0
"""


def bingham_cyl_deck(n, dtype):
    """poiseuille_cyl_bingham of bench.py:107-124 with its cylinder: n x n
    x max(n/4, 8) cells of a 4 x 4 x 0.5 box, fully periodic, the fluid
    inside a cylinder of radius 1 along z, MOL, a Bingham fluid (mu 1,
    tau_0 1, papa_reg 0.001) driven by delp (0, 0, 2), fixed dt 0.01."""
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n} {max(n // 4, 8)}
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 4. 4. 0.5
geometry.is_periodic = 1 1 1
incflo.delp = 0. 0. 2.
incflo.geometry = "cylinder"
cylinder.internal_flow = true
cylinder.radius = 1.
cylinder.direction = 2
cylinder.center = 2. 2. 0.
incflo.fluid_model = "bingham"
incflo.mu = 1.
incflo.tau_0 = 1.
incflo.papa_reg = 0.001
incflo.fixed_dt = 0.01
"""


# the "paths" decks of A8 and A11 (name -> deck text, f64) and the "main"
# cells (name -> deck of (n, dtype), n)
A8_A11_PATHS = {
    "tgv2d_godunov": tgv2d_godunov_deck(32, "float64"),
    "tgv2d_godunov mac_phi": tgv2d_godunov_deck(32, "float64", MAC_PHI),
    "tgv2d_godunov forces_in_trans": tgv2d_godunov_deck(32, "float64", UFT),
    "shear3d mac_phi": shear3d_deck(32, "float64") + MAC_PHI,
    "rt2d": rt2d_patch_deck("float64"),
    "channel_cyl": channel_cyl_deck(32, "float64"),
    "poiseuille_cyl_bingham": bingham_cyl_deck(16, "float64"),
}
A8_A11_MAIN = {
    "channel_cyl": (channel_cyl_deck, 128),
    "poiseuille_cyl_bingham": (bingham_cyl_deck, 128),
    "tgv2d_godunov": (tgv2d_godunov_deck, 128),
    "rt2d": (rt2d_deck, 128),
}
# the kernels each main cell must launch (every other kernel no time):
# none on the 2D decks (their Godunov chain and V-cycles are plain
# PyTorch, as incflo_tpu's are jnp); on the EB decks the cell smoother on
# the area-fraction MAC levels and the cut-cell velocity and tracer
# levels (walled on the channel, periodic on the Bingham deck) -- the
# prebuilt cut-cell nodal operator takes its plain 27-point sweep
A8_A11_KERNELS = {
    "channel_cyl": (WALLED,),
    "poiseuille_cyl_bingham": ("cell_smooth",),
    "tgv2d_godunov": (),
    "rt2d": (),
}


# the next step's cell CG solves (MAC, cut-cell velocity, tracer) of the
# EB cells, held to this many times their tolerance: channel_cyl's
# converge (0.55-0.80 on an H100); poiseuille_cyl_bingham's cut-cell
# velocity solves stop on stagnation (2.15e4 x on an H100 in f32;
# incflo_tpu's and the port's alike up to 1.3e6 x at 32x32x8 in f64 on
# the CPU, tests/test_torch_eb_bingham32.py; ROADMAP C)
CELL_STAGNATION_BOUND = {"channel_cyl": 1.0, "poiseuille_cyl_bingham": 1e5}


def paths_a8_a11_cpu(incflo_torch, mg, torch, name):
    """phase_paths_a8_a11's CPU half, as paths_a9c_cpu."""
    from incflo_torch import state as st
    from incflo_torch.probs import smooth_perturbation
    cfg = incflo_torch.IncfloConfig.from_text(A8_A11_PATHS[name])
    sim_c = incflo_torch.Simulation(cfg, device="cpu")
    s_c = sim_c.init_state()
    if name == "poiseuille_cyl_bingham":
        p = torch.as_tensor(smooth_perturbation(cfg.grid, 11))
        s_c = s_c._replace(level=s_c.level._replace(
            velocity=s_c.level.velocity + p * sim_c.eb.fluid[..., None]))
    init = st.sim_to_numpy(s_c)
    mg.reset_counts()
    s_c = sim_c.advance_n(s_c, PATH_STEPS)
    return init, s_c, {k: mg.COUNTS[k] for k in ITER_KINDS}


def phase_paths_a8_a11(incflo_torch, gk, mg, torch, name):
    """An A8 / A11 deck, float64, PATH_STEPS on cuda (kernels) and on cpu
    (plain versions) from one state (the Bingham cylinder's perturbed by
    probs.smooth_perturbation, zero in covered cells): every field and dt
    to 1e-9 relative and the solvers' iterations equal.  shear3d with
    use_mac_phi_in_godunov: its predict takes the plain chain (no uad or
    predict_d launch), its advect the kernel."""
    from incflo_torch import state as st
    cfg = incflo_torch.IncfloConfig.from_text(A8_A11_PATHS[name])
    init, s_c, it_c = cpu_half(("a8_a11", name), lambda: paths_a8_a11_cpu(
        incflo_torch, mg, torch, name))
    sim_g = incflo_torch.Simulation(cfg, device="cuda")
    s_g = st.sim_from_numpy(init, "cuda", torch.float64)
    gk.reset_launches()
    mg.reset_counts()
    s_g = sim_g.advance_n(s_g, PATH_STEPS)
    torch.cuda.synchronize()
    iters = [it_c, {k: mg.COUNTS[k] for k in ITER_KINDS}]
    worst = 0.0
    for f in A9C_FIELDS + ("dt",):
        a = s_g.dt if f == "dt" else getattr(s_g.level, f)
        b = s_c.dt if f == "dt" else getattr(s_c.level, f)
        e = rel_state_err(a, b)
        worst = max(worst, e)
        if not e <= 1e-9:
            raise AssertionError(f"paths {name}: cuda and cpu steps disagree "
                                 f"in {f}: {e:.3e}")
    if iters[0] != iters[1]:
        raise AssertionError(f"paths {name}: iterations cpu {iters[0]}, "
                             f"cuda {iters[1]}")
    godunov = {k: gk.LAUNCHES[k] for k in ("uad", "predict_d", "advect")}
    if name == "shear3d mac_phi" and not (
            godunov["advect"] > 0 and godunov["uad"] == godunov["predict_d"]
            == 0):
        raise AssertionError(f"paths {name}: Godunov launches {godunov}")
    print(f"[paths] {name} {cfg.grid.n_cell} f64, {PATH_STEPS} steps: "
          f"cuda vs cpu "
          f"worst relative {worst:.3e} (tol 1e-9) over "
          f"{', '.join(A9C_FIELDS)}, dt; iterations equal {iters[0]}; "
          f"Godunov kernel launches {godunov}", flush=True)
    return worst


def phase_main_a8_a11(incflo_torch, gk, sk, s2, mg, torch, name, warm=2,
                      steps=5):
    """An A8 / A11 cell at its full width, float32, on the card: ms/step,
    the kernels' launches (counters zeroed just before the warm-up and
    read just after the timed steps), the per-step tallies, finite
    fields, covered cells at rest, the next step's nodal solves; then
    one profiled step for the device idle share."""
    deck, n = A8_A11_MAIN[name]
    cfg = incflo_torch.IncfloConfig.from_text(deck(n, "float32"))
    t_setup = time.perf_counter()
    sim = incflo_torch.Simulation(cfg)
    s = sim.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    a0 = float(s.level.velocity.abs().max())
    gk.reset_launches()
    sk.reset_launches()
    s2.reset_launches()
    mg.reset_counts()
    s = sim.advance_n(s, warm)
    torch.cuda.synchronize()
    warm_counts = {**mg.COUNTS, **sk.LAUNCHES}
    t0 = time.perf_counter()
    s = sim.advance_n(s, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {**gk.LAUNCHES, **sk.LAUNCHES, **s2.LAUNCHES}
    per_step = {k: (v - warm_counts[k]) / steps
                for k, v in {**mg.COUNTS, **sk.LAUNCHES}.items()}
    total = warm + steps
    for k, v in launches.items():
        if (v > 0) != (k in A8_A11_KERNELS[name]):
            raise AssertionError(f"{name}: kernel {k} launched {v} times in "
                                 f"{total} steps")
    check_one_launch(sk, name)
    check_tallies(name, per_step)
    lvl = s.level
    for f in A9C_FIELDS:
        if not bool(torch.isfinite(getattr(lvl, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    cells = 1
    for c in cfg.grid.n_cell:
        cells *= c
    ms = (t1 - t0) / steps * 1e3
    vmax = float(lvl.velocity.abs().max())
    out = {"deck": name, "start": "init_state",
           "n_cell": list(cfg.grid.n_cell), "ms_per_step": ms,
           "cells_per_s": cells / (ms * 1e-3), "steps": steps,
           "warmup": warm, "setup_s": setup_s, "launches": launches,
           "per_step": per_step}
    notes = []
    if sim.eb is not None:
        cov = sim.eb.covered > 0.5
        at_rest = float(lvl.velocity[cov].abs().max()) if bool(cov.any()) \
            else 0.0
        if at_rest != 0.0:
            raise AssertionError(f"{name}: covered cells move ({at_rest})")
        cut = int((sim.eb.cut > 0.5).sum())
        notes.append(f"{cut} cut cells, covered cells at rest")
        out["cut_cells"] = cut
    if name == "tgv2d_godunov":
        err = decay_check(sim, s, a0, torch)
        if not err <= 1e-3:
            raise AssertionError(f"tgv2d_godunov: amplitude off the exact "
                                 f"decay by {err:.2e}")
        notes.append(f"amplitude against the exact decay {err:.2e} (tol "
                     f"1e-3)")
        out["decay_err"] = err
    box = [s]

    def one_step():
        box[0] = sim.advance(box[0])
        torch.cuda.synchronize()
    solves, cell = logged_solves(mg, one_step)
    s = box[0]
    out.update(nodal_res_over_tol=[r for r, _, _ in solves],
               nodal_cycles=[it for _, it, _ in solves],
               cell_res_over_tol=[r for r, _, _ in cell],
               cell_cg_iters=[it for _, it, _ in cell])
    notes.append(f"the next step's nodal solves: residual / tol "
                 f"{[round(r, 3) for r, _, _ in solves]} in "
                 f"{[it for _, it, _ in solves]} V-cycles (maxiter "
                 f"{cfg.nodal_mg_maxiter}); its cell CG solves: best "
                 f"residual / tol {[float(f'{r:.3g}') for r, _, _ in cell]}"
                 f" in {[(it, m) for _, it, m in cell]} (iterations, "
                 f"maxiter)")
    # the f32 in-step nodal solve of rt2d stops on stagnation near its
    # tolerance, as the bubble's does: held to STAGNATION_BOUND, and the
    # final velocity re-projected from zero to 1 below; every other
    # cell's to its tolerance
    bound_n = STAGNATION_BOUND if name == "rt2d" else 1.0
    if ((per_step["nodal_cycles"] > 0 and not solves)
            or any(r > bound_n or it >= m for r, it, m in solves)):
        raise AssertionError(f"{name}: the step's nodal solves ended at "
                             f"{solves} (bound {bound_n} x tolerance)")
    if sim.eb is not None:
        bound_c = CELL_STAGNATION_BOUND[name]
        if not cell or any(r > bound_c or it >= m for r, it, m in cell):
            raise AssertionError(f"{name}: the step's cell solves ended at "
                                 f"{cell} (bound {bound_c} x tolerance)")
    if name == "rt2d":
        res_over_tol, cycles, div, _ = vd_projection_check(sim, s, mg,
                                                           torch)
        if not res_over_tol <= 1.0:
            raise AssertionError(f"rt2d: the re-projection stopped at "
                                 f"{res_over_tol:.2f} x tolerance")
        notes.append(f"max|div u| {div:.3e}, re-projection residual "
                     f"{res_over_tol:.2f} x tol in {cycles} V-cycles")
        out.update(max_div_u=div, reprojection_res_over_tol=res_over_tol)
    tally = ", ".join(f"{k} {per_step[k]:.1f}" for k in
                      ("cell_iters", "cell_solves", "nodal_cycles",
                       "tensor_cg_iters", "cell_smooth", "nodal_smooth",
                       WALLED, WALLED_NODAL, "host_syncs"))
    print(f"[main] {name} {cfg.grid.n_cell} f32: {ms:.3f} ms/step, "
          f"{cells / (ms * 1e-3):.4e} cells/s over {steps} steps after "
          f"{warm} warm-up (setup {setup_s:.1f} s); per step: {tally}; "
          f"t={float(s.t):.6f} dt={float(s.dt):.6e} max|u|={vmax:.6f}; "
          f"{'; '.join(notes)}; launches {launches}", flush=True)
    out["profile"] = phase_profile(sim, s, torch, name, ms, steps=1,
                                   table=False)
    return out, sim, s


def step_velocity_solver(mg, sim, s, torch):
    """The cut-cell velocity solver that one more step of an EB deck
    builds (the first CellSolver with the EB wall term it solves with),
    its coefficients for that step's beta."""
    found = []
    solve_info = mg.CellSolver.solve_info

    def capture(self, rhs, **kw):
        if self.levels[0].ebc is not None and not found:
            found.append(self)
        return solve_info(self, rhs, **kw)
    mg.CellSolver.solve_info = capture
    try:
        sim.advance(s)
        torch.cuda.synchronize()
    finally:
        mg.CellSolver.solve_info = solve_info
    if not found:
        raise AssertionError("the step solved no cut-cell velocity system")
    return found[0]


def phase_levels_eb(sk, mg, torch, sim, s):
    """`cell_smooth` on the EB levels the main path smooths: the fine
    level (128x128x32) and the first coarse one of the cut-cell velocity
    solver that one more poiseuille_cyl_bingham step builds (beta*ebc
    folded into diag, face 0 of the periodic z axis as a wrap plane,
    three components), 1 sweep + residual: bit-equal to cell_smooth_plain
    in float32 and, on the same coefficients, in float64, one kernel node
    a call (CUDA graph), kernel and plain ms, bound."""
    dev = torch.device("cuda")
    saved = save_launches(sk)
    solver = step_velocity_solver(mg, sim, s, torch)
    dinvs, fhis, fwalls = solver.smoother_coefs()
    if fwalls[0][2] is None:
        raise AssertionError("the EB velocity level has no z wrap plane")
    rows = []
    for dtype in (torch.float32, torch.float64):
        cast = lambda t: None if t is None else t.to(dtype)
        for li in (0, 1):
            lev = solver.levels[li]
            diag = cast(solver.diags[li])
            shape = tuple(diag.shape)
            g = torch.Generator(device=dev).manual_seed(31 + li)
            x = torch.randn(shape, generator=g, device=dev, dtype=dtype)
            b = torch.randn(shape, generator=g, device=dev, dtype=dtype)
            args = (x, b, diag, cast(dinvs[li]),
                    tuple(cast(f) for f in fhis[li]), 1, True)
            kw = dict(bc=(lev.bc_lo, lev.bc_hi),
                      Fwall=tuple(cast(w) for w in fwalls[li]))
            call = lambda: sk.cell_smooth(*args, **kw)
            plain = lambda: sk.cell_smooth_plain(*args, **kw)
            got, ref = call(), plain()
            if not all(torch.equal(u, v) for u, v in zip(got, ref)):
                raise AssertionError(f"EB level {li} {dtype}: kernel and "
                                     "plain version differ")
            launches = graph_launches(sk, call)
            if launches != 1:
                raise AssertionError(f"EB level {li}: one call is {launches}"
                                     " device launches")
            row = {"deck": "poiseuille_cyl_bingham", "family":
                   "cell/velocity of the step, ebc in diag, z wrap plane",
                   "level": li, "dtype": str(dtype).replace("torch.", ""),
                   "shape": "x".join(str(v) for v in shape),
                   "call": "1 sweep + residual", "bit_equal": True,
                   "device_launches": launches}
            if dtype == torch.float32:
                row.update(ms=device_ms(call), plain_ms=device_ms(plain),
                           bytes=smooth_bytes(mg, solver, li, x, True),
                           ops=count_ops(plain))
                row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                         row["ops"])
            rows.append(row)
            print(f"[levels] EB {row['family']} level {li} {row['shape']} "
                  f"{row['dtype']}: bit-equal to cell_smooth_plain, "
                  f"{launches} kernel node a call"
                  + (f", kernel {row['ms']:.4f} ms, plain "
                     f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f}"
                     f" ms ({row['bound_by']})" if "ms" in row else ""),
                  flush=True)
    torch.cuda.synchronize()
    check_one_launch(sk, "EB levels")
    restore_launches(sk, saved)
    return rows


# ---------------------------------------------------------------------
# sharded: the x-slab mesh (incflo_torch/parallel) and the halo-slab
# Godunov kernels (B8)
# ---------------------------------------------------------------------

HALO_KERNELS = ("uad_halo", "predict_d_halo", "advect_halo")
# wrapper calls of the halo-slab kernels per rank and step of shear3d
PER_STEP_HALO = {"uad_halo": 1, "predict_d_halo": 3, "advect_halo": 3}
SHARD_RANKS = 2
# the 2-rank sharded step against the 1-rank step from the same start:
# float64 to 1e-11 relative to each field's max after each step, with
# equal tensor-CG iterations.  float32 after 2 + 5 steps: each field's
# error against the 1-rank float64 run at most twice the 1-rank float32
# run's own error + 4 ulps (relative to the field's max).  A
# reduce-scatter sums the x transform in another order, and in float32
# that rounding, carried through 7 steps of direct solves, is as large as
# the 1-rank run's own (mac_phi, a singular solve's potential, differs
# between the two float32 runs by about 1e-3 of its max): the float64
# witness tells rounding from a fault, as chip_smoke "step2d" does.
TOL_SHARD_F64 = 1e-11
TOL_SHARD_F32_FACTOR, TOL_SHARD_F32_ULPS = 2.0, 4
# the 1-rank float32 runs from starts one rounding apart that give the
# witness its reference where the 1-rank nodal solves stagnate above
# their tolerance (sharded_cells): where such a solve stops is itself
# rounding, and with it the f32 error (rt2d at 64x128)
SHARD_F32_BAND = 3
SHARD_FIELDS = ("velocity", "p", "gp", "mac_phi", "dt")


def halo_rows(full, x0, nxl, halo):
    """Rows [x0 - halo, x0 + nxl + halo) of a whole-level array, wrapped:
    the padded slab a rank holds after its x exchange."""
    import torch
    idx = torch.arange(x0 - halo, x0 + nxl + halo,
                       device=full.device) % full.shape[0]
    return full.index_select(0, idx).contiguous()


def slab_grid(grid, nranks):
    from incflo_torch.parallel.mesh import SlabGrid
    nx = grid.n_cell[0]
    return SlabGrid(n_cell=(nx // nranks,) + tuple(grid.n_cell[1:]),
                    prob_lo=grid.prob_lo, prob_hi=grid.prob_hi,
                    periodic=grid.periodic, nx_full=nx)


def phase_halo_kernels(gk, sk, grid_of, torch):
    """The halo-slab kernels at the shear3d n = 128 level cut into 2 slabs
    (nxl 64) and 4 (nxl 32), float32 and float64: every launch against
    its slab plain version and against the unsharded kernel's output on
    the same rows, bit-equal in float32 and within 1e-14 relative in
    float64.  Then their times at nxl 64 and 32, f32."""
    dev = torch.device("cuda")
    grid = grid_of(128)
    res = {k: {"max_abs_err": 0.0, "max_rel_err_f64": 0.0, "checked": 0}
           for k in HALO_KERNELS}

    def check(k, a, b, dtype):
        r = res[k]
        r["checked"] += 1
        if dtype == torch.float32:
            err = abs_err(a, b)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if err != 0.0:
                raise AssertionError(f"{k}: float32 differs from its "
                                     f"reference by {err:.3e}")
        else:
            err = rel_err(a, b)
            r["max_rel_err_f64"] = max(r["max_rel_err_f64"], err)
            if not err <= 1e-14:
                raise AssertionError(f"{k}: float64 differs from its "
                                     f"reference by {err:.3e} relative")

    saved = dict(gk.LAUNCHES)
    for dtype in (torch.float64, torch.float32):
        vel, forces, q, dt = kernel_inputs(grid, dtype, dev)
        uad = gk.uad(grid, vel, dt, True)
        umac = [gk.predict_d(grid, vel, uad, forces, dt, d, True)
                for d in range(3)]
        rates = [gk.advect_comp(grid, q, n, umac, forces, dt, bool(n % 2),
                                True) for n in range(3)]
        mac_lo = [umac[0].narrow(0, 0, grid.n_cell[0])] + umac[1:]
        for nranks in (2, 4):
            slab = slab_grid(grid, nranks)
            nxl = slab.n_cell[0]
            for r in range(nranks):
                x0 = r * nxl

                def pad(a):
                    return halo_rows(a, x0, nxl, gk.HALO)

                def rows(a):
                    return a.narrow(0, x0, nxl)

                vel_p, f_p, q_p = pad(vel), pad(forces), pad(q)
                uad_p = [pad(u) for u in uad]
                mac_p = [pad(m) for m in mac_lo]
                got = gk.uad_halo(slab, vel_p, dt, True)
                plain = gk.uad_slab_plain(slab, vel_p, dt, True)
                for a, b, c in zip(got, plain, uad):
                    check("uad_halo", a, b, dtype)
                    check("uad_halo", a, rows(c), dtype)
                for d in range(3):
                    got = gk.predict_d_halo(slab, vel_p, uad_p, f_p, dt, d,
                                            True)
                    check("predict_d_halo", got, gk.predict_d_slab_plain(
                        slab, vel_p, uad_p, f_p[..., d], dt, d, True), dtype)
                    check("predict_d_halo", got, rows(umac[d]), dtype)
                for n in range(3):
                    got = gk.advect_comp_halo(slab, q_p, n, mac_p, f_p, dt,
                                              bool(n % 2), True)
                    check("advect_halo", got, gk.advect_comp_slab_plain(
                        slab, q_p[..., n], mac_p, f_p[..., n], dt,
                        bool(n % 2), True), dtype)
                    check("advect_halo", got, rows(rates[n]), dtype)
    torch.cuda.synchronize()
    for k, r in res.items():
        print(f"[sharded] {k}: {r['checked']} outputs at 128x128x32 in 2 "
              f"and 4 slabs equal their slab plain version and the "
              f"unsharded kernel's rows (f32 max abs diff "
              f"{r['max_abs_err']:.1e}, f64 max rel {r['max_rel_err_f64']:.1e})",
              flush=True)

    # times, f32, PPM, with forces, the convective form, as the sharded
    # shear3d step calls them.  The bound's operations are those of the
    # slab's nxl output rows: the unsharded plain version's count on the
    # whole level times nxl / nx (the padded rows' extra work is the
    # kernel's cost, not the function's)
    vel, forces, q, dt = kernel_inputs(grid, torch.float32, dev)
    uad = gk.uad_plain(grid, vel, dt, True)
    umac = gk.predict_plain(grid, vel, forces, dt, True)
    mac_lo = [umac[0].narrow(0, 0, grid.n_cell[0])] + umac[1:]
    f0_full = forces[..., 0].contiguous()
    level_ops = {
        "uad_halo": count_ops(lambda: gk.uad_plain(grid, vel, dt, True)),
        "predict_d_halo": count_ops(lambda: gk.predict_d_plain(
            grid, vel, uad, f0_full, dt, 0, True)),
        "advect_halo": count_ops(lambda: gk.advect_comp_plain(
            grid, vel[..., 0], umac, f0_full, dt, False, True)),
    }
    for nranks in (2, 4):
        slab = slab_grid(grid, nranks)
        nxl = slab.n_cell[0]
        pad = lambda a: halo_rows(a, 0, nxl, gk.HALO)
        vel_p, f_p = pad(vel), pad(forces)
        uad_p = [pad(u) for u in uad]
        mac_p = [pad(m) for m in mac_lo]
        f0 = f_p[..., 0].contiguous()
        m = grid.n_cell[1] * grid.n_cell[2]
        rows_in, rows_out = nxl + 2 * gk.HALO, nxl
        calls = {
            "uad_halo": (lambda: gk.uad_halo(slab, vel_p, dt, True),
                         lambda: gk.uad_slab_plain(slab, vel_p, dt, True),
                         3, 3),
            "predict_d_halo": (
                lambda: gk.predict_d_halo(slab, vel_p, uad_p, f_p, dt, 0,
                                          True),
                lambda: gk.predict_d_slab_plain(slab, vel_p, uad_p, f0, dt,
                                                0, True), 7, 1),
            "advect_halo": (
                lambda: gk.advect_comp_halo(slab, vel_p, 0, mac_p, f_p, dt,
                                            False, True),
                lambda: gk.advect_comp_slab_plain(slab, vel_p[..., 0], mac_p,
                                                  f0, dt, False, True),
                5, 1),
        }
        for k, (kern, plain, n_in, n_out) in calls.items():
            t = {"device_launches": graph_launches(sk, kern),
                 "ms": device_ms(kern), "plain_ms": device_ms(plain),
                 "bytes": (n_in * rows_in + n_out * rows_out) * m * 4,
                 "ops": level_ops[k] * nxl // grid.n_cell[0]}
            t_bytes = t["bytes"] / PEAK_BYTES * 1e3
            t_ops = t["ops"] / PEAK_OPS["float32"] * 1e3
            t["bound_ms"] = max(t_bytes, t_ops)
            t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            res[k][f"nxl{nxl}"] = t
            if t["device_launches"] != 1:
                raise AssertionError(f"{k}: one call is "
                                     f"{t['device_launches']} device "
                                     "launches")
            print(f"[sharded] {k} nxl {nxl}: kernel {t['ms']:.4f} ms "
                  f"({t['device_launches']} device launch a call), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops)",
                  flush=True)
    gk.LAUNCHES.update(saved)      # comparison launches do not count
    return res


def one_rank_steps(incflo_torch, torch, deck, nsteps):
    """The unsharded port from init_state: the state after each step (as
    numpy) and the tensor CG's iterations in each."""
    from incflo_torch import state
    from incflo_torch.ops import multigrid as mg
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(deck))
    s = sim.init_state()
    states, trips = [state.sim_to_numpy(s)], []
    for _ in range(nsteps):
        before = mg.COUNTS["tensor_cg_iters"]
        s = sim.advance(s)
        trips.append(mg.COUNTS["tensor_cg_iters"] - before)
        states.append(state.sim_to_numpy(s))
    torch.cuda.synchronize()
    return states, trips


def state_errs(a, b):
    import numpy as np
    return {f: float(np.abs(a[f] - b[f]).max()
                     / max(float(np.abs(b[f]).max()), 1e-300))
            for f in SHARD_FIELDS}


def phase_sharded_step(incflo_torch, gk, torch, n=128, steps64=3, warm=2,
                       steps=5, instrumented=3):
    """shear3d n = 128 split over 2 ranks through Simulation(mesh=...):
    float64 init + steps64 steps held to the 1-rank port step to 1e-11
    with equal tensor-CG iterations; float32 warm + steps timed steps (the
    halo-slab launch counts zeroed just before them) held against a
    1-rank float64 run beside the 1-rank float32 run, then instrumented
    steps that time each exchange.  A generator for run_sharded (as
    sharded_cells)."""
    import numpy as np
    deck64 = shear3d_deck(n, "float64")
    deck32 = shear3d_deck(n, "float32")
    yield ([("f64", "steps", dict(deck=deck64, nsteps=steps64))],
           [("f32", "timed_steps",
             dict(deck=deck32, warm=warm, nsteps=steps,
                  instrumented=instrumented))])
    ref64, trips64 = one_rank_steps(incflo_torch, torch, deck64,
                                    warm + steps)
    trips1 = trips64[:steps64]
    ref32, _ = one_rank_steps(incflo_torch, torch, deck32, warm + steps)
    ranks = yield None
    r64 = [r["f64"] for r in ranks]
    r32 = [r["f32"] for r in ranks]
    print(f"[sharded] ranks: {r32[0]['mesh']}", flush=True)
    worst64 = {f: 0.0 for f in SHARD_FIELDS}
    for i, (a, b) in enumerate(zip(r64[0]["states"], ref64)):
        for f, e in state_errs(a, b).items():
            worst64[f] = max(worst64[f], e)
            if not e <= TOL_SHARD_F64:
                raise AssertionError(f"sharded f64 step {i}: {f} differs "
                                     f"from the 1-rank step by {e:.3e}")
    for r in r64:
        if r["cg_trips"] != trips1:
            raise AssertionError(f"sharded f64: tensor-CG iterations "
                                 f"{r['cg_trips']} per step, 1 rank "
                                 f"{trips1}")
    err32 = state_errs(r32[0]["state"], ref32[-1])
    witness = ref64[-1]
    own32 = state_errs(ref32[-1], witness)
    shard32 = state_errs(r32[0]["state"], witness)
    ulp = float(np.finfo(np.float32).eps)
    bound32 = {f: TOL_SHARD_F32_FACTOR * own32[f] + TOL_SHARD_F32_ULPS * ulp
               for f in SHARD_FIELDS}
    for f in SHARD_FIELDS:
        if not shard32[f] <= bound32[f]:
            raise AssertionError(
                f"sharded f32 after {warm + steps} steps: {f} is "
                f"{shard32[f]:.3e} from the float64 run, the 1-rank f32 "
                f"run {own32[f]:.3e} (bound {bound32[f]:.3e})")
    vel = r32[0]["state"]["velocity"]
    if not np.isfinite(vel).all():
        raise AssertionError("sharded f32: non-finite velocity")
    per_rank = []
    for rank, r in enumerate(r32):
        got = {k: r["launches"][k] / steps for k in HALO_KERNELS}
        if got != PER_STEP_HALO or any(r["launches"][k]
                                       for k in PER_STEP):
            raise AssertionError(f"sharded rank {rank}: launches "
                                 f"{r['launches']} in {steps} steps, "
                                 f"expected {PER_STEP_HALO} a step")
        per_rank.append(r["launches"])
    ms = max(r["ms_per_step"] for r in r32)
    comm = {k: max(r["comm"][k]["ms_per_step"] for r in r32)
            for k in r32[0]["comm"]}
    inst = max(r["instrumented_ms_per_step"] for r in r32)
    print(f"[sharded] shear3d n={n} f64 over {SHARD_RANKS} ranks: init + "
          f"{steps64} steps, worst rel err against 1 rank "
          + ", ".join(f"{f} {e:.2e}" for f, e in worst64.items())
          + f" (tol {TOL_SHARD_F64:g}); tensor-CG iterations {trips1} in "
          f"both", flush=True)
    print(f"[sharded] shear3d n={n} f32 over {SHARD_RANKS} ranks: "
          f"{ms:.3f} ms/step over {steps} steps after {warm} warm-up "
          f"(slowest rank); after {warm + steps} steps, rel err against "
          "the f64 run (2 ranks / 1 rank) "
          + ", ".join(f"{f} {shard32[f]:.2e} / {own32[f]:.2e}"
                      for f in SHARD_FIELDS)
          + "; against the 1-rank f32 run "
          + ", ".join(f"{f} {e:.2e}" for f, e in err32.items())
          + f"; per rank per step {PER_STEP_HALO} halo-slab wrapper calls "
          f"(one device launch each); instrumented "
          f"{inst:.3f} ms/step, of it exchanges (ms/step) "
          + ", ".join(f"{k} {v:.3f}" for k, v in comm.items()),
          flush=True)
    return {"n": n, "ranks": SHARD_RANKS, "mesh": r32[0]["mesh"],
            "ms_per_step": ms, "steps": steps, "warmup": warm,
            "instrumented_ms_per_step": inst,
            "comm_ms_per_step": comm,
            "comm": r32[0]["comm"], "launches_per_rank": per_rank,
            "f64_max_rel_err": worst64, "f64_tol": TOL_SHARD_F64,
            "cg_trips_per_step": trips1,
            "f32_rel_err_vs_f64": shard32,
            "f32_one_rank_rel_err_vs_f64": own32, "f32_bound": bound32,
            "f32_rel_err_vs_one_rank_f32": err32}


# ---------------------------------------------------------------------
# multigrid on an x-slab mesh: the slab smoothers and the decks they let
# run split over ranks
# ---------------------------------------------------------------------

SLAB_FAMILIES = ("cell_smooth_slab", "nodal_smooth_slab")
# the 2-rank cells: bench's rt deck at its bench width (64x64x128, x
# slabs of 32) and shear3d_vd at 128x128x32 (x slabs of 64)
SHARD_MG_DECKS = {"rt": lambda dt: rt_deck(128, dt),
                  "shear3d_vd": lambda dt: shear3d_deck(128, dt, vd=True)}
SHARD_MG_FIELDS = ("velocity", "density", "tracer", "p", "gp", "mac_phi",
                   "dt")


def ext_rows(full, start, stop, periodic=True):
    """Rows [start, stop) of a whole-level array, wrapped where x is
    periodic: a rank's extended slab after its deep halo exchange."""
    import torch
    idx = torch.arange(start, stop, device=full.device)
    if periodic:
        idx = idx % full.shape[0]
    return full.index_select(0, idx).contiguous()


def slab_call(sk, cell, coefs, kw, x, b, x0, rows, n, want,
              ends=(False, False)):
    """(kernel, plain, inputs) of one slab call on the extended slab of
    the rank whose `rows` rows start at x0: the slab form's launch
    (cell_smooth_ext / nodal_smooth_ext), its plain version on the same
    inputs, and those inputs.  ends: the slab's sides that are the
    level's own x faces (SlabMesh.ends): no halo rows there, and the
    level's code; the low one's wall plane is the level's."""
    lo, hi = sk.slab_depth(n, want)
    lo, hi = (0 if ends[0] else lo), (0 if ends[1] else hi)
    periodic = not any(ends) and kw["bc"][0][0] == 0
    e = lambda a: ext_rows(a, x0 - lo, x0 + rows + hi, periodic)
    bc = sk.slab_bc(kw["bc"], ends)
    if cell:
        diag, dinv, F = coefs
        xwall = kw["Fwall"][0] if ends[0] else None
        fw = (xwall,) + tuple(None if w is None else e(w)
                              for w in kw["Fwall"][1:])
        # a periodic x whose face 0 differs from face n (the EB wall
        # term's levels): the x wrap plane at the level's cell 0 inside
        # the extended slab, as cell_smooth_slab places it
        xwrap = None
        if periodic and kw["Fwall"][0] is not None:
            nx = x.shape[0]
            at = tuple(i for i in (g - x0 + lo for g in (0, nx))
                       if 0 < i < rows + lo + hi - 1)
            xwrap = (kw["Fwall"][0], at) if at else None
        args = (e(x), e(b), e(diag), e(dinv), [e(f) for f in F], n, want)
        inputs = list(args[:4]) + args[4] + [w for w in fw if w is not None]
        if xwrap is not None:
            inputs.append(xwrap[0])
        return (lambda: sk.cell_smooth_ext(*args, bc=kw["bc"], Fwall=fw,
                                           ends=ends, xwrap=xwrap),
                lambda: sk.cell_smooth_plain(
                    *args, bc=bc, Fwall=fw,
                    open_x=(not ends[0], not ends[1]), xwrap=xwrap),
                inputs)
    sigma, dinv, dx = coefs
    args = (e(x), e(b), ext_rows(sigma, x0 - lo, x0 + rows + hi - 1,
                                 periodic), e(dinv), dx, n, want)
    return (lambda: sk.nodal_smooth_ext(*args, bc=kw["bc"], ends=ends),
            lambda: sk.nodal_smooth_plain(*args, bc=bc), list(args[:4]))


def slab_forms(sk, mg, torch, solvers, tag, seed):
    """The slab forms of the smoother kernels at every level of the
    given hierarchies ((family, solver) pairs, f32 on the card) whose
    2-rank x slabs are even, at the call the V-cycles make there (1
    sweep + residual cell, 2 nodal, the bottom's sweeps without; the
    deepest that fits where a slab is narrower than its halo): each
    rank's extended slab through the kernel, bit-equal to the plain
    version on the same inputs, its own rows bit-equal to the
    whole-level kernel's rows; one kernel node a call; rank 0's kernel
    and plain times by CUDA-graph replay and the bound (the extended
    inputs read once, the slab's rows written once; the operations of
    the slab's rows, the whole-level plain count times nxl / nx).  Where
    the level's x ends in walls, rank 0 holds its low x face and the last
    rank its high one (and a nodal level's node nx)."""
    import numpy as np
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    res = {k: {"max_abs_err": 0.0, "checked": 0, "levels": []}
           for k, _ in solvers}
    saved = save_launches(sk)
    for family, solver in solvers:
        cell = family == "cell_smooth_slab"
        last = len(solver.levels) - 1
        for li in range(last + 1):
            shape = tuple(solver.diags[li].shape)
            coefs, kw = level_args(mg, solver, li)
            periodic = kw["bc"][0][0] == 0
            extra = int(not cell and not periodic)
            nxl = (shape[0] - extra) // SHARD_RANKS
            if nxl % 2:
                continue
            n, want = (solver.nu_bottom, False) if li == last \
                else (solver.nu1, True)
            if sk.slab_depth(n, want)[0] > nxl:
                n = (nxl - 2) // 2 if want else nxl // 2
            x = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=dev)
            b = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=dev)
            whole_fn = sk.cell_smooth if cell else sk.nodal_smooth
            plain_fn = sk.cell_smooth_plain if cell \
                else sk.nodal_smooth_plain
            whole = whole_fn(x, b, *coefs, n, want, **kw)

            def call(r):
                ends = (False, False) if periodic \
                    else (r == 0, r == SHARD_RANKS - 1)
                rows = nxl + (extra if ends[1] else 0)
                lo = 0 if ends[0] else sk.slab_depth(n, want)[0]
                return slab_call(sk, cell, coefs, kw, x, b, r * nxl, rows,
                                 n, want, ends), lo, rows

            for r in range(SHARD_RANKS):
                (kern, plain, _), lo, rows = call(r)
                got, ref = kern(), plain()
                for u, v, w in zip(got, ref, whole):
                    if v is None:
                        continue
                    err = abs_err(u, v)
                    res[family]["max_abs_err"] = max(
                        res[family]["max_abs_err"], err)
                    res[family]["checked"] += 1
                    if err != 0.0 or not torch.equal(
                            u.narrow(0, lo, rows),
                            w.narrow(0, r * nxl, rows)):
                        raise AssertionError(
                            f"{family} level {li} rank {r}: the slab kernel "
                            "differs from its plain version or from the "
                            "whole level's rows")
            (kern, plain, inputs), _, rows = call(0)
            row = {"level": li, "shape": "x".join(map(str, shape)),
                   "nxl": nxl, "call": f"{n} sweeps"
                   + (" + residual" if want else ""),
                   "device_launches": graph_launches(sk, kern),
                   "ms": device_ms(kern), "plain_ms": device_ms(plain),
                   "bytes": 4 * (sum(t.numel() for t in inputs)
                                 + (1 + want) * rows * x[0].numel()),
                   "ops": count_ops(lambda: plain_fn(
                       x, b, *coefs, n, want, **kw)) * nxl // shape[0]}
            row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                     row["ops"])
            if row["device_launches"] != 1:
                raise AssertionError(f"{family} level {li}: one call is "
                                     f"{row['device_launches']} device "
                                     "launches")
            res[family]["levels"].append(row)
            walls = "" if periodic else ", the level's x walls on the end " \
                "ranks"
            print(f"[{tag}] {family} level {li} {row['shape']} in 2 slabs "
                  f"(nxl {nxl}{walls}), {row['call']}: bit-equal to the "
                  f"plain version and the whole level's rows on both ranks; "
                  f"kernel {row['ms']:.4f} ms (1 device launch), plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} "
                  f"ms ({row['bound_by']})", flush=True)
    torch.cuda.synchronize()
    check_one_launch(sk, f"{tag} smoothers")
    restore_launches(sk, saved)
    return res


def phase_slab_smoothers(sk, mg, torch):
    """slab_forms at every level of rt's two hierarchies (64x64x128, the
    MAC and nodal operators of rt_operators): x periodic."""
    mac, nodal = rt_operators(mg, (64, 64, 128), torch.float32,
                              torch.device("cuda"), 30)
    return slab_forms(sk, mg, torch, list(zip(SLAB_FAMILIES, (mac, nodal))),
                      "slab", 37)


def one_rank_run(incflo_torch, torch, deck, nsteps, perturb=None, sim=None,
                 ulp_seed=None):
    """The port on one rank on the card from init_state (perturb: a
    whole-level numpy array added to its velocity, in the state's dtype;
    ulp_seed: then each cell of the velocity, density and tracer scaled
    by 1 - eps, 1 or 1 + eps of its dtype, seeded -- a start one rounding
    apart; sim: the deck's Simulation, built already), stepped by the
    plain step Simulation._advance_impl as every rank of a mesh steps
    (the fused 2D step stays off under a mesh, Simulation._fused_step):
    the states after init and each step (numpy), each step's tallies
    (ITER_KINDS) and the steps' nodal solves that iterated (residual /
    tolerance, V-cycles, maxiter; multigrid.NODAL_LOG)."""
    import numpy as np
    from incflo_torch import state
    from incflo_torch.ops import multigrid as mg
    if sim is None:
        sim = incflo_torch.Simulation(
            incflo_torch.IncfloConfig.from_text(deck))
    mg.reset_counts()
    s = sim.init_state()
    if perturb is not None:
        v = s.level.velocity
        s = s._replace(level=s.level._replace(velocity=v + torch.as_tensor(
            perturb).to(device=v.device, dtype=v.dtype)))
    if ulp_seed is not None:
        rng = np.random.default_rng(ulp_seed)
        nudge = lambda a: a * (1 + torch.as_tensor(rng.integers(
            -1, 2, tuple(a.shape)), device=a.device, dtype=a.dtype)
            * torch.finfo(a.dtype).eps)
        s = s._replace(level=s.level._replace(**{
            f: nudge(getattr(s.level, f))
            for f in ("velocity", "density", "tracer")}))
    states = [state.sim_to_numpy(s)]
    tallies = [{k: mg.COUNTS[k] for k in ITER_KINDS}]
    mg.NODAL_LOG = []
    try:
        for _ in range(nsteps):
            before = dict(mg.COUNTS)
            s = sim._advance_impl(s)
            tallies.append({k: mg.COUNTS[k] - before[k]
                            for k in ITER_KINDS})
            states.append(state.sim_to_numpy(s))
        torch.cuda.synchronize()
        solves = [(float(res) / float(tol), it, maxiter)
                  for res, tol, it, maxiter in mg.NODAL_LOG]
    finally:
        mg.NODAL_LOG = None
    return states, tallies, solves


def mg_state_errs(a, b, floors=None):
    """Each field's largest difference relative to the reference's max,
    or to floors[field] where that is larger."""
    import numpy as np
    floors = floors or {}
    return {f: float(np.abs(a[f] - b[f]).max()
                     / max(float(np.abs(b[f]).max()), floors.get(f, 0.0),
                           1e-300))
            for f in SHARD_MG_FIELDS}


def phase_sharded_mg(incflo_torch, torch):
    """rt (64x64x128) and shear3d_vd (128x128x32) split over 2 ranks that
    share the card, multigrid on the slabs (sharded_cells)."""
    return (yield from sharded_cells(incflo_torch, torch, SHARD_MG_DECKS,
                                     "sharded_mg"))[0]


def sharded_cells(incflo_torch, torch, decks, tag, floors=None, steps64=1,
                  warm=1, steps=2, instrumented=1, perturbs=None,
                  families=SLAB_FAMILIES, sims32=None, jobs=()):
    """Each deck of `decks` (cell -> deck of a dtype) split over 2 ranks
    that share the card: float64 init + steps64 steps held to the 1-rank
    port to TOL_SHARD_F64 (relative to each field's max, or to
    floors[cell][field] where that is larger) with equal CG iterations,
    V-cycles and tensor-CG iterations in every step on both ranks;
    float32 warm + steps timed steps (the launch counts zeroed just
    before them) held against a 1-rank float64 run beside the 1-rank
    float32 run (PR 6's witness bound), then `instrumented` steps that
    time each exchange.  Where the 1-rank float32 run's nodal solves stop
    on stagnation above their tolerance, its error is one draw of what
    rounding gives: the witness then takes the largest error of it and
    of SHARD_F32_BAND runs from starts one rounding apart (one_rank_run's
    ulp_seed), and the ranks are held to the main path's checks of such
    a deck: their nodal solves stop below maxiter and no further above
    their tolerance than the 1-rank runs' worst, and the final velocity
    re-projected from zero reaches the tolerance (vd_projection_check;
    a deck without EB).  perturbs: cell -> a function of the deck's
    1-rank Simulation giving a whole-level array that every run of the
    cell adds to its initial velocity; sims32: cell -> the deck's 1-rank
    float32 Simulation, built already.  Every rank must launch
    each slab smoother kernel of `families` in the timed steps.  A
    generator for run_sharded: it yields the ranks' jobs (untimed: every
    cell's float64 steps and `jobs`, more (key, name, kwargs) of
    workers; timed: every cell's float32 steps), then runs the 1-rank
    references and yields None, then takes the jobs' results on every
    rank.  Printed
    and returned beside the times: each rank's setup seconds (its
    Simulation and init), the 27-point EB nodal smoother's and the 2D
    flux-form slab sweep calls a step, and each rank's Godunov kernel
    launches.  Returns (the cells' results, each rank's results of the
    spawn)."""
    from incflo_torch import state
    from incflo_torch.ops import multigrid as mg
    ulp = 1.1920928955078125e-07
    sims32 = dict(sims32 or {})
    pert = {}
    for cell, deck_of in decks.items():
        make = (perturbs or {}).get(cell)
        if make is not None and cell not in sims32:
            sims32[cell] = incflo_torch.Simulation(
                incflo_torch.IncfloConfig.from_text(deck_of("float32")))
        pert[cell] = None if make is None else make(sims32[cell])
    yield ([(f"{cell} f64", "steps",
             dict(deck=deck_of("float64"), nsteps=steps64,
                  perturb=pert[cell]))
            for cell, deck_of in decks.items()] + list(jobs),
           [(f"{cell} f32", "timed_steps",
             dict(deck=deck_of("float32"), warm=warm, nsteps=steps,
                  instrumented=instrumented, perturb=pert[cell]))
            for cell, deck_of in decks.items()])
    t0 = time.time()
    refs = {}
    for cell, deck_of in decks.items():
        deck64 = deck_of("float64")
        sim32 = sims32.pop(cell, None)
        if sim32 is None:
            sim32 = incflo_torch.Simulation(
                incflo_torch.IncfloConfig.from_text(deck_of("float32")))
        ref64, tal64, _ = one_rank_run(incflo_torch, torch, deck64,
                                       warm + steps, pert[cell])
        ref32, _, solves = one_rank_run(incflo_torch, torch, None,
                                        warm + steps, pert[cell], sim32)
        band = [ref32[-1]]
        stalls = any(r > 1.0 for r, _, _ in solves)
        if stalls:
            for seed in range(SHARD_F32_BAND):
                more, _, more_solves = one_rank_run(
                    incflo_torch, torch, None, warm + steps, pert[cell],
                    sim32, seed)
                band.append(more[-1])
                solves += more_solves
        refs[cell] = (ref64, tal64, band,
                      (sim32, max(r for r, _, _ in solves)) if stalls
                      else None)
        del sim32
    t1 = time.time()
    ranks = yield None
    out = {}
    for cell, deck_of in decks.items():
        fl = (floors or {}).get(cell)
        ref64, tal64, band, stalled = refs[cell]
        r64 = [r[f"{cell} f64"] for r in ranks]
        r32 = [r[f"{cell} f32"] for r in ranks]
        worst64 = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
        for i, (a, b) in enumerate(zip(r64[0]["states"], ref64)):
            for f, e in mg_state_errs(a, b, fl).items():
                worst64[f] = max(worst64[f], e)
                if not e <= TOL_SHARD_F64:
                    raise AssertionError(f"{cell} 2 ranks f64 step {i}: {f} "
                                         f"differs from 1 rank by {e:.3e}")
        for rank, r in enumerate(r64):
            if r["tallies"] != tal64[:steps64 + 1]:
                raise AssertionError(f"{cell} 2 ranks f64, rank {rank}: "
                                     f"tallies {r['tallies']}, 1 rank "
                                     f"{tal64[:steps64 + 1]}")
        own32 = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
        for b in band:
            for f, e in mg_state_errs(b, ref64[-1], fl).items():
                own32[f] = max(own32[f], e)
        shard32 = mg_state_errs(r32[0]["state"], ref64[-1], fl)
        bound32 = {f: TOL_SHARD_F32_FACTOR * own32[f]
                   + TOL_SHARD_F32_ULPS * ulp for f in SHARD_MG_FIELDS}
        for f in SHARD_MG_FIELDS:
            if not shard32[f] <= bound32[f]:
                raise AssertionError(
                    f"{cell} 2 ranks f32 after {warm + steps} steps: {f} is "
                    f"{shard32[f]:.3e} from the float64 run, the 1-rank f32 "
                    f"run {own32[f]:.3e} (bound {bound32[f]:.3e}; "
                    f"{len(band)} 1-rank starts)")
        stall = None
        if stalled is not None:
            sim32, worst = stalled
            for rank, r in enumerate(r32):
                if not r["nodal_solves"] or any(
                        q > worst or it >= m
                        for q, it, m in r["nodal_solves"]):
                    raise AssertionError(
                        f"{cell} 2 ranks f32, rank {rank}: nodal solves "
                        f"ended at {r['nodal_solves']} (bound {worst:.3f} x "
                        f"tolerance, the 1-rank runs' worst)")
            # the plain nodal operator: an EB deck's exact one is another
            res_over_tol = cycles = div = None
            if sim32.eb is None:
                res_over_tol, cycles, div, _ = vd_projection_check(
                    sim32, state.sim_from_numpy(
                        r32[0]["state"], "cuda", torch.float32), mg, torch)
                if not res_over_tol <= 1.0:
                    raise AssertionError(f"{cell} 2 ranks f32: the "
                                         f"re-projection stopped at "
                                         f"{res_over_tol:.2f} x tolerance")
            stall = {"starts": len(band),
                     "one_rank_worst_res_over_tol": worst,
                     "nodal_res_over_tol": [q for q, _, _ in
                                            r32[0]["nodal_solves"]],
                     "nodal_cycles": [it for _, it, _ in
                                      r32[0]["nodal_solves"]],
                     "reprojection_res_over_tol": res_over_tol,
                     "reprojection_cycles": cycles, "max_div_u": div}
        per_step = []
        for rank, r in enumerate(r32):
            got = {k: v / steps for k, v in r["smoother_launches"].items()}
            if not all(got[k] > 0 for k in families):
                raise AssertionError(f"{cell} rank {rank}: slab smoother "
                                     f"launches {r['smoother_launches']} in "
                                     f"{steps} steps")
            per_step.append(got)
        stencil = [r["stencil_slab_calls"] / steps for r in r32]
        slab_2d = [{k: v / steps for k, v in r["slab_2d_calls"].items()}
                   for r in r32]
        godunov = [{k: v for k, v in r["launches"].items() if v}
                   for r in r32]
        setup = [r["setup_s"] for r in r32]
        ms = max(r["ms_per_step"] for r in r32)
        inst = max(r["instrumented_ms_per_step"] for r in r32)
        comm = {k: {q: max(r["comm"][k][q] for r in r32)
                    for q in ("calls_per_step", "bytes_per_step",
                              "ms_per_step")} for k in r32[0]["comm"]}
        print(f"[{tag}] {cell} f64 over {SHARD_RANKS} ranks: init + "
              f"{steps64} steps, worst rel err against 1 rank "
              + ", ".join(f"{f} {e:.2e}" for f, e in worst64.items())
              + f" (tol {TOL_SHARD_F64:g}); tallies "
              f"{tal64[1:steps64 + 1]} on every rank", flush=True)
        print(f"[{tag}] {cell} f32 over {SHARD_RANKS} ranks sharing "
              f"the card: {ms:.3f} ms/step over {steps} steps after {warm} "
              "warm-up (slowest rank); rel err against the f64 run "
              "(2 ranks / 1 rank) "
              + ", ".join(f"{f} {shard32[f]:.2e} / {own32[f]:.2e}"
                          for f in SHARD_MG_FIELDS)
              + ("" if stall is None else
                 f" (the 1-rank: the largest over {stall['starts']} starts "
                 f"one rounding apart, its nodal solves stagnating above "
                 f"their tolerance, at worst "
                 f"{stall['one_rank_worst_res_over_tol']:.3f} x; rank 0's "
                 f"nodal solves "
                 f"{[round(q, 3) for q in stall['nodal_res_over_tol']]} x "
                 f"tol in {stall['nodal_cycles']} V-cycles"
                 + ("" if stall["reprojection_res_over_tol"] is None else
                    f", the final velocity re-projected to "
                    f"{stall['reprojection_res_over_tol']:.2f} x tol in "
                    f"{stall['reprojection_cycles']} V-cycles, max|div u| "
                    f"{stall['max_div_u']:.3e}") + ")")
              + "; smoother launches a step per rank "
              + "; ".join(str({k: v for k, v in p.items() if v})
                          for p in per_step)
              + (f"; 27-point EB nodal slab sweeps a step per rank "
                 f"{stencil}" if any(stencil) else "")
              + (f"; 2D slab sweeps a step per rank {slab_2d}"
                 if any(any(c.values()) for c in slab_2d) else "")
              + (f"; Godunov launches per rank {godunov}"
                 if any(godunov) else "")
              + f"; setup s per rank {[round(v, 2) for v in setup]}"
              + f"; instrumented {inst:.3f} ms/step, exchanges per step "
              + ", ".join(f"{k} {v['calls_per_step']:.0f} calls "
                          f"{v['bytes_per_step'] / 1e6:.3f} MB "
                          f"{v['ms_per_step']:.3f} ms"
                          for k, v in comm.items())
              + f"; the cells' 1-rank runs {t1 - t0:.1f} s (beside the "
              "ranks' untimed jobs)", flush=True)
        out[cell] = {"ranks": SHARD_RANKS, "mesh": r32[0]["mesh"],
                     "ms_per_step": ms, "steps": steps, "warmup": warm,
                     "instrumented_ms_per_step": inst, "comm": comm,
                     "smoother_launches_per_step": per_step,
                     "launches_per_rank": [r["smoother_launches"]
                                           for r in r32],
                     "stencil_slab_calls_per_step": stencil,
                     "slab_2d_calls_per_step": slab_2d,
                     "godunov_launches_per_rank": [r["launches"]
                                                   for r in r32],
                     "setup_s": setup,
                     "counts": [r["counts"] for r in r32],
                     "f64_max_rel_err": worst64, "f64_tol": TOL_SHARD_F64,
                     "tallies": tal64[:steps64 + 1],
                     "f32_rel_err_vs_f64": shard32,
                     "f32_one_rank_rel_err_vs_f64": own32,
                     "f32_bound": bound32, "f32_stall": stall,
                     "floors": fl, "one_rank_s_all_cells": t1 - t0}
    return out, ranks


# the 2-rank cells of an x that ends in boundaries: bench's channel
# without its cylinder at its bench width (128x64x16, x slabs of 64) and
# the bingham deck at 64x64x16 (slabs of 32; its section 4 cell is
# 128x128x32); bingham starts from rest, and its p, gp and mac_phi are
# rounding noise, held relative to the deck's pressure scale delp = 2
SHARD_XWALL_DECKS = {"channel": lambda dt: channel_deck(128, dt),
                     "bingham": lambda dt: bingham_deck(64, dt)}
SHARD_XWALL_FLOORS = {"bingham": {"p": 2.0, "gp": 4.0, "mac_phi": 2.0}}


def channel_operators(mg, cells, dtype, dev, seed):
    """The two operators of the channel step that run V-cycles or sweeps
    on its slabs, from seeded variable coefficients with the channel's
    sides (the dx of its 1.2 x 0.4 x 0.1 box): the tracer's Helmholtz
    operator (Dirichlet inflow x-lo, Neumann outflow x-hi, Neumann y
    walls, periodic z) and the nodal sigma-Poisson one (Neumann x-lo and
    y, the Dirichlet outflow plane at x-hi)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    dx = (1.2 / cells[0], 0.4 / cells[1], 0.1 / cells[2])
    faces = []
    for ax in range(3):
        f = 1e-3 * (0.5 + 1.5 * rng.random(tuple(
            n + (1 if a == ax else 0) for a, n in enumerate(cells))))
        if ax == 2:             # the periodic face n is face 0
            f = np.concatenate([f.take(range(cells[ax]), axis=ax),
                                f.take([0], axis=ax)], axis=ax)
        faces.append(t(f))
    tracer = mg.CellSolver(dx, (2, 1, 0), (1, 1, 0), alpha=1.0, beta=1e-3,
                           acoef=t(0.5 + rng.random(cells)),
                           bcoef=tuple(faces), direct=False)
    rho = 0.5 + 1.5 * rng.random(cells)
    nodal = mg.NodalSolver(dx, (False, False, True), (1, 1, 0), (2, 1, 0),
                           t(0.9 * min(dx) / rho), direct=False)
    return tracer, nodal


def phase_sharded_xwalls(incflo_torch, sk, mg, torch):
    """The slab forms with the level's x walls on the end ranks at every
    level of the channel's (128x64x16) tracer and nodal hierarchies
    (slab_forms), then the channel (128x64x16) and bingham (64x64x16)
    decks on 2 ranks sharing the card (sharded_cells)."""
    tracer, nodal = channel_operators(mg, (128, 64, 16), torch.float32,
                                      torch.device("cuda"), 41)
    forms = slab_forms(sk, mg, torch,
                       list(zip(SLAB_FAMILIES, (tracer, nodal))),
                       "sharded_xwalls", 43)
    cells, _ = yield from sharded_cells(incflo_torch, torch,
                                        SHARD_XWALL_DECKS, "sharded_xwalls",
                                        SHARD_XWALL_FLOORS)
    return {"slab_forms": forms, "cells": cells}


# the 2-rank EB cells: bench's channel_cyl at its bench width (128x64x16,
# x slabs of 64; its cylinder lies wholly on rank 0) and
# poiseuille_cyl_bingham at 64x64x16 (slabs of 32; its section 4 cell is
# 128x128x32), from rest plus a seeded perturbation zero in covered cells
SHARD_EB_DECKS = {"channel_cyl": lambda dt: channel_cyl_deck(128, dt),
                  "poiseuille_cyl_bingham": lambda dt: bingham_cyl_deck(64,
                                                                        dt)}


def eb_perturbation(sim):
    """probs.smooth_perturbation of the whole level, zero in covered
    cells (numpy)."""
    from incflo_torch.probs import smooth_perturbation
    fluid = sim.eb.fluid.cpu().numpy()
    return smooth_perturbation(sim.cfg.grid, 11) * fluid[..., None]


def eb_operators_f32(mg, torch, sim):
    """The MAC solver and the cut-cell velocity solver (the EB wall term
    in diag; the one the next step builds) of a deck's 1-rank float32
    Simulation on the card (the Bingham deck's from its perturbed
    start)."""
    s = sim.init_state()
    if sim.cfg.grid.periodic[0]:
        s = s._replace(level=s.level._replace(
            velocity=s.level.velocity + torch.as_tensor(
                eb_perturbation(sim), dtype=torch.float32,
                device=s.level.velocity.device)))
    return sim._mac_solver, step_velocity_solver(mg, sim, s, torch)


def phase_sharded_eb(incflo_torch, sk, mg, torch):
    """Embedded boundaries on the x-slab mesh: cell_smooth_slab at every
    level of channel_cyl's (128x64x16) and poiseuille_cyl_bingham's
    (64x64x16) MAC and cut-cell velocity hierarchies (slab_forms; the
    Bingham velocity levels with the x wrap plane of the EB wall term),
    then both decks on 2 ranks sharing the card (sharded_cells, the f32
    steps timed from init without a warm-up step; the 1-rank float32
    Simulations built once for both parts):
    their constant-density nodal projection is the plain 27-point EB
    solver, so they launch cell_smooth_slab alone, and the 27-point slab
    sweeps are counted apart."""
    solvers, sims = [], {}
    for cell, deck_of in SHARD_EB_DECKS.items():
        sims[cell] = incflo_torch.Simulation(
            incflo_torch.IncfloConfig.from_text(deck_of("float32")))
        solvers += [("cell_smooth_slab", op)
                    for op in eb_operators_f32(mg, torch, sims[cell])]
    forms = slab_forms(sk, mg, torch, solvers, "sharded_eb", 47)
    del solvers
    cells, _ = yield from sharded_cells(
        incflo_torch, torch, SHARD_EB_DECKS, "sharded_eb",
        perturbs={"poiseuille_cyl_bingham": eb_perturbation},
        families=("cell_smooth_slab",), warm=0, sims32=sims)
    return {"slab_forms": forms, "cells": cells}


def eb_cylinder_2d_deck(n, dtype):
    """incflo_tpu's sharded 2D EB deck (tests/test_sharding.py:172-205)
    at n x n: fully periodic 4 x 4 box, the fluid inside a cylinder of
    radius 1 at (2, 2), driven by delp (2, 0), mu 1, fixed dt 0.01,
    MOL-EB, Crank-Nicolson diffusion."""
    return deck_header(dtype) + f"""
amr.n_cell = {n} {n}
geometry.prob_lo = 0. 0.
geometry.prob_hi = 4. 4.
geometry.is_periodic = 1 1
incflo.delp = 2. 0.
incflo.geometry = "cylinder"
cylinder.internal_flow = true
cylinder.radius = 1.
cylinder.direction = 2
cylinder.center = 2. 2. 0.
incflo.mu = 1.
incflo.fixed_dt = 0.01
incflo.use_godunov = false
incflo.diffusion_type = 1
incflo.do_initial_proj = 0
"""


# the 2-rank cells of the 2D decks and the Godunov options: bench's tgv2d
# at its bench width (128^2, x slabs of 64) by MOL and by Godunov,
# incflo_tpu's 2D EB cylinder at 128^2, rt2d at 64x128 (2D V-cycles on
# slabs with y walls; its f32 nodal V-cycles stagnate above their
# tolerance, so its f32 witness takes the band of sharded_cells),
# shear3d 128x128x32 with use_mac_phi_in_godunov and with both options
SHARD_2D_DECKS = {
    "tgv2d": lambda dt: tgv2d_deck(128, dt),
    "tgv2d_godunov": lambda dt: tgv2d_godunov_deck(128, dt),
    "eb_cylinder": lambda dt: eb_cylinder_2d_deck(128, dt),
    "rt2d": lambda dt: rt2d_deck(128, dt),
    "shear3d_mac_phi": lambda dt: shear3d_deck(128, dt) + MAC_PHI,
    "shear3d_both": lambda dt: shear3d_deck(128, dt) + MAC_PHI + UFT,
}
# the halo-slab Godunov kernels each cell launches in its timed steps on
# every rank (every other Godunov kernel no time): the MAC-phi warm start
# predicts by the plain chain and advects by advect_halo; forces in the
# traces send predict and advect to the plain chain
# (incflo_tpu/ops/godunov.py:475,648); the 2D chain is plain
SHARD_2D_HALO = {"shear3d_mac_phi": ("advect_halo",)}
# the 2D slab sweeps (multigrid.SLAB_2D) each cell makes on every rank,
# and the cells that sweep the 9-point EB stencils on their slabs
SHARD_2D_SWEEPS = {"eb_cylinder": ("cell",), "rt2d": ("cell", "nodal")}
SHARD_2D_STENCIL = ("eb_cylinder",)


def rt2d_sweep_cases(sim, nranks):
    """The operators of rt2d's projections at the deck's width, float32,
    from its initial density on a 1-rank Simulation: the MAC one
    (beta = 1 / rho averaged to the faces) and the nodal one (sigma =
    dt / rho), periodic x, Neumann y walls; each with a seeded x and b
    and the calls at every level of its hierarchy
    (workers.sweep_levels)."""
    import numpy as np
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.parallel import workers
    per, neu = int(mg.SolverBC.PERIODIC), int(mg.SolverBC.NEUMANN)
    s = sim.init_state()
    rho = s.level.density.double().cpu().numpy()
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    rx = 0.5 * (rho + np.roll(rho, 1, 0))
    ry = np.concatenate([rho[:, :1], 0.5 * (rho[:, 1:] + rho[:, :-1]),
                         rho[:, -1:]], 1)
    dx = tuple(sim.grid.dx)
    mac = dict(kind="cell", dx=dx, bc_lo=(per, neu), bc_hi=(per, neu),
               alpha=0.0, beta=1.0, acoef=None,
               bcoef=[f32(np.concatenate([1 / rx, 1 / rx[:1]], 0)),
                      f32(1 / ry)], ebc=None)
    nodal = dict(kind="nodal", dx=dx, periodic=(True, False),
                 bc_lo=(per, neu), bc_hi=(per, neu),
                 sigma=f32(float(s.dt) / rho))
    return [workers.sweep_levels(mac, nranks, 700),
            workers.sweep_levels(nodal, nranks, 800)]


def phase_sharded_2d(incflo_torch, torch):
    """2D decks and the two Godunov options on the x-slab mesh: every
    SHARD_2D_DECKS cell on 2 ranks sharing the card (sharded_cells: f64
    init + 1 step against 1 rank, f32 against its witness bound, the f32
    steps timed from init without a warm-up step).  Each rank must launch the halo-slab kernels of SHARD_2D_HALO and no other
    Godunov kernel, and make the 2D slab sweeps of SHARD_2D_SWEEPS and
    the 9-point EB slab sweeps of SHARD_2D_STENCIL.  In the same spawn the
    2D cell and nodal sweeps of rt2d's projections (rt2d_sweep_cases)
    at every slab level, float32 on the card: each rank's rows bit-equal
    to the whole level's, one halo exchange a call
    (workers.sweep_mismatches)."""
    from incflo_torch.parallel import workers
    rt2d = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(
        SHARD_2D_DECKS["rt2d"]("float32")))
    cases = rt2d_sweep_cases(rt2d, SHARD_RANKS)
    n_cell = list(rt2d.grid.n_cell)
    cells, ranks = yield from sharded_cells(
        incflo_torch, torch, SHARD_2D_DECKS, "sharded_2d", families=(),
        warm=0, sims32={"rt2d": rt2d},
        jobs=[("rt2d sweeps", "solver_sweeps", dict(cases=cases))])
    del rt2d
    bad, n_slabs = workers.sweep_mismatches(
        ranks, "rt2d sweeps", cases,
        workers.solver_sweeps(None, cases, "cuda"))
    if bad:
        raise AssertionError(f"sharded_2d: rt2d's f32 slab sweeps differ "
                             f"from the whole level's at {bad[:10]}")
    calls = sum(len(lev) for c in ranks[0]["rt2d sweeps"]
                for lev in c["levels"][:c["n_slab"]])
    print(f"[sharded_2d] rt2d {n_cell} f32 2D slab sweeps of the MAC and nodal projections on the card: "
          f"every rank's rows bit-equal to the whole level's at {n_slabs} "
          f"slab levels (MAC rank 0, 1; nodal rank 0, 1), {calls} calls "
          f"on rank 0, one halo exchange each", flush=True)
    for cell, r in cells.items():
        want = SHARD_2D_HALO.get(cell, ())
        for rank, got in enumerate(r["godunov_launches_per_rank"]):
            bad = {k: v for k, v in got.items() if (v > 0) != (k in want)}
            if bad:
                raise AssertionError(f"sharded_2d {cell} rank {rank}: Godunov "
                                     f"launches {got}, want {want} alone")
        for rank, calls in enumerate(r["slab_2d_calls_per_step"]):
            if not all(calls[k] > 0 for k in SHARD_2D_SWEEPS.get(cell, ())):
                raise AssertionError(f"sharded_2d {cell} rank {rank}: 2D slab "
                                     f"sweeps a step {calls}")
        if cell in SHARD_2D_STENCIL and not all(
                c > 0 for c in r["stencil_slab_calls_per_step"]):
            raise AssertionError(f"sharded_2d {cell}: 9-point EB slab sweeps "
                                 f"{r['stencil_slab_calls_per_step']}")
    return {"cells": cells, "rt2d_sweeps": {"n_cell": n_cell,
                                            "slab_levels": n_slabs,
                                            "calls_rank0": calls}}


# the AMR cells on the x-slab mesh (2 ranks sharing the card): rt_amr at
# full width -- bench's rt (64x64x128, x slabs of 32) with one refined
# level, its z slab patch of 128x128x32 over the whole x range split in
# slabs of 64, regridded after step 2 -- and three small float64 cells:
# shear3d_amr on a 32x32x32 base (the deck's z tag band needs 32 z cells
# to leave coarse-fine faces; its fully periodic base level runs the
# halo-slab Godunov kernels beside a split patch), the box deck (its patch
# held whole on every rank) and rt2d on the dense fine level
SHARD_AMR_MAIN = lambda dt: rt_deck(128, dt) + RT_AMR_KEYS
SHARD_AMR_SMALL = {
    "shear3d_amr": (lambda: shear3d_deck(32, "float64").replace(
        "amr.n_cell = 32 32 8", "amr.n_cell = 32 32 32")
        + SHEAR3D_AMR_KEYS, False),
    "box": (lambda: AMR_BOX, False),
    "dense": (lambda: AMR_RT2D.replace("amr.patch_mode = slab\n", ""), True)}
# what each cell must launch on every rank, by tree level: the slab
# smoothers on rt_amr's split base and patch, the halo-slab Godunov
# kernels on shear3d_amr's split base and the slab smoothers on its patch
SHARD_AMR_KERNELS = {"rt_amr": {0: SLAB_FAMILIES, 1: SLAB_FAMILIES},
                     "shear3d_amr": {0: HALO_KERNELS, 1: SLAB_FAMILIES}}


def one_rank_amr(incflo_torch, torch, deck, nsteps, dense=False,
                 ulp_seed=None):
    """An AMR deck on one rank on the card (the patch tree, or dense the
    dense fine level) from init (ulp_seed: every level's velocity,
    density and tracer then nudged one rounding, as one_rank_run does)
    through nsteps steps: the whole trees after init and each step
    ((tree record, per-level dicts); dense: (None, [fine level])), each
    step's tallies and the steps' nodal solves that iterated."""
    import numpy as np
    from incflo_torch import state
    from incflo_torch.amr import AMRSimulation
    from incflo_torch.amr_patch import PatchState, SlabAMRSimulation
    from incflo_torch.ops import multigrid as mg
    cfg = incflo_torch.IncfloConfig.from_text(deck)
    amr = (AMRSimulation if dense else SlabAMRSimulation)(cfg)
    mg.reset_counts()
    s = amr.init_state()
    if ulp_seed is not None:
        rng = np.random.default_rng(ulp_seed)
        nudge = lambda a: a * (1 + torch.as_tensor(rng.integers(
            -1, 2, tuple(a.shape)), device=a.device, dtype=a.dtype)
            * torch.finfo(a.dtype).eps)
        s = PatchState([st._replace(level=st.level._replace(**{
            f: nudge(getattr(st.level, f))
            for f in ("velocity", "density", "tracer")})) for st in s.levels])

    def record():
        if dense:
            return None, [state.sim_to_numpy(s)]
        return amr.tree_meta(), state.patch_to_numpy(amr, s)
    states = [record()]
    tallies = [{k: mg.COUNTS[k] for k in ITER_KINDS}]
    mg.NODAL_LOG = []
    try:
        for _ in range(nsteps):
            before = dict(mg.COUNTS)
            s = amr.advance(s)
            tallies.append({k: mg.COUNTS[k] - before[k]
                            for k in ITER_KINDS})
            states.append(record())
        torch.cuda.synchronize()
        solves = [(float(res) / float(tol), it, maxiter)
                  for res, tol, it, maxiter in mg.NODAL_LOG]
    finally:
        mg.NODAL_LOG = None
    return states, tallies, solves


def tree_errs(a, b, cell):
    """Each field's (and dt's) largest difference over the levels of two
    whole trees (tree record, per-level dicts), relative to b's max;
    their trees must be equal."""
    if a[0] != b[0]:
        raise AssertionError(f"sharded_amr {cell}: trees {a[0]} and "
                             f"{b[0]} differ")
    worst = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
    for la, lb in zip(a[1], b[1]):
        for f, e in mg_state_errs(la, lb).items():
            worst[f] = max(worst[f], e)
    return worst


def check_amr_f64(cell, ranks, key, ref, tallies):
    """The ranks' float64 trees within TOL_SHARD_F64 of the 1-rank ones,
    equal tallies and dt bits on every rank; returns the worst
    errors."""
    got = ranks[0][key]["states"]
    worst = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
    for i, (a, b) in enumerate(zip(got, ref)):
        a = (a[0], a[1][:1]) if a[0] is None else a
        for f, e in tree_errs(a, b, cell).items():
            worst[f] = max(worst[f], e)
            if not e <= TOL_SHARD_F64:
                raise AssertionError(f"sharded_amr {cell} f64 state {i}: "
                                     f"{f} differs from 1 rank by {e:.3e}")
    for rank, r in enumerate(ranks):
        if r[key]["tallies"] != tallies[:len(got)]:
            raise AssertionError(f"sharded_amr {cell} f64 rank {rank}: "
                                 f"tallies {r[key]['tallies']}, 1 rank "
                                 f"{tallies}")
        if r[key]["dts"] != ranks[0][key]["dts"]:
            raise AssertionError(f"sharded_amr {cell}: the ranks' dts "
                                 f"{[q[key]['dts'] for q in ranks]}")
    return worst


def amr_launches(cell, ranks, key, nsteps):
    """Each rank's launches a step by tree level (the smoother and
    Godunov kernels), checked against SHARD_AMR_KERNELS."""
    out = []
    for rank, r in enumerate(ranks):
        per = {lev: {k: v / nsteps for t in (c["smoother"], c["godunov"])
                     for k, v in t.items() if v}
               for lev, c in sorted(r[key]["per_level"].items())}
        for lev, want in SHARD_AMR_KERNELS.get(cell, {}).items():
            if not all(per.get(lev, {}).get(k, 0) > 0 for k in want):
                raise AssertionError(f"sharded_amr {cell} rank {rank} level "
                                     f"{lev}: launches a step {per}, want "
                                     f"{want}")
        out.append(per)
    return out


def phase_sharded_amr(incflo_torch, torch):
    """Both AMR drivers split over 2 ranks that share the card
    (workers.amr_steps; a generator for run_sharded, as sharded_cells):
    rt_amr at full width, float64 init + 1 step held to the 1-rank port
    within TOL_SHARD_F64 with equal tallies and dts on every rank,
    float32 init + 2 steps (a regrid after the second) held to the
    witness of sharded_cells (2x the largest error of the 1-rank float32
    runs from starts one rounding apart against the 1-rank float64 run,
    + 4 ulps; the ranks' nodal solves end before maxiter and below their
    tolerance or no further above it than the 1-rank runs' worst),
    timed; the small SHARD_AMR_SMALL cells in float64 against 1 rank.
    Every rank must launch the kernels of SHARD_AMR_KERNELS on each
    level.  Prints ms/step (slowest rank), setup s per rank, exchanges a
    step by kind and the launches a step per rank on the base and the
    patch."""
    ulp = 1.1920928955078125e-07
    yield ([("rt_amr f64", "amr_steps",
             dict(deck=SHARD_AMR_MAIN("float64"), nsteps=1))]
           + [(f"{cell} f64", "amr_steps", dict(deck=deck(), nsteps=1,
                                                dense=dense))
              for cell, (deck, dense) in SHARD_AMR_SMALL.items()],
           [("rt_amr f32", "amr_steps",
             dict(deck=SHARD_AMR_MAIN("float32"), nsteps=2))])
    t0 = time.time()
    ref64, tal64, _ = one_rank_amr(incflo_torch, torch,
                                   SHARD_AMR_MAIN("float64"), 2)
    band, solves = [], []
    for seed in (None,) + tuple(range(SHARD_F32_BAND)):
        got, _, sv = one_rank_amr(incflo_torch, torch,
                                  SHARD_AMR_MAIN("float32"), 2,
                                  ulp_seed=seed)
        band.append(got[-1])
        solves += sv
    # a solve that reaches its tolerance passes; one that stagnates above
    # it may stop as far above it as the 1-rank runs' worst
    worst_solve = max([1.0] + [q for q, _, _ in solves])
    small = {cell: one_rank_amr(incflo_torch, torch, deck(), 1, dense)
             for cell, (deck, dense) in SHARD_AMR_SMALL.items()}
    t1 = time.time()
    ranks = yield None
    out = {"ranks": SHARD_RANKS, "mesh": ranks[0]["rt_amr f32"]["mesh"],
           "cells": {}}
    worst64 = check_amr_f64("rt_amr", ranks, "rt_amr f64", ref64, tal64)
    r32 = [r["rt_amr f32"] for r in ranks]
    own32 = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
    for b in band:
        for f, e in tree_errs(b, ref64[-1], "rt_amr").items():
            own32[f] = max(own32[f], e)
    shard32 = tree_errs(r32[0]["states"][-1], ref64[-1], "rt_amr")
    bound32 = {f: TOL_SHARD_F32_FACTOR * own32[f] + TOL_SHARD_F32_ULPS * ulp
               for f in SHARD_MG_FIELDS}
    for f in SHARD_MG_FIELDS:
        if not shard32[f] <= bound32[f]:
            raise AssertionError(
                f"sharded_amr rt_amr 2 ranks f32 after 2 steps: {f} is "
                f"{shard32[f]:.3e} from the float64 run, the 1-rank f32 runs "
                f"{own32[f]:.3e} (bound {bound32[f]:.3e})")
    for rank, r in enumerate(r32):
        if not r["nodal_solves"] or any(q > worst_solve or it >= m
                                        for q, it, m in r["nodal_solves"]):
            raise AssertionError(f"sharded_amr rt_amr f32 rank {rank}: nodal "
                                 f"solves ended at {r['nodal_solves']} (bound "
                                 f"{worst_solve:.3f} x tolerance)")
    steps = 2
    per_step = amr_launches("rt_amr", ranks, "rt_amr f32", steps)
    ms = max(r["ms_per_step"] for r in r32)
    setup = [r["setup_s"] for r in r32]
    comm = {k: max(r["comm"][k] for r in r32) / steps for k in r32[0]["comm"]}
    bounds = [t[0]["bounds"][1:] for t in r32[0]["states"]]
    card = card_line()
    print(f"[sharded_amr] rt_amr f64 over {SHARD_RANKS} ranks: init + 1 step, "
          f"worst rel err against 1 rank over both levels "
          + ", ".join(f"{f} {e:.2e}" for f, e in worst64.items())
          + f" (tol {TOL_SHARD_F64:g}); tallies {tal64[1:2]} on every rank",
          flush=True)
    print(f"[sharded_amr] rt_amr f32 over {SHARD_RANKS} ranks sharing the "
          f"card: {ms:.3f} ms/step over {steps} steps from init (slowest "
          f"rank; a regrid after step 2; patch bounds {bounds}); setup s per "
          f"rank {[round(v, 2) for v in setup]}; rel err against the f64 run "
          f"(2 ranks / 1-rank worst of {len(band)} starts one rounding apart) "
          + ", ".join(f"{f} {shard32[f]:.2e} / {own32[f]:.2e}"
                      for f in SHARD_MG_FIELDS)
          + f"; rank 0's nodal solves "
          f"{[round(q, 3) for q, _, _ in r32[0]['nodal_solves']]} x tol "
          f"(1-rank worst {worst_solve:.3f}); exchanges a step (calls) "
          + ", ".join(f"{k} {v:.1f}" for k, v in comm.items())
          + "; launches a step per rank by level "
          + "; ".join(str(p) for p in per_step)
          + f"; the 1-rank runs {t1 - t0:.1f} s (beside the ranks' "
          f"untimed jobs); {card}", flush=True)
    out["cells"]["rt_amr"] = {
        "n_cell": list(incflo_torch.IncfloConfig.from_text(
            SHARD_AMR_MAIN("float32")).grid.n_cell),
        "ms_per_step": ms, "steps": steps,
        "setup_s": setup, "comm_calls_per_step": comm, "bounds": bounds,
        "launches_per_step_per_rank": per_step,
        "f64_max_rel_err": worst64, "f64_tol": TOL_SHARD_F64,
        "tallies": tal64[:2], "f32_rel_err_vs_f64": shard32,
        "f32_one_rank_rel_err_vs_f64": own32, "f32_bound": bound32,
        "nodal_res_over_tol": [q for q, _, _ in r32[0]["nodal_solves"]],
        "one_rank_worst_res_over_tol": worst_solve, "card": card}
    for cell, (_, dense) in SHARD_AMR_SMALL.items():
        ref, tal, _ = small[cell]
        key = f"{cell} f64"
        worst = check_amr_f64(cell, ranks, key, ref, tal)
        per_step = amr_launches(cell, ranks, key, 1)
        split = ranks[0][key]["split"]
        print(f"[sharded_amr] {cell} f64 over {SHARD_RANKS} ranks: init + 1 "
              f"step, worst rel err against 1 rank "
              + ", ".join(f"{f} {e:.2e}" for f, e in worst.items())
              + f"; tallies {tal[1:]} on every rank; split entries "
              f"{split[-1]}; launches a step per rank by level "
              + "; ".join(str(p) for p in per_step), flush=True)
        out["cells"][cell] = {"f64_max_rel_err": worst, "tallies": tal,
                              "split": split,
                              "launches_per_step_per_rank": per_step}
    if ranks[0]["box f64"]["split"][-1] != [True, False]:
        raise AssertionError(f"sharded_amr box: split entries "
                             f"{ranks[0]['box f64']['split']}")
    out["one_rank_s"] = t1 - t0
    return out


# ROADMAP A13b and A14's last cells on 2 ranks, float64 init + 1 step
# against 1 rank: amr_eb's deck at 64x32x8 (the base split, the x band
# patch held whole on every rank with its whole geometry); shear3d at
# bench width with nx = 127, which does not split into 2 slabs (the level
# held whole on every rank: bit-equal to 1 rank, no exchange); shear3d
# 264x8x8, whose direct solves take rfftn on one device and V-cycles on
# the slabs under a mesh (against the port on a 1-rank mesh)
SHARD_AMR_EB = lambda: amr_eb_deck(64, "float64")
SHARD_WHOLE = lambda: shear3d_deck(128, "float64").replace(
    "amr.n_cell = 128 128 32", "amr.n_cell = 127 128 32").replace(
    "geometry.prob_hi = 1. 1. 0.25", "geometry.prob_hi = 0.9921875 1. 0.25")
SHARD_RFFTN = lambda: shear3d_deck(32, "float64").replace(
    "amr.n_cell = 32 32 8", "amr.n_cell = 264 8 8").replace(
    "geometry.prob_hi = 1. 1. 0.25", "geometry.prob_hi = 8.25 0.25 0.25")
# on each rank, by tree level: the base split (cell_smooth_slab for its
# EB MAC, velocity and tracer solves; its exact octant nodal projection
# the 27-point slab sweeps, plain PyTorch), the patch whole (the walled
# smoothers)
SHARD_AMR_KERNELS["channel_cyl_amr"] = {0: ("cell_smooth_slab",),
                                        1: (WALLED, WALLED_NODAL)}


def one_rank_mesh_steps(deck, nsteps):
    """workers.steps on a 1-rank mesh of this process (a gloo process
    group of one, joined through a FileStore in a temporary directory)
    on the card: the port on 1 rank in the form a mesh gives it (an
    rfftn deck's V-cycles on the slab)."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from incflo_torch.parallel import workers
    from incflo_torch.parallel.mesh import SlabMesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh1_")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
    try:
        return workers.steps(SlabMesh(device="cuda"), deck, nsteps)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sharded_amr_eb(incflo_torch, torch):
    """The last cells of ROADMAP A13b and A14 on 2 ranks that share the
    card, float64 init + 1 step against 1 rank (a generator for
    run_sharded, untimed jobs only): amr_eb's deck at 64x32x8 within
    TOL_SHARD_F64 of 1 rank with equal tallies and dts on both ranks --
    where its nodal solves stop at maxiter (channel_cyl's at small sizes,
    ROADMAP C), with equal stops on both ranks and within the error of
    1-rank runs from starts one rounding apart if that is larger; the
    shear3d level that does not split, held whole, bit-equal to 1 rank
    with no exchange; the rfftn deck on the slabs' V-cycles within
    TOL_SHARD_F64 of a 1-rank mesh with equal tallies."""
    import numpy as np
    yield ([("channel_cyl_amr f64", "amr_steps",
             dict(deck=SHARD_AMR_EB(), nsteps=1)),
            ("whole f64", "steps", dict(deck=SHARD_WHOLE(), nsteps=1)),
            ("rfftn f64", "steps", dict(deck=SHARD_RFFTN(), nsteps=1))], [])
    t0 = time.time()
    amr_ref, amr_tal, amr_solves = one_rank_amr(incflo_torch, torch,
                                                SHARD_AMR_EB(), 1)
    whole_ref, whole_tal, _ = one_rank_run(incflo_torch, torch,
                                           SHARD_WHOLE(), 1)
    rfftn_ref = one_rank_mesh_steps(SHARD_RFFTN(), 1)
    t1 = time.time()
    ranks = yield None
    out = {"ranks": SHARD_RANKS, "one_rank_s": t1 - t0, "cells": {}}
    key = "channel_cyl_amr f64"
    got = ranks[0][key]["states"]
    worst = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
    for a, b in zip(got, amr_ref):
        for f, e in tree_errs(a, b, "channel_cyl_amr").items():
            worst[f] = max(worst[f], e)
    stops = [[it for _, it, _ in r[key]["nodal_solves"]] for r in ranks]
    at_maxiter = any(it >= m for _, it, m in amr_solves)
    band = None
    if not all(e <= TOL_SHARD_F64 for e in worst.values()):
        if not at_maxiter:
            raise AssertionError(f"sharded_amr_eb channel_cyl_amr: 2 ranks "
                                 f"differ from 1 by {worst}")
        band = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
        for seed in range(SHARD_F32_BAND):
            nudged, _, _ = one_rank_amr(incflo_torch, torch, SHARD_AMR_EB(),
                                        1, ulp_seed=seed)
            for f, e in tree_errs(nudged[-1], amr_ref[-1],
                                  "channel_cyl_amr").items():
                band[f] = max(band[f], e)
        bad = {f: (worst[f], band[f]) for f in SHARD_MG_FIELDS
               if not worst[f] <= max(TOL_SHARD_F64, band[f])}
        if bad:
            raise AssertionError(f"sharded_amr_eb channel_cyl_amr: 2 ranks "
                                 f"against 1 beyond the 1-rank band: {bad}")
    if any(s != stops[0] for s in stops):
        raise AssertionError(f"sharded_amr_eb channel_cyl_amr: the ranks' "
                             f"nodal solves stop at {stops}")
    for rank, r in enumerate(ranks):
        if r[key]["tallies"] != amr_tal or r[key]["dts"] != \
                ranks[0][key]["dts"]:
            raise AssertionError(f"sharded_amr_eb channel_cyl_amr rank "
                                 f"{rank}: tallies {r[key]['tallies']}, 1 "
                                 f"rank {amr_tal}")
    split = ranks[0][key]["split"]
    if split[-1] != [True, False]:
        raise AssertionError(f"sharded_amr_eb channel_cyl_amr: split "
                             f"{split}")
    per_step = amr_launches("channel_cyl_amr", ranks, key, 1)
    print(f"[sharded_amr_eb] channel_cyl_amr 64x32x8 f64 over {SHARD_RANKS} "
          f"ranks: init + 1 step, base split, patch "
          f"{got[-1][0]['bounds'][1]} held whole; worst rel err against 1 "
          f"rank " + ", ".join(f"{f} {e:.2e}" for f, e in worst.items())
          + f" (tol {TOL_SHARD_F64:g}"
          + ("" if band is None else ", or the 1-rank band "
             + ", ".join(f"{f} {e:.2e}" for f, e in band.items()))
          + f"); nodal stops {stops[0]} on every rank (1-rank residual / "
          f"tol {[float(f'{q:.3g}') for q, _, _ in amr_solves]}); tallies "
          f"{amr_tal[1:]} on every rank; launches a step per rank by level "
          + "; ".join(str(p) for p in per_step), flush=True)
    out["cells"]["channel_cyl_amr"] = {
        "f64_max_rel_err": worst, "f64_tol": TOL_SHARD_F64,
        "one_rank_band": band, "nodal_stops": stops[0],
        "one_rank_nodal_res_over_tol": [q for q, _, _ in amr_solves],
        "tallies": amr_tal, "split": split,
        "launches_per_step_per_rank": per_step}
    key = "whole f64"
    for rank, r in enumerate(ranks):
        res = r[key]
        if res["split"] or any(res["comm"].values()) \
                or res["tallies"] != whole_tal:
            raise AssertionError(f"sharded_amr_eb whole rank {rank}: split "
                                 f"{res['split']}, exchanges {res['comm']}, "
                                 f"tallies {res['tallies']} / {whole_tal}")
    for i, (a, b) in enumerate(zip(ranks[0][key]["states"], whole_ref)):
        bad = [f for f in SHARD_MG_FIELDS if not np.array_equal(a[f], b[f])]
        if bad:
            raise AssertionError(f"sharded_amr_eb whole state {i}: {bad} "
                                 f"differ from 1 rank")
    launches = [r[key]["launches"] for r in ranks]
    print(f"[sharded_amr_eb] shear3d 127x128x32 f64 over {SHARD_RANKS} "
          f"ranks: held whole on every rank, init + 1 step bit-equal to 1 "
          f"rank, no exchange, tallies {whole_tal[1:]}; Godunov launches "
          f"per rank {launches}", flush=True)
    out["cells"]["whole"] = {"bit_equal": True, "tallies": whole_tal,
                             "godunov_launches_per_rank": launches}
    key = "rfftn f64"
    worst = dict.fromkeys(SHARD_MG_FIELDS, 0.0)
    for a, b in zip(ranks[0][key]["states"], rfftn_ref["states"]):
        for f, e in mg_state_errs(a, b).items():
            worst[f] = max(worst[f], e)
    tal = rfftn_ref["tallies"]
    if not all(e <= TOL_SHARD_F64 for e in worst.values()) \
            or any(r[key]["tallies"] != tal or not r[key]["split"]
                   for r in ranks) or not tal[1]["nodal_cycles"] > 0:
        raise AssertionError(f"sharded_amr_eb rfftn: 2 ranks against a "
                             f"1-rank mesh {worst}, tallies "
                             f"{[r[key]['tallies'] for r in ranks]} / {tal}")
    slab = [r[key]["smoother_launches"] for r in ranks]
    print(f"[sharded_amr_eb] shear3d 264x8x8 f64 over {SHARD_RANKS} ranks: "
          f"V-cycles on the slabs in place of the rfftn solve, init + 1 "
          f"step, worst rel err against a 1-rank mesh "
          + ", ".join(f"{f} {e:.2e}" for f, e in worst.items())
          + f" (tol {TOL_SHARD_F64:g}); tallies {tal[1:]} on every rank; "
          f"smoother launches per rank {slab}; the 1-rank runs "
          f"{t1 - t0:.1f} s (beside the ranks' untimed jobs)", flush=True)
    out["cells"]["rfftn"] = {"f64_max_rel_err": worst, "tallies": tal,
                             "smoother_launches_per_rank": slab}
    return out


def run_sharded(phases, stamp):
    """The sharded phases (name -> the phase's generator) with one spawn
    of SHARD_RANKS ranks sharing the card.  Each phase first yields its
    jobs for the ranks ((key, workers function, kwargs)) as (untimed,
    timed): its float64 and bit-equality runs, and its timed float32
    runs.  The spawn (workers.several) runs every phase's untimed jobs,
    waits at a gate (workers.wait_for), then runs every phase's timed
    jobs.  Meanwhile each phase runs its 1-rank references on the card
    here and yields None; the gate opens when they are done, so nothing
    else runs on the card while a timed job does.  Last each phase takes
    its jobs' results on every rank, checks and prints them and returns
    its result.  A failure here kills the ranks.  Returns {name:
    result}."""
    import concurrent.futures
    import shutil
    import tempfile
    import threading
    from incflo_torch.parallel import launch
    jobs = {name: next(gen) for name, gen in phases.items()}
    stamp("the sharded phases' set-up")
    key = lambda name, k: f"{name}: {k}"
    gate = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    every = ([(key(name, k), fn, kw) for name, (untimed, _) in jobs.items()
              for k, fn, kw in untimed]
             + [("gate", "wait_for", dict(path=os.path.join(gate, "go")))]
             + [(key(name, k), fn, kw) for name, (_, timed) in jobs.items()
                for k, fn, kw in timed])
    cancel = threading.Event()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    t0 = time.time()
    try:
        spawn = pool.submit(
            launch.run, "incflo_torch.parallel.workers:several", SHARD_RANKS,
            dict(jobs=every), device="cuda", timeout=900, cancel=cancel)
        for name, gen in phases.items():
            if next(gen) is not None:
                raise RuntimeError(f"{name}: a third set of jobs")
            stamp(f"{name} 1-rank references")
        t1 = time.time()
        open(os.path.join(gate, "go"), "w").close()
        ranks = spawn.result()
    except BaseException:
        cancel.set()
        raise
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(gate, ignore_errors=True)
    print(f"[sharded] one spawn of {SHARD_RANKS} ranks ran the "
          f"{len(every) - 1} jobs of {len(phases)} phases in "
          f"{time.time() - t0:.1f} s: the 1-rank references here "
          f"{t1 - t0:.1f} s beside the untimed jobs, the ranks waited "
          f"{max(r['gate'] for r in ranks):.1f} s at the gate before the "
          f"timed jobs", flush=True)
    stamp("the sharded phases' spawn")
    out = {}
    for name, gen in phases.items():
        mine = [{k: r[key(name, k)] for part in jobs[name]
                 for k, _, _ in part} for r in ranks]
        try:
            gen.send(mine)
        except StopIteration as done:
            out[name] = done.value
        else:
            raise RuntimeError(f"{name}: a third set of jobs")
        stamp(name)
    return out


CLI_ARGS = ["max_step=4", "amr.check_int=2", "amr.plot_int=2"]


def cli_run(main, mods, torch, deck, cwd, argv, tag):
    """incflo_torch.main.run(deck argv) from directory cwd, its stdout
    captured; the launch counters of `mods` set to 0 just before and read
    just after.  Returns (launches, stdout, ms per step as the driver
    prints it, wall seconds)."""
    import contextlib
    import io as stringio
    os.makedirs(cwd, exist_ok=True)
    out = stringio.StringIO()
    old = os.getcwd()
    for m in mods:
        m.reset_launches()
    t0 = time.perf_counter()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = main.run([deck] + argv)
    finally:
        os.chdir(old)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {}
    for m in mods:
        launches.update(m.LAUNCHES)
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {tag}: exit code {rc}:\n{text}")
    per = [float(l.split()[-1]) for l in text.splitlines()
           if l.startswith("Time per step:")]
    if len(per) != 1:
        raise AssertionError(f"cli {tag}: no 'Time per step' line:\n{text}")
    return launches, text, per[0] * 1e3, wall


def cli_launches_check(tag, launches, per_step, steps):
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"cli {tag}: launches {launches}, expected "
                             f"{want} ({steps} steps)")


def npz_equal(a, b):
    """The names of the arrays of two .npz files that differ (or are
    missing from one), bit for bit."""
    import numpy as np
    x, y = np.load(a), np.load(b)
    return sorted(k for k in set(x.files) | set(y.files)
                  if k not in x.files or k not in y.files
                  or x[k].dtype != y[k].dtype
                  or not np.array_equal(x[k], y[k]))


def phase_cli(incflo_torch, gk, sk, s2, torch):
    """The CLI driver (incflo_torch.main) on the card in a temporary
    directory.  shear3d at 128x128x32 f32, max_step = 4, check_int =
    plot_int = 2, plt_vort: the Godunov kernels launched 1 / 3 / 3 times
    a step and nothing else; then a restart from chk00002 to step 4,
    whose chk00004 must be bit-equal to the unbroken run's; every
    plotfile field finite.  tgv2d at 128^2 f32 with plt_error_u: one
    step2d launch a step, the Norm lines printed and finite.  One line a
    run with the driver's ms/step (its evolve loop, the plotfile and
    checkpoint writes included) beside the card."""
    import math
    import tempfile
    import numpy as np
    from incflo_torch import main
    mods = (gk, sk, s2)
    card = card_line()
    rows = []
    with tempfile.TemporaryDirectory(prefix="incflo_cli_") as root:
        deck = os.path.join(root, "shear3d")
        with open(deck, "w") as f:
            f.write(shear3d_deck(128, "float32"))
        unbroken = os.path.join(root, "shear3d_unbroken")
        restart = os.path.join(root, "shear3d_restart")
        runs = [("shear3d 128x128x32", unbroken,
                 CLI_ARGS + ["amr.plt_vort=1"], 4),
                ("shear3d 128x128x32 restart", restart,
                 CLI_ARGS + ["amr.plt_vort=1", "amr.restart=" +
                             os.path.join(unbroken, "chk00002")], 2)]
        for tag, cwd, argv, steps in runs:
            launches, text, ms, wall = cli_run(main, mods, torch, deck, cwd,
                                               argv, tag)
            cli_launches_check(tag, launches, PER_STEP, steps)
            rows.append({"run": tag, "steps": steps, "ms_per_step": ms,
                         "wall_s": wall, "launches": launches})
            print(f"[cli] {tag} f32: {ms:.3f} ms/step (the driver's, writes "
                  f"included) over {steps} steps, {wall:.2f} s in all; "
                  f"launches {launches}; {card}", flush=True)
        for d in ("Header", "Level_0.npz"):
            a = os.path.join(unbroken, "chk00004", d)
            b = os.path.join(restart, "chk00004", d)
            if d == "Header":
                same = open(a).read() == open(b).read()
                bad = [] if same else ["Header"]
            else:
                bad = npz_equal(a, b)
            if bad:
                raise AssertionError(f"cli shear3d: the restarted chk00004 "
                                     f"differs from the unbroken one in "
                                     f"{bad}")
        for cwd, plts in ((unbroken, ("plt00000", "plt00002", "plt00004")),
                          (restart, ("plt00004",))):
            for plt in plts:
                z = np.load(os.path.join(cwd, plt, "Level_0.npz"))
                if "vort" not in z.files:
                    raise AssertionError(f"cli shear3d {plt}: no vort")
                bad = [k for k in z.files if not np.isfinite(z[k]).all()]
                if bad:
                    raise AssertionError(f"cli shear3d {plt}: non-finite "
                                         f"{bad}")
        print("[cli] shear3d: the restarted chk00004 is bit-equal to the "
              "unbroken one; every plotfile field finite", flush=True)

        deck = os.path.join(root, "tgv2d")
        with open(deck, "w") as f:
            f.write(tgv2d_deck(128, "float32"))
        tag = "tgv2d 128^2"
        launches, text, ms, wall = cli_run(
            main, mods, torch, deck, os.path.join(root, "tgv2d_run"),
            CLI_ARGS + ["amr.plt_error_u=1"], tag)
        cli_launches_check(tag, launches, {"step2d": 1}, 4)
        norms = [l.strip() for l in text.splitlines() if "Norm" in l]
        if len(norms) != 6 or not all(math.isfinite(float(l.split()[-1]))
                                      for l in norms):
            raise AssertionError(f"cli {tag}: Norm lines {norms}")
        rows.append({"run": tag, "steps": 4, "ms_per_step": ms,
                     "wall_s": wall, "launches": launches, "norms": norms})
        print(f"[cli] {tag} f32: {ms:.3f} ms/step (the driver's, writes "
              f"included) over 4 steps, {wall:.2f} s in all; launches "
              f"{launches}; {card}", flush=True)
        for l in norms:
            print(f"[cli] {tag} {l}", flush=True)
    return rows


# ---------------------------------------------------------------------
# ROADMAP A13: patch AMR (incflo_torch/amr_patch.py) on the card
# ---------------------------------------------------------------------

# the decks of tests/test_torch_amr_*.py (tests/test_amr_patch.py's
# RT2D :15-37 with fixed dt, the Taylor vortex band :354-380 at n = 32,
# the probtype-21 box :451-467) and its 3D RT slab deck (:309-326)
AMR_RT2D = """
incflo.dtype = float64
amr.n_cell = 16 32
amr.max_level = 1
amr.patch_mode = slab
geometry.prob_lo = 0. 0.
geometry.prob_hi = 0.5 1.0
geometry.is_periodic = 1 0
ylo.type = "sw"
yhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. -0.1
incflo.use_godunov = true
incflo.constant_density = false
incflo.advect_tracer = true
incflo.ntrac = 1
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.cfl = 0.9
incflo.init_shrink = 1.0
incflo.initial_iterations = 1
incflo.gradrhoerr = 0.1
incflo.fixed_dt = 0.2
"""
AMR_TGV = """
incflo.dtype = float64
amr.n_cell = 32 32
amr.max_level = 1
amr.patch_mode = slab
amr.regrid_int = -1
geometry.prob_lo = 0. 0.
geometry.prob_hi = 2. 2.
geometry.is_periodic = 1 1
incflo.probtype = 2
incflo.mu = 0.001
incflo.ro_0 = 1.
incflo.fixed_dt = 0.008
incflo.diffusion_type = 0
incflo.initial_iterations = 3
incflo.tag_region = true
incflo.tag_region_lo = 0.75 0.0
incflo.tag_region_hi = 1.25 2.0
incflo.use_godunov = false
"""
AMR_BOX = """
incflo.dtype = float64
amr.n_cell = 32 32
amr.max_level = 1
amr.patch_mode = box
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1. 1.
geometry.is_periodic = 1 1
incflo.probtype = 21
incflo.tag_region = true
incflo.tag_region_lo = 0.3 0.4
incflo.tag_region_hi = 0.6 0.7
incflo.fixed_dt = 0.002
"""
AMR_RT3D = """
incflo.dtype = float64
amr.n_cell = 16 16 32
amr.max_level = 1
amr.patch_mode = slab
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 0.5 0.5 1.0
geometry.is_periodic = 1 1 0
zlo.type = "sw"
zhi.type = "sw"
incflo.probtype = 5
incflo.gravity = 0. 0. -0.1
incflo.constant_density = false
incflo.advect_tracer = true
incflo.mu = 0.001
incflo.mu_s = 0.001
incflo.gradrhoerr = 0.1
incflo.cfl = 0.5
"""
AMR_EB_KEYS = "amr.max_level = 1\namr.regrid_int = 2\n"


def amr_eb_deck(n, dtype):
    """bench's channel_cyl with its cylinder (channel_cyl_deck) and one
    refined level, regridded every 2 steps (ROADMAP A13b): the cut cells
    tag a band of x around the cylinder, which choose_patch_mode makes a
    slab patch with cut cells of its own."""
    return channel_cyl_deck(n, dtype) + AMR_EB_KEYS


AMR_PATHS = {"rt2d slab": AMR_RT2D, "tgv slab": AMR_TGV, "box": AMR_BOX,
             "rt3d slab 16x16x32": AMR_RT3D,
             "channel_cyl 32x16x8": amr_eb_deck(32, "float64")}
# the steps of a paths deck before its regrid (1 unless named): the EB
# deck takes 2, the second with a regrid of its own inside
AMR_PATH_STEPS = {"channel_cyl 32x16x8": 2}
# the full-width cells: bench's rt (64x64x128) and shear3d (128x128x32)
# with one refined level, regridded every 2 steps.  rt_amr runs at
# cfl 0.5, the cfl of tests/test_amr_patch.py's 3D RT slab deck: at
# bench's 0.9 the patch's velocity next to its low coarse-fine face
# triples in step 3 and blows up in step 4, in incflo_tpu as in the port
# (the same fields within 2.6e-11 over 3 steps in f64 on the CPU;
# ROADMAP C)
RT_AMR_KEYS = ("amr.max_level = 1\nincflo.gradrhoerr = 0.1\n"
               "amr.regrid_int = 2\nincflo.cfl = 0.5\n")
SHEAR3D_AMR_KEYS = ("amr.max_level = 1\namr.patch_mode = slab\n"
                    "incflo.tag_region = true\n"
                    "incflo.tag_region_lo = 0. 0. 0.10\n"
                    "incflo.tag_region_hi = 1. 1. 0.15\namr.regrid_int = 2\n")
AMR_MAIN = {"rt_amr": lambda: rt_deck(128, "float32") + RT_AMR_KEYS,
            "shear3d_amr": lambda: shear3d_deck(128, "float32")
            + SHEAR3D_AMR_KEYS,
            "channel_cyl_amr": lambda: amr_eb_deck(128, "float32")}
# each cell's slab axis (choose_patch_mode picks slab for all three), its
# warm-up and its timed steps: channel_cyl_amr's band lies along x, and
# its steps take seconds on the host (PERF.md), so it times 2
AMR_RUN = {"rt_amr": (2, 2, 5), "shear3d_amr": (2, 2, 5),
           "channel_cyl_amr": (0, 1, 2)}
# the kernels each level of a cell launches (every other kernel no time):
# shear3d's periodic base level the Godunov kernels (its solves are
# direct), rt's walled base level the walled smoothers, channel_cyl's EB
# base level the walled cell smoother (its nodal projection is the exact
# octant operator's 27-point stencils, plain PyTorch on both devices as
# in incflo_tpu); every patch the walled smoothers (Dirichlet coarse-fine
# faces on both sides of the slab axis; on channel_cyl's patch the
# cut-cell solves and the vfrac-weighted nodal weak form) and the plain
# walled Godunov chain (MOL on the EB deck)
AMR_KERNELS = {"rt_amr": {0: (WALLED, WALLED_NODAL),
                          1: (WALLED, WALLED_NODAL)},
               "shear3d_amr": {0: tuple(PER_STEP),
                               1: (WALLED, WALLED_NODAL)},
               "channel_cyl_amr": {0: (WALLED,), 1: (WALLED, WALLED_NODAL)}}
# the CLI's decks, each with its checkpoint interval k: max_step = 2k, a
# patch checkpoint and a plotfile every k steps, a restart from step k.
# The EB deck at its paths size (its steps take seconds at any size)
AMR_CLI = {"rt_amr": (AMR_MAIN["rt_amr"], 2),
           "channel_cyl_amr": (lambda: amr_eb_deck(32, "float64"), 1)}
# the paths deck and the cell of AMR with embedded boundaries, which
# scripts/slab_smoke.py runs alone as "amr_eb"
AMR_EB = ("channel_cyl 32x16x8", "channel_cyl_amr")
# the bounds, in tolerances, of the nodal solves of an AMR step, by role
# (a level's first nodal solve of the step is its "step" solve; its later
# ones, the composite sync's re-projection and on a MOL deck the
# corrector's projection, are "sync").  In f32 the V-cycles stop on
# stagnation above the tolerance, as the bubble's and rt2d's do (ROADMAP
# C): rt's base level at 3.6 x, a patch level at 13-15 x (on an H100;
# the f64 solve of the same shear3d_amr patch converges, 0.19 x on the
# CPU).  A
# correction solve of the composite sync starts from zero against
# nonzero Dirichlet values and may end after one V-cycle far above its
# tolerance (4.7e5 x on rt_amr's patch), in incflo_tpu as in the port
# (ROADMAP C, known flaws): it is held to end before maxiter only
AMR_NODAL_BOUNDS = {("base", "step"): 5.0, ("patch", "step"): 20.0,
                    ("base", "sync"): float("inf"),
                    ("patch", "sync"): float("inf")}
# a cell's own bounds where they differ: channel_cyl_amr's EB base level
# solves by the exact octant operator, whose f32 V-cycles stagnate at
# 20.6-31.2 x its tolerance beside the patch (52, 53 and 45 V-cycles of
# 100 on an H100), where the one-level channel_cyl's converge in 4; in
# f64 at 32x16x8 and 64x32x8 they run to maxiter, in incflo_tpu as in
# the port with equal iterations (ROADMAP C, known flaws)
AMR_NODAL_BOUNDS_OF = {"channel_cyl_amr": {("base", "step"): 40.0}}


def amr_state_errs(a, b):
    """The worst relative difference of every field and dt over the
    entries of two PatchStates."""
    worst = 0.0
    for sa, sb in zip(a.levels, b.levels):
        for f in A9C_FIELDS:
            worst = max(worst, rel_state_err(getattr(sa.level, f),
                                             getattr(sb.level, f)))
        worst = max(worst, rel_state_err(sa.dt, sb.dt))
    return worst


def paths_amr_run(incflo_torch, mg, torch, name, dev):
    """An AMR paths deck on `dev`: the trees' states and records after
    init, each of its AMR_PATH_STEPS and one regrid, and each step's
    iterations."""
    from incflo_torch.amr_patch import SlabAMRSimulation
    cfg = incflo_torch.IncfloConfig.from_text(AMR_PATHS[name])
    amr = SlabAMRSimulation(cfg, device=dev)
    s = amr.init_state()
    states, trees, iters = [s], [amr.tree_meta()], []
    for _ in range(AMR_PATH_STEPS.get(name, 1)):
        before = dict(mg.COUNTS)
        s = amr.advance(s)
        if dev == "cuda":
            torch.cuda.synchronize()
        iters.append({k: mg.COUNTS[k] - before[k] for k in ITER_KINDS})
        states.append(s)
        trees.append(amr.tree_meta())
    states.append(amr.regrid(s))
    trees.append(amr.tree_meta())
    return states, trees, iters


def cpu_paths_ahead(incflo_torch, mg, torch):
    """Every CPU half of the paths runs (phase_paths, the A9c / 3D MOL,
    A8 / A11 and AMR paths decks) into CPU_RUNS, for main() to
    run while nvcc builds the kernels: the cpu runs need none of them.
    On two intra-op threads: these levels are small, and torch's default
    of one thread a core ran the EB AMR paths deck about eight times slower
    than two threads on an 8-core host (and nvcc shares the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        for name in ("shear3d", "shear3d_vd", "rt", "tgv2d"):
            CPU_RUNS["paths", name] = paths_cpu(incflo_torch, torch, name)
        for name in A9C_DECKS:
            CPU_RUNS["a9c", name] = paths_a9c_cpu(incflo_torch, mg, torch,
                                                  name)
        for name in A8_A11_PATHS:
            CPU_RUNS["a8_a11", name] = paths_a8_a11_cpu(incflo_torch, mg,
                                                        torch, name)
        for name in AMR_PATHS:
            CPU_RUNS["amr", name] = paths_amr_run(incflo_torch, mg, torch,
                                                  name, "cpu")
    finally:
        torch.set_num_threads(threads)


def phase_paths_amr(incflo_torch, mg, torch, name):
    """An AMR deck on cuda (kernels) and on cpu (plain versions), f64:
    each from its own init_state, its AMR_PATH_STEPS and one regrid; the
    trees (axis, bounds, parents) identical, every entry's fields and dt
    to 1e-9 relative after init, each step and the regrid, the solvers'
    iterations equal."""
    runs = {"cpu": cpu_half(("amr", name), lambda: paths_amr_run(
        incflo_torch, mg, torch, name, "cpu")),
        "cuda": paths_amr_run(incflo_torch, mg, torch, name, "cuda")}
    (sc, tc, ic), (sg, tg, ig) = runs["cpu"], runs["cuda"]
    if tc != tg:
        raise AssertionError(f"amr {name}: trees differ {tc} vs {tg}")
    if ic != ig:
        raise AssertionError(f"amr {name}: iterations differ {ic} vs {ig}")
    worst = max(amr_state_errs(a, b) for a, b in zip(sg, sc))
    print(f"[paths] amr {name}: cuda vs cpu f64, init + {len(ig)} step(s)"
          f" + regrid, "
          f"{len(tg[-1]['bounds'])} entries, bounds {tg[-1]['bounds'][1:]},"
          f" worst relative {worst:.3e} (tol 1e-9); iterations {ig}",
          flush=True)
    if not worst <= 1e-9:
        raise AssertionError(f"amr {name}: cuda and cpu differ: {worst:.3e}")
    return worst


def amr_cells(amr):
    """Cells each level advances."""
    out = {}
    for sim, lev in zip(amr.sims, amr.level_of):
        n = 1
        for c in sim.grid.n_cell:
            n *= c
        out[lev] = out.get(lev, 0) + n
    return out


def phase_main_amr(incflo_torch, gk, sk, mg, torch, name):
    """An AMR cell at full width, f32, through SlabAMRSimulation.advance
    on the card, its warm-up and timed steps from AMR_RUN: the patch mode
    chosen automatically (it must be slab, along the cell's axis), ms/step
    and setup s, the cells per level, the bounds after each regrid, the
    launches a step of each kernel per level (counters zeroed just before
    the warm-up, read just after the timed steps), the solvers' tallies,
    finite fields with covered cells at rest; then one more step,
    profiled for the device idle share, whose nodal solves are held to
    AMR_NODAL_BOUNDS and whose patch solvers it returns."""
    from incflo_torch.amr_patch import SlabAMRSimulation, choose_patch_mode
    from incflo_torch.parallel import workers
    axis, warm, steps = AMR_RUN[name]
    cfg = incflo_torch.IncfloConfig.from_text(AMR_MAIN[name]())
    mode = choose_patch_mode(cfg)
    if mode != "slab":
        raise AssertionError(f"{name}: patch mode {mode}, expected slab")
    t_setup = time.perf_counter()
    amr = SlabAMRSimulation(cfg)
    s = amr.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    if amr.axis != axis:
        raise AssertionError(f"{name}: slab axis {amr.axis}, expected "
                             f"{'xyz'[axis]}")
    # an EB deck's patches are tagged from the cut cells: each holds some
    if amr.sim0.eb is not None and any(sim.eb is None
                                       for sim in amr.sims[1:]):
        raise AssertionError(f"{name}: a patch without cut cells: "
                             f"{amr.tree_meta()}")
    band = {"axis": "xyz"[amr.axis], "bounds": amr.bounds[1:],
            "cut_cells": [0 if sim.eb is None else int(sim.eb.cut.sum())
                          for sim in amr.sims[1:]]}
    bounds = [amr.tree_meta()["bounds"][1:]]
    gk.reset_launches()
    sk.reset_launches()
    mg.reset_counts()
    with workers.level_tallies(amr, {"godunov": gk.LAUNCHES,
                                     "smoother": sk.LAUNCHES}) as per_level:
        for _ in range(warm):
            s = amr.advance(s)
            bounds.append(amr.tree_meta()["bounds"][1:])
        torch.cuda.synchronize()
        warm_counts = dict(mg.COUNTS)
        t0 = time.perf_counter()
        for _ in range(steps):
            s = amr.advance(s)
            bounds.append(amr.tree_meta()["bounds"][1:])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    total = warm + steps
    per_step = {k: (v - warm_counts[k]) / steps for k, v in mg.COUNTS.items()}
    launches = {lev: {k: v for t in per_level[lev].values()
                      for k, v in t.items() if v}
                for lev in sorted(per_level)}
    per_level_step = {lev: {k: v / total for k, v in t.items()}
                      for lev, t in launches.items()}
    for lev, want in AMR_KERNELS[name].items():
        got = set(launches.get(lev, {}))
        if got != set(want):
            raise AssertionError(f"{name} level {lev}: kernels {launches}, "
                                 f"expected {want}")
    if name == "shear3d_amr":
        got = {k: launches[0][k] / total for k in PER_STEP}
        if got != {k: float(v) for k, v in PER_STEP.items()}:
            raise AssertionError(f"{name}: level-0 Godunov launches a step "
                                 f"{got}, expected {PER_STEP}")
    check_one_launch(sk, name)
    check_tallies(name, per_step)
    for sim, st in zip(amr.sims, s.levels):
        for f in A9C_FIELDS:
            if not bool(torch.isfinite(getattr(st.level, f)).all()):
                raise AssertionError(f"{name}: non-finite {f}")
        if sim.eb is not None:
            covered = sim.eb.covered > 0.5
            if bool(covered.any()) and \
                    bool(st.level.velocity[covered].abs().max() > 0):
                raise AssertionError(f"{name}: a covered cell moves")
    ms = (t1 - t0) / steps * 1e3
    cells = amr_cells(amr)
    # one more step, profiled for the device idle share: its nodal solves
    # with their shapes, and the patch solvers it builds, which
    # phase_levels_amr holds to their plain versions
    prof = {}

    def run(st, k):
        with patch_solvers(mg, amr) as prof["solvers"]:
            for _ in range(k):
                st = amr.advance(st)
        return st
    shaped, cell = shaped_nodal_solves(mg, lambda: prof.update(
        profile=phase_profile(amr.sim0, s, torch, name, ms, steps=1,
                              run=run, table=False)))
    solves = [sv for _, sv in shaped]
    base = amr.sim0.grid.node_shape
    seen, roles = set(), []
    for shape, _ in shaped:
        roles.append(("base" if shape == base else "patch",
                      "sync" if shape in seen else "step"))
        seen.add(shape)
    bounds_n = [AMR_NODAL_BOUNDS_OF.get(name, {}).get(r, AMR_NODAL_BOUNDS[r])
                for r in roles]
    if not any(r == ("patch", "step") for r in roles) or any(
            r > b or it >= m for (r, it, m), b in zip(solves, bounds_n)):
        raise AssertionError(f"{name}: the step's nodal solves ended at "
                             f"{shaped} (roles {roles}, bounds {bounds_n} x "
                             f"tolerance)")
    if any(it >= m for _, it, m in cell):
        raise AssertionError(f"{name}: a cell solve reached maxiter: {cell}")
    card = card_line()
    tally = ", ".join(f"{k} {per_step[k]:.1f}" for k in
                      ("cell_iters", "cell_solves", "nodal_cycles",
                       "nodal_solves", "tensor_cg_iters", "host_syncs"))
    print(f"[main] {name} {cfg.grid.n_cell} f32: patch mode {mode} (auto), "
          f"band along {band['axis']} {band['bounds']} with cut cells of its"
          f" own {band['cut_cells']}; {ms:.3f} ms/step over {steps} steps "
          f"after {warm} warm-up (setup {setup_s:.1f} s); cells per level "
          f"{cells}; bounds after each step {bounds}; per step: {tally}; "
          f"launches a step per level {per_level_step}; the next step's "
          f"nodal solves: residual / tol {[round(r, 3) for r, _, _ in solves]}"
          f" in {[it for _, it, _ in solves]} V-cycles (maxiter "
          f"{cfg.nodal_mg_maxiter}; {roles}); its "
          f"cell CG solves: "
          f"best residual / tol {[float(f'{r:.3g}') for r, _, _ in cell]} in"
          f" {[it for _, it, _ in cell]} iterations; t={float(s.t):.6f} "
          f"dt={float(s.dt):.6e}; {card}", flush=True)
    out = {"deck": name, "n_cell": list(cfg.grid.n_cell),
           "patch_mode": mode, "band": band,
           "cells_per_level": cells, "ms_per_step": ms, "steps": steps,
           "warmup": warm, "setup_s": setup_s, "bounds": bounds,
           "per_step": per_step, "launches_per_level": launches,
           "launches_per_step_per_level": per_level_step,
           "nodal_roles": roles,
           "nodal_res_over_tol": [r for r, _, _ in solves],
           "nodal_cycles": [it for _, it, _ in solves],
           "cell_res_over_tol": [r for r, _, _ in cell],
           "cell_cg_iters": [it for _, it, _ in cell], "card": card,
           "profile": prof["profile"]}
    return out, prof["solvers"]


def shaped_nodal_solves(mg, run):
    """logged_solves(mg, run) with each iterated nodal solve's node shape
    (NodalSolver's and EBNodalSolver's, the exact octant operator of an
    EB level): ([(shape, (residual / tol, V-cycles, maxiter))], cell
    solves)."""
    shapes = []
    classes = (mg.NodalSolver, mg.EBNodalSolver)
    infos = [c.solve_info for c in classes]

    def shaped(info):
        def wrapped(self, rhs, *a, **kw):
            n = len(mg.NODAL_LOG)
            out = info(self, rhs, *a, **kw)
            if len(mg.NODAL_LOG) > n:
                shapes.append(tuple(rhs.shape))
            return out
        return wrapped
    for c, info in zip(classes, infos):
        c.solve_info = shaped(info)
    try:
        solves, cell = logged_solves(mg, run)
    finally:
        for c, info in zip(classes, infos):
            c.solve_info = info
    if len(shapes) != len(solves):
        raise AssertionError(f"{len(solves)} nodal solves logged, "
                             f"{len(shapes)} shapes")
    return list(zip(shapes, solves)), cell


@contextlib.contextmanager
def patch_solvers(mg, amr):
    """Within: the cell and nodal solvers the steps build on the patches
    (those whose fine level has a Dirichlet side on both ends of the slab
    axis, the coarse-fine faces), by the first of each kind (MAC,
    velocity, tracer; nodal), collected into the dict it yields."""
    found = {}
    cell_info, nodal_info = mg.CellSolver.solve_info, \
        mg.NodalSolver.solve_info
    cells = {sim.grid.cell_shape for sim in amr.sims[1:]}
    nodes = {sim.grid.node_shape for sim in amr.sims[1:]}

    def cf(lev):
        return (lev.bc_lo[amr.axis] == mg.SolverBC.DIRICHLET
                and lev.bc_hi[amr.axis] == mg.SolverBC.DIRICHLET)

    def cell(self, rhs, **kw):
        lev = self.levels[0]
        if cf(lev) and tuple(rhs.shape[:3]) in cells:
            kind = ("velocity" if rhs.dim() == 4 else
                    "mac" if lev.acoef is None else "tracer")
            found.setdefault(kind, self)
        return cell_info(self, rhs, **kw)

    def nodal(self, rhs, **kw):
        if cf(self.levels[0]) and tuple(rhs.shape) in nodes:
            found.setdefault("nodal", self)
        return nodal_info(self, rhs, **kw)
    mg.CellSolver.solve_info, mg.NodalSolver.solve_info = cell, nodal
    try:
        yield found
    finally:
        mg.CellSolver.solve_info, mg.NodalSolver.solve_info = \
            cell_info, nodal_info


def phase_levels_amr(sk, mg, torch, name, solvers):
    """The walled smoothers at every level of the patch hierarchies that
    the profiled step of `name` built (`solvers`, from phase_main_amr:
    MAC, velocity, tracer and nodal, the coarse-fine faces Dirichlet on
    both sides of the slab axis, the nodal Dirichlet rows inhomogeneous:
    b holds seeded values there; on an EB patch the cut-cell
    coefficients with the wall term and the vfrac-weighted nodal sigma),
    at the call their V-cycles make: bit-equal to the plain version in
    float32 through the solvers' own _smooth_res, within 1e-13 in
    float64 on the same coefficients, one kernel node a call (CUDA
    graph); kernel, plain and bound ms."""
    import numpy as np
    saved = save_launches(sk)
    if set(solvers) != {"mac", "velocity", "tracer", "nodal"} and \
            set(solvers) != {"mac", "velocity", "nodal"}:
        raise AssertionError(f"{name}: patch solvers found {list(solvers)}")
    rng = np.random.default_rng(47)
    rows = []
    for kind, solver in sorted(solvers.items()):
        cell = isinstance(solver, mg.CellSolver)
        name_k = WALLED if cell else WALLED_NODAL
        last = len(solver.levels) - 1
        for li in range(last + 1):
            coefs, kw = level_args(mg, solver, li)
            shape = tuple(solver.diags[li].shape)
            n = solver.nu_bottom if li == last else solver.nu1
            want = li < last
            dev = solver.diags[li].device
            x = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=dev)
            b = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=dev)
            plain_fn = sk.cell_smooth_plain if cell else sk.nodal_smooth_plain
            kern_fn = sk.cell_smooth if cell else sk.nodal_smooth
            call = lambda: solver._smooth_res(x, b, li, n, want)
            plain = lambda: plain_fn(x, b, *coefs, n, want, **kw)
            got, ref = call(), plain()
            if not all(torch.equal(u, v) for u, v in zip(got, ref)
                       if v is not None):
                raise AssertionError(f"{name} {kind} level {li}: kernel and "
                                     "plain version differ (f32)")
            cast = lambda t: t.to(torch.float64) if isinstance(
                t, torch.Tensor) else (tuple(cast(u) for u in t)
                                       if isinstance(t, tuple) else t)
            c64 = tuple(cast(c) for c in coefs)
            kw64 = {k: cast(v) if k == "Fwall" else v for k, v in kw.items()}
            x64, b64 = x.to(torch.float64), b.to(torch.float64)
            g64 = kern_fn(x64, b64, *c64, n, want, **kw64)
            r64 = plain_fn(x64, b64, *c64, n, want, **kw64)
            e64 = max(rel_state_err(u, v) for u, v in zip(g64, r64)
                      if v is not None)
            if not e64 <= TOL_WALLED_F64:
                raise AssertionError(f"{name} {kind} level {li}: f64 kernel "
                                     f"and plain differ by {e64:.3e}")
            launches = graph_launches(sk, call)
            if launches != 1:
                raise AssertionError(f"{name} {kind} level {li}: one call is "
                                     f"{launches} device launches")
            row = {"deck": name, "solver": kind, "family": name_k,
                   "level": li, "shape": "x".join(str(v) for v in x.shape),
                   "bc": repr(kw["bc"]),
                   "call": f"{n} sweeps" + (" + residual" if want else ""),
                   "bit_equal_f32": True, "max_rel_err_f64": e64,
                   "device_launches": launches, "ms": device_ms(call),
                   "plain_ms": device_ms(plain),
                   "bytes": smooth_bytes(mg, solver, li, x, want),
                   "ops": count_ops(plain)}
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"])
            rows.append(row)
            print(f"[levels] amr {name} patch {kind} level {li} "
                  f"{row['shape']} bc {row['bc']}, {row['call']}: bit-equal "
                  f"f32, f64 {e64:.2e}, {launches} kernel node a call, kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    torch.cuda.synchronize()
    check_one_launch(sk, f"{name} levels")
    restore_launches(sk, saved)
    return rows


def phase_cli_amr(incflo_torch, gk, sk, s2, torch, name):
    """The CLI driver on an AMR_CLI deck on the card: the patch mode
    auto-selected (slab), max_step = 2k with a patch checkpoint and a
    plotfile every k steps, then a restart from step k (an EB deck's
    cut-cell geometry rebuilt from the deck) whose last checkpoint (every
    patch level and the tree) is bit-equal to the unbroken one; the walled
    smoothers launched and no Godunov kernel; every plotfile field
    finite."""
    import tempfile
    import numpy as np
    from incflo_torch import main
    deck_text, k = AMR_CLI[name]
    argv = [f"max_step={2 * k}", f"amr.check_int={k}", f"amr.plot_int={k}"]
    chk = lambda d, step: os.path.join(d, f"chk{step:05d}")
    rows = []
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="incflo_amr_cli_") as root:
        deck = os.path.join(root, name)
        with open(deck, "w") as f:
            f.write(deck_text())
        unbroken = os.path.join(root, "unbroken")
        restart = os.path.join(root, "restart")
        for tag, cwd, args, steps in (
                (name, unbroken, argv, 2 * k),
                (f"{name} restart", restart,
                 argv + ["amr.restart=" + chk(unbroken, k)], k)):
            launches, text, ms, wall = cli_run(main, (gk, sk, s2), torch,
                                               deck, cwd, args, tag)
            if tag == name and \
                    "amr.patch_mode auto-selected: slab" not in text:
                raise AssertionError(f"cli {tag}: no slab auto-selection:\n"
                                     f"{text}")
            if not launches[WALLED] > 0 or not launches[WALLED_NODAL] > 0 \
                    or any(launches[g] for g in PER_STEP):
                raise AssertionError(f"cli {tag}: launches {launches}")
            rows.append({"run": tag, "steps": steps, "ms_per_step": ms,
                         "wall_s": wall, "launches": launches})
            print(f"[cli] {tag}: {ms:.3f} ms/step (the driver's, writes "
                  f"included) over {steps} steps, "
                  f"{wall:.2f} s in all; launches {launches}; {card}",
                  flush=True)
        a, b = chk(unbroken, 2 * k), chk(restart, 2 * k)
        names = sorted(os.path.relpath(os.path.join(r, f), a)
                       for r, _, fs in os.walk(a) for f in fs)
        if "Patch.json" not in names or len(names) < 5:
            raise AssertionError(f"cli {name}: {a} holds {names}")
        for f in names:
            pa, pb = os.path.join(a, f), os.path.join(b, f)
            bad = npz_equal(pa, pb) if f.endswith(".npz") else (
                [] if open(pa).read() == open(pb).read() else [f])
            if bad:
                raise AssertionError(f"cli {name}: the restarted "
                                     f"{os.path.basename(a)} differs in {f}: "
                                     f"{bad}")
        plt = lambda step: f"plt{step:05d}"
        for cwd, plts in ((unbroken, (plt(0), plt(k), plt(2 * k))),
                          (restart, (plt(2 * k),))):
            for p in plts:
                for lv in ("Level_0.npz", "Level_1.npz"):
                    z = np.load(os.path.join(cwd, p, lv))
                    bad = [v for v in z.files if not np.isfinite(z[v]).all()]
                    if bad:
                        raise AssertionError(f"cli {name} {p} {lv}: "
                                             f"non-finite {bad}")
        print(f"[cli] {name}: the restarted {os.path.basename(a)} "
              f"({len(names)} files, every patch level) is bit-equal to the "
              f"unbroken one; every plotfile field finite", flush=True)
    return rows


def phase_amr(incflo_torch, gk, sk, s2, mg, torch, stamp, names=None):
    """ROADMAP A13 and A13b on the card: the AMR paths decks cuda vs cpu,
    the full-width cells, each cell's patch levels' smoothers against
    their plain versions, the CLI with its restart; `names` keeps only
    those paths decks and cells (scripts/slab_smoke.py amr_eb)."""
    keep = [n for n in (*AMR_PATHS, *AMR_MAIN) if names is None or n in names]
    for name in AMR_PATHS:
        if name in keep:
            phase_paths_amr(incflo_torch, mg, torch, name)
            stamp(f"amr paths {name}")
    main, levels, cli = {}, [], []
    for name in AMR_MAIN:
        if name not in keep:
            continue
        main[name], solvers = phase_main_amr(incflo_torch, gk, sk, mg,
                                             torch, name)
        stamp(f"amr main {name}")
        levels += phase_levels_amr(sk, mg, torch, name, solvers)
        stamp(f"amr levels {name}")
        del solvers
    for name in AMR_CLI:
        if name in keep:
            cli += phase_cli_amr(incflo_torch, gk, sk, s2, torch, name)
            stamp(f"amr cli {name}")
    return main, levels, cli


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "incflo_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(incflo_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import incflo_torch
    from incflo_torch.grid import Grid
    from incflo_torch.ops import cuda_build
    from incflo_torch.ops import godunov_kernels as gk
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    from incflo_torch.ops import step2d_kernels as s2

    def grid_of(n):
        nz = max(n // 4, 8)
        return Grid((n, n, nz), (0.0, 0.0, 0.0), (1.0, 1.0, 0.25),
                    (True, True, True))

    t_start = time.time()

    def stamp(what):
        print(f"[time] {what} done at {time.time() - t_start:.1f} s",
              flush=True)
    profile = "--profile" in argv
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    build_s = phase_build(cuda_build, [gk.SOURCE, sk.SOURCE, s2.SOURCE],
                          lambda: cpu_paths_ahead(incflo_torch, mg, torch))
    stamp("build, the paths' cpu halves beside it")
    kres = phase_kernels(gk, sk, grid_of, torch)
    hres = phase_halo_kernels(gk, sk, grid_of, torch)
    sres = phase_smoothers(sk, mg, grid_of, torch)
    wres = phase_walled_smoother(sk, mg, torch)
    wnres = phase_walled_nodal(sk, mg, torch)
    levels = phase_levels(sk, mg, torch)
    s2res = phase_step2d(incflo_torch, s2, sk, torch)
    stamp("build, kernels, levels, step2d")
    phase_solvers(mg, torch)
    phase_solvers_walled(mg, torch)
    phase_paths(incflo_torch, torch)
    phase_paths(incflo_torch, torch, vd=True)
    phase_paths(incflo_torch, torch, rt=True)
    phase_paths(incflo_torch, torch, tgv=True)
    for deck in A9C_DECKS:
        phase_paths_a9c(incflo_torch, mg, torch, deck)
    phase_paths_tgv2d_explicit(incflo_torch, s2, torch)
    stamp("solvers, paths")
    for deck in A8_A11_PATHS:
        phase_paths_a8_a11(incflo_torch, gk, mg, torch, deck)
        stamp(f"paths {deck}")
    main128, sim, s = phase_main(incflo_torch, gk, torch, 128, 20, 20)
    if profile:
        phase_profile(sim, s, torch, 128, main128["ms_per_step"])
    del sim, s
    main256, sim, s = phase_main(incflo_torch, gk, torch, 256, 2, 3)
    if profile:
        phase_profile(sim, s, torch, 256, main256["ms_per_step"])
    del sim, s
    main_vd = []
    for start in ("init_state", "perturbed_density"):
        r, sim, s = phase_main_vd(incflo_torch, gk, sk, mg, torch, start)
        if profile:
            phase_profile(sim, s, torch, f"128 shear3d_vd from {start}",
                          r["ms_per_step"])
        main_vd.append(r)
        del sim, s
    main_rt, sim, s = phase_main_rt(incflo_torch, gk, sk, mg, torch)
    if profile:
        phase_profile(sim, s, torch, "128 rt", main_rt["ms_per_step"])
        phase_rt_sections(sim, s, sk, torch)
    del sim, s
    main_a9c = {}
    for deck in A9C_DECKS:
        r, sim, s = phase_main_a9c(incflo_torch, gk, sk, s2, mg, torch,
                                   deck)
        if profile:
            r["profile"] = phase_profile(sim, s, torch, deck,
                                         r["ms_per_step"])
        main_a9c[deck] = r
        del sim, s
    stamp("main up to the A9c cells")
    main_a8 = {}
    for deck in A8_A11_MAIN:
        r, sim, s = phase_main_a8_a11(incflo_torch, gk, sk, s2, mg, torch,
                                      deck)
        main_a8[deck] = r
        stamp(f"main {deck}")
        if deck == "poiseuille_cyl_bingham":
            levels_eb = phase_levels_eb(sk, mg, torch, sim, s)
            stamp("levels_eb")
        del sim, s
    main_tgv = phase_main_tgv2d(incflo_torch, (gk, sk, s2), torch, profile,
                                s2res["ms_by_n"])
    stamp("main tgv2d")
    cli = phase_cli(incflo_torch, gk, sk, s2, torch)
    stamp("cli")
    amr_main, amr_levels, amr_cli = phase_amr(incflo_torch, gk, sk, s2, mg,
                                              torch, stamp)
    slab = phase_slab_smoothers(sk, mg, torch)
    stamp("slab smoothers")
    sharded = run_sharded({
        "sharded": phase_sharded_step(incflo_torch, gk, torch),
        "sharded_mg": phase_sharded_mg(incflo_torch, torch),
        "sharded_xwalls": phase_sharded_xwalls(incflo_torch, sk, mg, torch),
        "sharded_eb": phase_sharded_eb(incflo_torch, sk, mg, torch),
        "sharded_2d": phase_sharded_2d(incflo_torch, torch),
        "sharded_amr": phase_sharded_amr(incflo_torch, torch),
        "sharded_amr_eb": phase_sharded_amr_eb(incflo_torch, torch)}, stamp)
    shard, shard_mg, xwalls, ebslab, shard_2d, shard_amr, shard_amr_eb = (
        sharded[k] for k in ("sharded", "sharded_mg", "sharded_xwalls",
                             "sharded_eb", "sharded_2d", "sharded_amr",
                             "sharded_amr_eb"))

    # `launches` is the count over the kernel's own main path: shear3d
    # n = 128 for the Godunov kernels (their count in shear3d_vd beside
    # it), shear3d_vd from init_state for the periodic smoothers, rt for
    # the walled cell and nodal smoothers, the first fused tgv2d run at
    # 128^2 for the fused step, the sharded shear3d n = 128 run (rank 0;
    # every rank's beside it) for the halo-slab kernels
    def a9c_per_step(k):
        """Launches a step of kernel k on each A9c / 3D MOL deck's main
        run (the smoothers' over the timed steps)."""
        return {deck: r["per_step"][k] if k in r["per_step"]
                else r["launches"].get(k, 0) / (r["warmup"] + r["steps"])
                for deck, r in main_a9c.items()}

    def a8_per_step(k):
        """The same on the A8 / A11 main cells."""
        return {deck: r["per_step"][k] if k in r["per_step"]
                else r["launches"].get(k, 0) / (r["warmup"] + r["steps"])
                for deck, r in main_a8.items()}

    kernels = []
    for k in PER_STEP:
        r = kres[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "incflo_torch/csrc/godunov.cu",
            "replaces": gk.REPLACES[k],
            "launches": main128["launches"][k],
            "launches_per_step": PER_STEP[k],
            "launches_shear3d_vd": [m["launches"][k] for m in main_vd],
            "launches_per_step_a9c": a9c_per_step(k),
            "device_launches_per_call": r["device_launches"],
            "max_abs_err": r["max_abs_err"],
            "max_rel_err_f32": r["max_rel_err_f32"],
            "tol_f32": 0.0,
            "max_rel_err_f64": r["max_rel_err_f64"],
            "tol_f64": TOL_EXACT_F64,
            "shape": "shear3d 128x128x32, float32",
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "no_fma_bound_ms": r["no_fma_bound_ms"],
            "bytes": r["bytes"], "ops": r["ops"], "library_ms": None,
            "at_256": r["at_256"]})
    for k in SMOOTHERS:
        r = sres[k]
        fine = r["128x128x32"]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "incflo_torch/csrc/smoothers.cu",
            "replaces": sk.REPLACES[k],
            "also_replaces": sk.ALSO_REPLACES[k],
            "launches": main_vd[0]["launches"][k],
            **launch_keys(levels, k),
            "launches_per_step": main_vd[0]["per_step"][k],
            "launches_shear3d_vd": [m["launches"][k] for m in main_vd],
            "launches_per_step_a9c": a9c_per_step(k),
            "max_abs_err": r["max_abs_err"],
            "max_err_x_f32": r["max_err_x_f32"], "tol_x_f32": TOL_SMOOTH_X,
            "max_err_res_f32": r["max_err_res_f32"],
            "tol_res_f32": TOL_SMOOTH_RES,
            "max_rel_err_f64": r["max_rel_err_f64"],
            "tol_f64": TOL_SMOOTH_F64,
            "shape": "128x128x32, 2 sweeps + residual, float32",
            "ms": fine["ms"], "plain_ms": fine["plain_ms"],
            "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
            "bytes": fine["bytes"], "ops": fine["ops"], "library_ms": None,
            "at_64x64x16": r["64x64x16"]})
    fine = wres["64x64x128"]
    kernels.append({
        "name": WALLED, "route": "cuda",
        "source": "incflo_torch/csrc/smoothers.cu",
        "replaces": sk.REPLACES[WALLED],
        "launches": main_rt["launches"][WALLED],
        "launches_per_step": main_rt["per_step"][WALLED],
        "launches_per_step_a9c": a9c_per_step(WALLED),
        **launch_keys(levels, WALLED),
        "max_abs_err": wres["max_abs_err"],
        "max_err_x_f32": wres["max_err_x_f32"], "tol_x_f32": TOL_SMOOTH_X,
        "max_err_res_f32": wres["max_err_res_f32"],
        "tol_res_f32": TOL_SMOOTH_RES,
        "max_rel_err_f64": wres["max_rel_err_f64"],
        "tol_f64": TOL_WALLED_F64,
        "shape": "64x64x128, periodic x and y, Neumann z, 2 sweeps + "
                 "residual, float32",
        "ms": fine["ms"], "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
        "bytes": fine["bytes"], "ops": fine["ops"], "library_ms": None,
        "at_8x8x16": wres["8x8x16"]})
    fine = wnres["64x64x129"]
    kernels.append({
        "name": WALLED_NODAL, "route": "cuda",
        "source": "incflo_torch/csrc/smoothers.cu",
        "replaces": sk.REPLACES[WALLED_NODAL] + " (jnp; no Pallas body)",
        "launches": main_rt["launches"][WALLED_NODAL],
        "launches_per_step": main_rt["per_step"][WALLED_NODAL],
        "launches_per_step_a9c": a9c_per_step(WALLED_NODAL),
        **launch_keys(levels, WALLED_NODAL),
        "max_abs_err": wnres["max_abs_err"],
        "max_err_x_f32": wnres["max_err_x_f32"], "tol_x_f32": TOL_SMOOTH_X,
        "max_err_res_f32": wnres["max_err_res_f32"],
        "tol_res_f32": TOL_SMOOTH_RES,
        "max_rel_err_f64": wnres["max_rel_err_f64"],
        "tol_f64": TOL_SMOOTH_F64,
        "shape": "64x64x129 nodes, periodic x and y, Neumann z, 2 sweeps + "
                 "residual, float32",
        "ms": fine["ms"], "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
        "bytes": fine["bytes"], "ops": fine["ops"], "library_ms": None,
        "at_8x8x17": wnres["8x8x17"]})
    for k in HALO_KERNELS:
        r = hres[k]
        t = r["nxl64"]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "incflo_torch/csrc/godunov.cu",
            "replaces": gk.REPLACES[k] + " (per shard, with _halo_x :502)",
            "launches": shard["launches_per_rank"][0][k],
            "launches_per_rank": [c[k] for c in shard["launches_per_rank"]],
            "launches_per_step": PER_STEP_HALO[k],
            "launches_per_step_a9c": a9c_per_step(k),
            "launches_mac_phi": [c[k] for c in shard_2d["cells"][
                "shear3d_mac_phi"][
                "godunov_launches_per_rank"]],
            "device_launches_per_call": t["device_launches"],
            "max_abs_err": r["max_abs_err"], "tol_f32": 0.0,
            "max_rel_err_f64": r["max_rel_err_f64"], "tol_f64": 1e-14,
            "outputs_checked": r["checked"],
            "shape": "shear3d 128x128x32 in 2 slabs (nxl 64, + 4 halo rows "
                     "a side), float32",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bytes": t["bytes"], "ops": t["ops"], "library_ms": None,
            "at_nxl32": r["nxl32"]})
    for k in SLAB_FAMILIES:
        r = slab[k]
        fine = r["levels"][0]
        extra_forms = [f for f in (slab, xwalls["slab_forms"],
                                   ebslab["slab_forms"]) if k in f]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "incflo_torch/csrc/smoothers.cu",
            "replaces": sk.REPLACES[k] + " (under a mesh incflo_tpu sweeps "
                        "in jnp, GSPMD deriving the halos)",
            "launches": shard_mg["rt"]["launches_per_rank"][0][k],
            "launches_per_rank": [c[k] for c in
                                  shard_mg["rt"]["launches_per_rank"]],
            "launches_per_step": shard_mg["rt"][
                "smoother_launches_per_step"][0][k],
            "launches_per_step_shear3d_vd": shard_mg["shear3d_vd"][
                "smoother_launches_per_step"][0][k],
            "launches_xwalls": {
                cell: [c[k] for c in x["launches_per_rank"]]
                for cell, x in xwalls["cells"].items()},
            "launches_per_step_xwalls": {
                cell: [p[k] for p in x["smoother_launches_per_step"]]
                for cell, x in xwalls["cells"].items()},
            "xwalls_forms": xwalls["slab_forms"][k],
            "launches_eb": {
                cell: [c[k] for c in x["launches_per_rank"]]
                for cell, x in ebslab["cells"].items()},
            "launches_per_step_eb": {
                cell: [p[k] for p in x["smoother_launches_per_step"]]
                for cell, x in ebslab["cells"].items()},
            "eb_forms": ebslab["slab_forms"].get(k),
            "launches_per_step_a9c": a9c_per_step(k),
            "device_launches_per_call": max(
                v["device_launches"] for f in extra_forms for v in f[k][
                    "levels"]),
            "max_abs_err": max(f[k]["max_abs_err"] for f in extra_forms),
            "tol_f32": 0.0,
            "outputs_checked": sum(f[k]["checked"] for f in extra_forms),
            "shape": f"rt {fine['shape']} in 2 slabs (nxl {fine['nxl']}), "
                     f"{fine['call']}, float32",
            "ms": fine["ms"], "plain_ms": fine["plain_ms"],
            "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
            "bytes": fine["bytes"], "ops": fine["ops"], "library_ms": None,
            "levels": r["levels"]})
    tgv_main = main_tgv[0]
    kernels.append({
        "name": "step2d", "route": "cuda",
        "source": "incflo_torch/csrc/step2d.cu",
        "replaces": s2.REPLACES["step2d"],
        "launches": tgv_main["launches"]["step2d"],
        "launches_per_step": tgv_main["launches_per_step"],
        "launches_per_step_a9c": a9c_per_step("step2d"),
        "max_abs_err": s2res["max_abs_err"],
        "max_err_f32": s2res["max_err_f32"],
        "tol_f32": "rtol 1e-4, atol 1e-5 of each field's max "
                   "(max_err_f32 <= 1), elementwise but gp; against "
                   "float64 step_plain at most 2x step_plain's error + 4 "
                   "ulps",
        "max_elementwise_err_f32_but_gp":
            s2res["max_elementwise_err_f32"],
        "max_rel_err_f64": s2res["max_rel_err_f64"],
        "tol_f64": TOL_STEP2D_F64,
        "worst_cg_res_over_tol": s2res["worst_cg_res_over_tol"],
        "shape": "tgv2d 128x128, one step from init_state, float32",
        "ms": s2res["ms"], "plain_ms": s2res["plain_ms"],
        "timing": "CUDA-graph replay, median of 25, calls per graph "
                  "to last ~1 ms",
        "ms_256": s2res["ms_by_n"][256],
        "plain_ms_256": s2res["plain_ms_by_n"][256],
        "bound_ms_256": s2res["bound_ms_256"],
        "by_shape": s2res["by_n"],
        "bound_ms": s2res["bound_ms"], "bound_by": s2res["bound_by"],
        "bytes": s2res["bytes"], "ops": s2res["ops"], "library_ms": None,
        "device_launches_per_call": s2res["device_launches"],
        "barriers_per_step": s2res["barriers_per_step"],
        "cg_trips": [s2res["trips_pred"], s2res["trips_corr"]],
        "grid_blocks": s2res["grid_blocks"],
        "max_blocks": s2res["max_blocks"],
        "at_128_and_256": s2res["at"]})
    for entry in kernels:
        entry["launches_per_step_a8_a11"] = a8_per_step(entry["name"])
        entry["launches_per_step_amr"] = {
            cell: {lev: t.get(entry["name"], 0.0) for lev, t in
                   r["launches_per_step_per_level"].items()}
            for cell, r in amr_main.items()}
        entry["launches_cli"] = {r["run"]: r["launches"].get(entry["name"], 0)
                                 for r in cli}
        entry["launches_per_step_sharded_amr"] = {
            cell: [{lev: t.get(entry["name"], 0.0) for lev, t in p.items()}
                   for p in r["launches_per_step_per_rank"]]
            for cell, r in list(shard_amr["cells"].items())
            + [("channel_cyl_amr", shard_amr_eb["cells"]["channel_cyl_amr"])]}
    print(json.dumps({"kernels": kernels, "levels": levels,
                      "levels_eb": levels_eb, "build_s": build_s,
                      "main": [main128, main256] + main_vd + [main_rt]
                      + main_tgv + list(main_a9c.values())
                      + list(main_a8.values()),
                      "sharded": shard, "sharded_mg": shard_mg,
                      "sharded_xwalls": xwalls["cells"],
                      "sharded_eb": ebslab["cells"],
                      "sharded_2d": shard_2d,
                      "sharded_amr": shard_amr,
                      "sharded_amr_eb": shard_amr_eb,
                      "cli": cli,
                      "amr": {"main": list(amr_main.values()),
                              "levels": amr_levels, "cli": amr_cli},
                      "seconds": time.time() - t_start}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
