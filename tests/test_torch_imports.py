"""incflo_torch stands alone: it imports neither JAX nor incflo_tpu, it
runs on the card unless the CPU is asked for, and it builds every deck
it once refused naming a ROADMAP item (AMR with embedded boundaries,
A13b; a level that does not split over a mesh, A14)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import bench
import incflo_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "incflo_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports_in_source():
    files = sorted((ROOT / "incflo_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 24
    for name in ("smoother_kernels.py", "godunov_walls.py", "mol.py",
                 "step2d_kernels.py", "mesh.py", "launch.py", "workers.py",
                 "derive.py", "diagnostics.py", "io.py", "main.py"):
        assert any(p.name == name for p in files), name
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_import_leaves_no_jax_in_modules():
    code = ("import sys, incflo_torch, incflo_torch.simulation, "
            "incflo_torch.ops.godunov_kernels, "
            "incflo_torch.ops.smoother_kernels, "
            "incflo_torch.ops.godunov_walls, "
            "incflo_torch.ops.mol, incflo_torch.ops.step2d_kernels, "
            "incflo_torch.ops.cuda_build, incflo_torch.parallel.mesh, "
            "incflo_torch.parallel.launch, incflo_torch.parallel.workers, "
            "incflo_torch.ops.derive, incflo_torch.utils.diagnostics, "
            "incflo_torch.utils.io, incflo_torch.main\n"
            "bad = [m for m in sys.modules if any(m == f or "
            "m.startswith(f + '.') for f in ('jax', 'jaxlib', "
            "'incflo_tpu'))]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_matmul_precision_is_full_f32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _cfg(extra="", config="shear3d"):
    text, _ = bench._deck(config, 16, "float64")
    return incflo_torch.IncfloConfig.from_text(text + extra)


def test_simulation_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        incflo_torch.Simulation(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        incflo_torch.Simulation(_cfg(), device="cuda")
    sim = incflo_torch.Simulation(_cfg(), device="cpu")
    assert sim.device.type == "cpu"


class _KernelReached(Exception):
    pass


def test_kernel_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """Only a CPU tensor gets the plain version.  Any other tensor (here
    one on the meta device) goes for the kernel library, stubbed to raise,
    and outside the kernels' scope the wrapper raises before that."""
    from incflo_torch.grid import Grid
    from incflo_torch.ops import godunov_kernels as gk

    def no_library():
        raise _KernelReached
    monkeypatch.setattr(gk, "_lib", no_library)
    n = (8, 4, 6)
    grid = Grid(n_cell=n, prob_lo=(0.0,) * 3, prob_hi=(1.0, 0.5, 0.75),
                periodic=(True,) * 3)
    vel = torch.zeros(n + (3,), dtype=torch.float32, device="meta")
    umac = [torch.zeros(tuple(m + (a == d) for a, m in enumerate(n)),
                        dtype=torch.float32, device="meta") for d in range(3)]
    before = dict(gk.LAUNCHES)
    with pytest.raises(_KernelReached):
        gk.predict(grid, vel, None, 0.01, True)
    with pytest.raises(_KernelReached):
        gk.advect(grid, vel, umac, vel, 0.01, (0, 0, 0), True)
    walled = Grid(n_cell=n, prob_lo=(0.0,) * 3, prob_hi=(1.0, 0.5, 0.75),
                  periodic=(True, False, True))
    with pytest.raises(NotImplementedError):
        gk.predict(walled, vel, None, 0.01, True)
    with pytest.raises(NotImplementedError):
        gk.advect(grid, vel, umac, None, 0.01, (0, 0, 0), True,
                  use_forces_in_trans=True)
    with pytest.raises(TypeError):
        gk.uad(grid, vel.half(), 0.01, True)
    assert gk.LAUNCHES == before


# decks that ran only after the A8 and A11 slice (2D Godunov, 2D walls,
# 2D multigrid, use_forces_in_trans, use_mac_phi_in_godunov, embedded
# boundaries)
SLICE_DECKS = [
    ("tgv2d", "incflo.use_godunov = true\n"),
    ("tgv2d", 'geometry.is_periodic = 1 0\nylo.type = "nsw"\n'
     'yhi.type = "nsw"\n'),
    ("tgv2d", "incflo.constant_density = false\n"),
    ("tgv2d", "incflo.advect_tracer = true\n"),
    ("tgv2d", "incflo.fluid_model = powerlaw\nincflo.n = 0.5\n"),
    ("shear3d", "incflo.godunov_use_forces_in_trans = true\n"),
    ("poiseuille_cyl_bingham", ""),
    ("rt", ""),
    ("channel_cyl", ""),
    ("tgv2d", "incflo.probtype = 111\nincflo.advect_tracer = true\n"),
    ("shear3d", "incflo.use_mac_phi_in_godunov = true\n"),
    ("shear3d", ""),
]


# and decks whose initial tags localize: a band, and a blob (slab too at
# 16^2: its box, padded by a block a side, would cover over half the
# domain)
TAGGED_DECKS = [
    ("rt", "incflo.gradrhoerr = 0.1\n"),
    ("tgv2d", "incflo.tag_region = true\nincflo.tag_region_lo = 0.3 0.\n"
     "incflo.tag_region_hi = 0.45 1.\n"),
    ("tgv2d", "incflo.tag_region = true\nincflo.tag_region_lo = 0.3 0.3\n"
     "incflo.tag_region_hi = 0.45 0.45\n"),
]


@pytest.mark.parametrize("config,extra", SLICE_DECKS + TAGGED_DECKS)
def test_amr_decks_take_incflo_tpus_patch_mode(config, extra):
    """The same decks with amr.max_level = 1 resolve to the patch mode
    incflo_tpu's choose_patch_mode picks and build that driver on the
    CPU: the patch tree (slab or box) or the dense fine level; an EB
    deck, which once raised naming ROADMAP A13b, builds both, each level
    with its cut cells."""
    from incflo_tpu import amr_patch as jap
    from incflo_tpu.config import IncfloConfig as JConfig
    from incflo_torch import amr, amr_patch
    text = bench._deck(config, 16, "float64")[0] + extra \
        + "amr.max_level = 1\n"
    cfg = incflo_torch.IncfloConfig.from_text(text)
    mode = amr_patch.choose_patch_mode(cfg)
    assert mode == jap.choose_patch_mode(JConfig.from_text(text))
    if config in ("channel_cyl", "poiseuille_cyl_bingham"):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            tree = amr_patch.SlabAMRSimulation(cfg, device="cpu")
            dense = amr.AMRSimulation(cfg, device="cpu")
        assert tree.sim0.eb is not None and dense.sim.eb is not None
        assert dense.sim.grid.n_cell == tuple(2 * n
                                              for n in cfg.grid.n_cell)
    elif mode in ("slab", "box"):
        import jax.numpy as jnp
        from incflo_tpu import probs as jprobs
        jcfg = JConfig.from_text(text)
        rho = jprobs.init_fluid(jcfg, jcfg.grid, jnp.float64).density
        axis = jap.SlabAMRSimulation._best_axis(
            None, jap.compute_tags(jcfg, np.asarray(rho), jcfg.grid))
        drv = amr_patch.SlabAMRSimulation(cfg, device="cpu")
        assert drv.sim0.grid == cfg.grid and len(drv.sims) == 1
        assert drv.axis == axis
    else:
        drv = amr.AMRSimulation(cfg, device="cpu")
        assert drv.sim.grid.n_cell == tuple(2 * n for n in cfg.grid.n_cell)
    if (config, extra) in TAGGED_DECKS:
        assert mode == "slab"


def test_amr_under_a_mesh_names_a14(tmp_path, monkeypatch):
    """A deck whose base nx does not split into equal slabs over a
    mesh's ranks (16 cells on 3), which once raised naming ROADMAP A14,
    runs with that level held whole on every rank: Simulation drops the
    mesh and steps bit-equal to one device, both AMR drivers build it
    whole (parallel/mesh.py, tests/test_torch_sharded_amr_eb.py), and
    the CLI driver runs it."""
    from incflo_torch import amr, amr_patch, main
    from incflo_torch.parallel.mesh import SlabMesh
    mesh = SlabMesh.__new__(SlabMesh)
    mesh.device, mesh.rank, mesh.size = torch.device("cpu"), 0, 3
    extra = "amr.max_level = 1\n"
    sim = incflo_torch.Simulation(_cfg(extra), device="cpu", mesh=mesh)
    assert sim.mesh is None and sim.grid == _cfg(extra).grid
    one = incflo_torch.Simulation(_cfg(extra), device="cpu")
    a, b = sim.advance(sim.init_state()), one.advance(one.init_state())
    for f in ("velocity", "p", "gp", "mac_phi"):
        assert torch.equal(getattr(a.level, f), getattr(b.level, f)), f
    tree = amr_patch.SlabAMRSimulation(_cfg(extra), device="cpu", mesh=mesh)
    assert tree.mesh is mesh and tree.sim0.mesh is None
    dense = amr.AMRSimulation(_cfg(extra), device="cpu", mesh=mesh)
    assert dense.mesh is mesh and dense.sim.mesh is None
    deck = tmp_path / "inputs"
    deck.write_text(bench._deck("shear3d", 16, "float64")[0] + extra)
    monkeypatch.chdir(tmp_path)
    assert main.run([str(deck), "max_step=1"], mesh=mesh) == 0


@pytest.mark.parametrize("config,extra", SLICE_DECKS)
def test_decks_of_the_a8_a11_slice_build(config, extra):
    """The one-level form of each deck builds on the CPU, and a deck with
    a cylinder finds its cut cells and advects by MOL."""
    sim = incflo_torch.Simulation(_cfg(extra, config), device="cpu")
    has_cylinder = config in ("channel_cyl", "poiseuille_cyl_bingham")
    assert (sim.eb is not None) == has_cylinder
    if has_cylinder:
        assert not sim.cfg.use_godunov and float(sim.eb.cut.sum()) > 0


def test_eb_deck_asking_for_godunov_takes_mol_eb():
    """incflo_tpu/simulation.py:49-66: the Godunov scheme does not see
    cut cells, so an EB deck that asks for it advects by MOL-EB, warns,
    and keeps its CFL at the MOL bound."""
    extra = "incflo.use_godunov = true\nincflo.cfl = 0.9\n"
    with pytest.warns(UserWarning, match="MOL-EB"):
        sim = incflo_torch.Simulation(_cfg(extra, "channel_cyl"),
                                      device="cpu")
    assert not sim.cfg.use_godunov and sim.cfg.cfl == 0.5
    assert not hasattr(sim, "godunov")


def test_tgv2d_deck_is_accepted():
    """The 2D periodic MOL deck with implicit diffusion builds its three
    direct solvers; on the CPU it never takes the fused step kernel."""
    sim = incflo_torch.Simulation(_cfg("", "tgv2d"), device="cpu")
    assert sim.grid.ndim == 2 and not sim.cfg.use_godunov
    for solver in (sim._mac_solver, sim._diff_proto, sim._nodal_hat):
        assert solver.symbol is not None and solver.symbol.fwd is not None
    assert sim._fused_step(sim.init_state()) is None


def test_variable_density_periodic_deck_is_accepted():
    """Fully periodic 3D decks run with variable density and tracers,
    with no prebuilt direct solvers; so does the rt deck of the same
    physics between slip walls, and a constant-density deck between
    slip walls prebuilds the projections but no batched velocity solver
    (its components have different BCs)."""
    vd = ("incflo.constant_density = false\nincflo.advect_tracer = true\n"
          "incflo.mu_s = 0.0002\n")
    sim = incflo_torch.Simulation(_cfg(vd), device="cpu")
    assert sim._mac_solver is None and sim._diff_proto is None
    sim = incflo_torch.Simulation(_cfg("", "rt"), device="cpu")
    assert sim._mac_solver is None and sim._diff_proto is None
    assert sim.grid.periodic == (True, True, False)
    slip = 'geometry.is_periodic = 1 1 0\nzlo.type = "sw"\nzhi.type = "sw"\n'
    sim = incflo_torch.Simulation(_cfg(slip), device="cpu")
    assert sim._mac_solver is not None and sim._nodal_hat is not None
    assert sim._diff_proto is None
