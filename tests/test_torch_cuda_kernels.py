"""The CUDA kernels (incflo_torch/csrc/godunov.cu, csrc/smoothers.cu,
csrc/step2d.cu) against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; they skip where
torch.cuda.is_available() is false.  Run them on a GPU host with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
(--noconftest because tests/conftest.py imports JAX, which a GPU host
need not have).

Tolerances: the Godunov kernels repeat the plain version's operations
with no FMA contraction, in the same order, so they are held bit-equal
to it in float32 and within 1e-14 of the field's max in float64, at
ragged and short-axis shapes that cut the fused kernels' 8 x 32 tiles
(uad and uad_halo on their own too).  The smoothers: float64
1e-12 relative; float32 2e-6 absolute on x and 5e-4 on the residual for
O(1) fields on a unit-spaced level scale (the limits of
tests/test_pallas_kernels.py).  The walled cell smoother is held to the
same limits on every level of a CellSolver hierarchy with Neumann and
Dirichlet sides.  Since the smoothers became one launch a call, they are
also held to bit-equality with their plain versions in float32 and to
1e-13 relative in float64, in both regimes (the wrappers' `_regime`
forced to resident and to grid), on either side of the resident size,
walled nodal levels included; and a call captured in a CUDA graph is one
kernel node.  The fused step kernel: float64 1e-9 relative to each
field's max, float32 within rtol 1e-4 / atol 1e-5 (the bounds of
tests/test_pallas_step2d.py): its transforms and dots sum in another
order than cuBLAS and torch.sum, so the tensor CG may stop a trip apart
from step_plain, within the solve's tolerance.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import bench
import incflo_torch

from incflo_torch.grid import Grid
from incflo_torch.ops import cuda_build
from incflo_torch.ops import godunov_kernels as gk
from incflo_torch.ops import multigrid as mg
from incflo_torch.ops import smoother_kernels as sk
from incflo_torch.ops import step2d_kernels as s2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build_all([gk.SOURCE, sk.SOURCE, s2.SOURCE])
    return torch.device("cuda")


def _grid(n=(16, 8, 12)):
    return Grid(n_cell=n, prob_lo=(0.0,) * 3, prob_hi=(1.0, 0.5, 0.75),
                periodic=(True,) * 3)


def _fields(grid, ncomp, seed, dtype, device):
    rng = np.random.default_rng(seed)
    xs = [np.linspace(0, 2 * np.pi, n, endpoint=False) for n in grid.n_cell]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    out = []
    for c in range(ncomp):
        a, b, d = rng.normal(size=3)
        out.append(a * np.sin(X + c) + b * np.cos(2 * Y - c)
                   + d * np.sin(Z + 0.3 * c)
                   + 0.1 * rng.standard_normal(X.shape))
    return torch.as_tensor(np.stack(out, -1), dtype=dtype, device=device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# ragged and short axes: no axis a multiple of the 8 x 32 tile, axes
# shorter than a tile and its halo (5 x 3 x 2), an odd periodic x
GODUNOV_SHAPES = [(16, 8, 12), (24, 9, 7), (33, 8, 16), (5, 3, 2)]


def _same_bits(got, ref, dtype):
    """float32 bit for bit; float64 within 1e-14 of the field's max."""
    assert got.shape == ref.shape
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    else:
        assert _rel(got, ref) <= 1e-14


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GODUNOV_SHAPES)
@pytest.mark.parametrize("use_ppm", [True, False])
@pytest.mark.parametrize("with_forces", [True, False])
def test_predict_kernel_matches_plain(cuda, dtype, shape, use_ppm,
                                      with_forces):
    grid = _grid(shape)
    vel = _fields(grid, 3, 1, dtype, cuda)
    forces = 0.3 * _fields(grid, 3, 2, dtype, cuda) if with_forces else None
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    n0 = dict(gk.LAUNCHES)
    got = gk.predict(grid, vel, forces, dt, use_ppm)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["uad"] == n0["uad"] + 1
    assert gk.LAUNCHES["predict_d"] == n0["predict_d"] + 3
    ref = gk.predict_plain(grid, vel, forces, dt, use_ppm)
    for d in range(3):
        _same_bits(got[d], ref[d], dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GODUNOV_SHAPES)
@pytest.mark.parametrize("use_ppm", [True, False])
def test_uad_kernel_matches_plain(cuda, dtype, shape, use_ppm):
    """uad, a fused x-march on the 8 x 32 tiles: each face bit-equal."""
    grid = _grid(shape)
    vel = _fields(grid, 3, 6, dtype, cuda)
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    n0 = gk.LAUNCHES["uad"]
    got = gk.uad(grid, vel, dt, use_ppm)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["uad"] == n0 + 1
    for a, b in zip(got, gk.uad_plain(grid, vel, dt, use_ppm)):
        _same_bits(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GODUNOV_SHAPES)
@pytest.mark.parametrize("use_ppm", [True, False])
@pytest.mark.parametrize("iconserv", [0, 1])
@pytest.mark.parametrize("ncomp", [1, 3, 5])
@pytest.mark.parametrize("with_forces", [True, False])
def test_advect_kernel_matches_plain(cuda, dtype, shape, use_ppm, iconserv,
                                     ncomp, with_forces):
    grid = _grid(shape)
    q = _fields(grid, ncomp, 3, dtype, cuda)
    forces = (0.2 * _fields(grid, ncomp, 4, dtype, cuda) if with_forces
              else None)
    vel = _fields(grid, 3, 5, dtype, cuda)
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    umac = gk.predict_plain(grid, vel, None, dt, use_ppm)
    n0 = gk.LAUNCHES["advect"]
    # one launch per component, each writing its strided slice of `out`
    got = gk.advect(grid, q, umac, forces, dt, (iconserv,) * ncomp, use_ppm)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["advect"] == n0 + ncomp
    ref = gk.advect_plain(grid, q, umac, forces, dt, (iconserv,) * ncomp,
                          use_ppm)
    _same_bits(got, ref, dtype)


def test_kernels_raise_outside_scope(cuda):
    walled = Grid(n_cell=(8, 8, 8), prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3,
                  periodic=(True, True, False))
    vel = torch.zeros((8, 8, 8, 3), device=cuda)
    with pytest.raises(NotImplementedError):
        gk.predict(walled, vel, None, 0.01, True)
    with pytest.raises(NotImplementedError):
        gk.predict(_grid((8, 8, 8)), vel, None, 0.01, True,
                   use_forces_in_trans=True)
    with pytest.raises(TypeError):
        gk.uad(_grid((8, 8, 8)), vel.half(), 0.01, True)


# (8, 4, 2): two cells along z; (9, 5, 7): odd sizes, ragged last block;
# (33, 8, 16): an odd periodic axis whose wrap spans thread blocks
SMOOTH_SHAPES = [(16, 8, 16), (32, 8, 16), (8, 4, 2), (9, 5, 7), (33, 8, 16)]


def _smooth_check(got, ref, dtype):
    for (a, b), atol in zip(zip(got, ref), (2e-6, 5e-4)):
        if dtype == torch.float64:
            assert _rel(a, b) <= 1e-12
        else:
            assert float((a - b).abs().max()) <= atol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
@pytest.mark.parametrize("ncomp", [0, 3])
@pytest.mark.parametrize("nsweeps", [0, 2, 8])
def test_cell_smooth_kernel_matches_plain(cuda, dtype, shape, ncomp,
                                          nsweeps):
    rng = np.random.default_rng(6)
    full = shape + ((ncomp,) if ncomp else ())
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    F = [t(0.5 + rng.random(full)) for _ in range(3)]
    diag = t(1.0 + rng.random(full)) + sum(
        f + torch.roll(f, 1, dims=ax) for ax, f in enumerate(F))
    dinv = sk.guarded_reciprocal(diag)
    x, b = t(rng.standard_normal(full)), t(rng.standard_normal(full))
    x_in = x.clone()
    n0 = sk.LAUNCHES["cell_smooth"]
    got = sk.cell_smooth(x, b, diag, dinv, F, nsweeps, True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["cell_smooth"] == n0 + 1
    assert torch.equal(x, x_in)          # the input is not smoothed in place
    _smooth_check(got, sk.cell_smooth_plain(x, b, diag, dinv, F, nsweeps,
                                            True), dtype)
    only_x, none = sk.cell_smooth(x, b, diag, dinv, F, nsweeps, False)
    assert none is None and torch.equal(only_x, got[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
@pytest.mark.parametrize("nsweeps", [0, 2, 24])
def test_nodal_smooth_kernel_matches_plain(cuda, dtype, shape, nsweeps):
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    sigma = t(0.6 + 0.8 * rng.random(shape))
    dx = (1.0, 0.5, 0.25)
    box = sigma
    for ax in range(3):
        box = box + torch.roll(box, 1, dims=ax)
    w0 = -sum(1.0 / d ** 2 for d in dx) / 9.0
    dinv = sk.guarded_reciprocal(w0 * box)
    x, b = t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    n0 = sk.LAUNCHES["nodal_smooth"]
    got = sk.nodal_smooth(x, b, sigma, dinv, dx, nsweeps, True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["nodal_smooth"] == n0 + 1
    _smooth_check(got, sk.nodal_smooth_plain(x, b, sigma, dinv, dx, nsweeps,
                                             True), dtype)
    only_x, none = sk.nodal_smooth(x, b, sigma, dinv, dx, nsweeps, False)
    assert none is None and torch.equal(only_x, got[0])


# (lo, hi) BC codes per axis: 0 periodic, 1 Neumann, 2 Dirichlet
P, N, D = 0, 1, 2
WALL_BCS = {
    "pallas_pdn": ((P, D, N), (P, D, N)),
    "pallas_pnp": ((P, N, P), (P, N, P)),
    "rt_scalar": ((P, P, N), (P, P, N)),
    "rt_normal_velocity": ((P, P, D), (P, P, D)),
    "walled_x": ((D, N, P), (D, N, P)),
    "all_dirichlet": ((D, D, D), (D, D, D)),
    "mixed_sides": ((N, D, N), (D, N, D)),
}


def _walled_solver(shape, bc, ncomp, dtype, device, seed=8):
    """A Helmholtz CellSolver with random coefficients and the given
    BCs; its levels, diags and smoother_coefs are what a V-cycle hands
    the kernel.  Sizes with an odd or 2-cell axis have one level."""
    rng = np.random.default_rng(seed)
    tail = (ncomp,) if ncomp else ()
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    bcoef = []
    for ax in range(3):
        fs = tuple(n + (1 if a == ax else 0) for a, n in enumerate(shape))
        b = t(0.5 + rng.random(fs + tail))
        if bc[0][ax] == P:      # the periodic face n is face 0
            b = torch.cat([b.narrow(ax, 0, shape[ax]), b.narrow(ax, 0, 1)],
                          dim=ax)
        bcoef.append(b)
    acoef = t(1.0 + rng.random(shape + tail))
    return mg.CellSolver((1.0, 0.5, 0.25), bc[0], bc[1], alpha=1.0, beta=0.3,
                         acoef=acoef, bcoef=tuple(bcoef), direct=False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(16, 8, 16), (8, 4, 2), (9, 5, 7)])
@pytest.mark.parametrize("ncomp", [0, 3])
@pytest.mark.parametrize("nsweeps", [0, 2, 8])
@pytest.mark.parametrize("bcname", sorted(WALL_BCS))
def test_walled_cell_smooth_kernel_matches_plain(cuda, dtype, shape, ncomp,
                                                 nsweeps, bcname):
    bc = WALL_BCS[bcname]
    solver = _walled_solver(shape, bc, ncomp, dtype, cuda)
    dinvs, fhis, fwalls = solver.smoother_coefs()
    rng = np.random.default_rng(9)
    for li, diag in enumerate(solver.diags):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
        x = t(rng.standard_normal(tuple(diag.shape)))
        b = t(rng.standard_normal(tuple(diag.shape)))
        args = (x, b, diag, dinvs[li], fhis[li], nsweeps)
        kw = dict(bc=bc, Fwall=fwalls[li])
        n0 = dict(sk.LAUNCHES)
        got = sk.cell_smooth(*args, True, **kw)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["cell_smooth_walled"] == n0["cell_smooth_walled"] + 1
        assert sk.LAUNCHES["cell_smooth"] == n0["cell_smooth"]
        _smooth_check(got, sk.cell_smooth_plain(*args, True, **kw), dtype)
        only_x, none = sk.cell_smooth(*args, False, **kw)
        assert none is None and torch.equal(only_x, got[0])


def test_walled_cell_smooth_two_cell_dirichlet_axis(cuda):
    """Dirichlet on both sides of a 2-cell axis: each cell is the other's
    opposite neighbour, and both walls add their third to the one
    coupling between them."""
    bc = ((P, P, D), (P, P, D))
    solver = _walled_solver((4, 4, 2), bc, 0, torch.float64, cuda)
    dinvs, fhis, fwalls = solver.smoother_coefs()
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((4, 4, 2)), device=cuda)
    b = torch.as_tensor(rng.standard_normal((4, 4, 2)), device=cuda)
    args = (x, b, solver.diags[0], dinvs[0], fhis[0], 4, True)
    kw = dict(bc=bc, Fwall=fwalls[0])
    got = sk.cell_smooth(*args, **kw)
    ref = sk.cell_smooth_plain(*args, **kw)
    assert _rel(got[0], ref[0]) <= 1e-13 and _rel(got[1], ref[1]) <= 1e-13
    # and both equal the flux form of the operator
    r = b - mg.cell_apply(got[0], solver.levels[0])
    assert _rel(got[1], r) <= 1e-12


def test_walled_solves_match_cpu(cuda):
    """A walled CellSolver and NodalSolver on the card against the CPU:
    same iterations, solutions to 1e-12."""
    bc = WALL_BCS["rt_scalar"]
    cpu = _walled_solver((16, 16, 32), bc, 0, torch.float64, "cpu")
    rng = np.random.default_rng(11)
    rhs = torch.as_tensor(rng.standard_normal((16, 16, 32)))
    xc, _, itc = cpu.solve_info(rhs)
    xg, _, itg = cpu.to(cuda).solve_info(rhs.to(cuda))
    assert itc == itg > 1 and _rel(xg.cpu(), xc) <= 1e-12
    sigma = torch.as_tensor(0.5 + rng.random((16, 16, 32)))
    nod = mg.NodalSolver((1.0, 0.5, 0.25), (True, True, False), bc[0],
                         bc[1], sigma, direct=False)
    nrhs = torch.as_tensor(rng.standard_normal((16, 16, 33)))
    xc, _, itc = nod.solve_info(nrhs)
    xg, _, itg = nod.to(cuda).solve_info(nrhs.to(cuda))
    assert itc == itg > 1 and _rel(xg.cpu(), xc) <= 1e-12


def test_smoothers_raise_outside_scope(cuda):
    m = torch.zeros((8, 4, 6), device=cuda)
    with pytest.raises(NotImplementedError):
        sk.nodal_smooth(m[0], m[0], m[0], m[0], (1.0, 1.0, 1.0), 2, True)
    with pytest.raises(TypeError):
        sk.cell_smooth(m.half(), m.half(), m.half(), m.half(),
                       (m.half(),) * 3, 2, True)
    with pytest.raises(ValueError):
        sk.cell_smooth(m, m, m, m.cpu(), (m, m, m), 2, True)
    with pytest.raises(ValueError):     # walled axis without its wall plane
        sk.cell_smooth(m, m, m, m, (m, m, m), 2, True,
                       bc=((P, P, N), (P, P, N)))
    with pytest.raises(ValueError):     # periodic on one side only
        sk.cell_smooth(m, m, m, m, (m, m, m), 2, True,
                       bc=((P, P, N), (P, P, P)), Fwall=(None, None, m[..., :1]))
    n0 = dict(sk.LAUNCHES)
    with pytest.raises(ValueError):     # a walled nodal axis of one cell
        sk.nodal_smooth(m[..., :2], m[..., :2], m[..., :1], m[..., :2],
                        (1.0, 1.0, 1.0), 2, True, bc=((P, P, N), (P, P, N)))
    with pytest.raises(ValueError):     # sigma with as many cells as nodes
        sk.nodal_smooth(m, m, m, m, (1.0, 1.0, 1.0), 2, True,
                        bc=((P, P, N), (P, P, N)))
    assert sk.LAUNCHES == n0


# ---------------------------------------------------------------------
# the smoothers, one launch a call: bit-equal to the plain versions in
# float32 and within 1e-13 relative in float64, in both regimes
# ---------------------------------------------------------------------

REGIMES = {"resident": 1, "grid": 2}


@pytest.fixture(params=sorted(REGIMES))
def regime(request):
    return REGIMES[request.param]


def _bit_check(got, ref, dtype):
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        elif dtype == torch.float32:
            assert torch.equal(a, b)
        else:
            assert _rel(a, b) <= 1e-13


def _cell_case(shape, ncomp, bc, dtype, device, seed):
    """Wrapper arguments of a one-level walled or periodic CellSolver
    with random coefficients (bc = None: periodic)."""
    bc = bc or ((P, P, P), (P, P, P))
    solver = _walled_solver(shape, bc, ncomp, dtype, device, seed)
    dinvs, fhis, fwalls = solver.smoother_coefs()
    rng = np.random.default_rng(seed + 1)
    full = tuple(solver.diags[0].shape)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ((t(rng.standard_normal(full)), t(rng.standard_normal(full)),
             solver.diags[0], dinvs[0], fhis[0]),
            dict(bc=bc, Fwall=fwalls[0]))


# (8, 4, 2): 2 cells along z; (9, 5, 7): odd sizes, an odd periodic
# wrap; (33, 8, 16): an odd wrap across CTAs; (2, 6, 4): 2 cells along x
REDESIGN_SHAPES = [(8, 4, 2), (9, 5, 7), (33, 8, 16), (2, 6, 4),
                   (16, 8, 16)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", REDESIGN_SHAPES)
@pytest.mark.parametrize("ncomp", [0, 3])
@pytest.mark.parametrize("nsweeps", [0, 1, 8])
@pytest.mark.parametrize("bcname", ["periodic", "rt_scalar",
                                    "rt_normal_velocity", "mixed_sides"])
def test_cell_smooth_bit_equal_both_regimes(cuda, regime, dtype, shape,
                                            ncomp, nsweeps, bcname):
    bc = None if bcname == "periodic" else WALL_BCS[bcname]
    args, kw = _cell_case(shape, ncomp, bc, dtype, cuda, 12)
    name = "cell_smooth" if bc is None else "cell_smooth_walled"
    for want in (True, False):
        n0 = sk.DEVICE_LAUNCHES[name]
        got = sk.cell_smooth(*args, nsweeps, want, **kw, _regime=regime)
        torch.cuda.synchronize()
        assert sk.DEVICE_LAUNCHES[name] == n0 + 1
        assert sk.LAST_PLAN[name][0] == regime
        _bit_check(got, sk.cell_smooth_plain(*args, nsweeps, want, **kw),
                   dtype)


def _eb_wrap_case(shape, ncomp, bc, dtype, device, seed):
    """Wrapper arguments of a CellSolver level with the EB wall term
    whose periodic face n differs from face 0, as the cut-cell velocity
    operator's does: smoother_coefs hands the kernel face 0 of each
    periodic axis as a wrap plane."""
    rng = np.random.default_rng(seed)
    tail = (ncomp,) if ncomp else ()
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    bcoef = tuple(t(0.5 + rng.random(tuple(
        n + (1 if a == ax else 0) for a, n in enumerate(shape)) + tail))
        for ax in range(3))
    solver = mg.CellSolver((1.0, 0.5, 0.25), bc[0], bc[1], alpha=1.0,
                           beta=0.3, acoef=t(1.0 + rng.random(shape + tail)),
                           bcoef=bcoef, ebc=t(rng.random(shape + tail)),
                           max_levels=1, direct=False)
    dinvs, fhis, fwalls = solver.smoother_coefs()
    assert all(w is not None for w in fwalls[0])
    full = tuple(solver.diags[0].shape)
    return solver, ((t(rng.standard_normal(full)),
                     t(rng.standard_normal(full)), solver.diags[0], dinvs[0],
                     fhis[0]), dict(bc=bc, Fwall=fwalls[0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", REDESIGN_SHAPES)
@pytest.mark.parametrize("ncomp", [0, 3])
@pytest.mark.parametrize("bcname", ["periodic", "rt_scalar"])
def test_cell_smooth_wrap_plane_bit_equal_both_regimes(cuda, regime, dtype,
                                                       shape, ncomp, bcname):
    bc = ((P, P, P), (P, P, P)) if bcname == "periodic" else WALL_BCS[bcname]
    solver, (args, kw) = _eb_wrap_case(shape, ncomp, bc, dtype, cuda, 13)
    got = sk.cell_smooth(*args, 2, True, **kw, _regime=regime)
    torch.cuda.synchronize()
    _bit_check(got, sk.cell_smooth_plain(*args, 2, True, **kw), dtype)
    if dtype == torch.float64:   # the operator is cell_apply's
        r = args[1] - mg.cell_apply(got[0], solver.levels[0])
        assert _rel(got[1], r) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(8, 4, 2), (9, 5, 7), (33, 8, 16),
                                   (16, 8, 16)])
@pytest.mark.parametrize("ncomp", [0, 3])
def test_cell_smooth_ext_x_wrap_plane_bit_equal_both_regimes(
        cuda, regime, dtype, shape, ncomp):
    """The slab form's launch on an extended slab of an EB level (x open,
    the y and z wrap planes) with the level's x wrap plane at two
    interior planes, as the first and last ranks of a mesh place it:
    bit-equal to its plain version in both regimes."""
    bc = ((P, P, P), (P, P, P))
    solver, (args, kw) = _eb_wrap_case(shape, ncomp, bc, dtype, cuda, 17)
    fw = kw["Fwall"]
    xwrap = (fw[0], (2, shape[0] - 3))
    got = sk.cell_smooth_ext(*args, 2, True, bc=bc, Fwall=fw, xwrap=xwrap,
                             _regime=regime)
    torch.cuda.synchronize()
    ref = sk.cell_smooth_plain(*args, 2, True, bc=sk.slab_bc(bc),
                               Fwall=(None,) + tuple(fw[1:]),
                               open_x=(True, True), xwrap=xwrap)
    _bit_check(got, ref, dtype)


NODAL_BCS = {
    "periodic": ((P, P, P), (P, P, P)),
    "rt": ((P, P, N), (P, P, N)),
    "dirichlet_side": ((N, P, N), (D, P, N)),
    "walled_x": ((D, N, P), (N, D, P)),
    "all_walls": ((D, N, D), (N, D, N)),
}


def _nodal_case(cells, bc, dtype, device, seed):
    """Wrapper arguments on a one-level NodalSolver with random sigma:
    nodes = cells, + 1 along a walled axis."""
    rng = np.random.default_rng(seed)
    periodic = tuple(c == P for c in bc[0])
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    solver = mg.NodalSolver((1.0, 0.5, 0.25), periodic, bc[0], bc[1],
                            t(0.6 + 0.8 * rng.random(cells)), max_levels=1,
                            direct=False)
    nodes = tuple(solver.dinvs[0].shape)
    return (t(rng.standard_normal(nodes)), t(rng.standard_normal(nodes)),
            solver.sigmas[0], solver.dinvs[0], solver.levels[0].dx)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cells", [(8, 4, 2), (9, 5, 7), (2, 6, 4),
                                   (16, 8, 16), (20, 12, 34)])
@pytest.mark.parametrize("nsweeps", [0, 2, 24])
@pytest.mark.parametrize("bcname", sorted(NODAL_BCS))
def test_nodal_smooth_bit_equal_both_regimes(cuda, regime, dtype, cells,
                                             nsweeps, bcname):
    bc = NODAL_BCS[bcname]
    args = _nodal_case(cells, bc, dtype, cuda, 13)
    name = "nodal_smooth" if bcname == "periodic" else "nodal_smooth_walled"
    for want in (True, False):
        n0 = sk.DEVICE_LAUNCHES[name]
        got = sk.nodal_smooth(*args, nsweeps, want, bc=bc, _regime=regime)
        torch.cuda.synchronize()
        assert sk.DEVICE_LAUNCHES[name] == n0 + 1
        assert sk.LAST_PLAN[name][0] == regime
        _bit_check(got, sk.nodal_smooth_plain(*args, nsweeps, want, bc=bc),
                   dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("above", [False, True], ids=["under", "over"])
def test_smoothers_either_side_of_the_resident_threshold(cuda, dtype,
                                                         above):
    """The regime the kernels choose by themselves, and bit-equality
    there, on the levels just within and just past the resident size:
    1024 cells or 128 nodes of each colour."""
    cells = (16, 16, 10 if above else 8)     # 1280 or 1024 of each colour
    args, kw = _cell_case(cells, 0, WALL_BCS["rt_scalar"], dtype, cuda, 14)
    got = sk.cell_smooth(*args, 2, True, **kw)
    assert sk.LAST_PLAN["cell_smooth_walled"][0] == (2 if above else 1)
    _bit_check(got, sk.cell_smooth_plain(*args, 2, True, **kw), dtype)
    # one node more than cells along the walled z: 8x4x10 or 8x4x8
    cells = (8, 4, 9 if above else 7)       # 160 or 128 of each colour
    bc = NODAL_BCS["rt"]
    args = _nodal_case(cells, bc, dtype, cuda, 15)
    got = sk.nodal_smooth(*args, 2, True, bc=bc)
    assert sk.LAST_PLAN["nodal_smooth_walled"][0] == (2 if above else 1)
    _bit_check(got, sk.nodal_smooth_plain(*args, 2, True, bc=bc), dtype)


def _capture(fn):
    """fn() captured in a CUDA graph that keeps its cudaGraph_t."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = fn()
    return g, out


def _smoother_calls(dtype, device, cells):
    """{name: call} for each family at one level size."""
    cargs, ckw = _cell_case(cells, 3, None, dtype, device, 16)
    wargs, wkw = _cell_case(cells, 0, WALL_BCS["rt_scalar"], dtype, device,
                            17)
    nargs = _nodal_case(cells, NODAL_BCS["periodic"], dtype, device, 18)
    rt = NODAL_BCS["rt"]
    wnargs = _nodal_case(cells, rt, dtype, device, 19)
    return {
        "cell_smooth": lambda: sk.cell_smooth(*cargs, 2, True, **ckw),
        "cell_smooth_walled": lambda: sk.cell_smooth(*wargs, 8, True, **wkw),
        "nodal_smooth": lambda: sk.nodal_smooth(*nargs, 2, True),
        "nodal_smooth_walled": lambda: sk.nodal_smooth(*wnargs, 24, True,
                                                       bc=rt),
    }


@pytest.mark.parametrize("cells", [(4, 4, 8), (64, 64, 32)],
                         ids=["resident", "grid"])
def test_smoother_call_is_one_device_launch(cuda, cells):
    """Captured in a CUDA graph, each wrapper call is exactly one kernel
    node; the C entry reports one launch; replays give the eager
    result."""
    for name, call in _smoother_calls(torch.float32, cuda, cells).items():
        eager = call()
        n0 = sk.DEVICE_LAUNCHES[name]
        g, out = _capture(call)
        assert sk.DEVICE_LAUNCHES[name] == n0 + 2    # warm-up + capture
        assert sk.graph_kernels(g) == 1, name
        for _ in range(2):
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(out[0], eager[0]) and torch.equal(out[1],
                                                                 eager[1])


def test_walled_nodal_solve_runs_through_the_kernel(cuda):
    """A walled NodalSolver on the card smooths every level through the
    walled nodal kernel, one device launch a call."""
    rng = np.random.default_rng(20)
    bc = NODAL_BCS["rt"]
    sigma = torch.as_tensor(0.5 + rng.random((16, 16, 32)), device=cuda)
    nod = mg.NodalSolver((1.0, 0.5, 0.25), (True, True, False), bc[0], bc[1],
                         sigma, direct=False)
    rhs = torch.as_tensor(rng.standard_normal((16, 16, 33)), device=cuda)
    n0 = dict(sk.LAUNCHES)
    d0 = dict(sk.DEVICE_LAUNCHES)
    _, _, it = nod.solve_info(rhs)
    calls = sk.LAUNCHES["nodal_smooth_walled"] - n0["nodal_smooth_walled"]
    assert it > 1 and calls >= it * (2 * len(nod.levels) - 1)
    assert sk.DEVICE_LAUNCHES["nodal_smooth_walled"] - d0[
        "nodal_smooth_walled"] == calls
    assert sk.LAUNCHES["nodal_smooth"] == n0["nodal_smooth"]


# the fused 2D step: tgv2d and its variants (Crank-Nicolson, no tensor
# solve, the tensor correction, a non-square grid driven by delp), and
# grids that cut the kernel's 8-row panels and 16-deep k-tiles: axes not
# a multiple of 8 (36 x 20) and a 4-cell axis (4 x 24)
STEP2D_DECKS = {
    "tgv2d": "",
    "crank_nicolson": "incflo.diffusion_type = 1\n",
    "no_tensor_solve": "incflo.use_tensor_solve = false\n",
    "tensor_correction": ("incflo.use_tensor_solve = false\n"
                          "incflo.use_tensor_correction = true\n"),
    "delp_24x16": ("amr.n_cell = 24 16\ngeometry.prob_hi = 1.5 1.\n"
                   "incflo.delp = 0.3 0.\n"),
    "ragged_36x20": "amr.n_cell = 36 20\ngeometry.prob_hi = 1.8 1.\n",
    "short_4x24": "amr.n_cell = 4 24\n",
}


def _tgv_sim(extra, dtype, device, n=16):
    text, _ = bench._deck("tgv2d", n, dtype)
    cfg = incflo_torch.IncfloConfig.from_text(text + extra)
    return incflo_torch.Simulation(cfg, device=device)


def _step2d_check(a, b, dtype):
    a, b = a.double().cpu(), b.double().cpu()
    d = float((a - b).abs().max())
    if dtype == "float64":
        assert d <= 1e-9 * max(float(b.abs().max()), 1e-300)
    else:
        assert bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("deck", sorted(STEP2D_DECKS))
def test_step2d_kernel_matches_plain(cuda, dtype, deck):
    sim = _tgv_sim(STEP2D_DECKS[deck], dtype, cuda)
    fs = s2.FusedStep(sim)
    sk_, sp = sim.init_state(), None
    sp = sk_
    for _ in range(3):
        n0 = s2.LAUNCHES["step2d"]
        sk_, cg = fs.step(sk_)
        assert s2.LAUNCHES["step2d"] == n0 + 1
        res = []
        sp = s2.step_plain(sim, sp, res)
        torch.cuda.synchronize()
        for f in ("velocity", "p", "gp", "mac_phi"):
            _step2d_check(getattr(sk_.level, f), getattr(sp.level, f), dtype)
        for f in ("t", "dt", "prev_dt", "prev_prev_dt"):
            _step2d_check(getattr(sk_, f), getattr(sp, f), dtype)
        assert int(sk_.step) == int(sp.step)
        cg = cg.cpu()
        assert float(cg[0]) <= float(cg[1]) and float(cg[2]) <= float(cg[3])
        barriers, t0, t1 = fs.diag.tolist()
        assert 0 <= t0 <= s2.FIXED_TRIPS and 0 <= t1 <= s2.FIXED_TRIPS
        assert barriers > 0


def test_step2d_is_deterministic(cuda):
    """Two launches on one state give the same bits (no float atomics,
    every block combines the partials in one order)."""
    sim = _tgv_sim("", "float32", cuda, n=64)
    fs = s2.FusedStep(sim)
    s = sim.init_state()
    a, _ = fs.step(s)
    b, _ = fs.step(s)
    assert torch.equal(a.level.velocity, b.level.velocity)
    assert torch.equal(a.level.p, b.level.p)


def test_advance_dispatches_the_fused_kernel(cuda):
    sim = _tgv_sim("", "float32", cuda)
    s = sim.init_state()
    n0 = s2.LAUNCHES["step2d"]
    s = sim.advance_n(s, 3)
    assert s2.LAUNCHES["step2d"] == n0 + 3 and int(s.step) == 3
    # the plain step on the card launches no kernel
    n0 = s2.LAUNCHES["step2d"]
    sim._advance_impl(sim.init_state())
    assert s2.LAUNCHES["step2d"] == n0
    # float64 is not fused by Simulation (supported() says no)
    sim64 = _tgv_sim("", "float64", cuda)
    sim64.advance(sim64.init_state())
    assert s2.LAUNCHES["step2d"] == n0


def test_step2d_raises_outside_scope(cuda):
    text, _ = bench._deck("shear3d", 16, "float32")
    sim3 = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(text), device=cuda)
    with pytest.raises(NotImplementedError):
        s2.FusedStep(sim3)
    sim = _tgv_sim("", "float32", cuda)
    fs = s2.FusedStep(sim)
    s = sim.init_state()
    bad = s._replace(level=s.level._replace(velocity=s.level.velocity.double()))
    n0 = s2.LAUNCHES["step2d"]
    with pytest.raises(ValueError):
        fs.step(bad)
    assert s2.LAUNCHES["step2d"] == n0


# ---------------------------------------------------------------------
# the halo-slab Godunov kernels (B8): each rank's x slab of a periodic
# level, cut here in one process from a whole-level field.  Every output
# is held bit-equal in float32 (and within 1e-14 in float64) to the slab
# plain version and to the unsharded kernel's output on the same rows.
# ---------------------------------------------------------------------

# (shape, ranks): the shear3d n = 128 level in 2 and 4 slabs, an odd
# ny * nz (9 x 7) over 3 ranks, and slabs that cut the 8 x 32 tiles: axes
# shorter than a tile (5-row slabs of 10 x 3 x 2) and a ragged ny (33 x 8
# x 16 over 3 ranks)
HALO_CASES = [((128, 128, 32), 2), ((128, 128, 32), 4), ((24, 9, 7), 3),
              ((10, 3, 2), 2), ((33, 8, 16), 3)]


def _slab_grid(grid, nranks):
    from incflo_torch.parallel.mesh import SlabGrid
    nx = grid.n_cell[0]
    return SlabGrid(n_cell=(nx // nranks,) + tuple(grid.n_cell[1:]),
                    prob_lo=grid.prob_lo, prob_hi=grid.prob_hi,
                    periodic=grid.periodic, nx_full=nx)


def _halo_rows(full, x0, nxl):
    """Rows [x0 - HALO, x0 + nxl + HALO) of a whole-level array, wrapped."""
    nx = full.shape[0]
    idx = torch.arange(x0 - gk.HALO, x0 + nxl + gk.HALO,
                       device=full.device) % nx
    return full.index_select(0, idx).contiguous()


def _same(a, b, dtype):
    assert a.shape == b.shape
    if dtype == torch.float32:
        assert torch.equal(a, b)
    else:
        assert _rel(a, b) <= 1e-14


def _halo_case(shape, dtype, dev):
    grid = Grid(n_cell=shape, prob_lo=(0.0,) * 3, prob_hi=(1.0, 1.0, 0.25),
                periodic=(True,) * 3)
    vel = _fields(grid, 3, 1, dtype, dev)
    forces = 0.3 * _fields(grid, 3, 2, dtype, dev)
    q = _fields(grid, 3, 3, dtype, dev)
    dt = torch.tensor(0.9 * min(grid.dx) / float(vel.abs().max()),
                      dtype=dtype, device=dev)
    return grid, vel, forces, q, dt


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("use_ppm", [True, False])
@pytest.mark.parametrize("shape,nranks", HALO_CASES)
def test_halo_kernels_match_slab_plain_and_unsharded_rows(
        cuda, dtype, use_ppm, shape, nranks):
    grid, vel, forces, q, dt = _halo_case(shape, dtype, cuda)
    slab = _slab_grid(grid, nranks)
    nxl = slab.n_cell[0]
    uad = gk.uad(grid, vel, dt, use_ppm)
    umac = [gk.predict_d(grid, vel, uad, forces, dt, d, use_ppm)
            for d in range(3)]
    rates = [gk.advect_comp(grid, q, n, umac, forces, dt, bool(n % 2),
                            use_ppm) for n in range(3)]
    mac_lo = [umac[0].narrow(0, 0, grid.n_cell[0])] + umac[1:]
    for r in range(nranks):
        x0 = r * nxl
        rows = lambda a: a.narrow(0, x0, nxl)
        vel_p, f_p, q_p = (_halo_rows(a, x0, nxl) for a in (vel, forces, q))
        uad_p = [_halo_rows(u, x0, nxl) for u in uad]
        mac_p = [_halo_rows(m, x0, nxl) for m in mac_lo]
        n0 = dict(gk.LAUNCHES)
        got = gk.uad_halo(slab, vel_p, dt, use_ppm)
        plain = gk.uad_slab_plain(slab, vel_p, dt, use_ppm)
        for a, b, c in zip(got, plain, uad):
            _same(a, b, dtype)
            _same(a, rows(c), dtype)
        for d in range(3):
            for fp in (f_p, None):
                got = gk.predict_d_halo(slab, vel_p, uad_p, fp, dt, d,
                                        use_ppm)
                plain = gk.predict_d_slab_plain(
                    slab, vel_p, uad_p, None if fp is None else fp[..., d],
                    dt, d, use_ppm)
                _same(got, plain, dtype)
            _same(got, rows(gk.predict_d(grid, vel, uad, None, dt, d,
                                         use_ppm)), dtype)
        out = torch.empty(slab.n_cell + (3,), dtype=dtype, device=cuda)
        for n in range(3):
            got = gk.advect_comp_halo(slab, q_p, n, mac_p, f_p, dt,
                                      bool(n % 2), use_ppm, out=out)
            plain = gk.advect_comp_slab_plain(slab, q_p[..., n], mac_p,
                                              f_p[..., n], dt, bool(n % 2),
                                              use_ppm)
            _same(got, plain, dtype)
            _same(got, rows(rates[n]), dtype)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["uad_halo"] == n0["uad_halo"] + 1
        assert gk.LAUNCHES["predict_d_halo"] == n0["predict_d_halo"] + 6
        assert gk.LAUNCHES["advect_halo"] == n0["advect_halo"] + 3


def test_halo_kernels_raise_outside_scope(cuda):
    grid, vel, forces, q, dt = _halo_case((16, 8, 8), torch.float32, cuda)
    slab = _slab_grid(grid, 2)
    with pytest.raises(ValueError):      # not grown by HALO rows
        gk.uad_halo(slab, vel[:10].contiguous(), dt, True)
    with pytest.raises(TypeError):
        gk.uad_halo(slab, vel.half(), dt, True)
