"""The plain versions of incflo_torch's smoother kernels
(ops/smoother_kernels.py) against incflo_tpu: the Pallas smoother kernels
in interpret mode (whole-level and x-slab tiled), and the jnp red-black
loops.

Inputs are seeded numpy arrays with variable coefficients.  Tolerances:
float32 against the Pallas kernels 2e-6 absolute on x and 5e-4 on the
residual (the limits of tests/test_pallas_kernels.py: same operator form,
another association of the sums); float64 against the jnp loops 1e-12 of
the field's max (the jnp cell loop smooths with the flux form, the
kernels with the diag-extracted form: they differ by rounding).

Walls: cell_smooth_plain with BC codes against
pallas_smoother.rb_sweep_3d in interpret mode (float64, 16x16x8, the BC
triples of tests/test_pallas_smoother.py, which are periodic in x) to
1e-12 of the field's max, and against the jnp sweep on the whole domain
for BCs with a non-periodic x, where the Pallas kernel's black pass sees
a stale ghost and the port, by design, does not.  The walled nodal
smoother (sk.nodal_smooth with bc) against incflo_tpu's jnp loop on
levels with walls, float64, 1e-12; its plain operator equals the
solver's multigrid.nodal_apply bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

from incflo_tpu.ops import multigrid as jmg

from incflo_torch.ops import multigrid as tmg
from incflo_torch.ops import smoother_kernels as sk

P3 = (0, 0, 0)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from incflo_tpu.ops import pallas_cell, pallas_guard, pallas_nodal
    monkeypatch.setattr(pallas_nodal, "INTERPRET", True)
    monkeypatch.setattr(pallas_cell, "INTERPRET", True)
    monkeypatch.setattr(pallas_guard, "_sharded", False)
    monkeypatch.setenv("INCFLO_SPECTRAL", "0")
    yield


def _dx(shape):
    return tuple(1.0 / n for n in shape)


def _cell_inputs(shape, seed, beta):
    """acoef, periodic face coefficients (face n == face 0), x, b."""
    rng = np.random.RandomState(seed)
    acoef = 1.0 + rng.rand(*shape)
    bcoef = []
    for ax in range(3):
        f = 0.5 + rng.rand(*shape)
        bcoef.append(np.concatenate([f, f.take([0], axis=ax)], axis=ax))
    return acoef, bcoef, rng.randn(*shape), rng.randn(*shape), beta


def _cell_solvers(shape, acoef, bcoef, beta, np_dtype):
    """Both packages' solvers; only level 0 is smoothed here, so the
    hierarchies stop there (max_levels=1)."""
    jd = jnp.float32 if np_dtype == np.float32 else jnp.float64
    js = jmg.CellSolver(_dx(shape), P3, P3, alpha=1.0, beta=beta,
                        acoef=jnp.asarray(acoef, jd),
                        bcoef=tuple(jnp.asarray(b, jd) for b in bcoef),
                        max_levels=1)
    ts = tmg.CellSolver(_dx(shape), P3, P3, alpha=1.0, beta=beta,
                        acoef=torch.as_tensor(acoef.astype(np_dtype)),
                        bcoef=tuple(torch.as_tensor(b.astype(np_dtype))
                                    for b in bcoef),
                        max_levels=1, direct=False)
    return js, ts


def _cell_plain(ts, x, b, n, np_dtype):
    dinvs, fhis = ts.smoother_coefs()[:2]
    return sk.cell_smooth_plain(torch.as_tensor(x.astype(np_dtype)),
                                torch.as_tensor(b.astype(np_dtype)),
                                ts.diags[0], dinvs[0], fhis[0], n, True)


def _jnp_cell_loop(js, x, b, n):
    lev, diag = js.levels[0], js.diags[0]
    dmax = jnp.max(jnp.abs(diag))
    ok = jnp.abs(diag) > 1e-8 * dmax
    inv = jnp.where(ok, 1.0 / jnp.where(ok, diag, 1.0), 0.0)
    red, black = jmg._checkerboards(x.shape, x.dtype, 3)
    for _ in range(n):
        x = x + red * (b - jmg.cell_apply(x, lev)) * inv
        x = x + black * (b - jmg.cell_apply(x, lev)) * inv
    return x, b - jmg.cell_apply(x, lev)


def _jnp_nodal_loop(js, x, b, n):
    lev, inv = js.levels[0], js.dinvs[0]
    red, black = jmg._checkerboards(x.shape, x.dtype)
    for _ in range(n):
        x = x + red * (b - jmg.nodal_apply(x, lev)) * inv
        x = x + black * (b - jmg.nodal_apply(x, lev)) * inv
    return x, b - jmg.nodal_apply(x, lev)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
@pytest.mark.parametrize("shape", [(16, 8, 16), (32, 8, 16)])
def test_cell_plain_matches_pallas_f32(shape, tiled):
    from incflo_tpu.ops import pallas_cell as pc
    acoef, bcoef, x, b, beta = _cell_inputs(shape, 1, 0.01)
    js, ts = _cell_solvers(shape, acoef, bcoef, beta, np.float32)
    lev, diag = js.levels[0], js.diags[0]
    fn = pc.smooth_tiled if tiled else pc.smooth
    out, res = fn(jnp.asarray(x, jnp.float32), jnp.asarray(b, jnp.float32),
                  diag, pc.face_hi_coefs(lev), lev, 2, True)
    got, gres = _cell_plain(ts, x, b, 2, np.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-6)
    np.testing.assert_allclose(gres.numpy(), np.asarray(res), atol=5e-4)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
@pytest.mark.parametrize("shape", [(16, 8, 16), (32, 8, 16)])
def test_nodal_plain_matches_pallas_f32(shape, tiled):
    from incflo_tpu.ops import pallas_nodal as pn
    rng = np.random.RandomState(2)
    sigma = (0.5 + rng.rand(*shape)).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    js = jmg.NodalSolver(_dx(shape), (True,) * 3, P3, P3, jnp.asarray(sigma),
                         max_levels=1)
    ts = tmg.NodalSolver(_dx(shape), (True,) * 3, P3, P3,
                         torch.as_tensor(sigma), max_levels=1,
                         direct=False)
    lev = js.levels[0]
    dx = tuple(float(d) for d in lev.dx)
    run = pn._run_tiled if tiled else pn._run
    out, res = run(jnp.asarray(x), jnp.asarray(b), js._sigma_interior(0),
                   js.dinvs[0], 2, True, dx, shape)
    np.testing.assert_allclose(ts.dinvs[0].numpy(), np.asarray(js.dinvs[0]),
                               rtol=1e-6)
    got, gres = sk.nodal_smooth_plain(torch.as_tensor(x), torch.as_tensor(b),
                                      ts.sigmas[0], ts.dinvs[0], dx, 2, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-6)
    np.testing.assert_allclose(gres.numpy(), np.asarray(res), atol=5e-4)


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


# (8, 4, 2): two cells along z, where the +z and -z neighbour coincide
@pytest.mark.parametrize("shape,nsweeps", [((16, 8, 16), 2), ((32, 8, 16), 8),
                                           ((8, 4, 2), 3)])
def test_cell_plain_matches_jnp_loop_f64(shape, nsweeps):
    acoef, bcoef, x, b, beta = _cell_inputs(shape, 3, 0.3)
    js, ts = _cell_solvers(shape, acoef, bcoef, beta, np.float64)
    xr, rr = _jnp_cell_loop(js, jnp.asarray(x), jnp.asarray(b), nsweeps)
    got, gres = _cell_plain(ts, x, b, nsweeps, np.float64)
    assert _rel(got.numpy(), xr) <= 1e-12
    assert _rel(gres.numpy(), rr) <= 1e-12


def test_cell_plain_batched_components_f64():
    """Components last, each with its own coefficients: every component
    equals the scalar smooth of its slice."""
    shape = (16, 8, 4)
    per = [_cell_inputs(shape, 10 + c, 0.2) for c in range(3)]
    outs = []
    for acoef, bcoef, x, b, beta in per:
        _, ts = _cell_solvers(shape, acoef, bcoef, beta, np.float64)
        outs.append(_cell_plain(ts, x, b, 2, np.float64))
    st = lambda i: np.stack([p[i] for p in per], axis=-1)
    ts = tmg.CellSolver(_dx(shape), P3, P3, alpha=1.0, beta=0.2,
                        acoef=torch.as_tensor(st(0)),
                        bcoef=tuple(torch.as_tensor(np.stack(
                            [p[1][ax] for p in per], axis=-1))
                            for ax in range(3)), max_levels=1, direct=False)
    got, gres = _cell_plain(ts, st(2), st(3), 2, np.float64)
    for c in range(3):
        # the guard of the reciprocal takes its max over all components
        assert _rel(got[..., c].numpy(), outs[c][0].numpy()) <= 1e-14
        assert _rel(gres[..., c].numpy(), outs[c][1].numpy()) <= 1e-12


@pytest.mark.parametrize("shape,nsweeps", [((16, 8, 16), 2),
                                           ((32, 8, 16), 24),
                                           ((8, 4, 2), 3)])
def test_nodal_plain_matches_jnp_loop_f64(shape, nsweeps):
    rng = np.random.RandomState(4)
    sigma = 0.5 + rng.rand(*shape)
    x, b = rng.randn(*shape), rng.randn(*shape)
    js = jmg.NodalSolver(_dx(shape), (True,) * 3, P3, P3, jnp.asarray(sigma),
                         max_levels=1)
    ts = tmg.NodalSolver(_dx(shape), (True,) * 3, P3, P3,
                         torch.as_tensor(sigma), max_levels=1,
                         direct=False)
    xr, rr = _jnp_nodal_loop(js, jnp.asarray(x), jnp.asarray(b), nsweeps)
    got, gres = sk.nodal_smooth_plain(
        torch.as_tensor(x), torch.as_tensor(b), ts.sigmas[0], ts.dinvs[0],
        ts.levels[0].dx, nsweeps, True)
    assert _rel(got.numpy(), xr) <= 1e-12
    assert _rel(gres.numpy(), rr) <= 1e-12
    # the operator alone, against the port's general nodal_apply
    y = sk.nodal_apply_plain(torch.as_tensor(x), ts.sigmas[0],
                             sk.nodal_coefs(ts.levels[0].dx))
    assert _rel(y.numpy(), tmg.nodal_apply(torch.as_tensor(x),
                                           ts.levels[0]).numpy()) <= 1e-13


def test_wrappers_use_plain_version_on_cpu_only(monkeypatch):
    """A CPU tensor gets the plain version and counts no launch; any other
    tensor goes for the kernel library (stubbed to raise); what the
    kernels do not take raises before that."""
    class Reached(Exception):
        pass

    def no_library():
        raise Reached
    monkeypatch.setattr(sk, "_lib", no_library)
    shape = (8, 4, 6)
    before = dict(sk.LAUNCHES)
    z = torch.zeros(shape)
    one = torch.ones(shape)
    x, r = sk.cell_smooth(z, one, one, one, (one, one, one), 1, False)
    assert r is None and x.shape == shape
    x, r = sk.nodal_smooth(z, one, one, one, _dx(shape), 1, True)
    assert r.shape == shape
    m = torch.zeros(shape, device="meta")
    with pytest.raises(Reached):
        sk.cell_smooth(m, m, m, m, (m, m, m), 2, True)
    with pytest.raises(Reached):
        sk.nodal_smooth(m, m, m, m, _dx(shape), 2, True)
    with pytest.raises(NotImplementedError):
        sk.nodal_smooth(m[0], m[0], m[0], m[0], _dx(shape), 2, True)
    with pytest.raises(TypeError):
        sk.cell_smooth(m.half(), m.half(), m.half(), m.half(),
                       (m.half(),) * 3, 2, True)
    with pytest.raises(ValueError):
        sk.cell_smooth(m, m, m, m[:4], (m, m, m), 2, True)
    assert sk.LAUNCHES == before


# ---------------------------------------------------------------------
# walls: the port's counterpart of pallas_smoother._rb_kernel
# ---------------------------------------------------------------------

PER, NEU, DIR = 0, 1, 2


@pytest.fixture
def psm_interpret():
    """Run pallas_smoother on the CPU, as tests/test_pallas_smoother.py
    does, and put its switch back."""
    from incflo_tpu.ops import pallas_smoother as psm
    old = psm.INTERPRET
    psm.INTERPRET = True
    yield psm
    psm.INTERPRET = old


def _walled_pair(bc_lo, bc_hi, seed=0, shape=(16, 16, 8), beta=0.01):
    """The set-up of tests/test_pallas_smoother.py in both packages:
    (jax level, port solver, x0, rhs) with random coefficients."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    acoef = 1.0 + rng.rand(nx, ny, nz)
    b = [0.5 + rng.rand(nx + 1, ny, nz), 0.5 + rng.rand(nx, ny + 1, nz),
         0.5 + rng.rand(nx, ny, nz + 1)]
    for ax in range(3):
        if bc_lo[ax] == PER:      # the periodic face n is face 0
            idx = [slice(None)] * 3
            idx[ax] = -1
            b[ax][tuple(idx)] = b[ax].take(0, axis=ax)
    rhs, x0 = rng.randn(nx, ny, nz), rng.randn(nx, ny, nz)
    jlev = jmg.CellLevel(_dx(shape), tuple(bc_lo), tuple(bc_hi), 1.0, beta,
                         jnp.asarray(acoef),
                         tuple(jnp.asarray(v) for v in b))
    ts = tmg.CellSolver(_dx(shape), bc_lo, bc_hi, alpha=1.0, beta=beta,
                        acoef=torch.as_tensor(acoef),
                        bcoef=tuple(torch.as_tensor(v) for v in b),
                        max_levels=1, direct=False)
    return jlev, ts, x0, rhs


def _port_sweeps(ts, x0, rhs, n, want_residual=False):
    dinvs, fhis, fwalls = ts.smoother_coefs()
    lev = ts.levels[0]
    return sk.cell_smooth_plain(
        torch.as_tensor(x0), torch.as_tensor(rhs), ts.diags[0], dinvs[0],
        fhis[0], n, want_residual, bc=(lev.bc_lo, lev.bc_hi),
        Fwall=fwalls[0])


def _jnp_walled_sweep(x, rhs, jlev, inv):
    red, black = jmg._checkerboards(x.shape, x.dtype, 3)
    x = x + red * (rhs - jmg.cell_apply(x, jlev)) * inv
    return x + black * (rhs - jmg.cell_apply(x, jlev)) * inv


@pytest.mark.parametrize("bcs", [(PER, PER, PER), (PER, DIR, NEU),
                                 (PER, NEU, PER)],
                         ids=["periodic", "p-dirichlet-neumann",
                              "p-neumann-p"])
def test_walled_cell_plain_matches_rb_kernel_interpret(psm_interpret, bcs):
    psm = psm_interpret
    jlev, ts, x0, rhs = _walled_pair(bcs, bcs)
    inv = 1.0 / jmg.cell_diag(jlev)
    x = jnp.asarray(x0)
    assert psm.supported(x, jlev)
    want = x
    for _ in range(2):
        want = psm.rb_sweep_3d(want, jnp.asarray(rhs), inv, jlev.acoef,
                               jlev.bcoef, jlev)
    got, _ = _port_sweeps(ts, x0, rhs, 2)
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("bc_lo,bc_hi", [
    ((DIR, NEU, PER), (DIR, NEU, PER)),      # tests/test_pallas_smoother.py
    ((NEU, DIR, DIR), (DIR, NEU, DIR)),      # a different kind on each side
    ((PER, PER, NEU), (PER, PER, NEU)),      # rt: scalars, MAC, tangential
    ((PER, PER, DIR), (PER, PER, DIR)),      # rt: normal velocity
], ids=["walled-x", "mixed-sides", "rt-neumann", "rt-dirichlet"])
def test_walled_cell_plain_matches_jnp_sweep_whole_domain(bc_lo, bc_hi):
    """Fresh ghosts on every axis, x included: equal to the jnp sweep on
    the whole domain, boundary rings and all; the residual too."""
    jlev, ts, x0, rhs = _walled_pair(bc_lo, bc_hi, seed=1)
    inv = 1.0 / jmg.cell_diag(jlev)
    want = jnp.asarray(x0)
    for _ in range(3):
        want = _jnp_walled_sweep(want, jnp.asarray(rhs), jlev, inv)
    got, res = _port_sweeps(ts, x0, rhs, 3, True)
    assert _rel(got.numpy(), want) <= 1e-12
    assert _rel(res.numpy(),
                jnp.asarray(rhs) - jmg.cell_apply(want, jlev)) <= 1e-12


def test_walled_cell_plain_two_cell_dirichlet_axis():
    """Dirichlet on both sides of a 2-cell axis: each cell is the other's
    opposite neighbour for both walls."""
    bcs = (PER, NEU, DIR)
    jlev, ts, x0, rhs = _walled_pair(bcs, bcs, seed=2, shape=(8, 4, 2),
                                     beta=0.3)
    inv = 1.0 / jmg.cell_diag(jlev)
    want = jnp.asarray(x0)
    for _ in range(4):
        want = _jnp_walled_sweep(want, jnp.asarray(rhs), jlev, inv)
    got, _ = _port_sweeps(ts, x0, rhs, 4)
    assert _rel(got.numpy(), want) <= 1e-12


WALLED_NODAL_BCS = {
    # rt's nodal projection: periodic x and y, Neumann z
    "rt": ((PER, PER, NEU), (PER, PER, NEU)),
    # a Dirichlet side (identity rows) and a non-periodic x
    "dirichlet-side": ((NEU, PER, NEU), (DIR, PER, NEU)),
    # walls on every axis, a different kind on each side
    "all-walls": ((DIR, NEU, DIR), (NEU, DIR, NEU)),
}


def _walled_nodal_pair(bc_lo, bc_hi, shape=(8, 8, 16), seed=5):
    """Both packages' one-level walled NodalSolvers on random sigma, and
    x, b at the nodes (one more than cells along each walled axis)."""
    rng = np.random.RandomState(seed)
    sigma = 0.5 + rng.rand(*shape)
    periodic = tuple(b == PER for b in bc_lo)
    nodes = tuple(n + (0 if p else 1) for n, p in zip(shape, periodic))
    x, b = rng.randn(*nodes), rng.randn(*nodes)
    js = jmg.NodalSolver(_dx(shape), periodic, bc_lo, bc_hi,
                         jnp.asarray(sigma), max_levels=1)
    ts = tmg.NodalSolver(_dx(shape), periodic, bc_lo, bc_hi,
                         torch.as_tensor(sigma), max_levels=1, direct=False)
    return js, ts, x, b, nodes


@pytest.mark.parametrize("bcname", sorted(WALLED_NODAL_BCS))
def test_walled_nodal_smooth_matches_jnp_loop(bcname):
    """The wrapper's CPU path on a walled nodal level,
    sk.nodal_smooth(..., bc=...), and the solver's own _smooth_res,
    against the jnp loop that incflo_tpu runs on a level with walls."""
    bc_lo, bc_hi = WALLED_NODAL_BCS[bcname]
    js, ts, x, b, nodes = _walled_nodal_pair(bc_lo, bc_hi)
    xr, rr = _jnp_nodal_loop(js, jnp.asarray(x), jnp.asarray(b), 3)
    got, gres = sk.nodal_smooth(torch.as_tensor(x), torch.as_tensor(b),
                                ts.sigmas[0], ts.dinvs[0], ts.levels[0].dx,
                                3, True, bc=(bc_lo, bc_hi))
    assert got.shape == nodes
    assert _rel(got.numpy(), xr) <= 1e-12
    assert _rel(gres.numpy(), rr) <= 1e-12
    sx, sres = ts._smooth_res(torch.as_tensor(x), torch.as_tensor(b), 0, 3,
                              True)
    assert torch.equal(sx, got) and torch.equal(sres, gres)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bcname", sorted(WALLED_NODAL_BCS))
def test_plain_walled_nodal_apply_is_the_solver_operator(bcname, dtype):
    """The plain version of the walled nodal kernel repeats
    multigrid.nodal_apply's operations bit for bit (the operator of the
    solver's residual and of its earlier smoother), in both types."""
    bc_lo, bc_hi = WALLED_NODAL_BCS[bcname]
    _, ts, x, _, _ = _walled_nodal_pair(bc_lo, bc_hi, shape=(6, 4, 10))
    lev = tmg.NodalLevel(ts.levels[0].dx, ts.levels[0].periodic, bc_lo,
                         bc_hi, ts.sigmas[0].to(dtype)).with_stencil()
    xt = torch.as_tensor(x, dtype=dtype)
    want = tmg.nodal_apply(xt, lev)
    got = sk.nodal_apply_plain(xt, ts.sigmas[0].to(dtype),
                               sk.nodal_coefs(lev.dx), (bc_lo, bc_hi))
    assert torch.equal(got, want)


def test_walled_nodal_argument_checks():
    """bc of nodal_smooth: codes, both sides of an axis, 2 cells (3 nodes)
    on a walled axis, and sigma with one cell fewer than nodes there."""
    nodes = torch.ones((8, 4, 7))
    sigma = torch.ones((8, 4, 6))
    rt = ((PER, PER, NEU), (PER, PER, NEU))
    dx = (1.0, 1.0, 1.0)
    x, r = sk.nodal_smooth(nodes, nodes, sigma, nodes, dx, 1, True, bc=rt)
    assert x.shape == r.shape == nodes.shape
    with pytest.raises(ValueError):     # sigma with as many cells as nodes
        sk.nodal_smooth(nodes, nodes, nodes, nodes, dx, 1, True, bc=rt)
    with pytest.raises(ValueError):     # periodic on one side only
        sk.nodal_smooth(nodes, nodes, sigma, nodes, dx, 1, True,
                        bc=((PER, PER, NEU), (PER, PER, PER)))
    with pytest.raises(ValueError):     # an unknown code
        sk.nodal_smooth(nodes, nodes, sigma, nodes, dx, 1, True,
                        bc=((PER, PER, 3), (PER, PER, NEU)))
    with pytest.raises(ValueError):     # a walled axis of one cell
        two = torch.ones((8, 4, 2))
        sk.nodal_smooth(two, two, two[..., :1], two, dx, 1, True, bc=rt)
    with pytest.raises(NotImplementedError):    # a 2D level
        sk.nodal_smooth(nodes[0], nodes[0], sigma[0], nodes[0], dx, 1, True,
                        bc=rt)
    with pytest.raises(ValueError):     # bc must name three axes
        sk.nodal_smooth(nodes, nodes, sigma, nodes, dx, 1, True,
                        bc=((PER, PER), (PER, PER)))


@pytest.mark.parametrize("shape", [(8, 4, 2), (9, 5, 7), (16, 8, 16)])
@pytest.mark.parametrize("ncomp", [0, 3])
@pytest.mark.parametrize("bc", [((PER, PER, PER), (PER, PER, PER)),
                                ((PER, PER, NEU), (PER, PER, NEU))],
                         ids=["periodic", "walled_z"])
def test_wrap_plane_takes_face_zero_of_a_periodic_axis(shape, ncomp, bc):
    """A level with the EB wall term whose periodic face n differs from
    face 0 (the cut-cell velocity operator): the kernel form reads face
    0 from the wrap plane that smoother_coefs passes, and its sweeps and
    residual are those of incflo_tpu's flux form on cell_apply to 1e-12;
    without the plane they are not."""
    rng = np.random.default_rng(14)
    tail = (ncomp,) if ncomp else ()
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    bcoef = tuple(t(0.5 + rng.random(tuple(
        n + (1 if a == ax else 0) for a, n in enumerate(shape)) + tail))
        for ax in range(3))
    ts = tmg.CellSolver((1.0, 0.5, 0.25), bc[0], bc[1], 1.0, 0.3,
                        t(1.0 + rng.random(shape + tail)), bcoef,
                        ebc=t(rng.random(shape + tail)), max_levels=1,
                        direct=False)
    dinvs, fhis, fwalls = ts.smoother_coefs()
    lev = ts.levels[0]
    x, b = (t(rng.standard_normal(shape + tail)) for _ in "xb")
    flux = tmg._rb_sweeps(x, b, dinvs[0], lambda v: tmg.cell_apply(v, lev),
                          2, True, 3)
    got = ts._smooth_res(x, b, 0, 2, True)
    for a, c in zip(got, flux):
        assert _rel(a, c) <= 1e-12
    no_plane = tuple(w if lev.bc_lo[ax] else None
                     for ax, w in enumerate(fwalls[0]))
    off = sk.cell_smooth(x, b, ts.diags[0], dinvs[0], fhis[0], 2, True,
                         bc=bc, Fwall=no_plane)
    assert _rel(off[1], flux[1]) > 1e-6


def test_walled_cell_smooth_argument_checks():
    one = torch.ones((8, 4, 6))
    F = (one, one, one)
    wall_z = (None, None, one[..., :1])
    bc = ((PER, PER, NEU), (PER, PER, NEU))
    x, _ = sk.cell_smooth(one, one, one, one, F, 1, False, bc=bc,
                          Fwall=wall_z)
    assert x.shape == one.shape
    with pytest.raises(ValueError):     # walled axis without its plane
        sk.cell_smooth(one, one, one, one, F, 1, False, bc=bc)
    with pytest.raises(ValueError):     # periodic on one side only
        sk.cell_smooth(one, one, one, one, F, 1, False,
                       bc=((PER, PER, NEU), (PER, PER, PER)), Fwall=wall_z)
    with pytest.raises(ValueError):     # a plane of the wrong shape
        sk.cell_smooth(one, one, one, one, F, 1, False, bc=bc,
                       Fwall=(None, None, one))
    with pytest.raises(ValueError):     # a 1-cell walled axis
        thin = torch.ones((8, 4, 1))
        sk.cell_smooth(thin, thin, thin, thin, (thin,) * 3, 1, False, bc=bc,
                       Fwall=(None, None, thin))
