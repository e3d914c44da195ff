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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    dinvs, fhis = ts.smoother_coefs()
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
