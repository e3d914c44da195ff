"""incflo_torch's derived fields (ops/derive.py) and diagnostics
(utils/diagnostics.py) against incflo_tpu's, on the same seeded numpy
fields, in float64: 2D at 16^2 and 3D at 16x16x8, periodic (and walled
for the nodal average).  Every field and number within 1e-12 relative
of incflo_tpu's (the same formulas; the sums may add in another order),
every printed line and every verdict equal.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax.numpy as jnp

from incflo_tpu.grid import Grid as JGrid
from incflo_tpu.ops import derive as jderive
from incflo_tpu.state import LevelState as JLevel
from incflo_tpu.utils import diagnostics as jdiag

from incflo_torch.grid import Grid as TGrid
from incflo_torch.ops import derive as tderive
from incflo_torch.state import LevelState as TLevel
from incflo_torch.utils import diagnostics as tdiag

TOL = 1e-12
SHAPES = {"2d": ((16, 16), (1.0, 1.0)), "3d": ((16, 16, 8), (1.0, 1.0, 0.5))}
NG = 2


def _grids(dim, periodic=True):
    n_cell, hi = SHAPES[dim]
    per = (periodic,) * len(n_cell)
    lo = (0.0,) * len(n_cell)
    return JGrid(n_cell, lo, hi, per), TGrid(n_cell, lo, hi, per)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _smooth(shape, ncomp, seed):
    """Smooth fields with a random mix of modes along every axis, plus
    noise, so that every derivative of every component is nonzero."""
    rng = np.random.default_rng(seed)
    xs = np.meshgrid(*[np.linspace(0, 2 * np.pi, n, endpoint=False)
                       for n in shape], indexing="ij")
    out = []
    for _ in range(ncomp):
        f = 0.05 * rng.standard_normal(shape)
        for ax, x in enumerate(xs):
            f = f + rng.normal() * np.sin((ax + 1) * x + rng.normal())
        out.append(f)
    return np.stack(out, -1)


def _vel_g(dim, seed=1):
    n_cell, _ = SHAPES[dim]
    return _smooth(tuple(n + 2 * NG for n in n_cell), len(n_cell), seed)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_vorticity_matches(dim):
    jg, tg = _grids(dim)
    v = _vel_g(dim)
    ref = np.asarray(jderive.vorticity(jnp.asarray(v), jg, NG))
    got = tderive.vorticity(torch.as_tensor(v), tg, NG).numpy()
    assert ref.shape == jg.cell_shape
    assert _rel(got, ref) <= TOL
    if dim == "3d":
        # every component of the curl is nonzero on this field
        t = torch.as_tensor(v)
        d = lambda c, ax: tderive._cc_deriv(t, c, ax, tg, NG)
        for curl in (d(2, 1) - d(1, 2), d(0, 2) - d(2, 0),
                     d(1, 0) - d(0, 1)):
            assert float(curl.abs().max()) > 0.1


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_divu_cc_matches(dim):
    jg, tg = _grids(dim)
    v = _vel_g(dim, 2)
    ref = np.asarray(jderive.divu_cc(jnp.asarray(v), jg, NG))
    got = tderive.divu_cc(torch.as_tensor(v), tg, NG).numpy()
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("probtype", [1, 2])
def test_exact_solutions_match(dim, probtype):
    jg, tg = _grids(dim)
    t, dt = 0.37, 0.01
    ref_u = jderive.exact_velocity(probtype, jg, t, jnp.float64)
    got_u = tderive.exact_velocity(probtype, tg, t, torch.float64, "cpu")
    assert len(got_u) == len(ref_u) == jg.ndim
    for a, b in zip(got_u, ref_u):
        assert a.shape == tg.cell_shape
        assert _rel(a.numpy(), b) <= TOL
    ref_p = jderive.exact_pressure(probtype, jg, t, dt, jnp.float64)
    got_p = tderive.exact_pressure(probtype, tg, t, dt, torch.float64,
                                     "cpu")
    assert _rel(got_p.numpy(), ref_p) <= TOL


def test_exact_solutions_refuse_other_probtypes():
    _, tg = _grids("2d")
    with pytest.raises(ValueError, match="probtype 1/2"):
        tderive.exact_velocity(3, tg, 0.0, torch.float64, "cpu")
    with pytest.raises(ValueError, match="probtype 1/2"):
        tderive.exact_pressure(3, tg, 0.0, 0.1, torch.float64, "cpu")


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("periodic", [True, False],
                         ids=["periodic", "walled"])
def test_node_to_cell_matches(dim, periodic):
    jg, tg = _grids(dim, periodic)
    p = np.random.default_rng(3).standard_normal(jg.node_shape)
    ref = np.asarray(jderive.node_to_cell(jnp.asarray(p), jg))
    got = tderive.node_to_cell(torch.as_tensor(p), tg).numpy()
    assert got.shape == tg.cell_shape
    assert _rel(got, ref) <= TOL


# ---------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------

def _level(dim, seed, ntrac=2):
    n_cell, _ = SHAPES[dim]
    nd = len(n_cell)
    rng = np.random.default_rng(seed)
    d = {"velocity": _smooth(n_cell, nd, seed),
         "density": 1.0 + 0.3 * rng.random(n_cell),
         "tracer": rng.standard_normal(n_cell + (ntrac,)),
         "gp": rng.standard_normal(n_cell + (nd,)),
         "p": rng.standard_normal(n_cell),
         "mac_phi": rng.standard_normal(n_cell)}
    return d


def _both(d):
    return (JLevel(**{k: jnp.asarray(v) for k, v in d.items()}),
            TLevel(**{k: torch.as_tensor(v) for k, v in d.items()}))


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_max_values_and_their_line_match(dim, capsys):
    jl, tl = _both(_level(dim, 4))
    ref, got = jdiag.max_values(jl), tdiag.max_values(tl)
    assert list(got) == list(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL * abs(ref[k]), k
    jdiag.print_max_values(jl, 0.125)
    ref_line = capsys.readouterr().out
    tdiag.print_max_values(tl, 0.125)
    assert capsys.readouterr().out == ref_line
    assert "max_u=" in ref_line and "rho_min=" in ref_line


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("bad", [None, ("p", np.nan), ("tracer", np.inf),
                                 ("velocity", -np.inf)],
                         ids=["finite", "nan_p", "inf_tracer", "ninf_vel"])
def test_check_for_nans_matches(dim, bad):
    d = _level(dim, 5)
    if bad is not None:
        name, val = bad
        d[name].reshape(-1)[7] = val
    jl, tl = _both(d)
    assert tdiag.check_for_nans(tl) == jdiag.check_for_nans(jl) \
        == (bad is not None)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_kinetic_energy_matches(dim):
    jg, tg = _grids(dim)
    jl, tl = _both(_level(dim, 6))
    ref = jdiag.kinetic_energy(jl, jg)
    got = tdiag.kinetic_energy(tl, tg)
    assert ref > 0 and abs(got - ref) <= TOL * ref


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_steady_state_reached_matches(dim):
    old = _level(dim, 7)
    new = dict(old)
    new["velocity"] = old["velocity"] + 1e-3 * _smooth(
        SHAPES[dim][0], len(SHAPES[dim][0]), 8)
    (jo, to), (jn, tn) = _both(old), _both(new)
    dt = 0.01
    diff = np.abs(new["velocity"] - old["velocity"])
    max_change = diff.max() / dt
    rel_l1 = diff.sum() / np.abs(new["velocity"]).sum()
    # tolerances on each side of both criteria
    tols = sorted({0.5 * rel_l1, 2.0 * rel_l1, 0.5 * max_change,
                   2.0 * max_change})
    verdicts = []
    for tol in tols:
        ref = jdiag.steady_state_reached(jo, jn, dt, tol)
        assert tdiag.steady_state_reached(to, tn, dt, tol) == ref, tol
        verdicts.append(ref)
    assert not verdicts[0] and verdicts[-1]
