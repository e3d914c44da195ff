"""incflo_torch Godunov chain (the plain PyTorch versions of the CUDA
kernels) against incflo_tpu.

Two references, the same inputs (smooth O(1) fields from a numpy seed):
  * the jnp path GodunovScheme._predict / advect (Pallas dispatch
    bypassed as tests/test_pallas_godunov.py does), float64, to 1e-11
    relative: the same algebra in another order of evaluation, so the
    two agree to rounding;
  * the Pallas kernels in interpret mode (INTERPRET monkeypatched as
    tests/test_pallas_godunov.py does), float32 at 16x8x16, within 2e-5
    (predict) and 3e-4 (advect) of the field's max: the Pallas test
    tolerances.
On the CPU the kernel wrappers take the plain versions, and their launch
counters do not move.

The fused kernels' launch plan (godunov_kernels.tile_plan, pure Python;
advect, predict_d and uad):
for the shear3d levels, the card tests' shapes and halo slabs, each CTA's
shared memory fits an H100 block, every output cell belongs to exactly
one CTA, and a slab's chunks read only its padded rows.

Walls: predict_plain / advect_plain on ghost-filled arrays of a grid
with slip or no-slip walls on z (and one with walls on x and z) against
the same jnp path, float64, to 1e-11 relative, from random fields, which
exercise every limiter branch and the one-sided forms at the walls.
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax.numpy as jnp

from incflo_tpu import bcs as jbcs
from incflo_tpu.bcs import BCType
from incflo_tpu.grid import Grid as JGrid
from incflo_tpu.ops import godunov as jgod
from incflo_tpu.ops import pallas_godunov as pg

from incflo_torch.grid import Grid as TGrid
from incflo_torch.ops import godunov as tgod
from incflo_torch.ops import godunov_kernels as gk


def _grids(n_cell, prob_hi):
    kw = dict(n_cell=n_cell, prob_lo=(0.0,) * 3, prob_hi=prob_hi,
              periodic=(True,) * 3)
    return JGrid(**kw), TGrid(**kw)


def _bcrec(ncomp):
    return np.full((ncomp, 3, 2), int(BCType.int_dir), np.int32)


def _smooth(shape, ncomp, seed):
    rng = np.random.default_rng(seed)
    xs = [np.linspace(0, 2 * np.pi, n, endpoint=False) for n in shape]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    out = []
    for c in range(ncomp):
        a, b, d = rng.normal(size=3)
        out.append(a * np.sin(X + c) + b * np.cos(2 * Y - c)
                   + d * np.sin(Z + 0.3 * c) + 0.1 * rng.normal())
    return np.stack(out, axis=-1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


N64 = (16, 8, 12)
HI64 = (1.0, 0.5, 0.75)
DT = 0.01


@pytest.mark.parametrize("use_ppm", [True, False])
@pytest.mark.parametrize("with_forces", [True, False])
def test_predict_plain_matches_jnp(use_ppm, with_forces):
    jg, tg = _grids(N64, HI64)
    vel = _smooth(N64, 3, 1)
    forces = 0.3 * _smooth(N64, 3, 2) if with_forces else None
    ng = 4
    scheme = jgod.GodunovScheme(jg, use_ppm, False)
    ref = scheme._predict(
        jbcs.grow(jnp.asarray(vel), ng, jg, _bcrec(3)),
        jbcs.grow(jnp.asarray(forces), 1, jg, _bcrec(3))
        if with_forces else None, DT, ng, _bcrec(3))
    n0 = dict(gk.LAUNCHES)
    got = gk.predict(tg, torch.as_tensor(vel),
                     None if forces is None else torch.as_tensor(forces),
                     torch.tensor(DT, dtype=torch.float64), use_ppm)
    assert gk.LAUNCHES == n0           # plain versions on the CPU
    for d in range(3):
        assert _rel(got[d].numpy(), ref[d]) <= 1e-11, d


@pytest.mark.parametrize("use_ppm", [True, False])
@pytest.mark.parametrize("iconserv", [(0, 0, 0), (1, 1, 1)])
def test_advect_plain_matches_jnp(use_ppm, iconserv):
    jg, tg = _grids(N64, HI64)
    q, vel = _smooth(N64, 3, 3), _smooth(N64, 3, 5)
    forces = 0.2 * _smooth(N64, 3, 4)
    ng = 4
    scheme = jgod.GodunovScheme(jg, use_ppm, False)
    umac = scheme._predict(jbcs.grow(jnp.asarray(vel), ng, jg, _bcrec(3)),
                           None, DT, ng, _bcrec(3))
    with mock.patch.object(pg, "enabled", return_value=False):
        ref = scheme.advect(jbcs.grow(jnp.asarray(q), ng, jg, _bcrec(3)),
                            umac, jbcs.grow(jnp.asarray(forces), 1, jg,
                                            _bcrec(3)),
                            DT, ng, _bcrec(3), list(iconserv), True)
    got = gk.advect(tg, torch.as_tensor(q),
                    [torch.tensor(np.asarray(u)) for u in umac],
                    torch.as_tensor(forces), DT, iconserv, use_ppm)
    assert _rel(got.numpy(), ref) <= 1e-11


def test_scheme_dispatch_matches_jnp_scalar_advect():
    """GodunovScheme on grown fields, one conserved scalar, no forces."""
    jg, tg = _grids(N64, HI64)
    rho = 1.0 + 0.1 * _smooth(N64, 1, 6)
    vel = _smooth(N64, 3, 7)
    ng = 3
    js = jgod.GodunovScheme(jg, True, False)
    ts = tgod.GodunovScheme(tg, True, False)
    umac_j = js._predict(jbcs.grow(jnp.asarray(vel), ng, jg, _bcrec(3)),
                         None, DT, ng, _bcrec(3))
    umac_t = ts.predict(torch.tensor(np.asarray(
        jbcs.grow(jnp.asarray(vel), ng, jg, _bcrec(3)))), None, DT, ng,
        _bcrec(3))
    for d in range(3):
        assert _rel(umac_t[d].numpy(), umac_j[d]) <= 1e-11
    rho_g = jbcs.grow(jnp.asarray(rho), ng, jg, _bcrec(1))
    with mock.patch.object(pg, "enabled", return_value=False):
        ref = js.advect(rho_g, umac_j, None, DT, ng, _bcrec(1), [1], False)
    got = ts.advect(torch.tensor(np.asarray(rho_g)), umac_t, None, DT,
                    ng, _bcrec(1), [1], False)
    assert _rel(got.numpy(), ref) <= 1e-11


# ---------------------------------------------------------------------
# walls: the wall forms of the plain versions against the jnp path
# ---------------------------------------------------------------------

NW = (8, 6, 12)
HIW = (1.0, 0.8, 1.5)
WALL_DECKS = {
    # (periodic, BCKind per (axis, side)); kinds as in incflo_tpu.bcs
    "slip_z": ((True, True, False), {2: "slip_wall"}),
    "noslip_z": ((True, True, False), {2: "no_slip_wall"}),
    "noslip_x_slip_z": ((False, True, False),
                        {0: "no_slip_wall", 2: "slip_wall"}),
}


def _walled_setup(name):
    periodic, walls = WALL_DECKS[name]
    kw = dict(n_cell=NW, prob_lo=(0.0,) * 3, prob_hi=HIW, periodic=periodic)
    kind = np.zeros((3, 2), np.int32)
    for ax, k in walls.items():
        kind[ax, :] = int(getattr(jbcs.BCKind, k))
    return (JGrid(**kw), TGrid(**kw), jbcs.velocity_bcrecs(kind, 3),
            jbcs.scalar_bcrecs(kind, 1, 3), jbcs.force_bcrecs(kind, 3, 3))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("deck,use_ppm", [
    ("slip_z", True), ("slip_z", False), ("noslip_z", True),
    ("noslip_x_slip_z", False)],
    ids=["slip_z-ppm", "slip_z-plm", "noslip_z-ppm", "noslip_x_slip_z-plm"])
def test_walled_predict_and_advect_plain_match_jnp(deck, use_ppm):
    jg, tg, vb, sb, fb = _walled_setup(deck)
    rng = np.random.default_rng(40)
    vel = 0.5 * rng.standard_normal(NW + (3,))
    forces = rng.standard_normal(NW + (3,))
    rho = 2.0 + rng.standard_normal(NW + (1,))
    ng = 4
    vel_g = jbcs.grow(jnp.asarray(vel), ng, jg, vb)
    f_g = jbcs.grow(jnp.asarray(forces), 1, jg, fb)
    rho_g = jbcs.grow(jnp.asarray(rho), ng, jg, sb)
    js = jgod.GodunovScheme(jg, use_ppm, False)
    ju = js._predict(vel_g, f_g, 0.02, ng, vb)
    n0 = dict(gk.LAUNCHES)
    tu = gk.predict_plain(tg, _t(vel_g), _t(f_g), 0.02, use_ppm,
                          bcrecs=np.asarray(vb), ng=ng)
    for d in range(3):
        assert tu[d].shape == ju[d].shape
        assert _rel(tu[d].numpy(), ju[d]) <= 1e-11, d
    if not jg.periodic[2]:      # no flow through a wall
        assert float(tu[2][:, :, 0].abs().max()) == 0.0
        assert float(tu[2][:, :, -1].abs().max()) == 0.0
    ja = js.advect(vel_g, ju, f_g, 0.02, ng, vb, [0] * 3, True)
    ta = gk.advect_plain(tg, _t(vel_g), tu, _t(f_g), 0.02, (0, 0, 0),
                         use_ppm, bcrecs=np.asarray(vb), ng=ng,
                         is_velocity=True)
    assert _rel(ta.numpy(), ja) <= 1e-11
    jr = js.advect(rho_g, ju, None, 0.02, ng, sb, [1], False)
    tr = gk.advect_plain(tg, _t(rho_g), tu, None, 0.02, (1,), use_ppm,
                         bcrecs=np.asarray(sb), ng=ng)
    assert _rel(tr.numpy(), jr) <= 1e-11
    assert gk.LAUNCHES == n0


def test_walled_scheme_takes_plain_path_by_periodicity():
    """GodunovScheme picks the wall forms from the grid alone, and gives
    what predict_plain / advect_plain give."""
    jg, tg, vb, sb, fb = _walled_setup("slip_z")
    rng = np.random.default_rng(41)
    ng = 3
    vel_g = _t(jbcs.grow(jnp.asarray(0.5 * rng.standard_normal(NW + (3,))),
                         ng, jg, vb))
    ts = tgod.GodunovScheme(tg, True, False)
    got = ts.predict(vel_g, None, 0.02, ng, np.asarray(vb))
    want = gk.predict_plain(tg, vel_g, None, 0.02, True,
                            bcrecs=np.asarray(vb), ng=ng)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = ts.advect(vel_g, got, None, 0.02, ng, np.asarray(vb), [0] * 3, True)
    b = gk.advect_plain(tg, vel_g, got, None, 0.02, (0, 0, 0), True,
                        bcrecs=np.asarray(vb), ng=ng, is_velocity=True)
    assert torch.equal(a, b)
    # a zero MAC-phi gradient (use_mac_phi_in_godunov from mac_phi = 0)
    # takes the same chain and changes nothing
    zeros = [torch.zeros_like(u) for u in got]
    again = ts.predict(vel_g, None, 0.02, ng, np.asarray(vb), gmacphi=zeros)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# ---------------------------------------------------------------------
# against the Pallas kernels in interpret mode (float32)
# ---------------------------------------------------------------------

NI = (16, 8, 16)          # m = ny*nz = 128, nx % 8 == 0: Pallas scope
HII = (1.0, 0.5, 1.0)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pg, "INTERPRET", True)


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("use_ppm", [True, False])
def test_predict_plain_matches_pallas_interpret(interpret, use_ppm):
    jg, tg = _grids(NI, HII)
    vel, forces = _f32(_smooth(NI, 3, 1)), _f32(0.3 * _smooth(NI, 3, 2))
    ref = pg.predict(jg, jnp.asarray(vel), jnp.asarray(forces), DT, use_ppm)
    got = gk.predict(tg, torch.as_tensor(vel), torch.as_tensor(forces),
                     DT, use_ppm)
    for d in range(3):
        assert _rel(got[d].numpy(), ref[d]) <= 2e-5, d


@pytest.mark.parametrize("use_ppm,iconserv", [(True, (0, 0, 0)),
                                              (True, (1, 1, 1)),
                                              (False, (0, 0, 0))])
def test_advect_plain_matches_pallas_interpret(interpret, use_ppm,
                                               iconserv):
    jg, tg = _grids(NI, HII)
    q, vel = _f32(_smooth(NI, 3, 3)), _f32(_smooth(NI, 3, 5))
    forces = _f32(0.2 * _smooth(NI, 3, 4))
    umac = pg.predict(jg, jnp.asarray(vel), None, DT, use_ppm)
    ref = pg.advect(jg, jnp.asarray(q), umac, jnp.asarray(forces), DT,
                    iconserv, use_ppm)
    got = gk.advect(tg, torch.as_tensor(q),
                    [torch.tensor(np.asarray(u)) for u in umac],
                    torch.as_tensor(forces), DT, iconserv, use_ppm)
    assert _rel(got.numpy(), ref) <= 3e-4


def test_wrappers_raise_outside_scope():
    walled = TGrid(n_cell=(8, 8, 8), prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3,
                   periodic=(True, False, True))
    vel = torch.zeros((8, 8, 8, 3), dtype=torch.float64)
    # the kernel wrappers refuse a walled grid and name the plain path
    with pytest.raises(NotImplementedError, match="predict_plain"):
        gk.predict(walled, vel, None, DT, True)
    with pytest.raises(ValueError, match="grown"):   # no ghosts, no bcrecs
        gk.predict_plain(walled, vel, None, DT, True)
    # 2D grids and use_forces_in_trans take the plain chain, which needs
    # grown arrays: given none, it says so
    flat = TGrid(n_cell=(8, 8), prob_lo=(0.0,) * 2, prob_hi=(1.0,) * 2,
                 periodic=(True, True))
    with pytest.raises(ValueError, match="grown"):
        tgod.GodunovScheme(flat, True, False).predict(
            torch.zeros((8, 8, 2), dtype=torch.float64), None, DT, 0,
            _bcrec(2))
    _, tg = _grids(N64, HI64)
    with pytest.raises(ValueError, match="grown"):
        tgod.GodunovScheme(tg, True, True).predict(
            torch.zeros(N64 + (3,), dtype=torch.float64), None, DT, 0,
            _bcrec(3))


# (output cells, halo rows a side): the shear3d levels n = 128 and 256,
# the card tests' ragged and short-axis shapes, and x slabs of 2 and 4
# ranks and of an odd level over 3
PLAN_CASES = [((128, 128, 32), 0), ((256, 256, 64), 0), ((16, 8, 12), 0),
              ((24, 9, 7), 0), ((33, 8, 16), 0), ((5, 3, 2), 0),
              ((64, 128, 32), gk.HALO), ((32, 128, 32), gk.HALO),
              ((8, 9, 7), gk.HALO)]


def _check_tile_plan(kind, cells, halo):
    nx = cells[0]
    for itemsize in (4, 8):
        pl = gk.tile_plan(kind, cells, itemsize)
        assert pl.smem == gk.smem_bytes(kind, itemsize)
        assert pl.smem <= gk.SMEM_BLOCK
        assert pl.ctas_per_sm >= 1
        nch, nty, ntz = pl.grid
        (ty, tz), ctas = pl.tile, nch * nty * ntz
        # one wave unless the rows cannot be cut finer
        assert ctas <= gk.SMS * pl.ctas_per_sm or pl.chunk == 1
        hits = np.zeros(cells, np.int32)
        for c in range(nch):
            x0, x1 = c * pl.chunk, min((c + 1) * pl.chunk, nx)
            assert x0 < x1
            # the input rows the chunk reads lie in a slab's padded rows
            assert halo == 0 or (halo + x0 - gk.REACH >= 0
                                 and halo + x1 + gk.REACH <= nx + 2 * halo)
            for a in range(nty):
                for b in range(ntz):
                    hits[x0:x1, a * ty:(a + 1) * ty,
                         b * tz:(b + 1) * tz] += 1
        assert (hits == 1).all(), (kind, itemsize)


@pytest.mark.parametrize("cells,halo", PLAN_CASES)
def test_tile_plan_fits_and_covers_every_output_once(cells, halo):
    for kind in ("advect", "predict_d"):
        _check_tile_plan(kind, cells, halo)


@pytest.mark.parametrize("cells,halo", PLAN_CASES)
def test_uad_tile_plan_fits_and_covers_every_output_once(cells, halo):
    """uad's plan (a fused x-march on the same tiles): its ring of the
    three components' planes fits, and it reaches REACH rows."""
    _check_tile_plan("uad", cells, halo)
