"""2D Godunov, use_forces_in_trans and use_mac_phi_in_godunov in
incflo_torch against incflo_tpu (ROADMAP A8).

The chain (float64, smooth O(1) fields from a numpy seed, to 1e-11 of
each field's max): GodunovScheme.predict and advect on a 2D grid,
periodic and with no-slip y walls, PPM and PLM, in three forms -- plain,
with the forces in the transverse traces (use_forces_in_trans), and with
the MAC-phi face gradient of use_mac_phi_in_godunov -- against
incflo_tpu's GodunovScheme on the same grown fields; and a 3D periodic
grid with use_forces_in_trans, which both packages send past their
kernels to the general chain.

The step: init + 3 steps of the 2D Godunov tgv2d (bench.py's tgv2d at
16^2 with incflo.use_godunov = true) in the same three forms, every
field and dt within 1e-10 of incflo_tpu's, every iterative solve ending
on the same iteration.

The routing: one step of a 3D periodic shear3d deck with
use_forces_in_trans calls none of the Godunov kernel wrappers and moves
no launch counter; one with use_mac_phi_in_godunov calls no predict
wrapper (its predict takes the MAC-phi gradient, as incflo_tpu's, in
the general chain) and the advect wrapper once for every advect, as
incflo_tpu/ops/godunov.py:648 sends that option's advect to its kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu import bcs as jbcs
from incflo_tpu.grid import Grid as JGrid
from incflo_tpu.ops import godunov as jgod

from incflo_torch.grid import Grid as TGrid
from incflo_torch.ops import godunov as tgod
from incflo_torch.ops import godunov_kernels as gk

import bench
import torch_parity as tp

DT = 0.02
NG = 4
FORMS = ("plain", "uft", "gmacphi")
EXTRA = {"plain": "",
         "uft": "incflo.godunov_use_forces_in_trans = true\n",
         "gmacphi": "incflo.use_mac_phi_in_godunov = true\n"}


def _setup(n_cell, walled):
    nd = len(n_cell)
    periodic = (True, not walled) if nd == 2 else (True,) * 3
    kw = dict(n_cell=n_cell, prob_lo=(0.0,) * nd,
              prob_hi=tuple(0.1 * n for n in n_cell), periodic=periodic)
    kind = np.zeros((nd, 2), np.int32)
    if walled:
        kind[1, :] = int(jbcs.BCKind.no_slip_wall)
    return (JGrid(**kw), TGrid(**kw), jbcs.velocity_bcrecs(kind, nd),
            jbcs.scalar_bcrecs(kind, 1, nd), jbcs.force_bcrecs(kind, nd, nd))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.tensor(np.asarray(a))


def _chain(n_cell, walled, use_ppm, form, seed):
    """The predict and advect of both packages on the same grown fields:
    (incflo_tpu's, the port's) MAC velocities, velocity rates and
    density rates."""
    jg, tg, vb, sb, fb = _setup(n_cell, walled)
    nd = len(n_cell)
    rng = np.random.default_rng(seed)
    vel = 0.5 * rng.standard_normal(n_cell + (nd,))
    forces = rng.standard_normal(n_cell + (nd,))
    rho = 2.0 + rng.standard_normal(n_cell + (1,))
    gmac = None
    if form == "gmacphi":
        gmac = [rng.standard_normal(tuple(n + (a == d)
                                          for a, n in enumerate(n_cell)))
                for d in range(nd)]
        if walled:      # the MAC fluxes through a Neumann wall are zero
            gmac[1][:, 0] = gmac[1][:, -1] = 0.0
    uft = form == "uft"
    vel_g = jbcs.grow(jnp.asarray(vel), NG, jg, vb)
    f_g = jbcs.grow(jnp.asarray(forces), 1, jg, fb)
    rho_g = jbcs.grow(jnp.asarray(rho), NG, jg, sb)
    js = jgod.GodunovScheme(jg, use_ppm, uft)
    ts = tgod.GodunovScheme(tg, use_ppm, uft)
    ju = js.predict(vel_g, f_g, DT, NG, vb,
                    gmacphi=None if gmac is None
                    else [jnp.asarray(g) for g in gmac])
    tu = ts.predict(_t(vel_g), _t(f_g), DT, NG, np.asarray(vb),
                    gmacphi=None if gmac is None
                    else [torch.as_tensor(g) for g in gmac])
    jv = js.advect(vel_g, ju, f_g, DT, NG, vb, [0] * nd, True)
    tv = ts.advect(_t(vel_g), tu, _t(f_g), DT, NG, np.asarray(vb),
                   [0] * nd, True)
    jr = js.advect(rho_g, ju, None, DT, NG, sb, [1], False)
    tr = ts.advect(_t(rho_g), tu, None, DT, NG, np.asarray(sb), [1], False)
    return (ju, jv, jr), (tu, tv, tr)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("use_ppm", [True, False], ids=["ppm", "plm"])
@pytest.mark.parametrize("walled", [False, True],
                         ids=["periodic", "noslip_y"])
def test_2d_chain_matches_incflo_tpu(walled, use_ppm, form):
    n0 = dict(gk.LAUNCHES)
    (ju, jv, jr), (tu, tv, tr) = _chain((12, 10), walled, use_ppm, form,
                                        seed=11)
    for d in range(2):
        assert _rel(tu[d].numpy(), ju[d]) <= 1e-11, d
    if walled:          # no flow through the walls
        assert float(tu[1][:, 0].abs().max()) == 0.0
        assert float(tu[1][:, -1].abs().max()) == 0.0
    assert _rel(tv.numpy(), jv) <= 1e-11
    assert _rel(tr.numpy(), jr) <= 1e-11
    assert gk.LAUNCHES == n0


@pytest.mark.parametrize("use_ppm", [True, False], ids=["ppm", "plm"])
def test_3d_forces_in_trans_chain_matches_incflo_tpu(use_ppm):
    (ju, jv, jr), (tu, tv, tr) = _chain((8, 6, 4), False, use_ppm, "uft",
                                        seed=12)
    for d in range(3):
        assert _rel(tu[d].numpy(), ju[d]) <= 1e-11, d
    assert _rel(tv.numpy(), jv) <= 1e-11
    assert _rel(tr.numpy(), jr) <= 1e-11


def test_forces_in_trans_changes_the_faces():
    """The forces enter the traces, not only the final states: the two
    placements give different faces (so the uft cases above test
    something)."""
    (_, _, _), (tu, _, _) = _chain((12, 10), False, True, "plain", seed=13)
    (_, _, _), (tw, _, _) = _chain((12, 10), False, True, "uft", seed=13)
    assert max(float((a - b).abs().max()) for a, b in zip(tu, tw)) > 1e-6


# ---------------------------------------------------------------------
# whole steps: the 2D Godunov tgv2d
# ---------------------------------------------------------------------

def _tgv2d_godunov(form):
    return (bench._deck("tgv2d", 16, "float64")[0]
            + "incflo.use_godunov = true\n" + EXTRA[form])


@pytest.fixture(scope="module", params=FORMS)
def tgv2d(request):
    text = _tgv2d_godunov(request.param)
    _, runs = tp.reference_run(text, 3)
    return text, runs[0]


def test_tgv2d_godunov_matches_incflo_tpu(tgv2d):
    text, (states, iters) = tgv2d
    sim = tp.port_sim(text)
    assert sim.grid.ndim == 2 and sim.cfg.use_godunov
    n0 = dict(gk.LAUNCHES)
    _, worst, _ = tp.compare_run(sim, sim.init_state(), states, iters)
    assert worst <= 1e-10
    assert gk.LAUNCHES == n0


# ---------------------------------------------------------------------
# routing: uft never reaches the kernels, the MAC-phi warm start only
# in predict
# ---------------------------------------------------------------------

class _KernelCalled(Exception):
    pass


@pytest.mark.parametrize("form", ["uft", "gmacphi"])
def test_3d_periodic_deck_launches_no_godunov_kernel(monkeypatch, form):
    def refuse(*args, **kwargs):
        raise _KernelCalled()
    refused = ("predict", "predict_sharded", "advect_sharded", "uad",
               "predict_d")
    if form == "uft":
        refused += ("advect", "advect_comp")
    for name in refused:
        monkeypatch.setattr(gk, name, refuse)
    calls = {"scheme": 0, "kernel": 0}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(tgod.GodunovScheme, "advect",
                        counted(tgod.GodunovScheme.advect, "scheme"))
    if form == "gmacphi":
        monkeypatch.setattr(gk, "advect", counted(gk.advect, "kernel"))
    text = bench._deck("shear3d", 16, "float64")[0] + EXTRA[form]
    sim = tp.port_sim(text)
    assert all(sim.grid.periodic) and sim.grid.ndim == 3
    n0 = dict(gk.LAUNCHES)
    s = sim.advance(sim.init_state())
    assert gk.LAUNCHES == n0          # the CPU runs the plain versions
    assert bool(torch.isfinite(s.level.velocity).all())
    assert calls["scheme"] > 0
    if form == "gmacphi":
        assert float(s.level.mac_phi.abs().max()) > 0.0
        assert calls["kernel"] == calls["scheme"]
    else:
        assert calls["kernel"] == 0
