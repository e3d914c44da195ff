"""EB cut-cell operators of incflo_torch against incflo_tpu (ROADMAP
A11), float64, from seeded fields, on the geometry of channel_cyl (16 x
8 x 8: walls on x and y, the cylinder a body) and poiseuille_cyl_bingham
(16 x 16 x 8, fully periodic, the fluid inside the cylinder):

  * eb/ops.py: the cut-cell convective rate, the redistribution (which
    also conserves sum(vfrac q) on the periodic deck), the small-cell
    correction, the one-sided derivatives, strain rate and vorticity;
  * eb/mol.py: the least-squares slopes, the centroid face states, the
    MOL-EB face velocities and fluxes;
  * the EB terms of ops/diffusion.py (face-centroid eta, the wall
    coefficient, the three second-order corrections, the wall probe
    read, divtau, the tracer Laplacian) and of ops/rheology.py (the
    viscosity with one-sided strain rates at cut cells).

Each within 1e-12 of incflo_tpu's (relative to the field's max).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.eb import mol as jmol
from incflo_tpu.eb import ops as jops
from incflo_tpu.ops import diffusion as jdiff
from incflo_tpu.ops import rheology as jrheo

from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.eb import mol as tmol
from incflo_torch.eb import ops as tops
from incflo_torch.ops import diffusion as tdiff
from incflo_torch.ops import rheology as trheo

import torch_parity as tp

NG = 3
TOL = 1e-12
DECKS = ("channel_cyl", "poiseuille_cyl_bingham")


@pytest.fixture(scope="module", params=DECKS)
def eb(request):
    text = tp.eb_deck(request.param, 16)
    je, te, jg, tg = tp.eb_arrays(text)
    return (request.param, text, je, te, jg, tg,
            JConfig.from_text(text), TConfig.from_text(text))


def _grown(tg, ncomp, seed, ng=NG):
    shape = tuple(n + 2 * ng for n in tg.n_cell) + (ncomp,)
    return np.random.default_rng(seed).standard_normal(shape)


def _faces(tg, ncomp, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(n + (a == d) for a, n in
                                      enumerate(tg.n_cell)) + (ncomp,))
            for d in range(tg.ndim)]


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_convective_rate_and_redistribution(eb):
    name, _, je, te, jg, tg, _, _ = eb
    fl = _faces(tg, 2, 1)
    jr = jops.eb_convective_rate([_j(f) for f in fl], jg, je)
    tr = tops.eb_convective_rate([_t(f) for f in fl], tg, te)
    assert tp.rel(tr.numpy(), jr) <= TOL
    q = tp.masked_random(tuple(tg.n_cell) + (2,), je.fluid, 2)
    jq = jops.redistribute(_j(q), jg, je)
    tq = tops.redistribute(_t(q), tg, te)
    assert tp.rel(tq.numpy(), jq) <= TOL
    if name == "poiseuille_cyl_bingham":      # periodic: nothing leaves
        vf = te.vfrac.numpy()[..., None]
        assert np.abs((vf * tq.numpy()).sum(axis=(0, 1, 2))
                      - (vf * q).sum(axis=(0, 1, 2))).max() <= 1e-12 \
            * np.abs(vf * q).sum()


def test_small_cell_correction(eb):
    _, _, je, te, jg, tg, _, _ = eb
    vel = tp.masked_random(tuple(tg.n_cell) + (3,), je.fluid, 3)
    umac = [f[..., 0] for f in _faces(tg, 1, 4)]
    # mark every cut cell small so that the correction acts somewhere
    je2 = je._replace(small=je.cut)
    te2 = tops.dataclasses.replace(te, small=te.cut)
    got = tops.correct_small_cells(_t(vel), [_t(u) for u in umac], tg, te2)
    want = jops.correct_small_cells(_j(vel), [_j(u) for u in umac], jg, je2)
    assert tp.rel(got.numpy(), want) <= TOL
    assert not np.allclose(got.numpy(), vel)


@pytest.mark.parametrize("comp,axis", [(0, 0), (1, 2), (2, 1)])
def test_one_sided_derivative(eb, comp, axis):
    _, _, je, te, jg, tg, _, _ = eb
    v = _grown(tg, 3, 5)
    got = tops.eb_cc_derivative(_t(v), comp, axis, tg, NG, te)
    want = jops.eb_cc_derivative(_j(v), comp, axis, jg, NG, je)
    assert tp.rel(got.numpy(), want) <= TOL


def test_strainrate_vorticity_and_viscosity(eb):
    _, _, je, te, jg, tg, jc, tc = eb
    v = _grown(tg, 3, 6)
    for f in ("eb_strainrate", "eb_vorticity"):
        got = getattr(tops, f)(_t(v), tg, NG, te)
        want = getattr(jops, f)(_j(v), jg, NG, je)
        assert tp.rel(got.numpy(), want) <= TOL, f
    bingham = "incflo.fluid_model = bingham\nincflo.tau_0 = 1.\n" \
        "incflo.papa_reg = 0.01\n"
    jcb = JConfig.from_text(tp.eb_deck(eb[0], 16) + bingham)
    tcb = TConfig.from_text(tp.eb_deck(eb[0], 16) + bingham)
    got = trheo.compute_viscosity(_t(v), tg, NG, tcb, out_ng=1, eb=te)
    want = jrheo.compute_viscosity(_j(v), jg, NG, jcb, out_ng=1, eb=je)
    assert tp.rel(got.numpy(), want) <= TOL


def test_lsq_slopes_and_face_states(eb):
    _, _, je, te, jg, tg, _, _ = eb
    q = _grown(tg, 1, 7)[..., 0]
    js = jmol.lsq_slopes(_j(q), jg, NG, je)
    ts = tmol.lsq_slopes(_t(q), tg, NG, te)
    assert tp.rel(ts.numpy(), js) <= TOL
    for d in range(3):
        for a, b in zip(tmol.face_states(_t(q), ts, d, tg, NG, te),
                        jmol.face_states(_j(q), js, d, jg, NG, je)):
            assert tp.rel(a.numpy(), b) <= TOL


def test_lsq_slopes_are_exact_for_linear_fields(eb):
    """sum_connected (q(i+off) - q(i) - s.delta)^2 is zero for q linear in
    the centroid positions, so the slope is its gradient wherever a cell
    sees neighbours along every axis."""
    _, _, _, te, _, tg, _, _ = eb
    g = np.array([0.3, -1.2, 0.7])
    shape = tuple(n + 2 * NG for n in tg.n_cell)
    idx = np.indices(shape).transpose(1, 2, 3, 0) - NG
    cent = np.zeros(shape + (3,))
    cent[tuple(slice(NG - 2, NG - 2 + s) for s in
               te.ccent_g2.shape[:3])] = te.ccent_g2.numpy()
    q = ((idx + cent) * g).sum(-1)
    s = tmol.lsq_slopes(torch.as_tensor(q), tg, NG, te).numpy()
    full = (te.conn_g1.numpy().sum(0) == 26)
    assert full.sum() > 0
    assert np.abs(s[full] - g).max() <= 1e-10


def test_mol_eb_faces_and_fluxes(eb):
    _, _, je, te, jg, tg, jc, tc = eb
    vel = _grown(tg, 3, 8)
    jv = jmol.predict_vels_on_faces_eb(_j(vel), jg, NG,
                                       jc.velocity_bcrecs(), je)
    tv = tmol.predict_vels_on_faces_eb(_t(vel), tg, NG,
                                       tc.velocity_bcrecs(), te)
    for d in range(3):
        assert tp.rel(tv[d].numpy(), jv[d]) <= TOL
    q = _grown(tg, 2, 9)
    jf = jmol.compute_convective_fluxes_eb(_j(q), jv, jg, NG,
                                           jc.tracer_bcrecs()[:1].repeat(
                                               2, axis=0), je)
    tf = tmol.compute_convective_fluxes_eb(_t(q), tv, tg, NG,
                                           tc.tracer_bcrecs()[:1].repeat(
                                               2, axis=0), te)
    for d in range(3):
        assert tp.rel(tf[d].numpy(), jf[d]) <= TOL


def test_diffusion_eb_terms(eb):
    _, _, je, te, jg, tg, jc, tc = eb
    eta_g1 = 1.0 + np.random.default_rng(10).random(
        tuple(n + 2 for n in tg.n_cell))
    jf = jdiff.eta_to_faces(_j(eta_g1), jg, eb=je)
    tf = tdiff.eta_to_faces(_t(eta_g1), tg, eb=te)
    for d in range(3):
        assert tp.rel(tf[d].numpy(), jf[d]) <= TOL
    eta_c = eta_g1[1:-1, 1:-1, 1:-1]
    jw = jdiff._eb_wall_coef(_j(eta_c), jg, je)
    tw = tdiff._eb_wall_coef(_t(eta_c), tg, te)
    assert tp.rel(tw.numpy(), jw) <= TOL
    u = _grown(tg, 3, 11)
    checks = [
        (tdiff._eb_wall_correction(_t(u), _t(eta_c), tw, tg, te, NG),
         jdiff._eb_wall_correction(_j(u), _j(eta_c), jw, jg, je, NG)),
        (tdiff._eb_centroid_flux_correction(
            _t(u), [f[..., None] for f in tf], tg, te, NG),
         jdiff._eb_centroid_flux_correction(
             _j(u), [f[..., None] for f in jf], jg, je, NG)),
        (tdiff._eb_centroid_state_correction(
            _t(u), [f[..., None] for f in tf], tg, te, NG),
         jdiff._eb_centroid_state_correction(
             _j(u), [f[..., None] for f in jf], jg, je, NG))]
    u_c = u[NG:-NG, NG:-NG, NG:-NG]
    for k in range(2):
        checks.append((tdiff._probe_interp(_t(u_c), te, tg, k),
                       jdiff._probe_interp(_j(u_c), je, jg, k)))
    for i, (got, want) in enumerate(checks):
        assert tp.rel(got.numpy(), want) <= TOL, i
    # divtau (the wall drag and the corrections, divided by vfrac) and
    # the tracer Laplacian (no-flux EB walls)
    vel = u_c * te.fluid.numpy()[..., None]
    rho = 1.0 + 0.1 * np.random.default_rng(12).random(tuple(tg.n_cell))
    got = tdiff.compute_divtau(_t(vel), _t(u), _t(rho), tf, _t(eta_g1), tc,
                               tg, NG, eb=te)
    want = jdiff.compute_divtau(_j(vel), _j(u), _j(rho), jf, _j(eta_g1), jc,
                                jg, NG, eb=je)
    assert tp.rel(got.numpy(), want) <= TOL
    tra = np.random.default_rng(13).random(tuple(tg.n_cell) + (1,))
    got = tdiff.compute_laps(_t(tra), [tf], tc, tg, eb=te)
    want = jdiff.compute_laps(_j(tra), [jf], jc, jg, eb=je)
    assert tp.rel(got.numpy(), want) <= TOL
