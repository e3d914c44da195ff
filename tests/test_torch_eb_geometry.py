"""EB geometry of incflo_torch against incflo_tpu (ROADMAP A11):
compute_eb_data for both bench.py cylinders (channel_cyl at 32 x 16 x 8,
poiseuille_cyl_bingham at 16 x 16 x 8) and a 2D circle -- volume and
area fractions, flags, EB area and normal, cell and face centroids,
octant fractions and wall distances within 1e-12 -- the same bits from
the threaded sub-box integrals as from one thread, the port's own
build of the C++ box integrator (csrc/eb_geometry.cpp) against its numpy
form, a build failure that raises with the compiler's message, the
static cut-cell arrays of build_eb_arrays, and the STL surface writer.
"""

import numpy as np
import pytest

from incflo_tpu.eb import surface as jsurf
from incflo_torch.eb import geometry as tgeom
from incflo_torch.eb import surface as tsurf

import torch_parity as tp

DECKS = {"channel_cyl": tp.eb_deck("channel_cyl", 32),
         "poiseuille_cyl_bingham": tp.eb_deck("poiseuille_cyl_bingham", 16),
         "circle2d": tp.eb_deck("circle2d")}
FIELDS = ("vfrac", "flags", "eb_area", "eb_normal", "centroid",
          "vfrac_oct", "wall_dist")


@pytest.fixture(scope="module", params=list(DECKS))
def geometry(request):
    return (request.param,) + tp.eb_geometry(DECKS[request.param])


def test_eb_data_matches_incflo_tpu(geometry):
    name, jd, td, jg, tg = geometry
    assert td.has_eb and jd.has_eb
    for f in FIELDS:
        a = np.asarray(getattr(jd, f), np.float64)
        b = np.asarray(getattr(td, f), np.float64)
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-12, f
    for d in range(tg.ndim):
        assert np.abs(jd.afrac[d] - td.afrac[d]).max() <= 1e-12
        assert np.abs(jd.face_cent[d] - td.face_cent[d]).max() <= 1e-12
    flags = np.asarray(td.flags)
    assert (flags == tgeom.CUT).any() and (flags == tgeom.COVERED).any()


def test_threaded_sub_box_integrals_give_the_same_bits(geometry,
                                                      monkeypatch):
    """A level of THREADED_CELLS cells or more integrates its centroids'
    and face fractions' sub-box offsets on threads: the same EBData bits
    as one thread (the threshold lowered so these small levels take the
    threaded path)."""
    import incflo_torch
    name = geometry[0]
    cfg = incflo_torch.IncfloConfig.from_text(DECKS[name])
    phi_if = tgeom.make_eb_geometry(cfg.eb_geometry, cfg.pp, cfg.grid)
    monkeypatch.setattr(tgeom, "THREADED_CELLS", 1 << 62)
    one = tgeom.compute_eb_data(phi_if, cfg.grid)
    monkeypatch.setattr(tgeom, "THREADED_CELLS", 1)
    threaded = tgeom.compute_eb_data(phi_if, cfg.grid)
    for f in FIELDS:
        assert np.array_equal(getattr(one, f), getattr(threaded, f)), f
    for d in range(cfg.grid.ndim):
        assert np.array_equal(one.afrac[d], threaded.afrac[d])
        assert np.array_equal(one.face_cent[d], threaded.face_cent[d])


def test_eb_arrays_match_incflo_tpu(geometry):
    name, _, _, _, _ = geometry
    je, te, _, _ = tp.eb_arrays(DECKS[name])
    assert te.offsets == je.offsets
    for f in ("vfrac", "cut", "covered", "fluid", "small", "eb_area",
              "nbr_conn", "vtot", "wtot_inv", "ccent_g2", "conn_g1",
              "lsq_minv_g1", "near_g1", "vfrac_oct", "wall_dist", "area_ov",
              "eb_normal", "probe_lo", "probe_frac", "probe_ok", "probe_nn",
              "probe_c2ok"):
        a, b = np.asarray(getattr(je, f)), getattr(te, f).numpy()
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-12, f
    for d in range(len(te.afrac)):
        assert np.array_equal(np.asarray(je.afrac[d]), te.afrac[d].numpy())
        assert np.abs(np.asarray(je.face_cent[d])
                      - te.face_cent[d].numpy()).max() <= 1e-12


@pytest.mark.parametrize("nd", [2, 3])
def test_native_integrator_matches_its_numpy_form(nd):
    """The box fractions of a sphere's (2D: a circle's) level set on a
    refine-4 node lattice, and of a random level set (every sign
    pattern).  Where a box's level set is constant along an axis (an
    axis-aligned cylinder) the eps-regularised plane formula is
    ill-conditioned and the two forms part by up to ~1e-6; both packages
    integrate with the C++ form, which the EBData test holds bit for
    bit."""
    s = 4
    n = (10, 7, 5)[:nd]
    coords = np.meshgrid(*[np.arange(m * s + 1) / (m * s) for m in n],
                         indexing="ij")
    smooth = sum((c - o) ** 2 for c, o in zip(coords, (0.45, 0.55, 0.5))) \
        - 0.3 ** 2
    rough = np.random.default_rng(5).standard_normal(smooth.shape)
    for phi in (smooth, rough):
        got = tgeom._box_fraction_native(phi, s, nd)
        want = tgeom._box_fraction_plain(phi, s, nd)
        assert got.shape == n
        assert np.abs(got - want).max() <= 1e-12
    assert 0.0 < got.min() < got.max() < 1.0


def test_failed_native_build_raises_with_the_compiler_message(
        tmp_path, monkeypatch):
    bad = tmp_path / "eb_geometry.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tgeom, "NATIVE_SOURCE", bad)
    monkeypatch.setattr(tgeom, "_NATIVE", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*eb_geometry"):
        tgeom.native_lib()


def test_surface_matches_incflo_tpu(geometry, tmp_path):
    name, jd, td, jg, tg = geometry
    jsurf.write_eb_surface(str(tmp_path / "j.stl"), jd, jg)
    tsurf.write_eb_surface(str(tmp_path / "t.stl"), td, tg)
    want = (tmp_path / "j.stl").read_text().replace("incflo_tpu_eb",
                                                    "incflo_torch_eb")
    got = (tmp_path / "t.stl").read_text()
    assert got == want and got.count("facet normal") > 0
