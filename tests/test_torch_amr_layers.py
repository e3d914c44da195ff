"""The host and interpolation layers of incflo_torch's AMR against
incflo_tpu's (ROADMAP A13), on seeded inputs: the ErrorEst tags, the
slab and box clustering, and the parent-to-child prolongations and the
average-down.  Float64; the numpy layers are equal, the interpolations
within 1e-13 relative.  The patch context and the dense mode are
tests/test_torch_amr_context.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu import amr_patch as jap
from incflo_tpu.config import IncfloConfig as JConfig

import incflo_torch
from incflo_torch import amr_patch as tap

import torch_parity as tp


def _close(a, b, tol=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert tp.rel(a, b) <= tol


# ---------------------------------------------------------------------
# tags and clustering
# ---------------------------------------------------------------------

@pytest.mark.parametrize("lev,extra", [
    (0, "incflo.gradrhoerr = 0.3\n"),
    (1, "incflo.gradrhoerr = 0.5 0.9\nincflo.rhoerr = 1.5 1.97\n"),
    (3, "incflo.rhoerr = 1.3\nincflo.tag_region = true\n"
        "incflo.tag_region_lo = 0.1 0.2\nincflo.tag_region_hi = 0.3 0.9\n"),
], ids=["gradient", "per_level", "region"])
def test_compute_tags(lev, extra):
    text = tp.BOX_DECK.replace("incflo.tag_region = true", "") + extra
    jc, tc = JConfig.from_text(text), incflo_torch.IncfloConfig.from_text(text)
    rho = 1.0 + np.random.default_rng(lev).random(tc.grid.cell_shape)
    want = jap.compute_tags(jc, rho, jc.grid, lev=lev)
    got = tap.compute_tags(tc, torch.as_tensor(rho), tc.grid, lev=lev)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def _blobs(seed, shape, n):
    rng = np.random.default_rng(seed)
    tags = np.zeros(shape, bool)
    for _ in range(n):
        lo = [int(rng.integers(0, s - 6)) for s in shape]
        ext = [int(rng.integers(1, 6)) for _ in shape]
        tags[tuple(slice(l, l + e) for l, e in zip(lo, ext))] = True
    return tags


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_choose_slabs_and_boxes(seed):
    shape = (48, 32, 24)
    tags = _blobs(seed, shape, 2 + seed)
    for ax in range(3):
        for budget in (1, 2, 4):
            assert tap._choose_slabs(tags, ax, shape[ax], budget) \
                == jap._choose_slabs(tags, ax, shape[ax], budget)
    for budget in (1, 3, 4):
        assert tap._choose_boxes(tags, shape, budget) \
            == jap._choose_boxes(tags, shape, budget)


def test_empty_tags_keep_a_centred_patch():
    tags = np.zeros((16, 24), bool)
    assert tap._choose_slabs(tags, 1, 24) == jap._choose_slabs(tags, 1, 24)
    assert tap._choose_boxes(tags, (16, 24), 4) \
        == jap._choose_boxes(tags, (16, 24), 4)


# ---------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,periodic", [((6, 9, 3), (False, True)),
                                            ((5, 7, 4, 2),
                                             (True, False, False))])
def test_prolong_and_average_down_windows(shape, periodic):
    nd = len(periodic)
    a = np.random.default_rng(len(shape)).standard_normal(shape)
    t = torch.as_tensor(a)
    _close(tap._prolong_window(t, nd), jap._prolong_window(jnp.asarray(a),
                                                           nd))
    _close(tap._nodal_prolong_window(t, nd, periodic),
           jap._nodal_prolong_window(jnp.asarray(a), nd, periodic))
    even = np.random.default_rng(5).standard_normal(
        tuple(2 * n for n in shape[:nd]) + shape[nd:])
    _close(tap._avg_down_window(torch.as_tensor(even), nd),
           jap._avg_down_window(jnp.asarray(even), nd))
