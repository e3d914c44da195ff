"""The fused 2D step kernel's solve order and launch plan, on the CPU.

  * step2d_kernels.solve_panels_plain -- a direct solve in the kernel's
    order (the axis-1 forward transform of a row panel, then the column
    phase's axis-0 forward transform, eigenvalue divide and axis-0
    inverse, then the axis-1 inverse) -- against incflo_tpu's
    spectral.solve (axis 0 first), float64, on the same numpy-seeded
    rhs, for the three symbols of tgv2d decks at 24 x 16 and at a ragged
    36 x 20: the MAC symbol (singular, mask-form zero mode), the
    velocity Helmholtz symbol (two components, a0 + dtd lam) and the
    nodal symbol.  1e-12 relative: the same transforms in another order
    of the per-axis products.
  * step2d_kernels.launch_plan for every grid shape the kernel takes,
    4 x 4 to 256 x 256 (non-square, axes not a multiple of 8): a CTA's
    shared memory fits an H100 block in float32 and float64, and the
    panels cover every row and every column exactly once, also when the
    cooperative limit makes a CTA walk several panels.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax.numpy as jnp

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import spectral as jsp
from incflo_tpu.simulation import Simulation as JSim

import incflo_torch
from incflo_torch.ops import step2d_kernels as s2

DECKS = {
    "24x16": "amr.n_cell = 24 16\ngeometry.prob_hi = 1.5 1.\n",
    "36x20": "amr.n_cell = 36 20\ngeometry.prob_hi = 1.8 1.\n",
}
# (solver attribute, alpha, beta, singular, components)
SYMBOLS = {
    "mac": ("_mac_solver", 0.0, 1.0, True, ()),
    "velocity": ("_diff_proto", 1.0, 0.0137, False, (2,)),
    "nodal": ("_nodal_hat", 0.0, 1.0, True, ()),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def sims():
    out = {}
    for name, extra in DECKS.items():
        text = bench._deck("tgv2d", 16, "float64")[0] + extra
        out[name] = (JSim(JConfig.from_text(text)),
                     incflo_torch.Simulation(
                         incflo_torch.IncfloConfig.from_text(text),
                         device="cpu"))
    return out


@pytest.mark.parametrize("symbol", sorted(SYMBOLS))
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_solve_panels_plain_matches_spectral_solve(sims, deck, symbol):
    jsim, tsim = sims[deck]
    attr, alpha, beta, singular, comp = SYMBOLS[symbol]
    jsym = getattr(jsim, attr).symbol
    tsym = getattr(tsim, attr).symbol
    assert tsym.fwd is not None and tsym.cells == tuple(tsim.grid.n_cell)
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal(tsym.cells + comp)
    ref = jsp.solve(jsym, jnp.asarray(rhs), alpha, beta, singular)
    got = s2.solve_panels_plain(tsym, torch.as_tensor(rhs), alpha, beta,
                                singular)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-12


# grid shapes in the kernel's scope: 4 to 256 cells an axis, at most
# 65536 cells, square and not, axes a multiple of 8 and not
PLAN_SHAPES = [(4, 4), (4, 256), (256, 4), (5, 7), (24, 16), (36, 20),
               (100, 36), (128, 128), (200, 256), (256, 256)]


@pytest.mark.parametrize("cells", PLAN_SHAPES)
def test_launch_plan_fits_and_covers_every_row_and_column(cells):
    nx, ny = cells
    for itemsize in (4, 8):
        pl = s2.launch_plan(cells, itemsize)
        assert pl.smem == s2.smem_bytes(cells, itemsize)
        assert pl.smem <= s2.SMEM_BLOCK
        assert max(cells) <= s2.MAX_AXIS
        assert (pl.panel, pl.ktile) == (s2.PANEL, s2.KTILE[itemsize])
        assert pl.ctas == max(pl.row_panels, pl.col_panels)
        # the kernel launches min(ctas, cap) CTAs; CTA b takes panels b,
        # b + CTAs, ... of each kind
        for cap in (pl.ctas, 3, 1):
            nblk = min(pl.ctas, cap)
            rows, cols = np.zeros(nx, np.int32), np.zeros(ny, np.int32)
            for b in range(nblk):
                for p in range(b, pl.row_panels, nblk):
                    rows[p * pl.panel:min((p + 1) * pl.panel, nx)] += 1
                for p in range(b, pl.col_panels, nblk):
                    cols[p * pl.panel:min((p + 1) * pl.panel, ny)] += 1
            assert (rows == 1).all() and (cols == 1).all(), (cells, cap)
