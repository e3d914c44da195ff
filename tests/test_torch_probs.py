"""The initial conditions of incflo_torch/probs.py against incflo_tpu's
probs.init_fluid: every ported probtype, in 3D and (where the reference
defines it) in 2D, on a grid with an offset, non-cubic domain, a
non-default ro_0, (ic_u, ic_v, ic_w) and three tracers.  Every field
(velocity, density, tracer, gp, p, mac_phi) to 1e-14 relative to its max
(the same numpy coordinates; torch's and XLA's sin, cos, exp and tanh may
differ in the last bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incflo_tpu import probs as jprobs
from incflo_tpu.config import IncfloConfig as JConfig

from incflo_torch import probs as tprobs
from incflo_torch import state as tstate
from incflo_torch.config import IncfloConfig as TConfig

import torch_parity as tp

BASE = tp.shear3d_deck(8).split("amr.n_cell")[0]
GRID3 = """amr.n_cell = 12 10 8
geometry.prob_lo = 0.1 -0.2 0.3
geometry.prob_hi = 1.3 0.6 0.8
geometry.is_periodic = 1 1 1
"""
GRID2 = """amr.n_cell = 12 10
geometry.prob_lo = 0.1 -0.2
geometry.prob_hi = 1.3 0.6
geometry.is_periodic = 1 1
"""
IC = """incflo.ro_0 = 1.3
incflo.ic_u = 0.7
incflo.ic_v = -0.4
incflo.ic_w = 0.25
incflo.ntrac = 3
incflo.mu_s = 0.001 0.002 0.003
"""
PROBTYPES_3D = [0, 114, 1, 2, 3, 4, 5, 11, 111, 112, 113, 12, 21, 22, 23,
                31, 311, 32, 322, 33, 333, 41]
PROBTYPES_2D = [0, 1, 2, 4, 5, 11, 111, 12, 21, 31, 322]


def _text(nd, probtype):
    return BASE + (GRID3 if nd == 3 else GRID2) + IC + \
        f"incflo.probtype = {probtype}\n"


def _check(nd, probtype):
    text = _text(nd, probtype)
    jcfg, tcfg = JConfig.from_text(text), TConfig.from_text(text)
    want = jprobs.init_fluid(jcfg, jcfg.grid, jnp.float64)
    got = tprobs.init_fluid(tcfg, tcfg.grid, torch.float64, "cpu")
    for f in tstate.LevelState._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-14 * max(np.abs(b).max(), 1e-300), f
    return got


@pytest.mark.parametrize("probtype", PROBTYPES_3D)
def test_init_fluid_3d_matches(probtype):
    got = _check(3, probtype)
    # every probtype sets something beyond the zero state
    assert float(got.velocity.abs().max()) > 0 or \
        float(got.tracer.abs().max()) > 0


@pytest.mark.parametrize("probtype", PROBTYPES_2D)
def test_init_fluid_2d_matches(probtype):
    _check(2, probtype)


def test_slanted_channel_raises_naming_a11():
    """probtype 6 (the rotated EB cylinder channel) is ported with ROADMAP
    A11: without a cylinder rotation it is the uniform start, as in
    incflo_tpu (tests/test_torch_eb_probtype6.py holds the rotated
    form); an unknown probtype is refused as by incflo_tpu."""
    _check(3, 6)
    _check(2, 6)
    cfg = TConfig.from_text(_text(3, 7))
    with pytest.raises(ValueError, match="unknown probtype 7"):
        tprobs.init_fluid(cfg, cfg.grid, torch.float64, "cpu")
    jcfg = JConfig.from_text(_text(3, 7))
    with pytest.raises(ValueError, match="unknown probtype 7"):
        jprobs.init_fluid(jcfg, jcfg.grid, jnp.float64)
