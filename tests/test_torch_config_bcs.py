"""incflo_torch deck layer, ghost fill, state transfer and initial
conditions against incflo_tpu.

Tolerance: exact.  Both packages parse the same text with the same
numpy code, and the ghost fill only copies, flips and combines values
in the same order, so the results must be bit-equal.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax.numpy as jnp

import bench
from incflo_tpu import bcs as jbcs
from incflo_tpu import probs as jprobs
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.grid import Grid as JGrid

from incflo_torch import bcs as tbcs
from incflo_torch import probs as tprobs
from incflo_torch import state as tstate
from incflo_torch.config import IncfloConfig as TConfig
from incflo_torch.grid import Grid as TGrid

DECKS = ["shear3d", "tgv2d", "rt", "poiseuille_cyl_bingham", "channel_cyl"]


def _same(a, b):
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        return int(a) == int(b)
    if dataclasses.is_dataclass(a):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("deck", DECKS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_config_fields_equal(deck, dtype):
    text, _ = bench._deck(deck, 32, dtype)
    j, t = JConfig.from_text(text), TConfig.from_text(text)
    names = [f.name for f in dataclasses.fields(JConfig)]
    assert names == [f.name for f in dataclasses.fields(TConfig)]
    for name in names:
        if name == "pp":
            assert j.pp.dump() == t.pp.dump()
            continue
        assert _same(getattr(j, name), getattr(t, name)), name
    assert np.array_equal(j.velocity_bcrecs(), t.velocity_bcrecs())
    assert np.array_equal(j.tracer_bcrecs(), t.tracer_bcrecs())


def _random_bcrecs(rng, ncomp, ndim, periodic):
    choices = [tbcs.BCType.ext_dir, tbcs.BCType.foextrap,
               tbcs.BCType.hoextrap, tbcs.BCType.reflect_even,
               tbcs.BCType.reflect_odd]
    rec = np.zeros((ncomp, ndim, 2), np.int32)
    for c in range(ncomp):
        for ax in range(ndim):
            for side in range(2):
                rec[c, ax, side] = (int(tbcs.BCType.int_dir) if periodic[ax]
                                    else int(rng.choice(choices)))
    return rec


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("walled", [False, True])
def test_grow_bit_equal(ndim, walled):
    rng = np.random.default_rng(10 * ndim + walled)
    n_cell = (12, 10, 8)[:ndim]
    periodic = (True,) * ndim if not walled else \
        (False,) + (True,) * (ndim - 2) + (False,)
    kw = dict(n_cell=n_cell, prob_lo=(0.0,) * ndim,
              prob_hi=(1.0, 0.8, 0.5)[:ndim], periodic=periodic)
    jg, tg = JGrid(**kw), TGrid(**kw)
    ncomp = ndim
    bcrec = _random_bcrecs(rng, ncomp, ndim, periodic)
    # inflow profile on the lo x face (probtype 31 scales by 6 y (1-y))
    vals = rng.standard_normal((ndim, 2, ncomp))
    field = rng.standard_normal(n_cell + (ncomp,))
    for ng in (1, 3, (2, 1, 3)[:ndim]):
        jev = jbcs.ExtDirValues(jg, vals, probtype=31)
        tev = tbcs.ExtDirValues(tg, vals, probtype=31)
        a = np.asarray(jbcs.grow(jnp.asarray(field), ng, jg, bcrec, jev))
        b = tbcs.grow(torch.as_tensor(field), ng, tg, bcrec, tev).numpy()
        assert a.shape == b.shape
        assert np.array_equal(a, b), ng
        a = np.asarray(jbcs.grow_scalar(jnp.asarray(field[..., 0]), ng, jg,
                                        bcrec[:1]))
        b = tbcs.grow_scalar(torch.as_tensor(field[..., 0]), ng, tg,
                             bcrec[:1]).numpy()
        assert np.array_equal(a, b), ng


def test_state_round_trip_and_init_fluid():
    text, _ = bench._deck("shear3d", 16, "float64")
    jcfg, tcfg = JConfig.from_text(text), TConfig.from_text(text)
    jl = jprobs.init_fluid(jcfg, jcfg.grid, jnp.float64)
    tl = tprobs.init_fluid(tcfg, tcfg.grid, torch.float64, "cpu")
    for f in tstate.LevelState._fields:
        a, b = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-15, err_msg=f)
    d = {f: np.asarray(getattr(jl, f)) for f in tstate.LevelState._fields}
    back = tstate.level_to_numpy(tstate.level_from_numpy(d, "cpu",
                                                         torch.float64))
    for f, a in d.items():
        assert np.array_equal(a, back[f]), f


def test_other_probtypes_raise():
    """Every probtype of incflo_tpu is ported (6, the slanted EB channel,
    with ROADMAP A11); an unknown one raises as incflo_tpu's does."""
    text, _ = bench._deck("shear3d", 16, "float64")
    cfg = TConfig.from_text(text + "incflo.probtype = 7\n")
    with pytest.raises(ValueError, match="unknown probtype 7"):
        tprobs.init_fluid(cfg, cfg.grid, torch.float64, "cpu")
