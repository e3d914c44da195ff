"""Probtype 6, the slanted EB channel, in incflo_torch against
incflo_tpu (ROADMAP A11; tests/torch_parity.probtype6_deck): its initial
fields equal incflo_tpu's, and init + 3 steps in float64 from the deck's
init plus a smooth velocity perturbation from a seed match incflo_tpu
to 1e-10 with every iterative solve ending on the same iteration.
"""

import numpy as np
import pytest
import torch

from incflo_tpu import probs as jprobs
from incflo_tpu.config import IncfloConfig as JConfig

from incflo_torch import probs as tprobs
from incflo_torch.config import IncfloConfig as TConfig

import torch_parity as tp

SEED = 5


def test_probtype6_initial_fields_match_incflo_tpu():
    text = tp.probtype6_deck()
    jc, tc = JConfig.from_text(text), TConfig.from_text(text)
    import jax.numpy as jnp
    jl = jprobs.init_fluid(jc, jc.grid, jnp.float64)
    tl = tprobs.init_fluid(tc, tc.grid, torch.float64, "cpu")
    for f in tl._fields:
        assert np.array_equal(np.asarray(getattr(jl, f)),
                              getattr(tl, f).numpy()), f
    u = tl.velocity.numpy()
    assert np.allclose(u[..., 0], np.cos(np.pi / 6))
    assert set(np.unique(tl.tracer.numpy()[..., 1])) == {0.0, 2.0}


@pytest.fixture(scope="module")
def probtype6():
    text = tp.probtype6_deck()
    sim = tp.port_sim(text)
    pert = tp.fluid_perturbation(sim, SEED)
    _, runs = tp.reference_run(text, 3, (pert,))
    return text, pert, runs[0]


def test_probtype6_matches_incflo_tpu(probtype6):
    text, pert, (states, iters) = probtype6
    sim = tp.port_sim(text)
    assert sim.eb is not None
    _, worst, _ = tp.compare_run(sim, tp.own_start(sim, pert), states, iters)
    assert worst <= 1e-10
