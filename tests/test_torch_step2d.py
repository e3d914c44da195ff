"""The tgv2d step of incflo_torch (2D, periodic, MOL, implicit tensor
diffusion, direct solves) and the plain version of its fused step kernel
against incflo_tpu, on the CPU.

  * Simulation(cfg, device="cpu") against incflo_tpu.Simulation, tgv2d at
    16x16, float64, the initial projection and 3 steps with the adaptive
    tensor CG, from the port's own init and from incflo_tpu's state
    carried across: every field and dt to 1e-10 relative to its max
    (measured about 1e-14: rounding through six projections a step).
  * step2d_kernels.step_plain against the program the Pallas kernel
    pallas_step2d.FusedStep._kernel evaluates, jax.jit(Simulation.
    _advance_impl) traced in kernel mode (pallas_guard.in_kernel(): the
    fixed-trip tensor CG, mask-form zero modes), 16x16, float64, 2 steps:
    1e-10.  Also for Crank-Nicolson diffusion.
  * step_plain in float32 at 32x32 against pallas_step2d.FusedStep run in
    Pallas interpret mode: rtol 1e-4 / atol 1e-5, the bounds of
    tests/test_pallas_step2d.py (float32 rounding through the same
    algorithm, the CG may stop a trip apart).
  * supported() and cg_probe_ok() answer as incflo_tpu's do; out_of_scope()
    names why a deck is not the kernel's, and FusedStep raises with it.
  * implicit diffusion on a 3D Godunov deck (shear3d 8x8x8, float64, 2
    steps) to 1e-10, now that the implicit branch is ported.

The interpret-mode tests set pallas_step2d.INTERPRET and clear
pallas_guard._sharded, which other test files of the JAX package leave
set in the process.
"""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.ops import pallas_guard, pallas_step2d
from incflo_tpu.simulation import Simulation as JSim

import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.ops import step2d_kernels as s2

FIELDS = tstate.LevelState._fields
SCALARS = ("t", "dt", "prev_dt", "prev_prev_dt")
WALLS_Y = 'geometry.is_periodic = 1 0\nylo.type = "nsw"\nyhi.type = "nsw"\n'


def _np_state(s):
    out = {f: np.asarray(getattr(s.level, f)) for f in FIELDS}
    for k in SCALARS + ("step",):
        out[k] = np.asarray(getattr(s, k))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _text(deck="tgv2d", n=16, dtype="float64", extra=""):
    text, _ = bench._deck(deck, n, dtype)
    return text + extra


def _compare(ts, ref, tol):
    got = tstate.sim_to_numpy(ts)
    for k in FIELDS + SCALARS:
        assert _rel(got[k], ref[k]) <= tol, k
    assert int(got["step"]) == int(ref["step"])


@pytest.fixture(scope="module")
def tgv_reference():
    """incflo_tpu's tgv2d at 16x16 f64: init and 3 adaptive steps."""
    sim = JSim(JConfig.from_text(_text()))
    s = sim.init_state()
    states = [_np_state(s)]
    for _ in range(3):
        s = sim.advance(s)
        states.append(_np_state(s))
    return states


@pytest.mark.parametrize("start", ["own_init", "carried_state"])
def test_tgv2d_step_matches_incflo_tpu(tgv_reference, start):
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_text()), device="cpu")
    if start == "own_init":
        s = sim.init_state()
    else:
        s = tstate.sim_from_numpy(tgv_reference[0], "cpu", torch.float64)
    _compare(s, tgv_reference[0], 1e-10)
    for ref in tgv_reference[1:]:
        s = sim.advance(s)
        _compare(s, ref, 1e-10)
    assert sim._fused is None          # the CPU never takes the kernel


@pytest.mark.parametrize("extra", ["", "incflo.diffusion_type = 1\n"],
                         ids=["implicit", "crank_nicolson"])
def test_step_plain_matches_the_kernel_mode_step(extra):
    jsim = JSim(JConfig.from_text(_text(extra=extra)))
    s = jsim.init_state()
    start = _np_state(s)
    step = jax.jit(jsim._advance_impl)
    refs = []
    pallas_guard.set_in_kernel(True)
    try:
        for _ in range(2):
            s = step(s, jsim._ctx())
            refs.append(_np_state(s))
    finally:
        pallas_guard.set_in_kernel(False)
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_text(extra=extra)),
        device="cpu")
    ts = tstate.sim_from_numpy(start, "cpu", torch.float64)
    for ref in refs:
        cg = []
        ts = s2.step_plain(sim, ts, cg)
        _compare(ts, ref, 1e-10)
        assert len(cg) == 2 and all(float(r) <= float(t) for r, t in cg)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_step2d, "INTERPRET", True)
    monkeypatch.setattr(pallas_guard, "_sharded", False)


def test_step_plain_matches_pallas_fused_step(interpret):
    text = _text(n=32, dtype="float32")
    jsim = JSim(JConfig.from_text(text))
    s = jsim.init_state()
    fused = pallas_step2d.maybe_fused(jsim, s)
    assert fused is not None
    out = _np_state(jax.jit(fused.__call__)(s, jsim._ctx()))
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                  device="cpu")
    got = tstate.sim_to_numpy(
        s2.step_plain(sim, tstate.sim_from_numpy(_np_state(s), "cpu",
                                                 torch.float32)))
    for k in FIELDS + SCALARS:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(out[k], np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


SUPPORTED_CASES = {
    "tgv2d_f32": ("tgv2d", 32, "float32", "", True),
    "tgv2d_f64": ("tgv2d", 32, "float64", "", False),
    "walls_y": ("tgv2d", 32, "float32", WALLS_Y, False),
    "variable_density": ("tgv2d", 32, "float32",
                         "incflo.constant_density = false\n", False),
    "3d_deck": ("shear3d", 16, "float32", "", False),
    "512x512": ("tgv2d", 512, "float32", "", False),
}


@pytest.mark.parametrize("case", list(SUPPORTED_CASES))
def test_supported_matches_pallas_step2d(case, interpret):
    deck, n, dtype, extra, want = SUPPORTED_CASES[case]
    text = _text(deck, n, dtype, extra)
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                  device="cpu")
    jsim = JSim(JConfig.from_text(text))
    assert pallas_step2d.supported(jsim) is want
    assert s2.supported(sim) is want


SCOPE_CASES = {
    "tgv2d_f32": ("tgv2d", 16, "float32", "", None),
    "tgv2d_f64": ("tgv2d", 16, "float64", "", None),
    "crank_nicolson": ("tgv2d", 16, "float32", "incflo.diffusion_type = 1\n",
                       None),
    "3d_deck": ("shear3d", 8, "float32", "", "3D grids"),
    "walls_y": ("tgv2d", 16, "float32", WALLS_Y, "walls"),
    "variable_density": ("tgv2d", 16, "float32",
                         "incflo.constant_density = false\n",
                         "variable density"),
    "tracer": ("tgv2d", 16, "float32", "incflo.advect_tracer = true\n",
               "tracer"),
    "512x512": ("tgv2d", 512, "float32", "", "cells"),
    "explicit": ("tgv2d", 16, "float32", "incflo.diffusion_type = 0\n",
                 "explicit diffusion"),
    "powerlaw": ("tgv2d", 16, "float32",
                 "incflo.fluid_model = powerlaw\nincflo.n = 0.5\n",
                 "non-Newtonian"),
    "bingham": ("tgv2d", 16, "float32",
                "incflo.fluid_model = bingham\nincflo.tau_0 = 1.\n"
                "incflo.papa_reg = 0.01\n", "non-Newtonian"),
    "boussinesq": ("tgv2d", 16, "float32",
                   "incflo.probtype = 111\nincflo.gravity = 0. -1.\n",
                   "Boussinesq"),
}


@pytest.mark.parametrize("case", list(SCOPE_CASES))
def test_fused_step_scope(case):
    """out_of_scope names why the kernel cannot run a deck; FusedStep
    raises with that reason, and supported() also wants float32."""
    deck, n, dtype, extra, why = SCOPE_CASES[case]
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_text(deck, n, dtype, extra)),
        device="cpu")
    got = s2.out_of_scope(sim)
    assert s2.supported(sim) is (why is None and dtype == "float32")
    if why is None:
        assert got is None
        s2.FusedStep(sim)
        return
    assert why in got
    with pytest.raises(NotImplementedError, match=f"step2d kernel: .*{why}"):
        s2.FusedStep(sim)


@pytest.mark.parametrize("trips,mu,want", [(12, 0.01, True), (1, 0.5, False)])
def test_cg_probe_matches(trips, mu, want, monkeypatch):
    """The probe's solve of a random velocity field from a seed (the
    Taylor-Green field is divergence-free, which all but removes the cross
    coupling): the bench mu passes with 12 trips; a stiff one (dt mu /
    dx^2 about 4) cannot reach rtol 1e-11 in one trip, and both probes
    say so."""
    monkeypatch.setenv("INCFLO_TENSOR_K", str(trips))
    monkeypatch.setattr(s2, "FIXED_TRIPS", trips)
    text = _text(extra=f"incflo.mu = {mu}\n")
    jsim = JSim(JConfig.from_text(text))
    s = jsim.init_state()
    vel = np.random.default_rng(6).standard_normal(
        np.asarray(s.level.velocity).shape)
    s = s._replace(level=s.level._replace(
        velocity=jax.numpy.asarray(vel)))
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                  device="cpu")
    ts = tstate.sim_from_numpy(_np_state(s), "cpu", torch.float64)
    assert pallas_step2d._cg_probe_ok(jsim, s) is want
    assert s2.cg_probe_ok(sim, ts) is want


def test_fused_step_on_a_cpu_state_runs_step_plain():
    """The wrapper takes the plain version for a state on the CPU, and
    launches nothing."""
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_text()), device="cpu")
    fs = s2.FusedStep(sim)
    s = sim.init_state()
    n0 = dict(s2.LAUNCHES)
    out, cg = fs.step(s)
    ref_cg = []
    ref = s2.step_plain(sim, s, ref_cg)
    assert s2.LAUNCHES == n0
    a, b = tstate.sim_to_numpy(out), tstate.sim_to_numpy(ref)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert cg.shape == (4,)
    assert cg.tolist() == [float(v) for pair in ref_cg for v in pair]
    assert float(cg[0]) <= float(cg[1]) and float(cg[2]) <= float(cg[3])


def test_implicit_diffusion_3d_matches_incflo_tpu():
    text = _text("shear3d", 8, "float64", "incflo.diffusion_type = 2\n")
    jsim = JSim(JConfig.from_text(text))
    s = jsim.init_state()
    refs = [_np_state(s)]
    for _ in range(2):
        s = jsim.advance(s)
        refs.append(_np_state(s))
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text),
                                  device="cpu")
    ts = tstate.sim_from_numpy(refs[0], "cpu", torch.float64)
    for ref in refs[1:]:
        ts = sim.advance(ts)
        _compare(ts, ref, 1e-10)


class _KernelReached(Exception):
    pass


def test_fused_step_off_the_cpu_launches_or_raises(monkeypatch):
    """A state that is not on the CPU (here on the meta device) goes for
    the kernel library, stubbed to raise: no fallback to step_plain.
    Outside the kernel's scope FusedStep raises before that."""
    def no_library():
        raise _KernelReached
    monkeypatch.setattr(s2, "_lib", no_library)
    sim = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_text(dtype="float32")),
        device="meta")
    fs = s2.FusedStep(sim)
    s = sim.init_state()
    n0 = dict(s2.LAUNCHES)
    with pytest.raises(_KernelReached):
        fs.step(s)
    assert s2.LAUNCHES == n0
    sim3 = incflo_torch.Simulation(
        incflo_torch.IncfloConfig.from_text(_text("shear3d", 8)),
        device="cpu")
    with pytest.raises(NotImplementedError, match="step2d"):
        s2.FusedStep(sim3)
