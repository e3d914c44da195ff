"""Convergence order of incflo_torch on the decaying Taylor vortex
(probtype 2), the checks of tests/test_simulation.py:99-128 run on the
port alone (ROADMAP A8): the L2 error of u against the exact solution
after n // 4 steps of the fixed dt = 0.256 / n (T = 0.064), at
n = 16 and 32, explicit diffusion, three initial iterations, float64 on
the CPU.  Limits as in incflo_tpu's tests: 2D MOL above 1.7; 2D Godunov
above 1.9 with both use_mac_phi_in_godunov settings; 3D Godunov (the
2D solution extended in z, w = 0) above 1.9, with w at the error level.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (caps torch's CPU threads)

import incflo_torch


def _taylor_vortex_error(n, use_godunov=False, use_mac_phi=False, ndim=2,
                         nz=8):
    cells = f"{n} {n}" if ndim == 2 else f"{n} {n} {nz}"
    lo = "0. 0." if ndim == 2 else "0. 0. 0."
    hi = "2. 2." if ndim == 2 else f"2. 2. {2.0 * nz / n}"
    per = "1 1" if ndim == 2 else "1 1 1"
    text = f"""
amr.n_cell = {cells}
amr.max_level = 0
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
geometry.is_periodic = {per}
incflo.probtype = 2
incflo.mu = 0.001
incflo.ro_0 = 1.
incflo.cfl = 0.45
incflo.fixed_dt = {0.256 / n}
max_step = {n // 4}
incflo.diffusion_type = 0
incflo.initial_iterations = 3
incflo.ntrac = 1
incflo.use_godunov = {"true" if use_godunov else "false"}
incflo.use_mac_phi_in_godunov = {"true" if use_mac_phi else "false"}
"""
    cfg = incflo_torch.IncfloConfig.from_text(text)
    sim = incflo_torch.Simulation(cfg, device="cpu")
    s = sim.advance_n(sim.init_state(), cfg.max_step)
    t = float(s.t)
    xc = (np.arange(n) + 0.5) * (2.0 / n)
    x = xc.reshape(-1, 1) if ndim == 2 else xc.reshape(-1, 1, 1)
    y = xc.reshape(1, -1) if ndim == 2 else xc.reshape(1, -1, 1)
    omega = np.pi ** 2 * 0.001
    u_ex = 1.0 - np.cos(np.pi * (x - t)) * np.sin(np.pi * (y - t)) \
        * np.exp(-2 * omega * t)
    vel = s.level.velocity.numpy()
    errs = {"u": np.sqrt(np.mean((vel[..., 0] - u_ex) ** 2))}
    if ndim == 3:
        errs["w"] = np.sqrt(np.mean(vel[..., 2] ** 2))
    return errs


def test_taylor_vortex_convergence_mol():
    e16, e32 = _taylor_vortex_error(16)["u"], _taylor_vortex_error(32)["u"]
    order = np.log2(e16 / e32)
    assert order > 1.7, f"convergence order {order} (e16={e16}, e32={e32})"


@pytest.mark.parametrize("use_mac_phi", [False, True])
def test_taylor_vortex_convergence_godunov(use_mac_phi):
    e16 = _taylor_vortex_error(16, True, use_mac_phi)["u"]
    e32 = _taylor_vortex_error(32, True, use_mac_phi)["u"]
    order = np.log2(e16 / e32)
    assert order > 1.9, \
        f"mac_phi={use_mac_phi}: order {order} (e16={e16}, e32={e32})"


def test_taylor_vortex_convergence_3d_godunov():
    e16 = _taylor_vortex_error(16, True, ndim=3)
    e32 = _taylor_vortex_error(32, True, ndim=3)
    order = np.log2(e16["u"] / e32["u"])
    assert order > 1.9, f"3D order {order} (e16={e16}, e32={e32})"
    assert e32["w"] < 5 * e32["u"], (e32["w"], e32["u"])
