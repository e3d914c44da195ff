"""Numeric helpers (port of incflo_tpu/ops/mathutil.py)."""

import torch

# clamp the tanh argument as incflo_tpu does, so initial conditions
# agree bit for bit (tanh saturates to 1.0 in float64 for |x| >= ~19)
_TANH_CLAMP = 30.0


def safe_tanh(x):
    return torch.tanh(torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP))


def expterm(nu):
    """Papanastasiou regularisation (1-exp(-nu))/nu with the series
    fallback for tiny nu (reference src/rheology/incflo_rheology.cpp:8-13)."""
    small = nu < 1.0e-9
    safe = torch.where(small, torch.ones_like(nu), nu)
    series = (1.0 - 0.5 * nu + nu * nu * (1.0 / 6.0)
              - (nu * nu * nu) * (1.0 / 24.0))
    return torch.where(small, series, -torch.expm1(-safe) / safe)
