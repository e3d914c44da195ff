"""The roofline's counts against hand-counted shapes."""

import pytest
import torch

from benchmark.reference import godunov_periodic as gp
from benchmark.roofline import kernels, peaks, smoothers
from benchmark.roofline.count import count_ops

F64 = "float64"


def test_count_ops_by_hand():
    a, b, c = (torch.ones(4, 5) for _ in range(3))
    assert count_ops(lambda: a + b * c) == 40
    assert count_ops(lambda: torch.clamp(a, b, c)) == 40
    assert count_ops(lambda: a @ torch.ones(5, 3)) == 2 * 4 * 3 * 5


def test_godunov_bytes_by_hand():
    cells, dx = (8, 8, 4), (0.125, 0.125, 0.25)
    n = 8 * 8 * 4
    _, nb, dt = kernels.godunov_call("uad", dict(
        cells=cells, dx=dx, vel=((8, 8, 4, 3), F64), ppm=True))
    assert (nb, dt) == (8 * (3 * n + 3 * n), F64)
    _, nb, _ = kernels.godunov_call("predict_d", dict(
        cells=cells, dx=dx, vel=((8, 8, 4, 3), F64),
        uad=[((8, 8, 4), F64)] * 3, forces=True, d=2, ppm=True))
    assert nb == 8 * (3 * n + 3 * n + n + 8 * 8 * 5)
    umac = [((9, 8, 4), F64), ((8, 9, 4), F64), ((8, 8, 5), F64)]
    _, nb, _ = kernels.godunov_call("advect", dict(
        cells=cells, dx=dx, q=((8, 8, 4, 3), F64), umac=umac, forces=False,
        icons=True, ppm=True))
    assert nb == 8 * (n + (288 + 288 + 320) + n)


def test_godunov_ops_are_the_plain_versions():
    cells, dx = (8, 8, 4), (0.125, 0.125, 0.25)
    vel = torch.rand(8, 8, 4, 3, dtype=torch.float64)
    dt = torch.tensor(0.01, dtype=torch.float64)

    class G:
        n_cell, dx_ = cells, dx
    G.dx = dx
    ops, _, _ = kernels.godunov_call("uad", dict(
        cells=cells, dx=dx, vel=((8, 8, 4, 3), F64), ppm=True))
    assert ops == count_ops(lambda: gp.uad_plain(G, vel, dt, True)) > 0


def test_smoother_counts_by_hand():
    x = ((8, 8, 5), F64)                  # nodes of 8 x 8 x 4, z walled
    call = dict(kind="nodal", x=x, coefs=[((8, 8, 4), F64), x], fwall=None,
                dx=(0.125, 0.125, 0.25), nsweeps=2, want=True,
                bc=((0, 0, 1), (0, 0, 1)))
    ops, nb, _ = kernels.smoother_call(call)
    assert nb == 8 * (4 * 320 + 256 + 320)
    xs = torch.rand(8, 8, 5, dtype=torch.float64)
    sig = torch.rand(8, 8, 4, dtype=torch.float64)
    assert ops == count_ops(lambda: smoothers.nodal_smooth_plain(
        xs, xs, sig, xs, (0.125, 0.125, 0.25), 2, True,
        ((0, 0, 1), (0, 0, 1)))) > 0


def test_bound_is_the_larger_of_bytes_and_operations():
    assert kernels.bound_s(0, 3.35e12, F64) == pytest.approx(1.0)
    assert kernels.bound_s(34e12, 1, F64) == pytest.approx(1.0)
    assert kernels.bound_s(67e12, 1, "float32") == pytest.approx(1.0)
    assert peaks.PEAK_OPS["float64"] == 34e12
