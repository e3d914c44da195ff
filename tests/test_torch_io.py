"""incflo_torch's checkpoints and plotfiles (utils/io.py) against
incflo_tpu's (incflo_tpu/utils/io.py), in float64.

Checkpoints, on bench.py's tgv2d deck at 8^2 (2D periodic MOL): a
checkpoint written after 3 steps by either package restarts in the
other; each package's next 2 steps from its own checkpoint are bit-equal
to its unbroken run (the contract of tests/test_io.py:15), and across
the packages they agree within 1e-10 relative.  The file one package
writes, the other reads bit-equal.

Plotfiles, on the same deck at 16^2 with plt_vort and plt_error_u/v, and
on the inline EB cylinder deck of tests/test_io.py:55 with plt_vfrac,
plt_forcing, plt_vort, plt_strainrate and plt_eta: both packages' plot
fields of one state within 1e-10 relative, the same field names and
Header, and the same Norm0/Norm2 lines to 1e-10.  And the dense AMR
driver's multi-level plotfile on the same tgv2d deck.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_parity as tp

import jax.numpy as jnp

import bench
from incflo_tpu.config import IncfloConfig as JConfig
from incflo_tpu.simulation import Simulation as JSim
from incflo_tpu.state import LevelState as JLevel
from incflo_tpu.state import SimState as JState
from incflo_tpu.utils import io as jio

import incflo_torch
from incflo_torch import state as tstate
from incflo_torch.utils import io as tio

TOL = 1e-10
SCALARS = ("t", "dt", "prev_dt", "prev_prev_dt")
EB_DECK = """
amr.n_cell = 16 16
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1. 1.
geometry.is_periodic = 1 1
incflo.probtype = 21
incflo.geometry = "cylinder"
cylinder.internal_flow = false
cylinder.radius = 0.2
cylinder.direction = 2
cylinder.center = 0.5 0.5 0.
incflo.mu = 0.01
incflo.delp = 0.4 0.
incflo.initial_iterations = 0
incflo.do_initial_proj = 0
amr.plt_vfrac = 1
amr.plt_forcing = 1
amr.plt_vort = 1
amr.plt_strainrate = 1
amr.plt_eta = 1
"""


def _tgv(n, extra=""):
    return bench._deck("tgv2d", n, "float64")[0] + extra


def _jax_state(d):
    """incflo_tpu's SimState of a dict of numpy arrays (tp.np_state)."""
    return JState(level=JLevel(**{f: jnp.asarray(d[f]) for f in tp.FIELDS}),
                  **{k: jnp.asarray(d[k]) for k in SCALARS + ("step",)})


def _equal(a, b):
    """Every field and scalar of two np_state dicts bit-equal."""
    return all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
               for k in tp.FIELDS + SCALARS + ("step",))


def _worst(a, b):
    return max(tp.rel(np.asarray(a[k], np.float64),
                      np.asarray(b[k], np.float64))
               for k in tp.FIELDS + ("dt",))


@pytest.fixture(scope="module")
def runs():
    """Both packages' unbroken runs of the 8^2 deck: their states after
    init and each of 5 steps (np_state dicts)."""
    text = _tgv(8)
    jsim = JSim(JConfig.from_text(text))
    s = jsim.init_state()
    jstates = [tp.np_state(s)]
    for _ in range(5):
        s = jsim.advance(s)
        jstates.append(tp.np_state(s))
    tsim = tp.port_sim(text)
    q = tsim.init_state()
    tstates = [tstate.sim_to_numpy(q)]
    for _ in range(5):
        q = tsim.advance(q)
        tstates.append(tstate.sim_to_numpy(q))
    return text, jsim, tsim, jstates, tstates


def _jax_steps(jsim, s, n=2):
    out = []
    for _ in range(n):
        s = jsim.advance(s)
        out.append(tp.np_state(s))
    return out


def _port_steps(tsim, s, n=2):
    out = []
    for _ in range(n):
        s = tsim.advance(s)
        out.append(tstate.sim_to_numpy(s))
    return out


def test_unbroken_runs_agree(runs):
    _, _, _, jstates, tstates = runs
    for a, b in zip(tstates, jstates):
        assert _worst(a, b) <= TOL


def test_port_checkpoint_restarts_in_incflo_tpu(runs, tmp_path):
    text, jsim, tsim, jstates, tstates = runs
    path = str(tmp_path / "chk00003")
    tio.write_checkpoint(path, tstate.sim_from_numpy(
        tstates[3], "cpu", torch.float64), tsim.cfg)
    s = jio.read_checkpoint(path, jsim.cfg, jsim.dtype)
    assert _equal(tp.np_state(s), tstates[3])
    after = _jax_steps(jsim, s)
    for i, got in enumerate(after):
        assert _worst(got, jstates[4 + i]) <= TOL
        assert _worst(got, tstates[4 + i]) <= TOL


def test_incflo_tpu_checkpoint_restarts_in_port(runs, tmp_path):
    text, jsim, tsim, jstates, tstates = runs
    path = str(tmp_path / "chk00003")
    jio.write_checkpoint(path, _jax_state(jstates[3]), jsim.cfg)
    s = tio.read_checkpoint(path, tsim.cfg, torch.float64, "cpu")
    assert s.step.dtype == torch.int32 and s.t.device.type == "cpu"
    assert _equal(tstate.sim_to_numpy(s), jstates[3])
    after = _port_steps(tsim, s)
    for i, got in enumerate(after):
        assert _worst(got, tstates[4 + i]) <= TOL
        assert _worst(got, jstates[4 + i]) <= TOL


@pytest.mark.parametrize("package", ["incflo_torch", "incflo_tpu"])
def test_restart_is_bit_exact(runs, tmp_path, package):
    """Each package's next 2 steps from its own checkpoint equal its
    unbroken run's bit for bit."""
    text, jsim, tsim, jstates, tstates = runs
    path = str(tmp_path / "chk00003")
    if package == "incflo_torch":
        tio.write_checkpoint(path, tstate.sim_from_numpy(
            tstates[3], "cpu", torch.float64), tsim.cfg)
        s = tio.read_checkpoint(path, tsim.cfg, torch.float64, "cpu")
        after, ref = _port_steps(tsim, s), tstates[4:]
    else:
        jio.write_checkpoint(path, _jax_state(jstates[3]), jsim.cfg)
        s = jio.read_checkpoint(path, jsim.cfg, jsim.dtype)
        after, ref = _jax_steps(jsim, s), jstates[4:]
    for got, want in zip(after, ref):
        assert _equal(got, want)


def test_checkpoint_files_agree(runs, tmp_path):
    """The two packages write the same files: the same Header lines (the
    numbers within 1e-10) and the same arrays in Level_0.npz."""
    text, jsim, tsim, jstates, tstates = runs
    tio.write_checkpoint(str(tmp_path / "port"), tstate.sim_from_numpy(
        tstates[3], "cpu", torch.float64), tsim.cfg)
    jio.write_checkpoint(str(tmp_path / "jax"), _jax_state(jstates[3]),
                         jsim.cfg)
    assert sorted(os.listdir(tmp_path / "port")) \
        == sorted(os.listdir(tmp_path / "jax")) == ["Header", "Level_0.npz"]
    _headers_agree(tmp_path / "port" / "Header", tmp_path / "jax" / "Header")
    a = np.load(tmp_path / "port" / "Level_0.npz")
    b = np.load(tmp_path / "jax" / "Level_0.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(tio.LEVEL_FIELDS)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and tp.rel(a[k], b[k]) <= TOL, k


def _headers_agree(pa, pb):
    la, lb = open(pa).read().splitlines(), open(pb).read().splitlines()
    assert len(la) == len(lb) == 11
    for x, y in zip(la, lb):
        if x == y:
            continue
        fx, fy = np.array(x.split(), float), np.array(y.split(), float)
        assert np.allclose(fx, fy, rtol=TOL, atol=0), (x, y)


def test_checkpoint_reads_into_float32(runs, tmp_path):
    text, jsim, tsim, jstates, tstates = runs
    path = str(tmp_path / "chk")
    jio.write_checkpoint(path, _jax_state(jstates[3]), jsim.cfg)
    s = tio.read_checkpoint(path, tsim.cfg, torch.float32, "cpu")
    assert s.level.velocity.dtype == s.t.dtype == torch.float32
    assert int(s.step) == 3
    assert np.array_equal(s.level.p.numpy(),
                          jstates[3]["p"].astype(np.float32))


def test_checkpoint_of_another_grid_is_refused(runs, tmp_path):
    text, jsim, tsim, jstates, tstates = runs
    path = str(tmp_path / "chk")
    jio.write_checkpoint(path, _jax_state(jstates[3]), jsim.cfg)
    other = incflo_torch.IncfloConfig.from_text(_tgv(16))
    with pytest.raises(ValueError, match="checkpoint grid"):
        tio.read_checkpoint(path, other, torch.float64, "cpu")


# ---------------------------------------------------------------------
# plotfiles
# ---------------------------------------------------------------------

def _norm_lines(out):
    lines = [l.split() for l in out.splitlines() if "Norm" in l]
    return [(l[:-1], float(l[-1])) for l in lines]


def _plotfiles_agree(tmp_path, text, start, capsys):
    """Write one state's plotfile in both packages; hold the fields, the
    Headers and the Norm lines together.  Returns the port's fields."""
    jsim = JSim(JConfig.from_text(text))
    tsim = tp.port_sim(text)
    jfields = jio.write_plotfile(str(tmp_path / "jax"), _jax_state(start),
                                 jsim.cfg, jsim)
    jout = capsys.readouterr().out
    tfields = tio.write_plotfile(str(tmp_path / "port"), tstate.sim_from_numpy(
        start, "cpu", torch.float64), tsim.cfg, tsim)
    tout = capsys.readouterr().out
    assert sorted(tfields) == sorted(jfields)
    for k in jfields:
        a, b = np.asarray(tfields[k]), np.asarray(jfields[k])
        assert a.shape == b.shape and tp.rel(a, b) <= TOL, k
    ja, tb = (json.load(open(tmp_path / d / "Header"))
              for d in ("jax", "port"))
    assert sorted(ja) == sorted(tb)
    for k in ja:
        if isinstance(ja[k], float):
            assert abs(tb[k] - ja[k]) <= TOL * abs(ja[k]), k
        else:
            assert tb[k] == ja[k], k
    for d in ("jax", "port"):
        npz = np.load(tmp_path / d / "Level_0.npz")
        assert sorted(npz.files) == ja["fields"]
    jn, tn = _norm_lines(jout), _norm_lines(tout)
    assert [w for w, _ in tn] == [w for w, _ in jn]
    for (_, x), (_, y) in zip(tn, jn):
        assert abs(x - y) <= TOL * abs(y)
    return tfields, tn


def test_tgv_plot_fields_and_norm_lines_match(tmp_path, capsys):
    text = _tgv(16, "amr.plt_error_u = 1\namr.plt_error_v = 1\n"
                "amr.plt_vort = 1\n")
    tsim = tp.port_sim(text)
    s = tsim.advance(tsim.init_state())
    fields, norms = _plotfiles_agree(tmp_path, text,
                                     tstate.sim_to_numpy(s), capsys)
    for name in ("velx", "vely", "gpx", "gpy", "rho", "tracer", "vort",
                 "error_u", "error_v"):
        assert name in fields, name
    assert [w[2] for w, _ in norms] == ["u", "u", "v", "v"]
    assert 0.0 < np.max(np.abs(fields["error_u"])) < 0.05


def test_eb_plot_fields_match(tmp_path, capsys):
    """vfrac, forcing, vort, strainrate and eta on the EB cylinder: the
    cut-cell forms of eb/ops.py, on a seeded velocity, zero in covered
    cells."""
    tsim = tp.port_sim(EB_DECK)
    assert tsim.eb is not None
    start = tstate.sim_to_numpy(tsim.init_state())
    start["velocity"] = tp.masked_random(start["velocity"].shape,
                                         tsim.eb.fluid.numpy(), 11)
    fields, _ = _plotfiles_agree(tmp_path, EB_DECK, start, capsys)
    assert fields["vfrac"].min() < 1e-12 and fields["vfrac"].max() == 1.0
    np.testing.assert_allclose(fields["forcingx"],
                               np.full_like(fields["forcingx"], 0.4))
    for name in ("vort", "strainrate", "eta"):
        assert np.isfinite(fields[name]).all(), name


def test_job_info_names_the_port(tmp_path):
    cfg = incflo_torch.IncfloConfig.from_text(_tgv(8))
    tio.write_job_info(str(tmp_path), cfg)
    text = open(tmp_path / "incflo_job_info").read()
    assert f"incflo_torch version: {incflo_torch.__version__}" in text
    assert f"torch: {torch.__version__}" in text
    assert "devices: cpu" in text and "amr.n_cell" in text


@pytest.mark.parametrize("max_level", [1, 2])
def test_dense_amr_plotfiles_match(tmp_path, max_level):
    """write_plotfile_amr of the dense-fine driver, both packages from
    one fine state (the port's initial one) after a regrid: the same
    Header, and every level's fields (averaged down) within 1e-10 and
    refinement masks equal.  The patch tree's plotfile and checkpoints
    are tests/test_torch_amr_rt2d.py's."""
    from incflo_tpu.amr import AMRSimulation as JAMR
    from incflo_torch.amr import AMRSimulation as TAMR
    text = _tgv(8) + f"""amr.max_level = {max_level}
amr.plt_vort = 1
incflo.tag_region = true
incflo.tag_region_lo = 0.25 0.5
incflo.tag_region_hi = 0.5 0.75
"""
    tamr = TAMR(incflo_torch.IncfloConfig.from_text(text), device="cpu")
    jamr = JAMR(JConfig.from_text(text))
    ts = tamr.init_state()
    js = _jax_state(tstate.sim_to_numpy(ts))
    jamr.regrid(js)
    tio.write_plotfile_amr(str(tmp_path / "t"), ts, tamr, tamr.cfg)
    jio.write_plotfile_amr(str(tmp_path / "j"), js, jamr, jamr.cfg)
    assert json.load(open(tmp_path / "t" / "Header")) \
        == json.load(open(tmp_path / "j" / "Header"))
    for lev in range(max_level + 1):
        zt = np.load(tmp_path / "t" / f"Level_{lev}.npz")
        zj = np.load(tmp_path / "j" / f"Level_{lev}.npz")
        assert sorted(zt.files) == sorted(zj.files)
        assert ("refine_mask" in zt.files) == (lev < max_level)
        for k in zj.files:
            if k == "refine_mask":
                assert zj[k].any()
                np.testing.assert_array_equal(zt[k], zj[k])
            else:
                assert tp.rel(zt[k], zj[k]) <= TOL, (lev, k)
