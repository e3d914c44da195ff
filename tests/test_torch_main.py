"""incflo_torch's CLI driver (incflo_torch/main.py) against incflo_tpu's
(incflo_tpu/main.py), on the CPU in float64.

bench.py's tgv2d deck at 8^2 with max_step = 4, plot_int = 2,
check_int = 2, plt_vort and plt_error_u, through each package's `run`
in its own directory, then a restart from chk00002 (with
plotfile_on_restart) in another: both packages write the same files,
every checkpoint and plotfile array within 1e-10 relative of
incflo_tpu's, the Headers agreeing (their numbers to 1e-10), the Norm
lines too; each package's restarted chk00004 is bit-equal to its
unbroken one.  And the driver's own contract: it runs on the card
unless INCFLO_PLATFORM=cpu asks for the CPU, and exits with an error
where there is no card; an AMR deck runs (patch tree or dense fine
level) and restarts bit-equal.
"""

import contextlib
import io as stringio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp

import bench
from incflo_tpu import main as jmain

import incflo_torch
from incflo_torch import main as tmain
from incflo_torch.utils import tracing

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["max_step=4", "amr.plot_int=2", "amr.check_int=2",
        "amr.plt_vort=1", "amr.plt_error_u=1"]
PACKAGES = {"incflo_torch": tmain, "incflo_tpu": jmain}
EB_CYLINDER = """incflo.geometry = "cylinder"
cylinder.internal_flow = false
cylinder.radius = 0.2
cylinder.direction = 2
cylinder.center = 0.5 0.5 0.
"""


def _run(mod, cwd, argv):
    """mod.run(argv) from directory cwd; (return code, stdout)."""
    out = stringio.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.run(argv)
    finally:
        os.chdir(old)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Each package's unbroken run and its restart from chk00002:
    {package: {"unbroken"|"restart": (directory, stdout)}}."""
    root = tmp_path_factory.mktemp("cli")
    deck = root / "inputs"
    deck.write_text(bench._deck("tgv2d", 8, "float64")[0])
    mp = pytest.MonkeyPatch()
    # incflo_tpu's driver would repoint the worker's JAX compile cache
    mp.setenv("INCFLO_JAX_CACHE", "")
    mp.setenv("INCFLO_PLATFORM", "cpu")
    out = {}
    try:
        for name, mod in PACKAGES.items():
            runs = {}
            for kind in ("unbroken", "restart"):
                d = root / name / kind
                d.mkdir(parents=True)
                argv = [str(deck)] + ARGS
                if kind == "restart":
                    chk = root / name / "unbroken" / "chk00002"
                    argv += [f"amr.restart={chk}",
                             "amr.plotfile_on_restart=1"]
                rc, text = _run(mod, d, argv)
                assert rc == 0, text
                runs[kind] = (d, text)
            out[name] = runs
    finally:
        mp.undo()
    return out


def _listing(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("kind", ["unbroken", "restart"])
def test_cli_writes_the_same_files(cli, kind):
    port = _listing(cli["incflo_torch"][kind][0])
    ref = _listing(cli["incflo_tpu"][kind][0])
    assert port == ref
    want = {"unbroken": ["chk00000", "chk00002", "chk00004", "plt00000",
                         "plt00002", "plt00004"],
            "restart": ["chk00004", "plt00002", "plt00004"]}[kind]
    assert sorted({p.split(os.sep)[0] for p in port}) == want


def _numbers(line):
    return np.array(line.split(), float)


@pytest.mark.parametrize("kind", ["unbroken", "restart"])
def test_cli_checkpoints_and_plotfiles_agree(cli, kind):
    pd, jd = cli["incflo_torch"][kind][0], cli["incflo_tpu"][kind][0]
    for rel in _listing(jd):
        a, b = os.path.join(pd, rel), os.path.join(jd, rel)
        top, leaf = rel.split(os.sep)
        if leaf.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files), rel
            for k in y.files:
                assert x[k].shape == y[k].shape, (rel, k)
                assert tp.rel(x[k], y[k]) <= TOL, (rel, k)
        elif leaf == "Header" and top.startswith("chk"):
            la, lb = open(a).read().splitlines(), open(b).read().splitlines()
            assert len(la) == len(lb)
            for u, v in zip(la, lb):
                if u != v:
                    assert np.allclose(_numbers(u), _numbers(v), rtol=TOL,
                                       atol=0), (rel, u, v)
        elif leaf == "Header":
            ha, hb = json.load(open(a)), json.load(open(b))
            assert sorted(ha) == sorted(hb)
            for k in hb:
                if isinstance(hb[k], float):
                    assert abs(ha[k] - hb[k]) <= TOL * abs(hb[k]), (rel, k)
                else:
                    assert ha[k] == hb[k], (rel, k)
        else:
            assert leaf == "incflo_job_info"
            assert "incflo_torch version" in open(a).read()


def test_cli_norm_lines_match(cli):
    for kind in ("unbroken", "restart"):
        got, ref = (_norm_lines(cli[p][kind][1]) for p in PACKAGES)
        assert len(ref) > 0 and [w for w, _ in got] == [w for w, _ in ref]
        for (_, x), (_, y) in zip(got, ref):
            assert abs(x - y) <= TOL * abs(y)


def _norm_lines(text):
    lines = [l.split() for l in text.splitlines() if "Norm" in l]
    return [(l[:-1], float(l[-1])) for l in lines]


@pytest.mark.parametrize("package", list(PACKAGES))
def test_cli_restart_is_bit_exact(cli, package):
    a = cli[package]["restart"][0] / "chk00004"
    b = cli[package]["unbroken"][0] / "chk00004"
    assert open(a / "Header").read() == open(b / "Header").read()
    x, y = np.load(a / "Level_0.npz"), np.load(b / "Level_0.npz")
    for k in y.files:
        assert np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype, k


def test_cli_prints_the_same_lines(cli):
    """The same kinds of lines in the same order (times aside)."""
    def kinds(text):
        return [l.split()[:3] for l in text.splitlines()]
    for kind in ("unbroken", "restart"):
        got, ref = (kinds(cli[p][kind][1]) for p in PACKAGES)
        assert got == ref


def test_cli_stops_at_stop_time(tmp_path, monkeypatch):
    """A stop_time deck batches its steps (incflo_tpu's _steps_to_stop)
    and still takes Simulation.evolve's sequence of steps, ending on
    stop_time."""
    deck = tmp_path / "inputs"
    deck.write_text(bench._deck("tgv2d", 8, "float64")[0])
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    rc, _ = _run(tmain, tmp_path, [str(deck), "stop_time=0.5",
                                   "max_step=-1", "amr.check_int=1000"])
    assert rc == 0
    sim = tp.port_sim(bench._deck("tgv2d", 8, "float64")[0]
                      + "stop_time = 0.5\nmax_step = -1\n")
    ref = sim.evolve()
    chk = sorted(p for p in os.listdir(tmp_path) if p.startswith("chk"))
    assert chk == ["chk00000", f"chk{int(ref.step):05d}"]
    lines = open(tmp_path / chk[-1] / "Header").read().splitlines()
    assert float(lines[3]) == float(ref.t) == 0.5
    x = np.load(tmp_path / chk[-1] / "Level_0.npz")
    assert np.array_equal(x["velocity"], ref.level.velocity.numpy())


def test_cli_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch, capsys):
    deck = tmp_path / "inputs"
    deck.write_text(bench._deck("tgv2d", 8, "float64")[0])
    monkeypatch.delenv("INCFLO_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert tmain.run([str(deck), "max_step=1", "amr.check_int=1"]) == 2
    assert "INCFLO_PLATFORM=cpu" in capsys.readouterr().err
    monkeypatch.setenv("INCFLO_PLATFORM", "tpu")
    assert tmain.run([str(deck), "max_step=1"]) == 2
    assert os.listdir(tmp_path) == ["inputs"]
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    assert tmain.run([str(deck), "max_step=1", "amr.check_int=1"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["chk00000", "chk00001", "inputs"]


def test_module_entry_point_exits_with_an_error_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    deck = tmp_path / "inputs"
    deck.write_text(bench._deck("tgv2d", 8, "float64")[0])
    env = {k: v for k, v in os.environ.items() if k != "INCFLO_PLATFORM"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", "incflo_torch.main",
                        str(deck), "max_step=1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda is not available" in r.stderr
    assert os.listdir(tmp_path) == ["inputs"]


def test_cli_describe_usage_and_missing_deck(tmp_path, capsys):
    assert tmain.run(["--describe"]) == 0
    out = capsys.readouterr().out
    assert f"incflo_torch {incflo_torch.__version__}" in out
    assert f"torch {torch.__version__}" in out and "git hash" in out
    assert tmain.run([]) == 2
    assert tmain.run([str(tmp_path / "absent")]) == 2
    assert "inputs file not found" in capsys.readouterr().err


def test_cli_eb_surface_and_profile_trace(tmp_path, monkeypatch):
    """incflo.write_eb_surface writes the STL of eb/surface.py, and
    INCFLO_PROFILE_DIR a torch.profiler chrome trace of the build and
    the evolve loop, the static solvers' build and the step's phases
    among its ranges."""
    deck = tmp_path / "inputs"
    deck.write_text(bench._deck("tgv2d", 8, "float64")[0] + EB_CYLINDER)
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    monkeypatch.setenv("INCFLO_PROFILE_DIR", str(tmp_path / "prof"))
    rc, out = _run(tmain, tmp_path, [str(deck), "max_step=1",
                                     "incflo.write_eb_surface=1"])
    assert rc == 0 and "Wrote eb_surface.stl" in out
    stl = open(tmp_path / "eb_surface.stl").read()
    assert stl.startswith("solid") and stl.count("facet normal") > 0
    trace = json.load(open(tmp_path / "prof" / "trace.rank0.json"))
    assert len(trace["traceEvents"]) > 0
    names = {e.get("name") for e in trace["traceEvents"]}
    want = {"static_solvers", *tracing.PHASES}
    assert want <= names, want - names
    assert tracing.SPANS is None


def _chk_files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("mode", ["slab", "dense"])
def test_cli_runs_an_amr_deck_and_restarts_bit_exact(tmp_path, monkeypatch,
                                                    mode):
    """An AMR deck through the port's CLI on the CPU: the RT2D deck of
    tests/test_amr_patch.py without amr.patch_mode (auto-selected: a
    slab patch tree, regridded every 2 steps) and tgv2d at 8^2 with
    nothing tagged (the dense fine level).  4 steps with a checkpoint and
    a plotfile every 2, then a restart from chk00002 whose chk00004 is
    bit-equal to the unbroken one."""
    deck = tmp_path / "inputs"
    if mode == "slab":
        deck.write_text(tp.rt2d_amr_deck().replace("amr.patch_mode = slab",
                                                   "")
                        + "amr.regrid_int = 2\n")
    else:
        deck.write_text(bench._deck("tgv2d", 8, "float64")[0]
                        + "amr.max_level = 1\n")
    monkeypatch.setenv("INCFLO_PLATFORM", "cpu")
    args = [str(deck), "max_step=4", "amr.plot_int=2", "amr.check_int=2"]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    rc, out = _run(tmain, tmp_path / "a", args)
    assert rc == 0 and f"amr.patch_mode auto-selected: {mode}" in out
    rc, _ = _run(tmain, tmp_path / "b", args + [
        f"amr.restart={tmp_path / 'a' / 'chk00002'}"])
    assert rc == 0
    a, b = tmp_path / "a" / "chk00004", tmp_path / "b" / "chk00004"
    files = _chk_files(a)
    assert files == _chk_files(b)
    if mode == "slab":
        assert "Patch.json" in files and "patch_level_1/Level_0.npz" in files
        hdr = json.load(open(tmp_path / "a" / "plt00004" / "Header"))
        assert hdr["patch_parents"] == [-1, 0] and hdr["patch_axis"] == 1
    else:
        assert files == ["Header", "Level_0.npz"]
        z = np.load(tmp_path / "a" / "plt00004" / "Level_1.npz")
        assert z["velx"].shape == (16, 16)
    for f in files:
        if f.endswith(".npz"):
            x, y = np.load(a / f), np.load(b / f)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f + k)
        else:
            assert open(a / f).read() == open(b / f).read(), f
