"""The harness on the CPU at test sizes: discovery by name, the result
line, the import guard, the exit without a card, and the check's
verdict on the program, on planted faults and on its control."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import check, core

ROOT = core.ROOT


def _run(name, spec, seconds=0.2, step=None, traced=False):
    return core.run_cell(name, 2 ** 31 + 7, seconds, traced,
                         time.perf_counter(), device="cpu", step=step,
                         spec=spec)


def test_discovery_finds_an_added_cell_and_metric(bench_copy):
    tmp, spec, add_cell = bench_copy
    add_cell("shear3d-extra", "shear3d", 16)
    (tmp / "metrics" / "steps_in_window.py").write_text(
        "def read(record):\n    return record['steps']\n")
    spec["end_to_end"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["shear3d-extra"]})
    result, _ = _run("shear3d-extra", spec)
    m = result["metrics"]
    assert m["steps_in_window"]["value"] == result["attempted"] > 0
    # cells_per_s lists its cells; setup_s, without a list, takes every one
    assert set(m) == {"setup_s", "steps_in_window"}


def test_result_line_shape(bench_copy):
    _, spec, add_cell = bench_copy
    add_cell("shear3d-shape", "shear3d", 16)
    for m in spec["end_to_end"]:
        if m["name"] == "cells_per_s":
            m["workloads"].append("shear3d-shape")
    result, notes = _run("shear3d-shape", spec)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert list(result["compared"]) == list(check.NUMBERS)
    for k in check.NUMBERS:
        entry = result["compared"][k]
        assert set(entry) == {"value", "limit"}
        assert any(line.startswith(f"{k} ") for line in notes)
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.loads(json.dumps(result))
    assert result["metrics"]["cells_per_s"]["unit"] == "cells/s"


def _unchanged(sim):
    return lambda s: s


def _altered(sim):
    def step(s):
        s = sim.advance(s)
        v = s.level.velocity.clone()
        v[0, 0, 0, 0] += 1e-6 * float(v.abs().max())
        return s._replace(level=s.level._replace(velocity=v))
    return step


@pytest.mark.parametrize("config,n,fault", [
    ("shear3d", 16, _unchanged), ("rt", 16, _unchanged),
    ("shear3d", 16, _altered)])
def test_a_planted_fault_is_not_correct(bench_copy, config, n, fault):
    _, spec, add_cell = bench_copy
    add_cell(f"{config}-fault", config, n)
    result, _ = _run(f"{config}-fault", spec, seconds=0.05, step=fault)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("config,n", [("shear3d", 16), ("rt", 64)])
def test_program_meets_the_reference(bench_copy, config, n):
    """The reference against the port's CPU path, through the harness.
    rt at 32x32x64: on 8x8x16 and 16x16x32 the port's own MAC solve
    stalls far above its tolerance (PERF.md, Open questions)."""
    tmp, spec, add_cell = bench_copy
    add_cell(f"{config}-ref", config, n)
    w = json.loads((tmp / "workloads" / f"{config}-ref.json").read_text())
    w["warmup_steps"] = 1
    (tmp / "workloads" / f"{config}-ref.json").write_text(json.dumps(w))
    result, notes = _run(f"{config}-ref", spec, seconds=0.01)
    assert result["correct"] is True, notes


@pytest.mark.parametrize("config,n,cell", [
    ("shear3d", 16, "shear3d-256-f64"), ("rt", 32, "rt-256-f64")])
def test_control_fails_the_cells_limits(config, n, cell):
    """The control, the float32 reference, against the limits of the
    cell: it has to fail one of its numbers."""
    from benchmark.harness import fields
    from benchmark.reference.step import ReferenceStep
    c = core.Cell(cell)
    text = "\n".join(c.config["deck"]).format(
        **{k: int(n * f) for k, f in zip(("nx", "ny", "nz"),
                                        c.config["cells_of_n"])})
    from benchmark.reference.deck import Deck
    deck = Deck.from_text(text)
    v, r, t = fields.initial_fields(deck, 5, torch.float64, "cpu")
    inputs = {"velocity": v, "density": r, "tracer": t}
    ref = ReferenceStep(deck, torch.float64, "cpu")
    prev = ref.step(check.start_state(ref.initial_projection(v, r), r, t,
                                      deck.grid.node_shape))
    values, _ = check.control_readings(deck, inputs, prev, "cpu")
    correct, _, failed = check.verdict(values, c.workload["limits"])
    assert not correct and failed >= 1, values


def test_import_guard_names_whole_top_level_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "incflo_tpu.ops.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", object())
    assert run.forbidden_modules() == ["incflo_tpu.ops.fake"]


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.harness.core\n"
            "import benchmark.reference.step, benchmark.roofline.kernels\n"
            "from benchmark.harness import core\n"
            "[core.reader(p.stem) for p in (core.BENCH / 'metrics')"
            ".glob('*.py')]\n"
            "print(benchmark.run.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "shear3d-256-f64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "shear3d-256-f64",
         "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
