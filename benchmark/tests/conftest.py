"""The benchmark's own tests (CPU; card tests marked `cuda`).  Run from
the repository's root: python -m pytest benchmark/tests -q"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)


def tiny_workload(config, n, limits=None):
    return {"config": config, "chips": 1, "n": n, "warmup_steps": 2,
            "why": "a CPU test size",
            "limits": limits or {"init": 1e-9, "first": 1e-9, "last": 1e-9}}


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's data (configs, workloads, metrics) that
    the harness reads in place of the repository's, with the spec of
    BENCHMARK.json; tests add files and entries to it."""
    from benchmark.harness import core
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", d), tmp_path / d)
    monkeypatch.setattr(core, "BENCH", tmp_path)
    spec = core.load_spec()

    def add_cell(name, config, n, limits=None):
        (tmp_path / "workloads" / f"{name}.json").write_text(
            json.dumps(tiny_workload(config, n, limits)))
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": name, "chips": 1,
                                  "why": "a CPU test size"})
    return tmp_path, spec, add_cell
