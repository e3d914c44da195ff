#!/usr/bin/env python3
"""The fused 2D step kernel of several trees on one card, in turns.

    python3 scripts/step2d_ab.py --tree parent=DIR [--tree NAME=DIR ...]
                                 [--n 128,256] [--out FILE]

Each DIR holds a checkout (for instance `git archive` unpacked into
_ab/parent, a directory .gitignore lists); this tree runs as "change".
The turns run the trees in order and then in reverse (parent, change,
change, parent with one --tree), one child process per turn, which
imports incflo_torch from its tree, builds its csrc/step2d.cu and
measures, float32 on the card, tgv2d at each n^2 of --n from
init_state:

  - one step2d_kernels.FusedStep call, median of 25 CUDA-graph replays
    (chip_smoke.device_ms);
  - tgv2d through Simulation.advance_n (the fused step): 2 warm-up + 20
    timed steps, host clock around a synchronised run.

Prints the card (nvidia-smi name and power limit), each number of each
turn and each tree's mean over its turns relative to the first tree's,
and writes every number as JSON to FILE (default
chiprun_out/step2d_ab.json).  It needs one CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("step2d", "tgv2d_step")


def child(tree, sizes, out):
    """One turn: measure the tree's fused step kernel and step, write
    JSON."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step2d_ab: needs a CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(tree))
    import incflo_torch
    from incflo_torch.ops import cuda_build
    from incflo_torch.ops import step2d_kernels as s2
    assert os.path.dirname(os.path.dirname(s2.__file__)) == \
        os.path.join(os.path.abspath(tree), "incflo_torch")
    cuda_build.build(s2.SOURCE)
    ms = {}
    for n in sizes:
        sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(
            cs.tgv2d_deck(n, "float32")))
        s0 = sim.init_state()
        fs = s2.FusedStep(sim)
        ms[f"step2d_{n}"] = cs.device_ms(lambda: fs.step(s0))
        s = sim.advance_n(s0, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_n(s, 20)
        torch.cuda.synchronize()
        ms[f"tgv2d_step_{n}"] = (time.perf_counter() - t0) / 20 * 1e3
        del sim, s, fs
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump({"tree": tree, "ms": ms}, f)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a tree to compare with this one")
    ap.add_argument("--n", default="128,256",
                    help="tgv2d sizes n (n x n cells), comma-separated")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "step2d_ab.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        child(a.child, [int(v) for v in a.n.split(",")], a.json)
        return 0
    if not a.tree:
        ap.error("at least one --tree NAME=DIR is required")
    trees = [tuple(t.split("=", 1)) for t in a.tree] + [("change", HERE)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[ab] {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    turns = []
    for name, tree in trees + trees[::-1]:
        path = f"{a.out}.{len(turns)}"
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", tree, "--json", path, "--n", a.n],
                       check=True)
        with open(path) as f:
            turns.append((name, json.load(f)))
        print(f"[ab] turn {len(turns)} ({name}) done", flush=True)
    names = [n for n, _ in trees]
    print("[ab] ms per call, turn by turn ("
          + ", ".join(n for n, _ in turns) + "), and each tree's mean "
          f"relative to {names[0]}'s:")
    sizes = [int(v) for v in a.n.split(",")]
    for k in (f"{k}_{n}" for n in sizes for k in KERNELS):
        t = [tr["ms"][k] for _, tr in turns]
        mean = {n: sum(v for (m, _), v in zip(turns, t) if m == n) / 2
                for n in names}
        print(f"[ab] {k}: " + ", ".join(f"{v:.5f}" for v in t) + "; "
              + ", ".join(f"{n} {mean[n] / mean[names[0]]:.4f}"
                          for n in names[1:]))
    with open(a.out, "w") as f:
        json.dump({"card": card, "turns": [{"name": n, **tr}
                                           for n, tr in turns]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
