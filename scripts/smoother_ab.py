#!/usr/bin/env python3
"""The smoother kernels of two trees on one card, in turns.

    python3 scripts/smoother_ab.py --parent DIR [--out FILE]

DIR holds a checkout of the parent commit (for instance `git archive`
unpacked into _ab/parent, a directory .gitignore lists).  One child
process per turn -- parent, change, change, parent -- imports
incflo_torch from its tree, builds its kernels and measures, float32 on
the card:

  - each level of the shear3d_vd (128x128x32) and rt (64x64x128)
    hierarchies at the call its V-cycles make there, through the solver's
    own _smooth_res (chip_smoke.hierarchy_cases), median of 25 CUDA-graph
    replays; a tree whose nodal smoother has no walls smooths a walled
    nodal level the way that tree does (plain PyTorch);
  - shear3d_vd from init_state and rt, 2 warm-up + 5 timed steps through
    Simulation.advance_n, host clock around a synchronised run.

Prints the card (nvidia-smi name and power limit), a table of the four
turns, and writes every number as JSON to FILE (default
chiprun_out/smoother_ab.json).  It needs one CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree, out):
    """One turn: measure the tree's smoothers and steps, write JSON."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("smoother_ab: needs a CUDA device")
    # this tree's chip_smoke (the level cases), the given tree's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(tree))
    import incflo_torch
    from incflo_torch.ops import cuda_build
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    assert os.path.dirname(os.path.dirname(sk.__file__)) == \
        os.path.join(os.path.abspath(tree), "incflo_torch")
    cuda_build.build(sk.SOURCE)
    rows = []
    for deck, family, li, solver, x, b, n, want in cs.hierarchy_cases(
            mg, torch, torch.float32, torch.device("cuda")):
        ms = cs.device_ms(lambda: solver._smooth_res(x, b, li, n, want))
        rows.append({"deck": deck, "family": family, "level": li,
                     "shape": "x".join(str(v) for v in x.shape),
                     "call": f"{n} sweeps" + (" + residual" if want else ""),
                     "ms": ms})
    steps = {}
    for deck in ("shear3d_vd", "rt"):
        text = (cs.shear3d_deck(128, "float32", vd=True)
                if deck == "shear3d_vd" else cs.rt_deck(128, "float32"))
        sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(text))
        s = sim.init_state()
        s = sim.advance_n(s, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sim.advance_n(s, 5)
        torch.cuda.synchronize()
        steps[deck] = (time.perf_counter() - t0) / 5 * 1e3
        del sim, s
    with open(out, "w") as f:
        json.dump({"tree": tree, "levels": rows, "ms_per_step": steps}, f)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of the parent commit")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "smoother_ab.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--json", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        child(a.child, a.json)
        return 0
    if not a.parent:
        ap.error("--parent DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[ab] {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    turns = []
    for name, tree in (("parent", a.parent), ("change", HERE),
                       ("change", HERE), ("parent", a.parent)):
        path = f"{a.out}.{len(turns)}"
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", tree, "--json", path], check=True)
        with open(path) as f:
            turns.append((name, json.load(f)))
        print(f"[ab] turn {len(turns)} ({name}) done", flush=True)
    print("[ab] ms per call (parent, change, change, parent) and "
          "parent/change of the means:")
    for i, row in enumerate(turns[0][1]["levels"]):
        t = [tr["levels"][i]["ms"] for _, tr in turns]
        ratio = (t[0] + t[3]) / (t[1] + t[2])
        print(f"[ab] {row['deck']} {row['family']} level {row['level']} "
              f"{row['shape']} {row['call']}: "
              + ", ".join(f"{v:.4f}" for v in t) + f"; {ratio:.2f}x")
    for deck in ("shear3d_vd", "rt"):
        t = [tr["ms_per_step"][deck] for _, tr in turns]
        print(f"[ab] {deck} ms/step: " + ", ".join(f"{v:.3f}" for v in t)
              + f"; {(t[0] + t[3]) / (t[1] + t[2]):.2f}x")
    with open(a.out, "w") as f:
        json.dump({"card": card, "turns": [{"name": n, **tr}
                                           for n, tr in turns]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
