#!/usr/bin/env python3
"""The Godunov kernels of several trees on one card, in turns.

    python3 scripts/godunov_ab.py --tree parent=DIR [--tree NAME=DIR ...]
                                  [--n 128,256] [--out FILE]

Each DIR holds a checkout (for instance `git archive` unpacked into
_ab/parent, a directory .gitignore lists); this tree runs as "change".
The turns run the trees in order and then in reverse (parent, change,
change, parent with one --tree), one child process per turn, which
imports incflo_torch from its tree, builds its csrc/godunov.cu and
measures, float32 on the card, at each shear3d level n of --n (n x n x
n/4 cells):

  - uad, predict_d (d = 0) and advect (component 0, convective form) as
    the shear3d step calls them: PPM, with forces, median of 25 CUDA-graph
    replays (chip_smoke.device_ms);
  - the halo-slab kernels uad_halo, predict_d_halo and advect_halo on the
    first of 2 x slabs (nxl = n / 2: 64 at n = 128), the same calls;
  - shear3d from init_state: 2 warm-up + 5 timed steps through
    Simulation.advance_n, host clock around a synchronised run.

Prints the card (nvidia-smi name and power limit), each number of each
turn and each tree's mean over its turns relative to the first tree's,
and writes every number as JSON to FILE (default
chiprun_out/godunov_ab.json).  It needs one CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("uad", "predict_d", "advect", "uad_halo", "predict_d_halo",
           "advect_halo", "shear3d_step")


def child(tree, sizes, out):
    """One turn: measure the tree's kernels and step, write JSON."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("godunov_ab: needs a CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(tree))
    import incflo_torch
    from incflo_torch.grid import Grid
    from incflo_torch.ops import cuda_build
    from incflo_torch.ops import godunov_kernels as gk
    assert os.path.dirname(os.path.dirname(gk.__file__)) == \
        os.path.join(os.path.abspath(tree), "incflo_torch")
    cuda_build.build(gk.SOURCE)
    ms = {}
    for n in sizes:
        grid = Grid((n, n, max(n // 4, 8)), (0.0,) * 3, (1.0, 1.0, 0.25),
                    (True,) * 3)
        vel, forces, _, dt = cs.kernel_inputs(grid, torch.float32,
                                              torch.device("cuda"))
        uad = gk.uad(grid, vel, dt, True)
        umac = [gk.predict_d(grid, vel, uad, forces, dt, d, True)
                for d in range(3)]
        slab = cs.slab_grid(grid, 2)
        nxl = slab.n_cell[0]
        pad = lambda a: cs.halo_rows(a, 0, nxl, gk.HALO)
        vel_p, f_p = pad(vel), pad(forces)
        uad_p = [pad(u) for u in uad]
        mac_p = [pad(m) for m in [umac[0].narrow(0, 0, n)] + umac[1:]]
        calls = {
            "uad": lambda: gk.uad(grid, vel, dt, True),
            "predict_d": lambda: gk.predict_d(grid, vel, uad, forces, dt, 0,
                                              True),
            "advect": lambda: gk.advect_comp(grid, vel, 0, umac, forces, dt,
                                             False, True),
            "uad_halo": lambda: gk.uad_halo(slab, vel_p, dt, True),
            "predict_d_halo": lambda: gk.predict_d_halo(
                slab, vel_p, uad_p, f_p, dt, 0, True),
            "advect_halo": lambda: gk.advect_comp_halo(
                slab, vel_p, 0, mac_p, f_p, dt, False, True)}
        for k, fn in calls.items():
            ms[f"{k}_{n}"] = cs.device_ms(fn)
        sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(
            cs.shear3d_deck(n, "float32")))
        s = sim.advance_n(sim.init_state(), 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_n(s, 5)
        torch.cuda.synchronize()
        ms[f"shear3d_step_{n}"] = (time.perf_counter() - t0) / 5 * 1e3
        del sim, s
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump({"tree": tree, "ms": ms}, f)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a tree to compare with this one")
    ap.add_argument("--n", default="128,256",
                    help="shear3d levels n (n x n x n/4 cells), comma-separated")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "godunov_ab.json"))
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
