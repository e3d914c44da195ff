#!/usr/bin/env python3
"""Where the fused 2D step kernel's time goes, from its probe.

    python3 scripts/step2d_probe.py [--n 128,256] [--reps 7] [--tree DIR]
                                    [--out FILE]

For each n, tgv2d at n^2 float32 from init_state: the kernel's probe
instantiation (csrc/step2d.cu, step2d_launch_probe: block 0 stamps
%globaltimer and clock64 after every segment of the step and before and
after every grid barrier) runs `reps` times on one state after a
warm-up, and the median ms of each kind of segment is printed --
transform (the products' k-loops), panel load, epilogue, barrier wait,
elementwise or stencil work, reduction finish -- beside the total, the
clock64 shares, the k-loops' shares spent waiting for a k-tile, issuing
the next one's copies and in the products, the SM clock, the barrier
count, and the kernel's own time (the main instantiation,
chip_smoke.device_ms).  A tree whose probe predates some kinds reports
them as 0.  The
stamps cost a block barrier each, so the probe's total runs above the
kernel's time.  --tree DIR takes incflo_torch from the checkout in DIR
(for instance a `git archive` unpacked into _ab/, a directory .gitignore
lists) instead of this one.  Prints the card (nvidia-smi name and power
limit) and writes the numbers as JSON to FILE (default
chiprun_out/step2d_probe.json).  It needs one CUDA device.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(n, reps, tree):
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(tree))
    import incflo_torch
    from incflo_torch.ops import step2d_kernels as s2
    sim = incflo_torch.Simulation(incflo_torch.IncfloConfig.from_text(
        cs.tgv2d_deck(n, "float32")))
    fs = s2.FusedStep(sim)
    s0 = sim.init_state()
    for _ in range(3):
        fs.probe(s0)
    splits = [fs.probe(s0)[1] for _ in range(reps)]
    med = {k: statistics.median(sp["ms"][k] for sp in splits)
           for k in splits[0]["ms"]}
    share = {k: statistics.median(sp["clock_share"][k] for sp in splits)
             for k in splits[0]["clock_share"]}
    out = {"n": n, "ms": med,
           "total_ms": statistics.median(sp["total_ms"] for sp in splits),
           "clock_share": share, "barriers": splits[0]["barriers"],
           # k-loop shares and the SM clock (a tree whose probe has them)
           **{k: statistics.median(sp.get(k) or 0.0 for sp in splits)
              for k in ("kloop_wait_share", "kloop_issue_share",
                        "kloop_mma_share", "clock_ghz")},
           "segments": splits[0]["segments"], "blocks": fs.blocks,
           "kernel_ms": cs.device_ms(lambda: fs.step(s0))}
    plan = getattr(s2, "launch_plan", None)
    if plan is not None:
        out["plan"] = plan(sim.grid.n_cell, 4)._asdict()
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="128,256")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "step2d_probe.json"))
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step2d_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[probe] {card}", flush=True)
    rows = []
    for n in (int(v) for v in a.n.split(",")):
        r = measure(n, a.reps, a.tree)
        rows.append(r)
        print(f"[probe] tgv2d {n}^2 f32: kernel {r['kernel_ms']:.4f} ms; "
              f"probe total {r['total_ms']:.4f} ms = "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items())
              + " ms (median of " + str(a.reps) + "); clock64 shares "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["clock_share"].items())
              + f"; k-loop shares: waiting {r['kloop_wait_share']:.3f}, "
              f"issuing {r['kloop_issue_share']:.3f}, products "
              f"{r['kloop_mma_share']:.3f}; SM clock "
              f"{r['clock_ghz']:.3f} GHz"
              + f"; {r['barriers']} grid barriers, {r['segments']} "
              f"segments, {r['blocks']} blocks"
              + (f"; plan {r['plan']}" if "plan" in r else ""), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
