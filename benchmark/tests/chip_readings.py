"""Readings for the check's limits at a cell's own size, on the card:
for each seed the program's three numbers (init, first, last) after a
short run of steps, and for the first `--control` seeds the control's
(the float32 reference against the float64 one, from the same fields
and the same program state), each with its gaps by field.  One process,
one Simulation for every seed.

    python benchmark/tests/chip_readings.py --workload rt-256-f64 \
        --seeds 11 12 13 --steps 3 --control 3
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness import check, core, fields, program
    dev = torch.device("cuda")
    cell = core.Cell(args.workload)
    dtype = getattr(torch, cell.deck.dtype)
    sim = program.build(cell.deck_text, dev)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        v, r, t = fields.initial_fields(cell.deck, seed, dtype, dev)
        s = program.initial_state(sim, v, r, t)
        inputs = {"velocity": v, "density": r, "tracer": t}
        port = {"init": s.level.velocity.clone()}
        s = sim.advance(s)
        port["first"] = program.fields_of(s)
        prev = s
        for _ in range(args.steps):
            prev, s = s, sim.advance(s)
        port["prev"], port["last"] = program.fields_of(prev), \
            program.fields_of(s)
        del s, prev
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        values, where = check.readings(cell.deck, inputs, port, dev)
        out = {"seed": seed, "program": values, "where": where,
               "run_s": t1 - t0, "check_s": time.perf_counter() - t1}
        if i < args.control:
            t2 = time.perf_counter()
            out["control"], out["control_where"] = check.control_readings(
                cell.deck, inputs, port["prev"], dev)
            out["control_s"] = time.perf_counter() - t2
        print(json.dumps(out), flush=True)
        del port, inputs, v, r, t
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
