"""The benchmark of incflo_torch on one NVIDIA GPU.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Runs the cell's deck (benchmark/workloads,
benchmark/configs) from fields made from the seed, times a closed loop
of steps for --seconds, checks the window's states against the plain
reference (benchmark/reference), and prints one JSON line as the last
line of standard output: the cell's end-to-end metrics (--trace 0) or
its per-layer metrics (--trace 1), `correct`, and the numbers compared
beside their limits.  Exits with an error, printing no result, where
torch finds no CUDA device, or where JAX or incflo_tpu was loaded."""

from __future__ import annotations

import time

T_ENTRY = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names the run may not load: the JAX stack and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "incflo_tpu")


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import core

    cell = core.Cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, notes = core.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_ENTRY)
    found = forbidden_modules()
    if found:
        print("benchmark: the run loaded " + ", ".join(found),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
