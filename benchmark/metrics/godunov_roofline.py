"""The Godunov CUDA kernels' share of their roofline, in percent: the
summed bound time of the traced window's calls (benchmark/roofline:
operations of the plain versions at each call's shapes, each input and
output byte once) over their summed kernel time in the trace."""

from benchmark.harness import trace
from benchmark.roofline import kernels


def read(record):
    tr = record.get("trace")
    if tr is None or not tr["godunov_calls"]:
        return None
    t = trace.group_us(tr)["godunov"] * 1e-6
    if t <= 0:
        return None
    bound = sum(kernels.bound_s(*kernels.godunov_call(kind, args))
                for kind, args in tr["godunov_calls"])
    return 100.0 * bound / t
