"""The smoother CUDA kernels' share of their roofline, in percent: the
summed bound time of the traced window's calls (benchmark/roofline)
over their summed time: the trace's kernels of the resident calls and
the CUDA-event times of the cooperative ones, which the trace does not
show."""

from benchmark.harness import trace
from benchmark.roofline import kernels


def read(record):
    tr = record.get("trace")
    if tr is None or not tr["smoother_calls"]:
        return None
    t = trace.group_us(tr)["smoother"] * 1e-6 + trace.cooperative(tr)[0] * 1e-3
    if t <= 0:
        return None
    bound = sum(kernels.bound_s(*kernels.smoother_call(c))
                for c in tr["smoother_calls"])
    return 100.0 * bound / t
