"""Device launches per step in the traced window: the trace's kernels
and the cooperative smoother launches it does not show."""

from benchmark.harness import trace


def read(record):
    tr = record.get("trace")
    if tr is None or not record["steps"]:
        return None
    return trace.launches(tr) / record["steps"]
