"""The share of the traced window in which no operation ran on the
device, in percent: 1 - busy / window, busy the union of the trace's
intervals and the cooperative smoother launches the trace does not
show."""

from benchmark.harness import trace


def read(record):
    tr = record.get("trace")
    if tr is None or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / record["window_s"])
