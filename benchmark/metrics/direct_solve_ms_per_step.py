"""Device ms per step of the direct solves' matrix-product and FFT
kernels (cuBLAS, cuFFT) in the traced window."""

from benchmark.harness import trace


def read(record):
    tr = record.get("trace")
    if tr is None or not record["steps"]:
        return None
    us = trace.group_us(tr)["direct"]
    return us * 1e-3 / record["steps"] if us else None
