"""Device ms per step of every operation in the traced window that is
not a Godunov kernel, a smoother kernel or a direct solve's GEMM or FFT:
PyTorch's elementwise, reduction and copy kernels."""

from benchmark.harness import trace


def read(record):
    tr = record.get("trace")
    if tr is None or not record["steps"]:
        return None
    return trace.group_us(tr)["torch"] * 1e-3 / record["steps"]
