"""Bools read back from the device per step to steer the solvers' loops
(incflo_torch.ops.multigrid.COUNTS["host_syncs"]) over the window."""


def read(record):
    n = record["counts"].get("host_syncs", 0)
    if not record["steps"] or not n:
        return None
    return n / record["steps"]
