"""Iterations of the iterative solves per step: the program's CG
iterations of the cell solves, V-cycles of the nodal solves and tensor
CG iterations (incflo_torch.ops.multigrid.COUNTS) over the window."""

KEYS = ("cell_iters", "nodal_cycles", "tensor_cg_iters")


def read(record):
    c = record["counts"]
    if not record["steps"] or not any(c.get(k, 0) for k in KEYS):
        return None
    return sum(c.get(k, 0) for k in KEYS) / record["steps"]
