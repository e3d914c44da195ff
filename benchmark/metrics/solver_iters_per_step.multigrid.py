"""The same reading as solver_iters_per_step, for the multigrid cells,
beside their own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("solver_iters_per_step")
