"""The same reading as launches_per_step, for the multigrid cells, beside
their own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("launches_per_step")
