"""The same reading as smoother_roofline, for the multigrid cells, beside
their own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("smoother_roofline")
