"""The same reading as host_syncs_per_step, for the multigrid cells, beside
their own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("host_syncs_per_step")
