"""The same reading as device_idle_share, for the multigrid cells, beside
their own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("device_idle_share")
