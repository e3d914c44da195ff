"""The same reading as peak_mem_gib, for the multigrid cells, beside their
own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("peak_mem_gib")
