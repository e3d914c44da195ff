"""The same reading as torch_ops_ms_per_step, for the multigrid cells,
beside their own rate (cells_per_s.multigrid)."""

from benchmark.harness.core import reader

read = reader("torch_ops_ms_per_step")
