"""The same reading as cells_per_s, for a cell whose step the host bounds
through its iterative solves (multigrid, a host sync per loop test): its
rate moves with the host, so it has a bound of its own."""

from benchmark.harness.core import reader

read = reader("cells_per_s")
