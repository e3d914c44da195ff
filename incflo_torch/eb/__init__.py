"""Embedded boundaries (port of incflo_tpu/eb/): cut-cell geometry on
the host (geometry.py, surface.py) and the cut-cell operators on the
simulation's device (ops.py, mol.py)."""
