"""Checkpoint and plotfile I/O and diagnostics (port of incflo_tpu/utils)."""
