"""Seconds from the harness's entry to the window's first step: imports,
the CUDA context, loading (on a checkout's first run building) the
kernel libraries, the Simulation and its static solvers, the initial
fields and projection, the warm-up steps."""


def read(record):
    return record["setup_s"]
