"""Seconds of the harness's span around building the Simulation (its
static solvers) and its initial state (the initial projection), device
synchronised at the end."""


def read(record):
    return record["sim_build_s"]
