"""The 95th percentile of the window's per-step device times (CUDA events
recorded after consecutive steps on the compute stream, so idle gaps
count), nearest rank.  Needs 200 steps or more in the window."""

import math


def read(record):
    t = sorted(record["step_ms"])
    if len(t) < 200:
        return None
    return t[math.ceil(0.95 * len(t)) - 1]
