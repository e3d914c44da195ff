"""Cell updates per second: the level's cells times the steps launched in
the window, over the window's host seconds (from the first step's
dispatch to the synchronize after the last)."""


def read(record):
    return record["cells"] * record["steps"] / record["window_s"]
